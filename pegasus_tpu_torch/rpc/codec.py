"""Binary codec for rrdb write requests.

Role parity: the thrift-serialized rrdb structs that travel on the wire
and inside mutations (idl/rrdb.thrift; the reference checks in generated
C++ and logs raw request blobs into mutations,
src/replica/mutation.cpp). We use a compact length-prefixed binary
format — one byte op code, then op-specific fields — shared by the
mutation log and (later) the network layer.

Grammar (little-endian):
    blob     := [u32 len][bytes]
    put      := OP_PUT blob(key) blob(value) u32(expire_ts)
    remove   := OP_REMOVE blob(key)
    multi_put:= OP_MULTI_PUT blob(hash_key) u32(expire) u32(n) {blob blob}*
    multi_rm := OP_MULTI_REMOVE blob(hash_key) u32(n) {blob}*
    incr     := OP_INCR blob(key) i64(increment) i32(expire)
    cas      := OP_CAS blob(hk) blob(check_sk) u8(type) blob(operand)
                u8(diff) blob(set_sk) blob(set_value) i32(expire) u8(ret)
    cam      := OP_CAM blob(hk) blob(check_sk) u8(type) blob(operand)
                u8(ret) u32(n) {u8(op) blob(sk) blob(value) i32(expire)}*
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

from pegasus_tpu_torch.server.types import (
    CheckAndMutateRequest,
    CheckAndSetRequest,
    IncrRequest,
    KeyValue,
    MultiPutRequest,
    MultiRemoveRequest,
    Mutate,
)

OP_PUT = 1
OP_REMOVE = 2
OP_MULTI_PUT = 3
OP_MULTI_REMOVE = 4
OP_INCR = 5
OP_CAS = 6
OP_CAM = 7
# bulk-load SST ingestion rides the 2PC pipeline as its own mutation
# (parity: RPC_RRDB_RRDB_BULK_LOAD through init_prepare,
# replica_2pc.cpp:211-230): request = (block_root, staged_app_name)
OP_INGEST = 8
# duplication-shipped writes (parity: duplicate-tagged update_request,
# idl/rrdb.thrift dup fields): carry the SOURCE timetag so the follower
# resolves conflicts; applied through the follower's own 2PC
# dup_put: (key, user_data, expire_ts, timetag); dup_remove: (key, timetag)
OP_DUP_PUT = 9
OP_DUP_REMOVE = 10


def _blob(b: bytes) -> bytes:
    return struct.pack("<I", len(b)) + b


class _Reader:
    def __init__(self, data: bytes, pos: int = 0) -> None:
        self.data = data
        self.pos = pos

    def blob(self) -> bytes:
        (n,) = struct.unpack_from("<I", self.data, self.pos)
        self.pos += 4
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated blob")
        self.pos += n
        return out

    def u8(self) -> int:
        v = self.data[self.pos]
        self.pos += 1
        return v

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.data, self.pos)
        self.pos += 4
        return v

    def i32(self) -> int:
        (v,) = struct.unpack_from("<i", self.data, self.pos)
        self.pos += 4
        return v

    def i64(self) -> int:
        (v,) = struct.unpack_from("<q", self.data, self.pos)
        self.pos += 8
        return v


def encode_write(op: int, req: Any) -> bytes:
    if op == OP_PUT:
        key, value, expire_ts = req
        return bytes([OP_PUT]) + _blob(key) + _blob(value) + struct.pack(
            "<I", expire_ts)
    if op == OP_REMOVE:
        (key,) = req if isinstance(req, tuple) else (req,)
        return bytes([OP_REMOVE]) + _blob(key)
    if op == OP_MULTI_PUT:
        assert isinstance(req, MultiPutRequest)
        out = [bytes([OP_MULTI_PUT]), _blob(req.hash_key),
               struct.pack("<iI", req.expire_ts_seconds, len(req.kvs))]
        for kv in req.kvs:
            out.append(_blob(kv.key))
            out.append(_blob(kv.value))
        return b"".join(out)
    if op == OP_MULTI_REMOVE:
        assert isinstance(req, MultiRemoveRequest)
        out = [bytes([OP_MULTI_REMOVE]), _blob(req.hash_key),
               struct.pack("<I", len(req.sort_keys))]
        out.extend(_blob(sk) for sk in req.sort_keys)
        return b"".join(out)
    if op == OP_INCR:
        assert isinstance(req, IncrRequest)
        return (bytes([OP_INCR]) + _blob(req.key)
                + struct.pack("<qi", req.increment, req.expire_ts_seconds))
    if op == OP_CAS:
        assert isinstance(req, CheckAndSetRequest)
        return (bytes([OP_CAS]) + _blob(req.hash_key)
                + _blob(req.check_sort_key)
                + bytes([int(req.check_type)]) + _blob(req.check_operand)
                + bytes([int(req.set_diff_sort_key)])
                + _blob(req.set_sort_key) + _blob(req.set_value)
                + struct.pack("<i", req.set_expire_ts_seconds)
                + bytes([int(req.return_check_value)]))
    if op == OP_INGEST:
        root, src_app, load_id = req
        return (bytes([OP_INGEST]) + _blob(root.encode())
                + _blob(src_app.encode()) + struct.pack("<Q", load_id))
    if op == OP_DUP_PUT:
        key, user_data, expire_ts, timetag = req
        return (bytes([OP_DUP_PUT]) + _blob(key) + _blob(user_data)
                + struct.pack("<IQ", expire_ts, timetag))
    if op == OP_DUP_REMOVE:
        key, timetag = req
        return bytes([OP_DUP_REMOVE]) + _blob(key) + struct.pack(
            "<Q", timetag)
    if op == OP_CAM:
        assert isinstance(req, CheckAndMutateRequest)
        out = [bytes([OP_CAM]), _blob(req.hash_key),
               _blob(req.check_sort_key), bytes([int(req.check_type)]),
               _blob(req.check_operand),
               bytes([int(req.return_check_value)]),
               struct.pack("<I", len(req.mutate_list))]
        for m in req.mutate_list:
            out.append(bytes([int(m.operation)]))
            out.append(_blob(m.sort_key))
            out.append(_blob(m.value))
            out.append(struct.pack("<i", m.set_expire_ts_seconds))
        return b"".join(out)
    raise ValueError(f"unknown write op {op}")


def decode_write(data: bytes, pos: int = 0) -> Tuple[int, Any, int]:
    """Returns (op, request, next_pos)."""
    r = _Reader(data, pos)
    op = r.u8()
    if op == OP_PUT:
        key = r.blob()
        value = r.blob()
        expire = r.u32()
        return op, (key, value, expire), r.pos
    if op == OP_REMOVE:
        return op, (r.blob(),), r.pos
    if op == OP_MULTI_PUT:
        hk = r.blob()
        expire = r.i32()
        n = r.u32()
        kvs = []
        for _ in range(n):
            k = r.blob()
            v = r.blob()
            kvs.append(KeyValue(k, v))
        return op, MultiPutRequest(hk, kvs, expire), r.pos
    if op == OP_MULTI_REMOVE:
        hk = r.blob()
        n = r.u32()
        sks = [r.blob() for _ in range(n)]
        return op, MultiRemoveRequest(hk, sks), r.pos
    if op == OP_INCR:
        key = r.blob()
        inc = r.i64()
        expire = r.i32()
        return op, IncrRequest(key, inc, expire), r.pos
    if op == OP_CAS:
        hk = r.blob()
        csk = r.blob()
        ctype = r.u8()
        operand = r.blob()
        diff = bool(r.u8())
        ssk = r.blob()
        sval = r.blob()
        expire = r.i32()
        ret = bool(r.u8())
        return op, CheckAndSetRequest(hk, csk, ctype, operand, diff, ssk,
                                      sval, expire, ret), r.pos
    if op == OP_INGEST:
        root = r.blob().decode()
        src_app = r.blob().decode()
        load_id = r.i64() & 0xFFFFFFFFFFFFFFFF
        return op, (root, src_app, load_id), r.pos
    if op == OP_DUP_PUT:
        key = r.blob()
        user_data = r.blob()
        (expire, timetag) = struct.unpack_from("<IQ", r.data, r.pos)
        r.pos += 12
        return op, (key, user_data, expire, timetag), r.pos
    if op == OP_DUP_REMOVE:
        key = r.blob()
        (timetag,) = struct.unpack_from("<Q", r.data, r.pos)
        r.pos += 8
        return op, (key, timetag), r.pos
    if op == OP_CAM:
        hk = r.blob()
        csk = r.blob()
        ctype = r.u8()
        operand = r.blob()
        ret = bool(r.u8())
        n = r.u32()
        muts = []
        for _ in range(n):
            mop = r.u8()
            sk = r.blob()
            v = r.blob()
            expire = r.i32()
            muts.append(Mutate(mop, sk, v, expire))
        return op, CheckAndMutateRequest(hk, csk, ctype, operand, muts,
                                         ret), r.pos
    raise ValueError(f"unknown write op {op}")


