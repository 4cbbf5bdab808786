"""Mutation: the unit of replication.

Parity: src/replica/mutation.h:79 — a mutation carries a ballot, a decree,
the primary's last_committed_decree (piggy-backed so secondaries advance
their commit point, replica_2pc.cpp:344,709), a primary-assigned
timestamp (determinism of value timetags across replicas), and one or
more client write requests. Batching rule (mutation.cpp:390,553): multiple
batchable writes (put/remove/multi_*) share a mutation; atomic ops
(incr/cas/cam) ride alone.

Wire/log format:
    [u64 ballot][u64 decree][u64 last_committed][u64 timestamp_us]
    [u32 n_ops] { [u32 len][encoded write] }*
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, List, Tuple

from pegasus_tpu_torch.rpc.codec import decode_write, encode_write

_HDR = struct.Struct("<QQQQI")

# ops that may share a mutation (parity: rpc_request_is_write_allow_batch)
from pegasus_tpu_torch.rpc.codec import (  # noqa: E402
    OP_CAM,
    OP_CAS,
    OP_DUP_PUT,
    OP_DUP_REMOVE,
    OP_INCR,
    OP_INGEST,
    OP_MULTI_PUT,
    OP_MULTI_REMOVE,
    OP_PUT,
    OP_REMOVE,
)

BATCHABLE_OPS = {OP_PUT, OP_REMOVE, OP_MULTI_PUT, OP_MULTI_REMOVE,
                 OP_DUP_PUT, OP_DUP_REMOVE}
# ingestion rides alone like atomic ops (a whole-SST apply must own its
# decree; parity: bulk-load mutations never batch)
ATOMIC_OPS = {OP_INCR, OP_CAS, OP_CAM, OP_INGEST}


@dataclass
class WriteOp:
    op: int
    request: Any


@dataclass
class Mutation:
    ballot: int
    decree: int
    last_committed: int
    timestamp_us: int
    ops: List[WriteOp] = field(default_factory=list)

    def encode(self) -> bytes:
        parts = [_HDR.pack(self.ballot, self.decree, self.last_committed,
                           self.timestamp_us, len(self.ops))]
        for wo in self.ops:
            blob = encode_write(wo.op, wo.request)
            parts.append(struct.pack("<I", len(blob)))
            parts.append(blob)
        return b"".join(parts)

    @staticmethod
    def decode(data: bytes) -> "Mutation":
        ballot, decree, last_committed, ts, n = _HDR.unpack_from(data, 0)
        pos = _HDR.size
        ops: List[WriteOp] = []
        for _ in range(n):
            (length,) = struct.unpack_from("<I", data, pos)
            pos += 4
            op, req, end = decode_write(data, pos)
            if end != pos + length:
                raise ValueError("mutation op length mismatch")
            ops.append(WriteOp(op, req))
            pos = end
        return Mutation(ballot, decree, last_committed, ts, ops)
