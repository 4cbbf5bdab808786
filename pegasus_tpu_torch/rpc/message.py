"""Wire codec for whole cluster messages.

Parity role: the reference's message_header + thrift-struct body
(src/rpc/rpc_message.h:81-126: lengths, crc32, rpc_name, gpid routing
fields; thrift payloads generated from idl/*.thrift). We use one compact
self-describing binary format instead of codegen: a tagged value grammar
plus a registry of message dataclasses (the IDL-equivalent single source
of truth is `server/types.py`).

Frame:
    [4s magic "PGT1"] [u32 body_len] [u32 crc32(body)]
    body := str(src) str(dst) str(msg_type) value(payload)

Value grammar (little-endian):
    N       none            T/F     bool
    i       i64             d       f64
    b       u32-len bytes   s       u32-len utf-8 str
    l/t     u32-count list/tuple of value
    m       u32-count dict of (value value)
    D       str(registry-name) u32-count fields (in dataclass field order)

Every registered dataclass is flat (primitives / lists / nested
registered dataclasses), so the grammar closes. Unknown tags or registry
names raise — a version-skewed peer fails loudly, not silently. The one
sanctioned evolution is appending defaulted fields: a decoder accepts a
SHORTER field list when every omitted trailing field has a default
(thrift optional-field semantics), so older clients — including the
compiled native one — keep working across additive changes.
"""

from __future__ import annotations

import dataclasses
import struct
import threading
from typing import Any, Callable, Dict, Tuple

from pegasus_tpu_torch.base.crc import crc32

MAGIC = b"PGT1"
_U32 = struct.Struct("<I")
_HDR = struct.Struct("<4sII")

# ---- dataclass registry ------------------------------------------------

_REGISTRY: Dict[str, type] = {}
_FIELDS: Dict[str, Tuple[str, ...]] = {}
# the default types are registered once, under the lock, and only then
# is _FILLED set: a thread that finds it unset waits for the lock, so
# none ever codes a frame against a partial registry
_FILL_LOCK = threading.Lock()
_FILLED = False


def register_message_type(cls: type) -> type:
    name = cls.__name__
    _REGISTRY[name] = cls
    _FIELDS[name] = tuple(f.name for f in dataclasses.fields(cls))
    return cls


def _register_defaults() -> None:
    from pegasus_tpu_torch.meta.server_state import PartitionConfig
    from pegasus_tpu_torch.ops.pushdown import PushdownSpec
    from pegasus_tpu_torch.server import types as t

    for cls in (t.KeyValue, t.MultiPutRequest, t.MultiRemoveRequest,
                t.MultiGetRequest, t.MultiGetResponse, t.FullKey,
                t.FullData, t.BatchGetRequest, t.BatchGetResponse,
                t.IncrRequest, t.IncrResponse, t.CheckAndSetRequest,
                t.CheckAndSetResponse, t.Mutate, t.CheckAndMutateRequest,
                t.CheckAndMutateResponse, t.GetScannerRequest,
                t.ScanRequest, t.ScanResponse, t.ScanPage, PushdownSpec,
                PartitionConfig):
        register_message_type(cls)


def fill_registry() -> None:
    """Register the default message types, once per process. A node
    calls it before its port opens, so that no reader thread imports
    the modules that define them."""
    global _FILLED
    if _FILLED:
        return
    with _FILL_LOCK:
        if not _FILLED:
            _register_defaults()
            _FILLED = True


# ---- value codec -------------------------------------------------------


def _enc_value(out: list, v: Any) -> None:
    if v is None:
        out.append(b"N")
    elif v is True:
        out.append(b"T")
    elif v is False:
        out.append(b"F")
    elif isinstance(v, int):  # bool handled above (is-checks)
        if -(1 << 63) <= v < (1 << 63):
            out.append(b"i" + struct.pack("<q", v))
        elif 0 <= v < (1 << 64):
            # crc64 partition hashes live here
            out.append(b"u" + struct.pack("<Q", v))
        else:
            raw = v.to_bytes((v.bit_length() + 8) // 8, "little",
                             signed=True)
            out.append(b"I" + _U32.pack(len(raw)))
            out.append(raw)
    elif isinstance(v, float):
        out.append(b"d" + struct.pack("<d", v))
    elif isinstance(v, (bytes, bytearray)):
        out.append(b"b" + _U32.pack(len(v)))
        out.append(bytes(v))
    elif isinstance(v, str):
        raw = v.encode()
        out.append(b"s" + _U32.pack(len(raw)))
        out.append(raw)
    elif isinstance(v, list):
        out.append(b"l" + _U32.pack(len(v)))
        for item in v:
            _enc_value(out, item)
    elif isinstance(v, tuple):
        out.append(b"t" + _U32.pack(len(v)))
        for item in v:
            _enc_value(out, item)
    elif isinstance(v, dict):
        out.append(b"m" + _U32.pack(len(v)))
        for k, val in v.items():
            _enc_value(out, k)
            _enc_value(out, val)
    elif dataclasses.is_dataclass(v):
        name = type(v).__name__
        fields = _FIELDS.get(name)
        if fields is None:
            raise TypeError(f"unregistered message dataclass {name}")
        raw = name.encode()
        out.append(b"D" + _U32.pack(len(raw)))
        out.append(raw)
        out.append(_U32.pack(len(fields)))
        for f in fields:
            _enc_value(out, getattr(v, f))
    else:
        raise TypeError(f"unencodable value type {type(v).__name__}")


class _Dec:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0) -> None:
        self.data = data
        self.pos = pos

    def _u32(self) -> int:
        (n,) = _U32.unpack_from(self.data, self.pos)
        self.pos += 4
        return n

    def _take(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated message")
        self.pos += n
        return out

    def value(self) -> Any:
        tag = self.data[self.pos:self.pos + 1]
        self.pos += 1
        if tag == b"N":
            return None
        if tag == b"T":
            return True
        if tag == b"F":
            return False
        if tag == b"i":
            (v,) = struct.unpack_from("<q", self.data, self.pos)
            self.pos += 8
            return v
        if tag == b"u":
            (v,) = struct.unpack_from("<Q", self.data, self.pos)
            self.pos += 8
            return v
        if tag == b"I":
            return int.from_bytes(self._take(self._u32()), "little",
                                  signed=True)
        if tag == b"d":
            (v,) = struct.unpack_from("<d", self.data, self.pos)
            self.pos += 8
            return v
        if tag == b"b":
            return self._take(self._u32())
        if tag == b"s":
            return self._take(self._u32()).decode()
        if tag == b"l":
            return [self.value() for _ in range(self._u32())]
        if tag == b"t":
            return tuple(self.value() for _ in range(self._u32()))
        if tag == b"m":
            return {self.value(): self.value()
                    for _ in range(self._u32())}
        if tag == b"D":
            name = self._take(self._u32()).decode()
            cls = _REGISTRY.get(name)
            if cls is None:
                raise ValueError(f"unknown message dataclass {name!r}")
            nf = self._u32()
            fields = _FIELDS[name]
            if nf > len(fields):
                raise ValueError(
                    f"{name}: field count mismatch ({nf} != {len(fields)})")
            vals = [self.value() for _ in range(nf)]
            if nf < len(fields):
                # thrift-style added-field skew: a peer built before a
                # trailing field was added sends the shorter layout.
                # Tolerate iff every omitted field has a default (it
                # was ADDED with one); anything else fails loudly.
                for fobj in dataclasses.fields(cls)[nf:]:
                    if (fobj.default is dataclasses.MISSING and
                            fobj.default_factory is dataclasses.MISSING):
                        raise ValueError(
                            f"{name}: field count mismatch "
                            f"({nf} != {len(fields)})")
            return cls(**dict(zip(fields, vals)))
        raise ValueError(f"unknown value tag {tag!r} at {self.pos - 1}")


# ---- frame codec -------------------------------------------------------


def encode_message(src: str, dst: str, msg_type: str, payload: Any) -> bytes:
    fill_registry()
    out: list = []
    _enc_value(out, src)
    _enc_value(out, dst)
    _enc_value(out, msg_type)
    _enc_value(out, payload)
    body = b"".join(out)
    return _HDR.pack(MAGIC, len(body), crc32(body)) + body


def decode_message(frame_body: bytes) -> Tuple[str, str, str, Any]:
    """Decodes a body (header already consumed/validated by the reader).
    Returns (src, dst, msg_type, payload)."""
    fill_registry()
    d = _Dec(frame_body)
    src = d.value()
    dst = d.value()
    msg_type = d.value()
    payload = d.value()
    return src, dst, msg_type, payload


def read_frames(buf: bytearray) -> "list[bytes]":
    """Extract complete frame bodies from a receive buffer (in place)."""
    bodies = []
    while True:
        if len(buf) < _HDR.size:
            return bodies
        magic, blen, want = _HDR.unpack_from(buf, 0)
        if magic != MAGIC:
            raise ValueError(f"bad frame magic {magic!r}")
        if len(buf) < _HDR.size + blen:
            return bodies
        body = bytes(buf[_HDR.size:_HDR.size + blen])
        if crc32(body) != want:
            raise ValueError("frame crc mismatch")
        del buf[:_HDR.size + blen]
        bodies.append(body)
