"""RESP2 wire protocol: parse client commands, serialize replies.

Parity: the reference's redis parser (src/redis_protocol/proxy_lib/
redis_parser.cpp) — inline and multibulk request forms in, the five
RESP2 reply types out. Incremental: feed() consumes bytes and yields
complete command argv lists.
"""

from __future__ import annotations

from typing import List, Optional

CRLF = b"\r\n"


class RespParser:
    """Incremental request parser (multibulk *N\\r\\n$len\\r\\n... and
    inline commands)."""

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[List[bytes]]:
        self._buf.extend(data)
        out = []
        while True:
            cmd = self._try_parse()
            if cmd is None:
                return out
            if cmd:
                out.append(cmd)

    def _try_parse(self) -> Optional[List[bytes]]:
        buf = self._buf
        if not buf:
            return None
        if buf[0:1] != b"*":
            # inline command: a plain line of words
            nl = buf.find(b"\r\n")
            if nl < 0:
                return None
            line = bytes(buf[:nl])
            del buf[:nl + 2]
            return line.split()
        # multibulk
        nl = buf.find(b"\r\n")
        if nl < 0:
            return None
        try:
            n = int(buf[1:nl])
        except ValueError:
            raise ValueError(f"bad multibulk header {bytes(buf[:nl])!r}")
        pos = nl + 2
        args = []
        for _ in range(n):
            if len(buf) < pos + 1 or buf[pos:pos + 1] != b"$":
                return None if len(buf) <= pos else self._bad(pos)
            nl2 = buf.find(b"\r\n", pos)
            if nl2 < 0:
                return None
            size = int(buf[pos + 1:nl2])
            if size < 0:
                # a negative bulk length in a REQUEST is a protocol error
                # (accepting it would desynchronize the buffer)
                raise ValueError(f"negative bulk length {size}")
            start = nl2 + 2
            if len(buf) < start + size + 2:
                return None
            args.append(bytes(buf[start:start + size]))
            pos = start + size + 2
        del buf[:pos]
        return args

    def _bad(self, pos: int):
        raise ValueError(f"bad bulk header at {pos}: "
                         f"{bytes(self._buf[pos:pos + 8])!r}")


# ---- reply serializers --------------------------------------------------


def simple(s: str) -> bytes:
    return b"+" + s.encode() + CRLF


def error(msg: str) -> bytes:
    return b"-ERR " + msg.encode() + CRLF


def integer(n: int) -> bytes:
    return b":" + str(n).encode() + CRLF


def bulk(data: Optional[bytes]) -> bytes:
    if data is None:
        return b"$-1" + CRLF  # nil
    return b"$" + str(len(data)).encode() + CRLF + data + CRLF


def array(items) -> bytes:
    if items is None:
        return b"*-1" + CRLF
    out = [b"*" + str(len(items)).encode() + CRLF]
    for item in items:
        if isinstance(item, bytes) or item is None:
            out.append(bulk(item))
        elif isinstance(item, int):
            out.append(integer(item))
        elif isinstance(item, (list, tuple)):
            out.append(array(item))
        else:
            out.append(bulk(str(item).encode()))
    return b"".join(out)
