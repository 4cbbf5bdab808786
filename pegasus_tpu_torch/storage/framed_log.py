"""Framed-log codec: [u32 len][u32 crc32(payload)][payload].

The storage WAL (storage/wal.py) frames its batches with it, as the JAX
package's WAL and mutation log do (parity: log_file replay,
src/replica/mutation_log_replay.cpp): replay stops at the first
incomplete or crc-mismatched frame, and boot truncates the file back to
the end of its valid prefix so later appends are never stranded behind
garbage.
"""

from __future__ import annotations

import struct
from typing import Iterator, Optional, Tuple

from pegasus_tpu_torch.base.crc import crc32

FRAME_HDR = struct.Struct("<II")


def pack_frame(payload: bytes) -> bytes:
    """One wire/log frame for `payload`."""
    return FRAME_HDR.pack(len(payload), crc32(payload)) + payload


def iter_frames(data: bytes, offset: int = 0
                ) -> Iterator[Tuple[bytes, int]]:
    """Yield (payload, end_offset) for each valid frame in `data`
    starting at byte `offset`; stops silently at a torn or corrupt
    tail (the recovery contract — everything before it is served,
    nothing after it is trusted)."""
    pos = offset
    n = len(data)
    size = FRAME_HDR.size
    while pos + size <= n:
        length, want = FRAME_HDR.unpack_from(data, pos)
        end = pos + size + length
        if end > n:
            return  # torn tail
        payload = data[pos + size:end]
        if crc32(payload) != want:
            return  # corrupt tail
        yield payload, end
        pos = end


def scan_valid_end(data: bytes) -> Optional[int]:
    """Byte offset just past the last valid frame, or None when the
    whole buffer is valid frames (nothing to repair)."""
    pos = 0
    for _payload, end in iter_frames(data):
        pos = end
    return pos if pos < len(data) else None
