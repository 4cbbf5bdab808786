"""Write-ahead log: framed, crc-protected batch records.

Parity: the reference's per-replica private log (src/replica/mutation_log.h)
at the *storage* layer — each committed write batch is appended as one
frame carrying its decree, and replayed on boot from the last durable
decree. The replication layer will layer its own mutation log on top; this
WAL guards the memtable.

Frame format (little-endian): the shared framed-log codec
(storage/framed_log.py — [u32 payload_len][u32 crc32(payload)][payload]
with torn-tail recovery) around:
payload:
    [u64 decree][u32 record_count] record*
record:
    [u8 op][u32 key_len][key][u32 value_len][value][u32 expire_ts]
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

from pegasus_tpu_torch.storage.vfs import (
    fsync_file,
    open_data_file,
    repair_truncate,
)
from pegasus_tpu_torch.storage.framed_log import (
    iter_frames,
    pack_frame,
    scan_valid_end,
)

OP_PUT = 0
OP_DEL = 1

_PAYLOAD_HDR = struct.Struct("<QI")
_REC_HDR = struct.Struct("<BI")


@dataclass
class WalRecord:
    op: int
    key: bytes
    value: bytes
    expire_ts: int


class WriteAheadLog:
    def __init__(self, path: str) -> None:
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # Truncate any torn/corrupt tail before appending: frames written
        # after garbage would be unreachable by replay() forever (replay
        # stops at the first bad frame), losing acknowledged writes on the
        # second restart.
        valid_end = self._scan_valid_end(path)
        if valid_end is not None:
            repair_truncate(path, valid_end)
        self._f = open_data_file(path, "ab")

    @staticmethod
    def _scan_valid_end(path: str) -> Optional[int]:
        """Byte offset just past the last valid frame, or None if the file
        doesn't exist or is fully valid."""
        if not os.path.exists(path):
            return None
        with open_data_file(path, "rb") as f:
            data = f.read()
        return scan_valid_end(data)

    def append_batch(self, decree: int, records: List[WalRecord],
                     sync: bool = False, flush: bool = True) -> None:
        """`flush=False` leaves the frame in the IO buffer (the replica
        apply path under a group-commit window: the ack's durability
        rides the private log, which hardened first, and every decree
        this WAL could recover also replays from the plog — the frame
        reaches the OS when the buffer fills or truncate()/close()
        flush it; a torn tail is recovered like any other)."""
        parts = [_PAYLOAD_HDR.pack(decree, len(records))]
        for r in records:
            parts.append(_REC_HDR.pack(r.op, len(r.key)))
            parts.append(r.key)
            parts.append(struct.pack("<I", len(r.value)))
            parts.append(r.value)
            parts.append(struct.pack("<I", r.expire_ts))
        self._f.write(pack_frame(b"".join(parts)))
        if not flush:
            return
        self._f.flush()
        if sync:
            fsync_file(self._f)

    def close(self) -> None:
        self._f.close()

    def truncate(self) -> None:
        """Drop all frames (called after a flush makes them durable)."""
        self._f.close()
        self._f = open_data_file(self.path, "wb")
        self._f.close()
        self._f = open_data_file(self.path, "ab")

    @staticmethod
    def replay(path: str) -> Iterator[Tuple[int, List[WalRecord]]]:
        """Yield (decree, records) batches; stop at the first torn frame."""
        if not os.path.exists(path):
            return
        with open_data_file(path, "rb") as f:
            data = f.read()
        for payload, _end in iter_frames(data):
            decree, count = _PAYLOAD_HDR.unpack_from(payload, 0)
            off = _PAYLOAD_HDR.size
            records = []
            try:
                for _ in range(count):
                    op, klen = _REC_HDR.unpack_from(payload, off)
                    off += _REC_HDR.size
                    key = payload[off:off + klen]
                    off += klen
                    (vlen,) = struct.unpack_from("<I", payload, off)
                    off += 4
                    value = payload[off:off + vlen]
                    off += vlen
                    (ets,) = struct.unpack_from("<I", payload, off)
                    off += 4
                    records.append(WalRecord(op, key, value, ets))
            except struct.error:
                return  # malformed payload despite crc — treat as torn
            yield decree, records
