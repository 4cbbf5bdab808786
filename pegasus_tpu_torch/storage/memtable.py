"""Memtable: sorted in-memory write buffer with tombstones.

Parity: RocksDB's memtable role in the reference stack. Point lookups are
O(1) dict hits; ordered iteration sorts lazily (writes are batched by the
replication layer, scans amortize the sort). Deletes are tombstones so they
shadow older SST data until compaction drops them.
"""

from __future__ import annotations

import bisect
from typing import Iterator, Optional, Tuple

TOMBSTONE = None


class Memtable:
    def __init__(self) -> None:
        # key -> (value_bytes | TOMBSTONE, expire_ts)
        self._data: dict[bytes, Tuple[Optional[bytes], int]] = {}
        self._sorted_keys: list[bytes] = []
        self._dirty = False
        self._bytes = 0

    def __len__(self) -> int:
        return len(self._data)

    @property
    def approximate_bytes(self) -> int:
        return self._bytes

    def put(self, key: bytes, value: bytes, expire_ts: int = 0) -> None:
        old = self._data.get(key)
        if old is None:
            self._dirty = True
            self._bytes += len(key)
        else:
            self._bytes -= len(old[0] or b"")
        self._data[key] = (value, expire_ts)
        self._bytes += len(value)

    def delete(self, key: bytes) -> None:
        old = self._data.get(key)
        if old is None:
            self._dirty = True
            self._bytes += len(key)
        else:
            self._bytes -= len(old[0] or b"")
        self._data[key] = (TOMBSTONE, 0)

    def get(self, key: bytes) -> Optional[Tuple[Optional[bytes], int]]:
        """Returns (value|TOMBSTONE, expire_ts) or None when absent."""
        return self._data.get(key)

    def _ensure_sorted(self) -> None:
        if self._dirty:
            self._sorted_keys = sorted(self._data.keys())
            self._dirty = False

    def iterate(self, start: bytes = b"", stop: Optional[bytes] = None,
                reverse: bool = False
                ) -> Iterator[Tuple[bytes, Optional[bytes], int]]:
        """Yield (key, value|TOMBSTONE, expire_ts) for start <= key < stop."""
        self._ensure_sorted()
        keys = self._sorted_keys
        lo = bisect.bisect_left(keys, start) if start else 0
        hi = bisect.bisect_left(keys, stop) if stop is not None else len(keys)
        rng = range(hi - 1, lo - 1, -1) if reverse else range(lo, hi)
        for i in rng:
            k = keys[i]
            v, ets = self._data[k]
            yield k, v, ets

    def items_sorted(self) -> Iterator[Tuple[bytes, Optional[bytes], int]]:
        return self.iterate()
