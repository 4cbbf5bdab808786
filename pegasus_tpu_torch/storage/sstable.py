"""Columnar SSTable in the raw (`none` codec) layout.

Each block stores

    keys        uint8[count, key_width]  (padded rows, width bucketed pow2)
    key_len     int32[count]
    expire_ts   uint32[count]            (decoded from the value header)
    hash_lo     uint32[count]            (low lane of crc64(pegasus_key_hash),
                                          precomputed at write time)
    flags       uint8[count]             (bit0 = tombstone)
    value_offs  uint32[count+1]
    value_heap  bytes                    (full pegasus-encoded values)

so a scan hands `keys/key_len/expire_ts/hash_lo` straight to the device
predicate (ops/record_block.block_from_columns) with no per-record host
decoding.

File layout:  magic | block* | index(JSON) | footer — byte-compatible with
the JAX package's files under `block_codec = none`. A file whose index
carries bloom or perfect-hash sidecars opens and serves; the sidecars are
ignored. A file whose index names a compressed codec is refused at open.
"""

from __future__ import annotations

import bisect
import json
import mmap
import os
import struct
from collections import OrderedDict
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple
from zlib import crc32 as _block_crc32

import numpy as np

from pegasus_tpu_torch.base.crc import crc32
from pegasus_tpu_torch.ops.predicates import host_alive_mask
from pegasus_tpu_torch.ops.record_block import hash_lo_column, next_bucket
from pegasus_tpu_torch.storage.block_codec import KNOWN_CODECS
from pegasus_tpu_torch.storage.vfs import fsync_dir, fsync_file, open_data_file
from pegasus_tpu_torch.utils.errors import StorageCorruptionError
from pegasus_tpu_torch.utils.flags import FLAGS, define_flag

define_flag("pegasus.storage", "block_crc", True,
            "write a crc32 per data block into new SST files and verify it "
            "on every block decode (cache misses only); files written "
            "without block CRCs keep serving unverified", mutable=True)

define_flag("pegasus.storage", "block_cache_bytes", 33_554_432,
            "per-table decoded-block cache budget in bytes (LRU)",
            mutable=True)

MAGIC = b"PGT2"
MAGIC_V1 = b"PGT1"  # pre-hash_lo format, still readable
FOOTER = struct.Struct("<QII4s")  # index_offset, index_size, index_crc, magic
_BLOCK_HDR = struct.Struct("<IIQ")  # count, key_width, value_heap_size

BLOCK_CAPACITY = 1024

FLAG_TOMBSTONE = 1


@dataclass
class BlockMeta:
    offset: int
    size: int
    count: int
    key_width: int
    first_key: bytes
    last_key: bytes
    crc: Optional[int] = None  # crc32 of the on-disk block bytes


class Block:
    """A decoded columnar block: numpy views over the mapped file."""

    __slots__ = ("keys", "key_len", "expire_ts", "hash_lo", "flags",
                 "value_offs", "value_heap", "_key_list", "_gets", "_nat",
                 "_cmp")

    def __init__(self, keys, key_len, expire_ts, hash_lo, flags, value_offs,
                 value_heap):
        self.keys = keys              # uint8[N, W]
        self.key_len = key_len        # int32[N]
        self.expire_ts = expire_ts    # uint32[N]
        self.hash_lo = hash_lo        # uint32[N] (None in PGT1 files)
        self.flags = flags            # uint8[N]
        self.value_offs = value_offs  # uint32[N+1]
        self.value_heap = value_heap  # uint8[heap]
        self._key_list = None
        self._gets = 0
        self._nat = None  # native pointer row (server/page.block_native_ptrs)
        self._cmp = None  # (now, alive mask) of alive_mask

    @property
    def count(self) -> int:
        return self.keys.shape[0]

    def key_at(self, i: int) -> bytes:
        return self.keys[i, :self.key_len[i]].tobytes()

    def alive_mask(self, now: int) -> np.ndarray:
        """bool[count] TTL-alive mask, cached per `now` second: every
        batch in the same second reuses it (TTL granularity is one
        second)."""
        cached = self._cmp
        if cached is not None and cached[0] == now:
            return cached[1]
        mask = host_alive_mask(self.expire_ts, now)
        self._cmp = (now, mask)
        return mask

    def key_list(self) -> list:
        """All keys as a sorted Python list, materialized at most once
        per cached block (for blocks that are read repeatedly)."""
        if self._key_list is None:
            keys, lens = self.keys, self.key_len
            self._key_list = [keys[i, :lens[i]].tobytes()
                              for i in range(keys.shape[0])]
        return self._key_list

    def lower_bound(self, key: bytes) -> int:
        """First row whose key >= `key`: O(log n) row probes, then a
        bisect over the materialized key list once the block proves hot
        (4 lookups)."""
        kl = self._key_list
        if kl is None:
            self._gets += 1
            if self._gets >= 4:
                kl = self.key_list()
        if kl is not None:
            return bisect.bisect_left(kl, key)
        lo, hi = 0, self.count
        while lo < hi:
            mid = (lo + hi) // 2
            if self.key_at(mid) < key:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def value_at(self, i: int) -> bytes:
        return self.value_heap[
            self.value_offs[i]:self.value_offs[i + 1]].tobytes()

    def is_tombstone(self, i: int) -> bool:
        return bool(self.flags[i] & FLAG_TOMBSTONE)


class SSTableWriter:
    """Writes a sorted record stream into a columnar SST."""

    def __init__(self, path: str, block_capacity: int = BLOCK_CAPACITY,
                 meta: Optional[dict] = None) -> None:
        self.path = path
        self._block_capacity = block_capacity
        self._meta = dict(meta or {})
        self._f = open_data_file(path + ".tmp", "wb")
        self._blocks: List[BlockMeta] = []
        self._pending: List[Tuple[bytes, bytes, int, int]] = []
        self._last_key: Optional[bytes] = None
        self._count = 0
        self._block_crc = bool(FLAGS.get("pegasus.storage", "block_crc"))
        self._f.write(MAGIC)

    def add(self, key: bytes, value: bytes, expire_ts: int = 0,
            tombstone: bool = False) -> None:
        if self._last_key is not None and key <= self._last_key:
            raise ValueError("keys must be added in strictly increasing order")
        self._last_key = key
        self._pending.append((key, value, expire_ts,
                              FLAG_TOMBSTONE if tombstone else 0))
        self._count += 1
        if len(self._pending) >= self._block_capacity:
            self._flush_block()

    def _flush_block(self) -> None:
        if not self._pending:
            return
        recs = self._pending
        self._pending = []
        n = len(recs)
        width = next_bucket(max(len(k) for k, *_ in recs))
        keys = np.zeros((n, width), dtype=np.uint8)
        key_len = np.zeros(n, dtype=np.int32)
        ets = np.zeros(n, dtype=np.uint32)
        flags = np.zeros(n, dtype=np.uint8)
        offs = np.zeros(n + 1, dtype=np.uint32)
        heap_parts = []
        pos = 0
        for i, (k, v, e, fl) in enumerate(recs):
            keys[i, :len(k)] = np.frombuffer(k, dtype=np.uint8)
            key_len[i] = len(k)
            ets[i] = e
            flags[i] = fl
            offs[i] = pos
            heap_parts.append(v)
            pos += len(v)
        offs[n] = pos
        heap = b"".join(heap_parts)
        buf = b"".join((
            _BLOCK_HDR.pack(n, width, len(heap)), keys.tobytes(),
            key_len.tobytes(), ets.tobytes(),
            hash_lo_column(keys, key_len).tobytes(), flags.tobytes(),
            offs.tobytes(), heap))
        offset = self._f.tell()
        self._f.write(buf)
        self._blocks.append(BlockMeta(
            offset=offset, size=len(buf), count=n, key_width=width,
            first_key=recs[0][0], last_key=recs[-1][0],
            crc=_block_crc32(buf) if self._block_crc else None))

    def finish(self) -> None:
        self._flush_block()
        index = {
            "blocks": [
                {"off": b.offset, "size": b.size, "count": b.count,
                 "kw": b.key_width, "first": b.first_key.hex(),
                 "last": b.last_key.hex(),
                 **({"crc": b.crc} if b.crc is not None else {})}
                for b in self._blocks
            ],
            "meta": self._meta,
            "total_count": self._count,
        }
        blob = json.dumps(index).encode()
        index_offset = self._f.tell()
        self._f.write(blob)
        self._f.write(FOOTER.pack(index_offset, len(blob), crc32(blob), MAGIC))
        self._f.flush()
        fsync_file(self._f)
        self._f.close()
        os.replace(self.path + ".tmp", self.path)
        # the rename must be durable before the caller truncates the WAL
        fsync_dir(os.path.dirname(self.path))

    def abandon(self) -> None:
        self._f.close()
        try:
            os.remove(self.path + ".tmp")
        except OSError:
            pass


class SSTable:
    """Reader with an in-memory index and a byte-capped block cache."""

    def __init__(self, path: str,
                 cache_bytes: Optional[int] = None) -> None:
        self.path = path
        self._f = open_data_file(path, "rb")
        self._f.seek(0, os.SEEK_END)
        file_size = self._f.tell()
        if file_size < len(MAGIC) + FOOTER.size:
            raise StorageCorruptionError(path, "not an sstable (too small)")
        # blocks decode as zero-copy views over the map; Linux keeps the
        # mapping alive past close()/unlink until the last view dies
        self._mv = memoryview(mmap.mmap(self._f.fileno(), 0,
                                        access=mmap.ACCESS_READ))
        index_offset, index_size, index_crc, magic = FOOTER.unpack(
            self._mv[file_size - FOOTER.size:])
        if magic not in (MAGIC, MAGIC_V1):
            raise StorageCorruptionError(path, "bad footer magic")
        self._has_hash_lo = magic == MAGIC
        blob = bytes(self._mv[index_offset:index_offset + index_size])
        if crc32(blob) != index_crc:
            raise StorageCorruptionError(path, "index crc mismatch")
        try:
            index = json.loads(blob)
        except ValueError as e:
            raise StorageCorruptionError(path, f"index unparsable: {e}")
        codec = index.get("codec")
        if codec is not None:
            known = "known to pegasus_tpu" if codec in KNOWN_CODECS \
                else "unknown"
            raise StorageCorruptionError(
                path, f"block codec {codec!r} ({known}) is not supported "
                      f"by this reader: only the raw 'none' layout is")
        self.blocks: List[BlockMeta] = [
            BlockMeta(offset=e["off"], size=e["size"], count=e["count"],
                      key_width=e["kw"], first_key=bytes.fromhex(e["first"]),
                      last_key=bytes.fromhex(e["last"]), crc=e.get("crc"))
            for e in index["blocks"]
        ]
        self.meta: dict = index.get("meta", {})
        self.total_count: int = index.get("total_count", 0)
        self._cache: "OrderedDict[int, Tuple[Block, int]]" = OrderedDict()
        self._cache_bytes = 0
        self._cache_budget = cache_bytes  # None -> flag at use
        self._last_keys = [b.last_key for b in self.blocks]
        self.first_key: Optional[bytes] = (
            self.blocks[0].first_key if self.blocks else None)
        self.last_key: Optional[bytes] = (
            self.blocks[-1].last_key if self.blocks else None)

    def close(self) -> None:
        self._f.close()

    def read_block(self, idx: int) -> Block:
        hit = self._cache.get(idx)
        if hit is not None:
            self._cache.move_to_end(idx)
            return hit[0]
        bm = self.blocks[idx]
        raw = self._mv[bm.offset:bm.offset + bm.size]
        if bm.crc is not None and _block_crc32(raw) != bm.crc:
            raise StorageCorruptionError(
                self.path, f"block {idx} crc mismatch (offset {bm.offset}, "
                           f"{bm.size} bytes)")
        n, width, heap_size = _BLOCK_HDR.unpack_from(raw, 0)
        pos = _BLOCK_HDR.size

        def column(dtype, count):
            nonlocal pos
            arr = np.frombuffer(raw, dtype=dtype, count=count, offset=pos)
            pos += arr.nbytes
            return arr

        keys = column(np.uint8, n * width).reshape(n, width)
        key_len = column(np.int32, n)
        ets = column(np.uint32, n)
        hash_lo = column(np.uint32, n) if self._has_hash_lo else None
        flags = column(np.uint8, n)
        offs = column(np.uint32, n + 1)
        heap = column(np.uint8, heap_size)
        blk = Block(keys, key_len, ets, hash_lo, flags, offs, heap)
        # charge the resident footprint a hot block grows (its key list)
        nbytes = 512 + n * (width + 64)
        budget = (self._cache_budget if self._cache_budget is not None
                  else int(FLAGS.get("pegasus.storage", "block_cache_bytes")))
        self._cache[idx] = (blk, nbytes)
        self._cache_bytes += nbytes
        while self._cache_bytes > budget and len(self._cache) > 1:
            _k, (_b, nb) = self._cache.popitem(last=False)
            self._cache_bytes -= nb
        return blk

    def get(self, key: bytes) -> Optional[Tuple[Optional[bytes], int]]:
        """Returns (value|None-for-tombstone, expire_ts), or None if absent."""
        idx = self._block_for_key(key)
        if idx is None:
            return None
        blk = self.read_block(idx)
        lo = blk.lower_bound(key)
        if lo == blk.count or blk.key_at(lo) != key:
            return None
        if blk.is_tombstone(lo):
            return (None, 0)
        return (blk.value_at(lo), int(blk.expire_ts[lo]))

    def _block_for_key(self, key: bytes) -> Optional[int]:
        lo = bisect.bisect_left(self._last_keys, key)
        if lo == len(self.blocks):
            return None
        return lo if self.blocks[lo].first_key <= key else None

    def iterate(self, start: bytes = b"", stop: Optional[bytes] = None,
                reverse: bool = False
                ) -> Iterator[Tuple[bytes, Optional[bytes], int]]:
        """Yield (key, value|None-for-tombstone, expire_ts) in range."""
        block_range = (range(len(self.blocks) - 1, -1, -1) if reverse
                       else range(len(self.blocks)))
        for bi in block_range:
            bm = self.blocks[bi]
            if stop is not None and bm.first_key >= stop:
                if reverse:
                    continue
                break
            if start and bm.last_key < start:
                if reverse:
                    break
                continue
            blk = self.read_block(bi)
            idxs = range(blk.count - 1, -1, -1) if reverse else range(blk.count)
            for i in idxs:
                k = blk.key_at(i)
                if start and k < start:
                    continue
                if stop is not None and k >= stop:
                    continue
                v = None if blk.is_tombstone(i) else blk.value_at(i)
                yield k, v, int(blk.expire_ts[i])

    def iter_blocks(self, start: bytes = b"", stop: Optional[bytes] = None
                    ) -> Iterator[Tuple[BlockMeta, Block]]:
        """Yield whole blocks intersecting [start, stop) — the columnar
        scan path feeds their columns to the device predicate."""
        bi = bisect.bisect_left(self._last_keys, start) if start else 0
        for bi in range(bi, len(self.blocks)):
            bm = self.blocks[bi]
            if stop is not None and bm.first_key >= stop:
                break
            yield bm, self.read_block(bi)

