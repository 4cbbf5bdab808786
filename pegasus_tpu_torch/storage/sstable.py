"""Columnar SSTable: sorted runs on disk, in the JAX package's format.

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
decoding. Under the `dcz`/`dcz2` codecs (`[pegasus.storage]
block_codec`, default dcz2) a block is stored encoded
(storage/block_codec.py) and decodes to exactly these columns.

File layout:  magic | block* | [bloom] | [phash] | index(JSON) | footer —
byte-compatible with the JAX package's files: the index names the codec
(absent for `none`), the bloom filter (storage/bloom.py) and the
perfect-hash index (storage/phash.py), both built at finish from one
full-key crc64 column per block. Files open through storage/vfs.py:
inside an at-rest encryption zone (storage/efile.py) they are written
and read encrypted, and each package reads the other's encrypted files.
Plaintext files are mapped; encrypted ones are read block by block.
"""

from __future__ import annotations

import bisect
import json
import io
import mmap
import os
import struct
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple
from zlib import crc32 as _block_crc32

import numpy as np

from pegasus_tpu_torch.base.crc import crc32, crc64, crc64_rows
from pegasus_tpu_torch.ops.predicates import host_alive_mask
from pegasus_tpu_torch.ops.record_block import hash_lo_column, next_bucket
from pegasus_tpu_torch.storage.block_codec import (
    CODEC_DCZ2,
    CODEC_NONE,
    KNOWN_CODECS,
    EncodedBlock,
    block_version,
    codec_accepts,
    encode_block,
    raw_block_size,
)
from pegasus_tpu_torch.storage.bloom import (
    BloomFilter,
    bloom_build_bits,
    bloom_probe_enabled,
)
from pegasus_tpu_torch.storage.phash import (
    KNOWN_PHASH_VERSIONS,
    PHASH_BUILD_FAIL,
    PHASH_HIT,
    PHASH_USEFUL,
    PHashIndex,
    phash_build_enabled,
    phash_probe_enabled,
)
from pegasus_tpu_torch.storage.vfs import fsync_dir, fsync_file, open_data_file
from pegasus_tpu_torch.utils.errors import StorageCorruptionError
from pegasus_tpu_torch.utils.flags import FLAGS, define_flag
from pegasus_tpu_torch.utils.metrics import METRICS
from pegasus_tpu_torch.utils.perf_context import current as _perf_current
from pegasus_tpu_torch.utils.tracing import annotate as _trace_annotate

define_flag("pegasus.storage", "block_crc", True,
            "write a crc32 per data block into new SST files and verify it "
            "on every block decode (cache misses only); files written "
            "without block CRCs keep serving unverified", mutable=True)

define_flag("pegasus.storage", "block_codec", "dcz2",
            "per-block codec stamped into new SST files at every writer "
            "finish site: 'dcz2' = dictionary-coded hashkeys + packed "
            "sortkeys + compressed value heap + FOR expire_ts + "
            "dict-indexed hash_lo; 'dcz' = the same with raw uint32 "
            "predicate columns; 'none' = the raw columnar layout",
            mutable=True)

define_flag("pegasus.storage", "block_cache_bytes", 33_554_432,
            "per-table decoded-block cache budget in bytes (LRU)",
            mutable=True)


def block_codec() -> str:
    codec = str(FLAGS.get("pegasus.storage", "block_codec"))
    if codec != CODEC_NONE and codec not in KNOWN_CODECS:
        raise ValueError(f"unknown block_codec {codec!r}")
    return codec


# node-wide storage observability (the rocksdb block-cache and filter
# tickers the reference exports per server): relaxed counters, ticked once
# per block read or filter probe
_STORAGE_METRICS = METRICS.entity("storage", "node")
_BLOCK_CACHE_HIT = _STORAGE_METRICS.relaxed_counter("block_cache_hit")
_BLOCK_CACHE_MISS = _STORAGE_METRICS.relaxed_counter("block_cache_miss")
_BLOOM_USEFUL = _STORAGE_METRICS.relaxed_counter("bloom_useful_count")
_COMPRESSED_DECODE = _STORAGE_METRICS.relaxed_counter(
    "compressed_block_decode_count")
_BLOCK_EVICT_BYTES = _STORAGE_METRICS.relaxed_counter(
    "block_cache_evict_bytes")

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
    """A decoded columnar block: numpy views over the mapped file, or,
    for a block decoded from a compressed file, real arrays whose value
    heap may be a zero-arg thunk that inflates on first value access (so
    key-only work never pays the heap decode)."""

    __slots__ = ("keys", "key_len", "expire_ts", "hash_lo", "flags",
                 "value_offs", "_vh", "_key_list", "_gets", "_nat", "_cmp",
                 "_probe")

    def __init__(self, keys, key_len, expire_ts, hash_lo, flags, value_offs,
                 value_heap):
        self.keys = keys              # uint8[N, W]
        self.key_len = key_len        # int32[N]
        self.expire_ts = expire_ts    # uint32[N]
        self.hash_lo = hash_lo        # uint32[N] (None in PGT1 files)
        self.flags = flags            # uint8[N]
        self.value_offs = value_offs  # uint32[N+1]
        self._vh = value_heap         # uint8[heap] view, or lazy thunk
        self._key_list = None
        self._gets = 0
        self._nat = None    # native pointer row (server/page.block_native_ptrs)
        self._cmp = None    # (now, alive mask) of alive_mask
        self._probe = None  # point-probe table (server/page.probe_nat)

    @property
    def value_heap(self):
        vh = self._vh
        if callable(vh):
            vh = self._vh = vh()
        return vh

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
    """Writes a sorted record stream into a columnar SST.

    The codec, the block-CRC switch and both sidecar switches are latched
    at construction, so a flag flip mid-write cannot tear one table.
    `async_io=True` moves file writes onto a background thread (bounded
    queue, one FIFO, so the order is kept); finish() joins it before
    writing the index, so data still precedes index and rename."""

    def __init__(self, path: str, block_capacity: int = BLOCK_CAPACITY,
                 meta: Optional[dict] = None,
                 async_io: bool = False) -> None:
        self.path = path
        self._block_capacity = block_capacity
        self._meta = dict(meta or {})
        self._f = open_data_file(path + ".tmp", "wb")
        self._blocks: List[BlockMeta] = []
        self._pending: List[Tuple[bytes, bytes, int, int]] = []
        self._last_key: Optional[bytes] = None
        self._count = 0
        self._offset = 0  # logical file position (writes may be queued)
        self._io_q = None
        self._io_thread = None
        self._io_err: List[BaseException] = []
        # the bloom filter and the perfect-hash index both consume one
        # full-key crc64 column per block, accumulated by _sidecar_note
        self._bloom_bits_per_key = bloom_build_bits()
        self.bloom_enabled = self._bloom_bits_per_key > 0
        self.phash_enabled = phash_build_enabled()
        self.sidecar_hashes = self.bloom_enabled or self.phash_enabled
        self._block_crc = bool(FLAGS.get("pegasus.storage", "block_crc"))
        self.codec = block_codec()
        # the block format version this writer emits; the file may still
        # carry older versions its codec accepts
        self.codec_version = 2 if self.codec == CODEC_DCZ2 else 1
        self._codec_raw_bytes = 0     # logical (raw-format) bytes
        self._codec_stored_bytes = 0  # bytes actually written
        self._key_hashes: List[np.ndarray] = []
        if async_io:
            import queue

            self._io_q = queue.Queue(maxsize=8)
            self._io_thread = threading.Thread(
                target=self._io_loop, name="sst-io", daemon=True)
            self._io_thread.start()
        self._write(MAGIC)

    def _io_loop(self) -> None:
        while True:
            buf = self._io_q.get()
            if buf is None:
                return
            try:
                if not self._io_err:
                    self._f.write(buf)
            except BaseException as e:  # noqa: BLE001 - surfaced at join
                self._io_err.append(e)

    def _write(self, buf) -> None:
        self._offset += len(buf)
        if self._io_q is not None:
            self._io_q.put(buf)
        else:
            self._f.write(buf)

    def _join_io(self) -> None:
        if self._io_thread is not None:
            self._io_q.put(None)
            self._io_thread.join()
            self._io_thread = None
            if self._io_err:
                raise self._io_err[0]

    def _sidecar_note(self, keys: np.ndarray, key_len: np.ndarray,
                      hashes: Optional[np.ndarray] = None) -> None:
        """Record one block's full-key crc64 column for the sidecars
        built at finish(). The per-block arrays stay segmented: their
        boundaries are the (block, slot) numbering the phash maps to."""
        if not self.sidecar_hashes:
            return
        self._key_hashes.append(hashes if hashes is not None
                                else crc64_rows(keys, key_len))

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

    def _encode(self, n, width, keys, key_len, ets, hash_lo, flags, offs,
                heap) -> bytes:
        """One block's on-disk bytes under this writer's codec."""
        if self.codec == CODEC_NONE:
            return b"".join((
                _BLOCK_HDR.pack(n, width, len(heap)),
                np.ascontiguousarray(keys, dtype=np.uint8).tobytes(),
                np.ascontiguousarray(key_len, dtype=np.int32).tobytes(),
                np.ascontiguousarray(ets, dtype=np.uint32).tobytes(),
                np.ascontiguousarray(hash_lo, dtype=np.uint32).tobytes(),
                np.ascontiguousarray(flags, dtype=np.uint8).tobytes(),
                np.ascontiguousarray(offs, dtype=np.uint32).tobytes(),
                heap))
        buf = encode_block(keys, key_len, ets, hash_lo, flags, offs, heap,
                           version=self.codec_version)
        self._codec_raw_bytes += raw_block_size(n, width, len(heap))
        self._codec_stored_bytes += len(buf)
        return buf

    def _append(self, buf, n, width, first_key, last_key) -> None:
        offset = self._offset
        self._write(buf)
        self._blocks.append(BlockMeta(
            offset=offset, size=len(buf), count=n, key_width=width,
            first_key=first_key, last_key=last_key,
            crc=_block_crc32(buf) if self._block_crc else None))

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
        self._sidecar_note(keys, key_len)
        buf = self._encode(n, width, keys, key_len, ets,
                           hash_lo_column(keys, key_len), flags, offs, heap)
        self._append(buf, n, width, recs[0][0], recs[-1][0])

    def add_block_columnar(self, keys: np.ndarray, key_len: np.ndarray,
                           ets: np.ndarray, hash_lo: np.ndarray,
                           flags: np.ndarray, value_offs: np.ndarray,
                           heap) -> None:
        """Append a block from already-columnar arrays, carrying hash_lo
        over from the source block."""
        n = int(keys.shape[0])
        if n == 0:
            return
        self._flush_block()
        first_key = bytes(keys[0, :int(key_len[0])])
        last_key = bytes(keys[-1, :int(key_len[-1])])
        if self._last_key is not None and first_key <= self._last_key:
            raise ValueError("blocks must be added in key order")
        if isinstance(heap, np.ndarray):
            heap = np.ascontiguousarray(heap, dtype=np.uint8).tobytes()
        width = int(keys.shape[1])
        self._sidecar_note(keys, key_len)
        buf = self._encode(n, width, keys, key_len, ets, hash_lo, flags,
                           value_offs, heap)
        self._append(buf, n, width, first_key, last_key)
        self._count += n
        self._last_key = last_key

    def add_block_encoded(self, enc: EncodedBlock) -> None:
        """Append an already-encoded block verbatim (no heap inflate, no
        re-encode). A block whose version this writer's codec cannot hold
        (a v2 block into a 'dcz' file) is transcoded down through the
        columnar path instead."""
        if self.codec == CODEC_NONE:
            raise ValueError("writer codec is 'none'; encoded blocks "
                             "must decode first")
        n = enc.n
        if n == 0:
            return
        if not codec_accepts(self.codec, enc.version):
            blk = enc.decode()
            self.add_block_columnar(blk.keys, blk.key_len, blk.expire_ts,
                                    blk.hash_lo, blk.flags,
                                    blk.value_offs, blk.value_heap)
            return
        self._flush_block()
        first_key = enc.key_at(0)
        last_key = enc.key_at(n - 1)
        if self._last_key is not None and first_key <= self._last_key:
            raise ValueError("blocks must be added in key order")
        buf = enc.raw if isinstance(enc.raw, bytes) else bytes(enc.raw)
        hashes = (crc64_rows(enc.key_matrix(), enc.key_len)
                  if self.sidecar_hashes else None)
        self.add_block_encoded_raw(buf, n, enc.key_width, enc.raw_heap_len,
                                   first_key, last_key, hashes)

    def add_block_encoded_raw(self, buf: bytes, n: int, key_width: int,
                              raw_heap_len: int, first_key: bytes,
                              last_key: bytes, key_hashes) -> None:
        """Append pre-encoded block bytes with the index metadata already
        in hand (the encoded subset's exit)."""
        if self.codec == CODEC_NONE:
            raise ValueError("writer codec is 'none'; encoded blocks "
                             "must decode first")
        if n == 0:
            return
        if not codec_accepts(self.codec, block_version(buf)):
            raise ValueError(
                f"block format v{block_version(buf)} cannot be stored "
                f"in a {self.codec!r} file")
        self._flush_block()
        if self._last_key is not None and first_key <= self._last_key:
            raise ValueError("blocks must be added in key order")
        if self.sidecar_hashes:
            if key_hashes is None:
                raise ValueError("sidecar build needs key hashes")
            self._sidecar_note(None, None, hashes=key_hashes)
        self._append(buf, n, key_width, first_key, last_key)
        self._codec_raw_bytes += raw_block_size(n, key_width, raw_heap_len)
        self._codec_stored_bytes += len(buf)
        self._count += n
        self._last_key = last_key

    def finish(self) -> None:
        self._flush_block()
        self._join_io()
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
        if self.codec != CODEC_NONE:
            # the codec is named once per file; 'none' files carry no key
            index["codec"] = self.codec
            index["codec_stats"] = {
                "raw_bytes": self._codec_raw_bytes,
                "stored_bytes": self._codec_stored_bytes,
            }
        self._build_sidecars(index)
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

    def _build_sidecars(self, index: dict) -> None:
        """Build and persist the bloom filter and the perfect-hash index
        from the accumulated per-block hash columns; the index names
        their offsets and geometry. A failed phash build leaves the run
        without one (it serves through bloom and bisect)."""
        if not self._key_hashes:
            return
        if self.bloom_enabled:
            bf = BloomFilter.build(np.concatenate(self._key_hashes),
                                   self._bloom_bits_per_key)
            bloom_off = self._f.tell()
            blob = bf.to_bytes()
            self._f.write(blob)
            index["bloom"] = {"off": bloom_off, "size": len(blob),
                              "m": bf.m, "k": bf.k}
        if self.phash_enabled:
            ph = PHashIndex.build(
                np.concatenate(self._key_hashes)
                if len(self._key_hashes) > 1 else self._key_hashes[0],
                [b.count for b in self._blocks])
            if ph is None:
                PHASH_BUILD_FAIL.increment()
            else:
                # a 4-byte aligned blob start: the native probe reads the
                # mapped slots as u32
                pad = (-self._f.tell()) % 4
                if pad:
                    self._f.write(b"\x00" * pad)
                ph_off = self._f.tell()
                blob = ph.to_bytes()
                self._f.write(blob)
                index["phash"] = {"off": ph_off, "size": len(blob),
                                  **ph.meta()}

    def abandon(self) -> None:
        try:
            self._join_io()
        except Exception:  # noqa: BLE001 - the write failed; abandoning
            pass
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
        # plaintext files are mapped: blocks decode as zero-copy views
        # over the map, and Linux keeps the mapping alive past
        # close()/unlink until the last view dies. Encrypted files (an
        # efile CipherFile) and fault-wrapped ones are read at offsets.
        self._mv: Optional[memoryview] = None
        self._read_lock = threading.Lock()
        if isinstance(self._f, io.BufferedReader):
            try:
                self._mv = memoryview(mmap.mmap(
                    self._f.fileno(), 0, access=mmap.ACCESS_READ))
            except (ValueError, OSError):
                self._mv = None  # empty file or a no-mmap file system
        self._f.seek(0, os.SEEK_END)
        file_size = self._f.tell()
        if file_size < len(MAGIC) + FOOTER.size:
            raise StorageCorruptionError(path, "not an sstable (too small)")
        index_offset, index_size, index_crc, magic = FOOTER.unpack(
            self._read_at(file_size - FOOTER.size, FOOTER.size))
        if magic not in (MAGIC, MAGIC_V1):
            raise StorageCorruptionError(path, "bad footer magic")
        self._has_hash_lo = magic == MAGIC
        blob = bytes(self._read_at(index_offset, index_size))
        if crc32(blob) != index_crc:
            raise StorageCorruptionError(path, "index crc mismatch")
        try:
            index = json.loads(blob)
        except ValueError as e:
            raise StorageCorruptionError(path, f"index unparsable: {e}")
        self.blocks: List[BlockMeta] = [
            BlockMeta(offset=e["off"], size=e["size"], count=e["count"],
                      key_width=e["kw"], first_key=bytes.fromhex(e["first"]),
                      last_key=bytes.fromhex(e["last"]), crc=e.get("crc"))
            for e in index["blocks"]
        ]
        self.meta: dict = index.get("meta", {})
        self.total_count: int = index.get("total_count", 0)
        # legacy files carry no codec key; an unknown codec is refused
        codec = index.get("codec")
        if codec is not None and codec not in KNOWN_CODECS:
            raise StorageCorruptionError(
                path, f"unsupported block codec {codec!r} "
                      f"(known: {', '.join(KNOWN_CODECS)})")
        self.codec: Optional[str] = codec
        self.codec_stats: Optional[dict] = index.get("codec_stats")
        # a file without a filter degrades to the unfiltered path
        self.bloom: Optional[BloomFilter] = None
        bl = index.get("bloom")
        if bl:
            self.bloom = BloomFilter.from_bytes(
                self._read_at(bl["off"], bl["size"]), bl["m"], bl["k"])
        # perfect-hash (block, slot) index: an unknown version is refused
        # at open, a torn blob degrades to bloom + bisect
        self.phash: Optional[PHashIndex] = None
        ph = index.get("phash")
        if ph:
            if ph.get("version") not in KNOWN_PHASH_VERSIONS:
                raise StorageCorruptionError(
                    path, f"unsupported phash index version "
                          f"{ph.get('version')!r} (known: "
                          f"{', '.join(map(str, KNOWN_PHASH_VERSIONS))})")
            self.phash = PHashIndex.from_bytes(
                self._read_at(ph["off"], ph["size"]), ph)
        # idx -> (Block, charged bytes); insert/evict accounting under a
        # lock (serving and the mask prefresher share run caches)
        self._cache: "OrderedDict[int, Tuple[Block, int]]" = OrderedDict()
        self._cache_bytes = 0
        self._cache_lock = threading.Lock()
        self._cache_budget = cache_bytes  # None -> flag at use
        self._off2idx: Optional[dict] = None
        self._last_keys = [b.last_key for b in self.blocks]
        self.first_key: Optional[bytes] = (
            self.blocks[0].first_key if self.blocks else None)
        self.last_key: Optional[bytes] = (
            self.blocks[-1].last_key if self.blocks else None)

    def _read_at(self, offset: int, size: int):
        """`size` bytes at logical `offset`: a view over the map, or a
        read of the (decrypting) file under a lock, since the serving
        thread and the mask prefresher share the handle."""
        if self._mv is not None:
            return self._mv[offset:offset + size]
        with self._read_lock:
            self._f.seek(offset)
            return self._f.read(size)

    def close(self) -> None:
        self._f.close()

    def clear_block_cache(self) -> None:
        """Drop every decoded block and its byte accounting."""
        with self._cache_lock:
            self._cache.clear()
            self._cache_bytes = 0

    def may_contain(self, key: bytes, key_hash: Optional[int] = None
                    ) -> bool:
        """False means definitively absent (bloom-filtered); tables
        without a filter, or with probing switched off, answer True."""
        bf = self.bloom
        if bf is None or not bloom_probe_enabled():
            return True
        hit = (bf.may_contain_hash(key_hash) if key_hash is not None
               else bf.may_contain(key))
        if not hit:
            _BLOOM_USEFUL.increment()
            pc = _perf_current()
            if pc is not None:
                pc.bloom_pruned += 1
        return hit

    def _read_raw_block(self, idx: int):
        """(raw bytes of block `idx`, its BlockMeta), crc-verified."""
        bm = self.blocks[idx]
        raw = self._read_at(bm.offset, bm.size)
        if bm.crc is not None and _block_crc32(raw) != bm.crc:
            raise StorageCorruptionError(
                self.path, f"block {idx} crc mismatch (offset {bm.offset}, "
                           f"{bm.size} bytes)")
        return raw, bm

    def read_block_encoded(self, idx: int) -> Optional[EncodedBlock]:
        """The encoded form of block `idx` (predicate columns parsed, key
        matrix and value heap untouched), the direct-compute entry point
        of the encoded scan probe. None for uncompressed files; no
        cache."""
        if self.codec is None:
            return None
        raw, _bm = self._read_raw_block(idx)
        return EncodedBlock.parse(raw)

    def block_index(self, bm: BlockMeta) -> int:
        """BlockMeta -> its position (block offsets are unique)."""
        o2i = self._off2idx
        if o2i is None:
            o2i = self._off2idx = {
                b.offset: i for i, b in enumerate(self.blocks)}
        return o2i[bm.offset]

    def read_block(self, idx: int) -> Block:
        pc = _perf_current()  # the op's PerfContext (None = untracked)
        hit = self._cache.get(idx)
        if hit is not None:
            try:
                self._cache.move_to_end(idx)
            except KeyError:
                pass  # raced a concurrent eviction; the block stays valid
            _BLOCK_CACHE_HIT.increment()
            if pc is not None:
                pc.block_cache_hit += 1
            return hit[0]
        _BLOCK_CACHE_MISS.increment()
        if pc is not None:
            pc.blocks_decoded += 1
            pc.bytes_read += self.blocks[idx].size
        raw, bm = self._read_raw_block(idx)
        if self.codec is not None:
            enc = EncodedBlock.parse(raw)
            blk = enc.decode()
            _COMPRESSED_DECODE.increment()
            _trace_annotate("block_decode")
            # a decoded compressed block is real allocation
            nbytes = enc.mem_bytes()
        else:
            n, width, heap_size = _BLOCK_HDR.unpack_from(raw, 0)
            pos = _BLOCK_HDR.size

            def column(dtype, count):
                nonlocal pos
                arr = np.frombuffer(raw, dtype=dtype, count=count,
                                    offset=pos)
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
            # charge the resident footprint a hot block grows (its key
            # list and probe table), not the view bookkeeping; a block
            # read from an encrypted file also holds its decrypted bytes
            lazy = 512 + n * (width + 64)
            nbytes = lazy if self._mv is not None else bm.size + lazy
        if pc is not None:
            # materialized bytes after the codec: the decoded size of a
            # compressed block, the on-disk size of a raw one
            pc.bytes_decoded += (nbytes if self.codec is not None
                                 else bm.size)
        budget = (self._cache_budget if self._cache_budget is not None
                  else int(FLAGS.get("pegasus.storage", "block_cache_bytes")))
        evicted = 0
        with self._cache_lock:
            prev = self._cache.get(idx)
            if prev is not None:
                # two threads raced the same cold block: release the
                # first insert's charge
                self._cache_bytes -= prev[1]
            self._cache[idx] = (blk, nbytes)
            self._cache_bytes += nbytes
            while self._cache_bytes > budget and len(self._cache) > 1:
                _k, (_b, nb) = self._cache.popitem(last=False)
                self._cache_bytes -= nb
                evicted += nb
        if evicted:
            _BLOCK_EVICT_BYTES.increment(evicted)
        return blk

    def verify_block(self, idx: int) -> bool:
        """Scrub entry point: re-read block `idx`'s raw bytes and check
        them against the index CRC, with no decode and no block-cache
        insert (a scrub of a cold table must not evict the serving
        working set). False for a block written without a CRC; raises
        StorageCorruptionError on a mismatch."""
        bm = self.blocks[idx]
        if bm.crc is None:
            return False
        raw = self._read_at(bm.offset, bm.size)
        if len(raw) != bm.size or _block_crc32(raw) != bm.crc:
            raise StorageCorruptionError(
                self.path,
                f"scrub: block {idx} crc mismatch (offset {bm.offset}, "
                f"{bm.size} bytes)")
        return True

    def verify_index_consistency(self) -> None:
        """Scrub's structural pass: block fences ordered within each
        block and across the file; every block's first key answers
        'maybe' from the bloom filter, and (with a perfect-hash index)
        locates to exactly (that block, slot 0). A sidecar that denies or
        mislocates a present key would turn into a silent NotFound."""
        prev_last: Optional[bytes] = None
        for i, bm in enumerate(self.blocks):
            if bm.first_key > bm.last_key:
                raise StorageCorruptionError(
                    self.path, f"scrub: block {i} fence inverted")
            if prev_last is not None and bm.first_key <= prev_last:
                raise StorageCorruptionError(
                    self.path, f"scrub: block {i} overlaps block {i - 1}")
            prev_last = bm.last_key
            if self.bloom is not None and \
                    not self.bloom.may_contain(bm.first_key):
                raise StorageCorruptionError(
                    self.path,
                    f"scrub: bloom filter denies resident key "
                    f"(block {i} first key)")
            if self.phash is not None:
                loc = self.phash.lookup_hash(crc64(bm.first_key))
                if loc < 0 or self.phash.unpack(loc) != (i, 0):
                    raise StorageCorruptionError(
                        self.path,
                        f"scrub: phash index denies or mislocates "
                        f"resident key (block {i} first key)")

    def index_memory(self) -> dict:
        """Resident sidecar bytes: {"bloom": ..., "phash": ...}."""
        return {
            "bloom": (self.bloom.bits.nbytes
                      if self.bloom is not None else 0),
            "phash": (self.phash.mem_bytes()
                      if self.phash is not None else 0),
        }

    def get(self, key: bytes, key_hash: Optional[int] = None
            ) -> Optional[Tuple[Optional[bytes], int]]:
        """Returns (value|None-for-tombstone, expire_ts), or None if absent.

        An indexed file answers through the perfect-hash index: a miss
        costs one slot gather and no block touch; a hit reads its (block,
        slot) row directly, and one row compare rejects a fingerprint
        collision. `key_hash` (crc64 of the full key) lets callers that
        already hashed skip the crc."""
        ph = self.phash
        if ph is not None and phash_probe_enabled():
            pc = _perf_current()
            h = key_hash if key_hash is not None else crc64(key)
            loc = ph.lookup_hash(h)
            if loc < 0:
                PHASH_USEFUL.increment()
                if pc is not None:
                    pc.phash_pruned += 1
                return None
            bi, slot = ph.unpack(loc)
            if bi < len(self.blocks) and slot < self.blocks[bi].count:
                blk = self.read_block(bi)
                if blk.key_at(slot) == key:
                    PHASH_HIT.increment()
                    if pc is not None:
                        pc.phash_located += 1
                    if blk.is_tombstone(slot):
                        return (None, 0)
                    return (blk.value_at(slot), int(blk.expire_ts[slot]))
                PHASH_USEFUL.increment()
                if pc is not None:
                    pc.phash_pruned += 1
                return None  # fingerprint collision: definitively absent
            # an out-of-range loc (corrupt index) serves via the bisect
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
