"""PartitionServer: the rrdb storage app for one partition.

Parity: src/server/pegasus_server_impl.{h,cpp}. The port serves put /
multi_put / remove, get / multi_get, get_scanner / scan / clear_scanner,
flush and manual_compact.

Ranged reads gather candidates into columnar blocks and evaluate filter,
TTL and partition-hash predicates for a whole block at once, where the
reference validates records one by one (on_multi_get:496, hot loop :643;
validate_key_value_for_scan:2382). Two modes reach the scan-predicate
kernel (ops/fused_scan.py) on the server's device:

- columnar: a fully compacted store (pure L1, no overlay) streams SST
  blocks through the cached static mask (filters + ownership, no `now`),
  evaluated once per block lifetime, one launch per window over the
  resident blocks (scan_coordinator.stacked_block_eval); TTL applies on
  the host from the block's expire_ts column;
- merge: with a memtable or L0 overlay, merged candidates are packed into
  a block and validated with `now` (ops.fused_scan.scan_table).

Standalone mode assigns decrees locally.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np

from pegasus_tpu_torch.base.key_schema import (
    generate_key,
    generate_next_bytes,
    restore_key,
)
from pegasus_tpu_torch.base.value_schema import (
    check_if_ts_expired,
    epoch_now,
    expire_ts_from_ttl,
    extract_user_data,
)
from pegasus_tpu_torch.ops.fused_scan import STATUS_KEEP, scan_table
from pegasus_tpu_torch.ops.predicates import (
    FilterSpec,
    host_alive_mask,
    split_gate,
)
from pegasus_tpu_torch.ops.record_block import (
    block_from_columns,
    build_record_block,
)
from pegasus_tpu_torch.server.read_limiter import RangeReadLimiter
from pegasus_tpu_torch.server.scan_context import (
    ScanContext,
    ScanContextCache,
)
from pegasus_tpu_torch.server.scan_coordinator import stacked_block_eval
from pegasus_tpu_torch.server.types import (
    KeyValue,
    MultiGetRequest,
    MultiGetResponse,
    MultiPutRequest,
    SCAN_CONTEXT_ID_COMPLETED,
    SCAN_CONTEXT_ID_NOT_EXIST,
    GetScannerRequest,
    ScanResponse,
)
from pegasus_tpu_torch.server.write_service import WriteService
from pegasus_tpu_torch.storage.engine import StorageEngine
from pegasus_tpu_torch.storage.sstable import BLOCK_CAPACITY
from pegasus_tpu_torch.utils.device import resolve_device
from pegasus_tpu_torch.utils.errors import ErrorCode, StorageStatus

# candidate records gathered per merge-path predicate launch
PREDICATE_BATCH = 2048

# server-side caps on one scan page: client batch_size is untrusted
SCAN_BATCH_CAP = 65536
SCAN_BYTES_CAP = 64 << 20

# SST blocks a columnar scan gathers before evaluating the window's
# missing masks in one stacked launch
LOOKAHEAD = 8


def _after(key: bytes) -> bytes:
    """Immediate lexicographic successor of an exact key."""
    return key + b"\x00"


class PartitionServer:
    def __init__(self, data_dir: str, app_id: int = 1, pidx: int = 0,
                 partition_count: int = 1, data_version: int = 1,
                 cluster_id: int = 1, device=None) -> None:
        """`device=None` serves on the card and raises without CUDA;
        `device="cpu"` runs the plain torch predicates on the host."""
        self.device = resolve_device(device)
        self.app_id = app_id
        self.pidx = pidx
        self.partition_count = partition_count
        # the &-mask ownership check (check_pegasus_key_hash) agrees with
        # `% partition_count` routing only for power-of-two counts
        self.partition_version = partition_count - 1
        self.validate_partition_hash = (
            partition_count > 1
            and (partition_count & (partition_count - 1)) == 0)
        self.data_version = data_version
        self.engine = StorageEngine(data_dir, data_version=data_version,
                                    values_carry_expire_header=True,
                                    device=self.device)
        self.write_service = WriteService(self.engine, data_version,
                                          cluster_id)
        self._write_lock = threading.Lock()  # single-writer invariant
        self._scan_cache = ScanContextCache()
        # device-resident SST blocks keyed by (sst path, block offset),
        # immutable per file
        self._device_block_cache: "OrderedDict[tuple, object]" = \
            OrderedDict()
        self._device_block_cache_cap = 1024
        # static keep masks: (ckey, pv, validate, filter_key) -> bool[cap];
        # `now`-free, so a block is evaluated once in its lifetime
        self._mask_cache: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._mask_cache_cap = 4096
        self._mask_lock = threading.Lock()
        self.engine.lsm.on_publish = self._on_store_publish

    def _on_store_publish(self, live_paths: set) -> None:
        """Compaction publish: drop cache entries of runs that left."""
        with self._mask_lock:
            for mkey in [k for k in self._mask_cache
                         if k[0][0] not in live_paths]:
                del self._mask_cache[mkey]
            for ckey in [k for k in self._device_block_cache
                         if k[0] not in live_paths]:
                del self._device_block_cache[ckey]

    def close(self) -> None:
        self.engine.close()

    def _next_decree(self) -> int:
        return self.engine.last_committed_decree + 1

    def _hash_gate(self, partition_hash: Optional[int]) -> int:
        """Reject requests whose routing hash no longer maps here
        (ERR_PARENT_PARTITION_MISUSED, replica_split_manager.h)."""
        if partition_hash is None or not self.validate_partition_hash:
            return 0
        if (partition_hash & self.partition_version) != self.pidx:
            return int(ErrorCode.ERR_PARENT_PARTITION_MISUSED)
        return 0

    # ---- write handlers ----------------------------------------------

    def on_put(self, key: bytes, user_data: bytes, ttl_seconds: int = 0,
               decree: Optional[int] = None,
               partition_hash: Optional[int] = None) -> int:
        with self._write_lock:
            gate = self._hash_gate(partition_hash)
            if gate:
                return gate
            d = self._next_decree() if decree is None else decree
            return self.write_service.put(key, user_data,
                                          expire_ts_from_ttl(ttl_seconds), d)

    def on_remove(self, key: bytes, decree: Optional[int] = None,
                  partition_hash: Optional[int] = None) -> int:
        with self._write_lock:
            gate = self._hash_gate(partition_hash)
            if gate:
                return gate
            d = self._next_decree() if decree is None else decree
            return self.write_service.remove(key, d)

    def on_multi_put(self, req: MultiPutRequest,
                     decree: Optional[int] = None,
                     partition_hash: Optional[int] = None) -> int:
        with self._write_lock:
            gate = self._hash_gate(partition_hash)
            if gate:
                return gate
            d = self._next_decree() if decree is None else decree
            return self.write_service.multi_put(req, d)

    # ---- point reads --------------------------------------------------

    def on_get(self, key: bytes,
               partition_hash: Optional[int] = None) -> Tuple[int, bytes]:
        """Parity: on_get (pegasus_server_impl.cpp:418): expired records
        are NotFound."""
        gate = self._hash_gate(partition_hash)
        if gate:
            return gate, b""
        hit = self.engine.get(key)
        if hit is None:
            return int(StorageStatus.NOT_FOUND), b""
        value, ets = hit
        if check_if_ts_expired(epoch_now(), ets):
            return int(StorageStatus.NOT_FOUND), b""
        return (int(StorageStatus.OK),
                extract_user_data(self.data_version, value))

    def on_multi_get(self, req: MultiGetRequest) -> MultiGetResponse:
        """Parity: on_multi_get (pegasus_server_impl.cpp:496)."""
        now = epoch_now()
        resp = MultiGetResponse()
        if not req.hash_key:
            resp.error = int(StorageStatus.INVALID_ARGUMENT)
            return resp

        # explicit sort keys -> point lookups (reference uses DB::MultiGet)
        if req.sort_keys:
            for sk in req.sort_keys:
                hit = self.engine.get(generate_key(req.hash_key, sk))
                if hit is None:
                    continue
                value, ets = hit
                if check_if_ts_expired(now, ets):
                    continue
                data = (b"" if req.no_value
                        else extract_user_data(self.data_version, value))
                resp.kvs.append(KeyValue(sk, data))
            resp.error = int(StorageStatus.OK)
            return resp

        # range mode over [start_sortkey, stop_sortkey]
        start_key = generate_key(req.hash_key, req.start_sortkey)
        if not req.start_inclusive:
            start_key = _after(start_key)
        if req.stop_sortkey:
            stop_key = generate_key(req.hash_key, req.stop_sortkey)
            if req.stop_inclusive:
                stop_key = _after(stop_key)
        else:
            stop_key = generate_next_bytes(req.hash_key)
        if stop_key and start_key >= stop_key:
            resp.error = int(StorageStatus.OK)
            return resp

        records, exhausted, resume_key = self._batched_scan(
            start_key, stop_key or None, now,
            FilterSpec.none(self.device),
            FilterSpec.make(req.sort_key_filter_type,
                            req.sort_key_filter_pattern, self.device),
            validate_hash=False, limiter=RangeReadLimiter(),
            max_records=req.max_kv_count, max_bytes=req.max_kv_size,
            reverse=req.reverse, with_values=not req.no_value)
        for key, data, _ets in records:
            resp.kvs.append(KeyValue(restore_key(key)[1], data))
        if req.reverse:
            resp.kvs.reverse()  # response is ascending by sort key
        resp.error = (int(StorageStatus.OK) if exhausted
                      else int(StorageStatus.INCOMPLETE))
        if not exhausted and not req.reverse and resume_key is not None:
            resp.resume_sort_key = restore_key(resume_key)[1]
        return resp

    # ---- ranged reads -------------------------------------------------

    def _batched_scan(
        self,
        start_key: bytes,
        stop_key: Optional[bytes],
        now: int,
        hash_filter: FilterSpec,
        sort_filter: FilterSpec,
        validate_hash: bool,
        limiter: RangeReadLimiter,
        max_records: int,
        max_bytes: int,
        reverse: bool = False,
        with_values: bool = True,
    ) -> Tuple[List[Tuple[bytes, bytes, int]], bool, Optional[bytes]]:
        """Core ranged read. Returns (records, exhausted, resume_key):
        (key, user_data, expire_ts) triples passing every predicate,
        whether the range completed, and where a follow-up continues."""
        sorted_runs = None if reverse else self.engine.lsm.sorted_runs()
        if sorted_runs is not None:
            return self._columnar_scan(sorted_runs, start_key, stop_key,
                                       now, hash_filter, sort_filter,
                                       validate_hash, limiter, max_records,
                                       max_bytes, with_values)

        out: List[Tuple[bytes, bytes, int]] = []
        out_bytes = 0
        it = self.engine.iterate(start_key, stop_key, reverse)
        exhausted = True
        resume_key: Optional[bytes] = None
        while True:
            batch: List[Tuple[bytes, bytes, int]] = []
            for key, value, ets in it:
                batch.append((key, value, ets))
                limiter.add_count()
                if len(batch) >= PREDICATE_BATCH or not limiter.valid():
                    break
            if not batch:
                break
            keep = self._validate_batch(batch, now, hash_filter, sort_filter,
                                        validate_hash)
            stop_early = False
            for i in np.flatnonzero(keep):
                key, value, ets = batch[i]
                data = (extract_user_data(self.data_version, value)
                        if with_values else b"")
                out.append((key, data, ets))
                out_bytes += len(key) + len(data)
                if ((max_records > 0 and len(out) >= max_records)
                        or (max_bytes > 0 and out_bytes >= max_bytes)):
                    resume_key = _after(key) if not reverse else key
                    stop_early = True
                    break
            if stop_early:
                exhausted = False
                break
            if not limiter.valid():
                last_key = batch[-1][0]
                resume_key = _after(last_key) if not reverse else last_key
                exhausted = False
                break
            if len(batch) < PREDICATE_BATCH:
                break
        return out, exhausted, resume_key

    def _columnar_scan(
        self,
        sorted_runs,
        start_key: bytes,
        stop_key: Optional[bytes],
        now: int,
        hash_filter: FilterSpec,
        sort_filter: FilterSpec,
        validate_hash: bool,
        limiter: RangeReadLimiter,
        max_records: int,
        max_bytes: int,
        with_values: bool,
    ) -> Tuple[List[Tuple[bytes, bytes, int]], bool, Optional[bytes]]:
        """Pure-L1 store: SST blocks stream through the cached static mask,
        combined with TTL on the host (one vectorized AND over expire_ts);
        only survivors materialize. Boundary blocks are trimmed to
        [start_key, stop_key) by bisection."""
        out: List[Tuple[bytes, bytes, int]] = []
        out_bytes = 0
        exhausted = True
        resume_key: Optional[bytes] = None
        filter_key = hash_filter.key + sort_filter.key

        def ranged_blocks():
            for run in sorted_runs:
                if stop_key is not None and (run.first_key or b"") >= stop_key:
                    continue
                if start_key and (run.last_key or b"") < start_key:
                    continue
                for bm_blk in run.iter_blocks(start_key, stop_key or None):
                    yield run, bm_blk

        blocks_iter = ranged_blocks()
        done_iter = False
        stopped = False
        while not stopped:
            window = []
            while not done_iter and len(window) < LOOKAHEAD:
                nxt = next(blocks_iter, None)
                if nxt is None:
                    done_iter = True
                    break
                run, (bm, blk) = nxt
                lo, hi = 0, blk.count
                if start_key and bm.first_key < start_key:
                    lo = blk.lower_bound(start_key)
                if stop_key is not None and bm.last_key >= stop_key:
                    hi = blk.lower_bound(stop_key)
                # only in-range rows count against the iteration budget
                limiter.add_count(hi - lo)
                window.append(((run.path, bm.offset), blk, lo, hi))
            if not window:
                break
            keeps = self._static_keep_window(window, validate_hash,
                                             filter_key)
            for (_ckey, blk, lo, hi), static_keep in zip(window, keeps):
                n = blk.count
                ets = blk.expire_ts
                keep = static_keep[:n] & host_alive_mask(ets, now)
                stop_early = False
                for i in np.flatnonzero(keep[lo:hi]):
                    idx = lo + int(i)
                    key = blk.key_at(idx)
                    data = (extract_user_data(self.data_version,
                                              blk.value_at(idx))
                            if with_values else b"")
                    out.append((key, data, int(ets[idx])))
                    out_bytes += len(key) + len(data)
                    if ((max_records > 0 and len(out) >= max_records)
                            or (max_bytes > 0 and out_bytes >= max_bytes)):
                        resume_key = _after(key)
                        stop_early = True
                        break
                if stop_early or not limiter.valid():
                    if not stop_early:
                        resume_key = _after(blk.key_at(n - 1))
                    exhausted = False
                    stopped = True
                    break
        return out, exhausted, resume_key

    def _validate_batch(self, batch: List[Tuple[bytes, bytes, int]],
                        now: int, hash_filter: FilterSpec,
                        sort_filter: FilterSpec,
                        validate_hash: bool) -> np.ndarray:
        """Merge path: pack the candidates into a block on the server's
        device and run the full predicate at second `now`; one copy of
        the status bytes back to the host."""
        if split_gate(validate_hash, self.pidx, self.partition_version):
            return np.zeros(len(batch), dtype=bool)
        block = build_record_block([b[0] for b in batch],
                                   [b[2] for b in batch],
                                   device=self.device)
        status = scan_table([block], [self.pidx], hash_filter, sort_filter,
                            validate_hash, self.partition_version, now=now)
        return status.cpu().numpy() == STATUS_KEEP

    # ---- scanners -----------------------------------------------------

    def on_get_scanner(self, req: GetScannerRequest) -> ScanResponse:
        """Parity: on_get_scanner (pegasus_server_impl.cpp:1151)."""
        start_key = req.start_key or b""
        if start_key and not req.start_inclusive:
            start_key = _after(start_key)
        stop_key = req.stop_key or b""
        if stop_key and req.stop_inclusive:
            stop_key = _after(stop_key)
        return self._serve_scan_batch(req, start_key, stop_key)

    def on_scan(self, context_id: int) -> ScanResponse:
        """Parity: on_scan (pegasus_server_impl.cpp:1399)."""
        ctx = self._scan_cache.take(context_id)
        if ctx is None:
            resp = ScanResponse()
            resp.error = int(StorageStatus.NOT_FOUND)
            resp.context_id = SCAN_CONTEXT_ID_NOT_EXIST
            return resp
        return self._serve_scan_batch(ctx.request, ctx.resume_key,
                                      ctx.stop_key)

    def on_clear_scanner(self, context_id: int) -> None:
        self._scan_cache.remove(context_id)

    def _serve_scan_batch(self, req: GetScannerRequest, start_key: bytes,
                          stop_key: bytes) -> ScanResponse:
        """One scan page. `req.pushdown` is not evaluated by this server:
        `pushdown_applied` stays False and the client evaluates locally."""
        now = epoch_now()
        resp = ScanResponse()
        batch_size = min(req.batch_size if req.batch_size > 0 else 1000,
                         SCAN_BATCH_CAP)
        if req.only_return_count:
            batch_size = -1  # count the whole (limiter-bounded) range
        records, exhausted, resume_key = self._batched_scan(
            start_key, stop_key or None, now,
            FilterSpec.make(req.hash_key_filter_type,
                            req.hash_key_filter_pattern, self.device),
            FilterSpec.make(req.sort_key_filter_type,
                            req.sort_key_filter_pattern, self.device),
            validate_hash=(req.validate_partition_hash
                           and self.validate_partition_hash),
            limiter=RangeReadLimiter(), max_records=batch_size,
            max_bytes=-1 if req.only_return_count else SCAN_BYTES_CAP,
            with_values=not req.no_value and not req.only_return_count)
        if req.only_return_count:
            resp.kv_count = len(records)
        else:
            for key, data, ets in records:
                kv = KeyValue(key, data)
                if req.return_expire_ts:
                    kv.expire_ts_seconds = ets
                resp.kvs.append(kv)
        resp.error = int(StorageStatus.OK)
        if exhausted or req.one_page:
            # one_page: the client promised not to page further
            resp.context_id = SCAN_CONTEXT_ID_COMPLETED
        else:
            resp.context_id = self._scan_cache.put(ScanContext(
                request=req, resume_key=resume_key or start_key,
                stop_key=stop_key))
        return resp

    # ---- static masks of SST blocks -----------------------------------

    def _static_keep_window(self, window, validate: bool,
                            filter_key) -> list:
        """Cached static keep masks for a window [(ckey, blk, lo, hi)] of
        blocks; the misses are evaluated in one table launch and cached
        for every later scan. Returns masks aligned to the window."""
        pv = self.partition_version
        keeps: list = [None] * len(window)
        misses = []
        with self._mask_lock:
            for j, (ckey, blk, _lo, _hi) in enumerate(window):
                mkey = (ckey, pv, validate, filter_key)
                cached = self._mask_cache.get(mkey)
                if cached is not None:
                    self._mask_cache.move_to_end(mkey)
                    keeps[j] = cached
                else:
                    misses.append((j, ckey, blk))
        if misses:
            blocks = [((j, ckey), self._device_cached_block(ckey, blk),
                       self.pidx) for j, ckey, blk in misses]
            for (j, ckey), keep in stacked_block_eval(
                    blocks, validate, pv, filter_key=filter_key):
                keeps[j] = keep
                self._store_mask(ckey, validate, filter_key, keep, pv)
        return keeps

    def _store_mask(self, ckey, validate: bool, filter_key, keep,
                    computed_pv: int) -> None:
        # room for every L1 block under a few filter flavors, so a large
        # partition's masks do not evict each other on every scan
        n_blocks = sum(len(run.blocks) for run in self.engine.lsm.l1_runs)
        cap = max(self._mask_cache_cap, 4 * n_blocks + 256)
        with self._mask_lock:
            if computed_pv != self.partition_version:
                return
            self._mask_cache[(ckey, computed_pv, validate,
                              filter_key)] = keep
            while len(self._mask_cache) > cap:
                self._mask_cache.popitem(last=False)

    def _device_cached_block(self, cache_key, blk):
        """The SST block's predicate columns on the server's device,
        zero-padded to BLOCK_CAPACITY rows, uploaded once and cached."""
        with self._mask_lock:
            dev_block = self._device_block_cache.get(cache_key)
            if dev_block is not None:
                self._device_block_cache.move_to_end(cache_key)
                return dev_block
        dev_block = block_from_columns(
            blk.keys, blk.key_len, blk.expire_ts, hash_lo=blk.hash_lo,
            capacity=max(BLOCK_CAPACITY, blk.count), device=self.device)
        with self._mask_lock:
            self._device_block_cache[cache_key] = dev_block
            if len(self._device_block_cache) > self._device_block_cache_cap:
                self._device_block_cache.popitem(last=False)
        return dev_block

    # ---- maintenance --------------------------------------------------

    def flush(self) -> bool:
        with self._write_lock:
            return self.engine.flush()

    def manual_compact(self, default_ttl: int = 0,
                       now: Optional[int] = None) -> None:
        """Parity: pegasus_manual_compact_service (manual CompactRange):
        freeze the overlay with a flush, then merge everything through
        the TTL / stale-split filter on the server's device. Writers are
        excluded for the whole merge."""
        with self._write_lock:
            self.engine.flush()
            self.engine.manual_compact(
                default_ttl=default_ttl, pidx=self.pidx,
                partition_version=self.partition_version,
                validate_hash=self.validate_partition_hash, now=now)
