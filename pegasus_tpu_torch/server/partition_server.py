"""PartitionServer: the rrdb storage app for one partition.

Parity: src/server/pegasus_server_impl.{h,cpp}. The port serves put /
multi_put / remove, get / multi_get, get_scanner / scan / clear_scanner,
flush and manual_compact.

Ranged reads gather candidates into columnar blocks and evaluate filter,
TTL and partition-hash predicates for a whole block at once, where the
reference validates records one by one (on_multi_get:496, hot loop :643;
validate_key_value_for_scan:2382). Three modes reach the scan-predicate
kernel (ops/fused_scan.py) on the server's device:

- batched: a batch of scans (on_get_scanner_batch, or many partitions'
  batches through scan_coordinator.scan_multi) is planned once per
  cached range (plan_scan_batch), each unique planned block's static
  mask is evaluated once in its lifetime (planned_misses), the host TTL
  mask is applied per block and second (prepare_serve), the pages are
  packed by one native call per flush (server/page.serve_batch) and a
  light write overlay merges host-side (finish_scan_batch); a batch the
  fast path does not take is served request by request, in one of:
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

import bisect
import threading
import time
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np

from pegasus_tpu_torch.base.key_schema import (
    check_key_hash,
    generate_key,
    generate_next_bytes,
    restore_key,
)
from pegasus_tpu_torch.base.value_schema import (
    check_if_ts_expired,
    epoch_now,
    expire_ts_from_ttl,
    extract_user_data,
    header_length,
)
from pegasus_tpu_torch.ops.fused_scan import STATUS_KEEP, scan_table
from pegasus_tpu_torch.ops.predicates import (
    FT_MATCH_ANYWHERE,
    FT_MATCH_POSTFIX,
    FT_MATCH_PREFIX,
    FT_NO_FILTER,
    FilterSpec,
    host_alive_mask,
    host_match_filter,
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
from pegasus_tpu_torch.server import page
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
from pegasus_tpu_torch.storage.memtable import TOMBSTONE
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


# the no-filter flavour's mask key component (and the normal form of any
# empty-pattern filter, which matches everything)
_NO_FILTER_KEY = (FT_NO_FILTER, b"", FT_NO_FILTER, b"")

_KNOWN_FILTERS = (FT_NO_FILTER, FT_MATCH_ANYWHERE, FT_MATCH_PREFIX,
                  FT_MATCH_POSTFIX)


def _normalize_filter_key(r) -> tuple:
    """(hash type, hash pattern, sort type, sort pattern), with
    empty-pattern components collapsed to FT_NO_FILTER and patterns
    under FT_NO_FILTER dropped: the matchers treat both as match-all, so
    distinct keys would only split batches and duplicate masks."""
    hft, hfp = r.hash_key_filter_type, r.hash_key_filter_pattern
    sft, sfp = r.sort_key_filter_type, r.sort_key_filter_pattern
    if hft == FT_NO_FILTER or not hfp:
        hft, hfp = FT_NO_FILTER, b""
    if sft == FT_NO_FILTER or not sfp:
        sft, sfp = FT_NO_FILTER, b""
    return (hft, hfp, sft, sfp)


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
        # mask and device-block caches are shared with the MaskPrefresher
        self._mask_lock = threading.Lock()
        # (store, generation, {(start, stop, want bucket) -> (plan,
        # unique entries, geometry, native table, frontier)}): batched
        # scan plans, one dict per run set, replaced wholesale when the
        # generation moves (see plan_scan_batch)
        self._plan_cache = None
        # (ckey, static-mask id) -> (second, static, alive, expired count,
        # live, live pointer): per-second TTL-applied serving masks (see
        # prepare_serve)
        self._live_cache: dict = {}
        # ((generation, second), {plan id -> (plan, expired count)}):
        # per-request expired accounting, reset each second and run set
        # (see finish_scan_batch)
        self._plan_expired_cache: tuple = (None, {})
        # expired records the batched path met and did not serve (the
        # reference's abnormal_read_count); the per-request path does not
        # count yet
        self.abnormal_read_count = 0
        # scan flavours (validate, filter_key) seen recently: after a
        # flush or compaction replaces the SSTs, the MaskPrefresher
        # evaluates the new blocks for these flavours in the background
        self._warm_flavors: "OrderedDict[tuple, float]" = OrderedDict()
        self._warm_flavors_cap = 64
        # filter flavours seen recently: filter_key -> last wall time. A
        # filtered flavour joins the warm set on its second occurrence
        # within the window: one-shot patterns must not multiply
        # background device work
        self._filter_seen: "OrderedDict[tuple, float]" = OrderedDict()
        self._filter_seen_cap = 256
        self._filter_seen_window = 30.0
        self.engine.lsm.on_publish = self._on_store_publish

    def _on_store_publish(self, live_paths: set) -> None:
        """Compaction publish: drop cache entries of runs that left. Warm
        flavours survive: the prefresher evaluates the new blocks."""
        with self._mask_lock:
            for mkey in [k for k in self._mask_cache
                         if k[0][0] not in live_paths]:
                del self._mask_cache[mkey]
            for ckey in [k for k in self._device_block_cache
                         if k[0] not in live_paths]:
                del self._device_block_cache[ckey]
        # per-second and per-generation caches: rebound wholesale (cheap
        # to rebuild, and safe against a concurrent reader)
        self._live_cache = {}
        self._plan_cache = None
        self._plan_expired_cache = (None, {})

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

    # ---- batched multi-scan: many scans share one predicate pass -----

    # overlay rows tolerated on the batched path before a batch falls
    # back to per-request (merged) serving
    OVERLAY_MERGE_LIMIT = 4096
    # blocks one warm pass loads per partition (bounds the IO)
    WARM_BATCH_LIMIT = 256

    def on_get_scanner_batch(self, reqs: List[GetScannerRequest]
                             ) -> List[ScanResponse]:
        """Serve a batch of scans with per-block dedup.

        The fast path takes a columnar store (a light write overlay
        merges host-side) and one flavour across the batch: one effective
        validate flag, one key filter, no count-only request and no
        pushdown. Each unique block the batch touches gets one static
        mask evaluation in its lifetime; per-request boundary trimming
        happens on the host against the cached mask. Anything else is
        served request by request (partition_server.py:2480 of the JAX
        package)."""
        state = self.plan_scan_batch(reqs)
        if state is None:
            return [self.on_get_scanner(r) for r in reqs]
        keep_masks = self.eval_planned_masks(state)
        return self.finish_scan_batch(state, keep_masks)

    def plan_scan_batch(self, reqs: List[GetScannerRequest],
                        now: Optional[int] = None, flavor=None):
        """Phase 1: qualify the batch and plan each request's blocks.
        None: the caller serves per request. `flavor` is the (validate,
        filter_key) the caller already grouped by (scan_coordinator), which
        skips the per-request re-derivation."""
        lsm = self.engine.lsm
        # the generation is read before the run set and checked again
        # after planning: a batch planned across a compaction publish
        # could pair the old runs with the new (empty) overlay, so such a
        # batch is served per request (memtable before runs)
        gen = lsm.generation
        runs = lsm.l1_runs
        # a light write overlay (memtable + small L0s) does not evict the
        # partition from the batched path: its rows merge host-side on
        # top of the device-filtered base (the YCSB-E 5%-insert shape)
        overlay_count = len(lsm.memtable) + sum(t.total_count
                                                for t in lsm.l0)
        if flavor is not None:
            validates = {flavor[0]}
            filters = {flavor[1]}
        else:
            validates = {bool(r.validate_partition_hash
                              and self.validate_partition_hash)
                         for r in reqs}
            filters = {_normalize_filter_key(r) for r in reqs}
        # pushdown specs are not evaluated by this server: such requests
        # take the per-request path, which leaves pushdown_applied False
        simple = (runs and overlay_count <= self.OVERLAY_MERGE_LIMIT
                  and len(validates) == 1 and len(filters) == 1
                  and all(f[0] in _KNOWN_FILTERS and f[2] in _KNOWN_FILTERS
                          for f in filters)
                  and not any(r.only_return_count or r.pushdown is not None
                              for r in reqs))
        if not simple:
            return None
        now = epoch_now() if now is None else now
        validate = validates.pop()
        filter_key = filters.pop()
        overlay = (self._overlay_snapshot(now, validate, filter_key)
                   if overlay_count else ([], {}))
        # per request: the block list and boundary bounds, capped a bit
        # beyond batch_size so expiry and hash drops do not starve the
        # page. Plans are cached per (range, want bucket) under the store
        # generation: zipfian traffic repeats the same scans, and a plan
        # is pure over the immutable run set. An over-budgeted cached plan
        # only means a further frontier, never a wrong page.
        req_plans = []
        unique: "OrderedDict[tuple, tuple]" = OrderedDict()
        pc = self._plan_cache
        if pc is None or pc[0] is not lsm or pc[1] != gen:
            pc = self._plan_cache = (lsm, gen, {})
        cache = pc[2]
        for req in reqs:
            start_key = req.start_key or b""
            if start_key and not req.start_inclusive:
                start_key = _after(start_key)
            stop_key = req.stop_key or b""
            if stop_key and req.stop_inclusive:
                stop_key = _after(stop_key)
            want = min(req.batch_size if req.batch_size > 0 else 1000,
                       SCAN_BATCH_CAP)
            wb = 1 << (want - 1).bit_length() if want > 1 else 1
            pkey = (start_key, stop_key, wb)
            hit = cache.get(pkey)
            if hit is not None:
                plan, uniq_entries, geom, nat, frontier = hit
            else:
                plan = []
                uniq_entries = []
                budget = wb * 2 + 64
                for run in runs:
                    if stop_key and (run.first_key or b"") >= stop_key:
                        continue
                    if start_key and (run.last_key or b"") < start_key:
                        continue
                    for bm, blk in run.iter_blocks(start_key,
                                                   stop_key or None):
                        lo, hi = 0, blk.count
                        if start_key and bm.first_key < start_key:
                            lo = blk.lower_bound(start_key)
                        if stop_key and bm.last_key >= stop_key:
                            hi = blk.lower_bound(stop_key)
                        ckey = (run.path, bm.offset)
                        uniq_entries.append((ckey, run, bm, blk))
                        plan.append((ckey, blk, lo, hi))
                        budget -= hi - lo
                        if budget <= 0:
                            break
                    if budget <= 0:
                        break
                # arena geometry and native entry table, once per cached
                # plan; the resume frontier past a capped plan's last row
                geom = page.plan_geometry(plan)
                nat = page.plan_nat(plan)
                frontier = (_after(plan[-1][1].key_at(
                    plan[-1][1].count - 1)) if plan else None)
                if len(cache) >= 8192:
                    cache.pop(next(iter(cache)))
                cache[pkey] = (plan, uniq_entries, geom, nat, frontier)
            for ckey, run, bm, blk in uniq_entries:
                unique.setdefault(ckey, (run, bm, blk))
            req_plans.append((req, start_key, stop_key, want, plan,
                              geom, nat, frontier))
        if lsm.generation != gen:
            return None
        return {"reqs": reqs, "req_plans": req_plans, "unique": unique,
                "validate": validate, "now": now, "overlay": overlay,
                "filter_key": filter_key}

    def planned_misses(self, state) -> "OrderedDict[tuple, object]":
        """Unique planned blocks whose static masks are not cached: the
        device work left, as ckey -> device block (uploaded here through
        the block cache). The cached masks go to state["cached_keep"].
        Masks are `now`-independent, so a block misses only on first
        touch after a flush or compaction, or for a new filter. The
        batch's flavour is registered for the MaskPrefresher."""
        keep_masks = {}
        misses: "OrderedDict[tuple, object]" = OrderedDict()
        validate = state["validate"]
        filter_key = state["filter_key"]
        with self._mask_lock:
            self._register_flavor(validate, filter_key, time.monotonic())
            for ckey, (_run, _bm, blk) in state["unique"].items():
                mkey = (ckey, self.partition_version, validate,
                        filter_key)
                cached = self._mask_cache.get(mkey)
                if cached is not None:
                    self._mask_cache.move_to_end(mkey)
                    keep_masks[ckey] = cached
                    continue
                misses[ckey] = blk
        for ckey, blk in list(misses.items()):
            misses[ckey] = self._device_cached_block(ckey, blk)
        state["cached_keep"] = keep_masks
        return misses

    def _register_flavor(self, validate: bool, filter_key,
                         wall: float) -> None:
        """Remember a scan flavour for background warming (the caller
        holds _mask_lock). The no-filter flavour always registers; a
        filtered one once it recurs within the window, so one-shot
        patterns neither multiply background device work nor evict the
        warm set."""
        register = filter_key == _NO_FILTER_KEY
        if not register:
            last = self._filter_seen.get(filter_key)
            register = (last is not None
                        and wall - last <= self._filter_seen_window)
            self._filter_seen[filter_key] = wall
            self._filter_seen.move_to_end(filter_key)
            while len(self._filter_seen) > self._filter_seen_cap:
                self._filter_seen.popitem(last=False)
        if register:
            fl = (validate, filter_key)
            self._warm_flavors[fl] = wall
            self._warm_flavors.move_to_end(fl)
            while len(self._warm_flavors) > self._warm_flavors_cap:
                self._warm_flavors.popitem(last=False)

    def hot_block_entries(self, wall: float, horizon_s: float):
        """(ckey, block, validate, filter_key) for current L1 blocks
        missing a static mask of a recently used flavour: the
        MaskPrefresher's work list, at most WARM_BATCH_LIMIT a pass.
        Prunes flavours idle past the horizon."""
        with self._mask_lock:
            flavors = []
            for fl in list(self._warm_flavors):
                if wall - self._warm_flavors[fl] > horizon_s:
                    del self._warm_flavors[fl]
                    continue
                flavors.append(fl)
        if not flavors:
            return []
        # probed without the lock (a racing store only makes this pass
        # warm one mask twice), so serving never stalls behind it
        pv = self.partition_version
        cache_get = self._mask_cache.get
        missing = []
        for run in list(self.engine.lsm.l1_runs):
            for i, bm in enumerate(run.blocks):
                ckey = (run.path, bm.offset)
                for validate, filter_key in flavors:
                    if cache_get((ckey, pv, validate,
                                  filter_key)) is None:
                        missing.append((run, i, ckey, validate,
                                        filter_key))
                        if len(missing) >= self.WARM_BATCH_LIMIT:
                            break
                if len(missing) >= self.WARM_BATCH_LIMIT:
                    break
            if len(missing) >= self.WARM_BATCH_LIMIT:
                break
        return [(ckey, run.read_block(i), validate, filter_key)
                for run, i, ckey, validate, filter_key in missing]

    def eval_planned_masks(self, state) -> dict:
        """Phase 2 (one partition): evaluate this partition's misses in
        stacked launches; returns ckey -> static keep mask."""
        misses = self.planned_misses(state)
        keep_masks = state["cached_keep"]
        for ckey, keep in self._eval_blocks_stacked(
                misses, state["filter_key"], state["validate"]):
            keep_masks[ckey] = keep
            self.store_mask(state, ckey, keep)
        return keep_masks

    def _eval_blocks_stacked(self, misses, filter_key, validate):
        blocks = [(ckey, dev, self.pidx) for ckey, dev in misses.items()]
        yield from stacked_block_eval(blocks, validate,
                                      self.partition_version,
                                      filter_key=filter_key)

    def prepare_serve(self, state, keep_masks) -> list:
        """Phase 2.5: combine each unique block's static keep with the
        host TTL mask, compute each request's overlay window and plan
        frontier, and return the batch's fast-path (overlay-free) request
        windows (plan, want, no_value, want_ets, live_masks, geom, nat,
        live_ptrs) for page.serve_batch. The coordinator concatenates
        them across partitions so that one native call packs a whole
        flush. Everything is stashed in `state`; idempotent."""
        if "windows" in state:
            return state["fast"]
        unique = state["unique"]
        now = state["now"]
        live_masks = {}
        live_ptrs = {}
        alive_all = {}
        exp_full = {}
        cache = self._live_cache
        for ckey, (_run, _bm, blk) in unique.items():
            static = keep_masks[ckey]
            # (block, flavour mask, second) cache: TTL validity is one
            # second, so every batch within it reuses static AND alive;
            # the entry pins the static array it was built from, since
            # id() alone could be a recycled address after an evict
            lkey = (ckey, id(static))
            hit = cache.get(lkey)
            if hit is not None and hit[0] == now and hit[1] is static:
                _now, _st, alive, exp, live, lptr = hit
            else:
                alive = blk.alive_mask(now)
                # whole-block expired count once per unique block;
                # requests spanning the whole block reuse it
                exp = len(alive) - int(np.count_nonzero(alive))
                live = static[:blk.count] & alive
                # .ctypes.data costs ~a µs: once per (block, flavour,
                # second), not per request window
                lptr = live.ctypes.data
                if len(cache) >= 4096:
                    cache.pop(next(iter(cache)))
                cache[lkey] = (now, static, alive, exp, live, lptr)
            alive_all[ckey] = alive
            exp_full[ckey] = exp
            live_masks[ckey] = live
            live_ptrs[ckey] = lptr
        overlay_keys, _overlay_map = state["overlay"]
        windows = []
        fast = []
        for req, start_key, stop_key, want, plan, geom, nat, pfrontier \
                in state["req_plans"]:
            capped = bool(plan) and geom[0] >= want * 2 + 64
            frontier = pfrontier if capped else None
            ov_lo = (bisect.bisect_left(overlay_keys, start_key)
                     if start_key else 0)
            ov_hi = len(overlay_keys)
            if stop_key:
                ov_hi = bisect.bisect_left(overlay_keys, stop_key, ov_lo)
            if frontier is not None:
                ov_hi = bisect.bisect_left(overlay_keys, frontier, ov_lo,
                                           ov_hi)
            windows.append((capped, frontier, ov_lo, ov_hi))
            if ov_lo >= ov_hi:
                fast.append((plan, want, req.no_value,
                             req.return_expire_ts, live_masks, geom, nat,
                             live_ptrs))
        state["live_masks"] = live_masks
        state["alive_all"] = alive_all
        state["exp_full"] = exp_full
        state["windows"] = windows
        state["fast"] = fast
        return fast

    def finish_scan_batch(self, state, keep_masks, served=None
                          ) -> List[ScanResponse]:
        """Phase 3: assemble the responses from the static masks, TTL
        applied on the host (one vectorized AND per unique block at the
        batch's single clock reading). `served`: this batch's slice of
        the coordinator's cross-partition native assembly, aligned with
        prepare_serve's fast list; None runs the native assembly here."""
        req_plans = state["req_plans"]
        now = state["now"]
        fast = self.prepare_serve(state, keep_masks)
        live_masks = state["live_masks"]
        alive_all = state["alive_all"]
        exp_full = state["exp_full"]
        windows = state["windows"]
        overlay_keys, overlay_map = state["overlay"]
        hdr = header_length(self.data_version)
        if served is None and fast:
            served = page.serve_batch(fast, SCAN_BYTES_CAP, hdr)
        served_iter = iter(served) if served is not None else None

        # per-(plan, second) expired counts: alive depends only on block
        # and second, and plans are cached objects, so repeats of a
        # popular scan within one second skip the per-entry count. The
        # plan is pinned in the value so its id() cannot be recycled; the
        # dict resets each second and generation.
        ptag = (self.engine.lsm.generation, now)
        if self._plan_expired_cache[0] != ptag:
            self._plan_expired_cache = (ptag, {})
        pec = self._plan_expired_cache[1]
        total_expired = 0

        out = []
        for (req, start_key, stop_key, want, plan, _geom, _nat, _pf), \
                (capped, frontier, ov_lo, ov_hi) in zip(req_plans,
                                                        windows):
            kvs: list = []
            size = 0
            exhausted = True
            resume_key = None
            stop_early = False
            want_ets = req.return_expire_ts
            no_value = req.no_value

            def base_rows(plan=plan):
                for ckey, blk, lo, hi in plan:
                    keep = live_masks[ckey]
                    for i in np.flatnonzero(keep[lo:hi]):
                        idx = lo + int(i)
                        yield blk.key_at(idx), blk, idx

            hit = pec.get(id(plan))
            if hit is not None:
                req_expired = hit[1]
            else:
                req_expired = 0
                for ckey, blk_, lo, hi in plan:
                    if lo == 0 and hi == blk_.count:
                        req_expired += exp_full[ckey]
                    else:
                        req_expired += int(np.count_nonzero(
                            ~alive_all[ckey][lo:hi]))
                pec[id(plan)] = (plan, req_expired)
            ov_i = ov_lo
            chunks = None
            if ov_lo >= ov_hi:
                # no overlay row shadows this window: the kept base rows
                # are the answer, packed by the flush's native call; an
                # arena overflow (None) is re-served with numpy below
                served = (next(served_iter) if served_iter is not None
                          else None)
                if served is not None:
                    kvs, size, last_key, truncated = served
                    if ((len(kvs) >= want or truncated)
                            and last_key is not None):
                        resume_key = _after(last_key)
                        stop_early = True
                else:
                    chunks = []
                    page.SERVE_STATS["numpy"] += 1
            if chunks is not None:
                taken = 0
                byte_est = 0
                truncated = False
                for ckey, blk, lo, hi in plan:
                    hit = np.flatnonzero(live_masks[ckey][lo:hi])
                    if hit.size > want - taken:
                        hit = hit[:want - taken]
                    if not hit.size:
                        continue
                    hit = hit + lo
                    # byte budget (keys + value-heap span upper bound):
                    # page blob offsets are uint32 and one response must
                    # stay bounded whatever the values weigh; a keys-only
                    # scan counts key bytes only
                    vo = blk.value_offs
                    chunk_bytes = int(hit.size) * blk.keys.shape[1]
                    if not no_value:
                        chunk_bytes += (int(vo[int(hit[-1]) + 1])
                                        - int(vo[int(hit[0])]))
                    if byte_est + chunk_bytes > SCAN_BYTES_CAP:
                        if byte_est == 0:
                            # a single oversized chunk: the row prefix
                            # that fits
                            row_bytes = np.full(hit.size,
                                                blk.keys.shape[1],
                                                dtype=np.int64)
                            if not no_value:
                                row_bytes += (vo[hit + 1].astype(np.int64)
                                              - vo[hit].astype(np.int64))
                            fit = int(np.searchsorted(
                                np.cumsum(row_bytes), SCAN_BYTES_CAP,
                                side="right"))
                            hit = hit[:max(1, fit)]
                            chunks.append((blk, hit))
                            taken += int(hit.size)
                        truncated = True
                        break
                    byte_est += chunk_bytes
                    chunks.append((blk, hit))
                    taken += int(hit.size)
                    if taken >= want:
                        break
                kvs, size, last_key = page.build_page(
                    chunks, hdr, no_value=no_value, want_ets=want_ets)
                if (taken >= want or truncated) and last_key is not None:
                    resume_key = _after(last_key)
                    stop_early = True
            elif ov_lo < ov_hi:
                # merge: interleave overlay rows in key order (an overlay
                # row shadows the base row of its key: newest wins,
                # tombstones hide)
                base = base_rows()
                base_item = next(base, None)
                while len(kvs) < want:
                    ov_key = overlay_keys[ov_i] if ov_i < ov_hi else None
                    if base_item is None and ov_key is None:
                        break
                    take_overlay = (ov_key is not None
                                    and (base_item is None
                                         or ov_key <= base_item[0]))
                    if take_overlay:
                        if base_item is not None and ov_key == base_item[0]:
                            base_item = next(base, None)  # shadowed
                        ov_i += 1
                        entry = overlay_map[ov_key]
                        if entry is None:
                            continue  # tombstone / hidden overlay row
                        data = b"" if no_value else entry[0]
                        kv = KeyValue(ov_key, data)
                        if want_ets:
                            kv.expire_ts_seconds = entry[1]
                        key = ov_key
                    else:
                        key, blk, idx = base_item
                        base_item = next(base, None)
                        data = (b"" if no_value
                                else extract_user_data(self.data_version,
                                                       blk.value_at(idx)))
                        kv = KeyValue(key, data)
                        if want_ets:
                            kv.expire_ts_seconds = int(blk.expire_ts[idx])
                    kvs.append(kv)
                    size += len(key) + len(data)
                    if len(kvs) >= want or size >= SCAN_BYTES_CAP:
                        resume_key = _after(key)
                        stop_early = True
                        break
            if stop_early:
                exhausted = False
            elif capped:
                resume_key = frontier
                exhausted = False
            total_expired += req_expired
            resp = ScanResponse()
            resp.kvs = kvs
            resp.error = int(StorageStatus.OK)
            if exhausted or req.one_page:
                resp.context_id = SCAN_CONTEXT_ID_COMPLETED
            else:
                resp.context_id = self._scan_cache.put(ScanContext(
                    request=req, resume_key=resume_key or start_key,
                    stop_key=stop_key))
            out.append(resp)
        self.abnormal_read_count += total_expired
        return out

    def _overlay_snapshot(self, now: int, validate: bool, filter_key):
        """(sorted keys, key -> None | (user data, expire_ts)) of the
        memtable + L0 overlay, newest wins, with the scan predicates (TTL,
        stale-split hash, the batch's key filter) evaluated on the host:
        the overlay is small by the fast path's qualifier, so a launch
        would cost more than it filters. A key failing the key filter is
        left out (its base copies fail the same filter in the mask); an
        expired, tombstoned or foreign row stays as a hidden shadow
        (None) that hides the base row of its key."""
        hft, hfp, sft, sfp = filter_key
        lsm = self.engine.lsm
        merged: dict = {}
        for key, value, ets in lsm.memtable.items_sorted():
            merged[key] = None if value is TOMBSTONE else (value, ets)
        for table in lsm.l0:  # newest first; the first writer wins
            for key, value, ets in table.iterate():
                if key not in merged:
                    merged[key] = None if value is None else (value, ets)
        out: dict = {}
        for key in sorted(merged):
            if hft != FT_NO_FILTER or sft != FT_NO_FILTER:
                hk, sk = restore_key(key)
                if not (host_match_filter(hk, hft, hfp)
                        and host_match_filter(sk, sft, sfp)):
                    continue  # fails the batch filter everywhere
            entry = merged[key]
            if entry is None:
                out[key] = None  # tombstone: shadows the base
                continue
            value, ets = entry
            if check_if_ts_expired(now, ets):
                self.abnormal_read_count += 1
                out[key] = None  # expired: hidden, and shadows the base
                continue
            if validate and not check_key_hash(key, self.pidx,
                                               self.partition_version):
                out[key] = None
                continue
            out[key] = (extract_user_data(self.data_version, value), ets)
        return list(out), out  # insertion order is already sorted

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
                self.store_mask_for(ckey, validate, filter_key, keep,
                                    computed_pv=pv)
        return keeps

    def store_mask(self, state, ckey, keep) -> None:
        self.store_mask_for(ckey, state["validate"], state["filter_key"],
                            keep, computed_pv=self.partition_version)

    def _effective_mask_cap(self) -> int:
        """Mask-cache capacity scaled to the data: every current L1 block
        times every warm flavour must fit, or the prefresher and the LRU
        evict each other's still-wanted masks and 'each block evaluated
        once' breaks on large partitions."""
        n_blocks = sum(len(run.blocks) for run in self.engine.lsm.l1_runs)
        flavors = max(1, len(self._warm_flavors))
        return max(self._mask_cache_cap, n_blocks * flavors + 256)

    def store_mask_for(self, ckey, validate: bool, filter_key, keep,
                       computed_pv: int) -> None:
        """Publish a static mask under the partition_version it was
        computed with; a mask computed under another version is dropped."""
        keep = np.asarray(keep)
        if keep.base is not None:
            # a row of a multi-flavour table's masks would pin the whole
            # [K, blocks * capacity] array per cache entry
            keep = keep.copy()
        cap = self._effective_mask_cap()
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
