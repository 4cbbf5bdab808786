"""PartitionServer: the rrdb storage app for one partition.

Parity: src/server/pegasus_server_impl.{h,cpp}. The port serves put /
multi_put / remove / multi_remove, the atomic writes incr /
check_and_set / check_and_mutate, get / ttl / multi_get / batch_get /
sortkey_count, get_scanner / scan / clear_scanner, flush, checkpoint,
manual_compact and the partition-count flip of a split, and the batched
point-read path (get / ttl / multi_get with sort keys / batch_get
through plan_get_batch, point_chunks and finish_get_batch, which
server/read_coordinator drives across partitions).

Point reads are host work, as in the JAX package: bloom filters and
perfect-hash indexes (storage/bloom.py, storage/phash.py) prune and
locate a flush's keys in one native call each, the node row cache
(server/row_cache.py) serves repeat rows, and native gathers assemble
co-located values; no point read reaches the device.

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

A block of a compressed run (`dcz`/`dcz2`) gets its first-touch static
mask on the host, from the encoded form (ops.predicates
.encoded_static_keep), exactly as in the JAX package; only blocks of
uncompressed runs and blocks holding malformed rows reach the kernel.
A scan's pushdown spec (ops/pushdown.py) is evaluated on the host: a
value filter joins the live mask, an aggregate folds the survivors.

Per-table app-envs (`update_app_envs`) set the compaction filter's
`default_ttl` and `user_specified_compaction` rules, which every manual,
env-triggered (`manual_compact.once.trigger_time`) and automatic
compaction of the partition runs (manual_compact merges off the write
lock and takes it only to freeze the overlay and to publish); the
request gates (`replica.deny_client_request` and the read and write
throttles, checked by every handler before its hash gate); and the
engine's flush and compaction triggers (`rocksdb.usage_scenario`).

Observability, as in the JAX package: each partition's counters live on
its ("replica", "app.pidx") metric entity (utils/metrics.py); every read
bills capacity units (server/capacity_units.py) to the ambient tenant
(server/tenancy.py); the request stream feeds the hotkey collectors
(server/hotkey.py) and the workload profile (server/workload.py); each
op or batched flush carries a PerfContext cost vector
(utils/perf_context.py) and a LatencyTracer stage chain whose stages
annotate the active trace span (utils/tracing.py), and a slow one lands
in the slow-query log (utils/latency_tracer.py,
`replica.slow_query_threshold_ms`).

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
    key_hash_parts,
    restore_key,
)
from pegasus_tpu_torch.base.value_schema import (
    PEGASUS_EPOCH_BEGIN,
    check_if_ts_expired,
    epoch_now,
    expire_ts_from_ttl,
    extract_user_data,
    header_length,
)
from pegasus_tpu_torch.ops import pushdown as pushdown_ops
from pegasus_tpu_torch.ops.compaction_rules import compile_rules
from pegasus_tpu_torch.ops.fused_scan import (
    STATUS_EXPIRED,
    STATUS_KEEP,
    scan_table,
)
from pegasus_tpu_torch.ops.predicates import (
    FT_MATCH_ANYWHERE,
    FT_MATCH_POSTFIX,
    FT_MATCH_PREFIX,
    FT_NO_FILTER,
    FilterSpec,
    encoded_static_keep,
    host_alive_mask,
    host_key_hash_lo,
    host_match_filter,
    split_gate,
)
from pegasus_tpu_torch.ops.record_block import (
    block_from_columns,
    build_record_block,
)
from pegasus_tpu_torch.server.capacity_units import (
    CapacityUnitCalculator,
    units as cu_units,
)
from pegasus_tpu_torch.server.hotkey import HotkeyCollector
from pegasus_tpu_torch.server.read_limiter import RangeReadLimiter
from pegasus_tpu_torch.server.scan_context import (
    ScanContext,
    ScanContextCache,
)
from pegasus_tpu_torch.server import page
from pegasus_tpu_torch.server.row_cache import ROW_CACHE
from pegasus_tpu_torch.server.scan_coordinator import stacked_block_eval
from pegasus_tpu_torch.server.types import (
    BatchGetRequest,
    BatchGetResponse,
    CheckAndMutateRequest,
    CheckAndMutateResponse,
    CheckAndSetRequest,
    CheckAndSetResponse,
    FullData,
    IncrRequest,
    IncrResponse,
    KeyValue,
    MultiGetRequest,
    MultiGetResponse,
    MultiPutRequest,
    MultiRemoveRequest,
    SCAN_CONTEXT_ID_COMPLETED,
    SCAN_CONTEXT_ID_NOT_EXIST,
    GetScannerRequest,
    ScanResponse,
)
from pegasus_tpu_torch.server.workload import WorkloadStats
from pegasus_tpu_torch.server.write_service import WriteService
from pegasus_tpu_torch.storage.compact_governor import GOVERNOR
from pegasus_tpu_torch.storage.engine import StorageEngine
from pegasus_tpu_torch.storage.memtable import TOMBSTONE
from pegasus_tpu_torch.storage.bloom import MultiProbe, bloom_probe_enabled
from pegasus_tpu_torch.storage.phash import (
    PHASH_HIT,
    PHASH_USEFUL,
    PHashMultiProbe,
    phash_probe_enabled,
)
from pegasus_tpu_torch.storage.sstable import BLOCK_CAPACITY
from pegasus_tpu_torch.utils.device import resolve_device
from pegasus_tpu_torch.utils.errors import ErrorCode, StorageStatus
from pegasus_tpu_torch.utils import perf_context as perf
from pegasus_tpu_torch.utils.flags import FLAGS, define_flag
from pegasus_tpu_torch.utils.latency_tracer import LatencyTracer, SlowQueryLog
from pegasus_tpu_torch.utils.metrics import METRICS
from pegasus_tpu_torch.utils.token_bucket import parse_throttle_env
from pegasus_tpu_torch.utils.tracing import current_span

define_flag("pegasus.server", "scan_pushdown_enabled", True,
            "evaluate GetScannerRequest.pushdown specs (value filters and "
            "aggregates) inside the scan-page path; off, a spec is ignored "
            "and pushdown_applied stays False (a pre-pushdown server)",
            mutable=True)

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

# absent-from-the-location-cache sentinel (None is a cached "absent")
_POINT_MISS = object()

# node-wide twin of the per-partition bloom counter (the same relaxed
# counter the sstable's solo path ticks: the registry dedupes by name)
_STORAGE_BLOOM_USEFUL = METRICS.entity(
    "storage", "node").relaxed_counter("bloom_useful_count")
# requests bounced for routing under a stale partition count (the
# ERR_PARENT_PARTITION_MISUSED hash gate)
_SPLIT_FENCE_REJECTS = METRICS.entity(
    "storage", "node").counter("split_fence_reject_count")

# point_stats key -> the partition metric it reads
_POINT_STAT_METRICS = {"bloom_pruned": "bloom_useful_count",
                       "phash_pruned": "phash_useful_count",
                       "phash_located": "phash_located_count",
                       "row_cache_hit": "row_cache_hit",
                       "row_cache_miss": "row_cache_miss"}
# mask_routes key -> the partition metric it reads
_MASK_ROUTE_METRICS = {"encoded": "mask_route_encoded_count",
                       "device_raw": "mask_route_device_raw_count",
                       "device_malformed":
                           "mask_route_device_malformed_count"}


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
        # this partition's metric entity: every counter below, the CU
        # calculator's, and the read-latency window
        self.metrics = METRICS.entity(
            "replica", f"{app_id}.{pidx}",
            {"table": str(app_id), "partition": str(pidx)})
        self.cu = CapacityUnitCalculator(self.metrics)
        # nanosecond time source of the range-read time budget: None is
        # the wall perf_counter_ns; a stub under a simulated loop sets
        # its virtual clock here
        self.clock_ns = None
        # expired records a read met and did not serve
        self._abnormal_reads = self.metrics.counter("abnormal_read_count")
        # the batched point-read path's counters, incremented once a
        # flush (node-wide twins on the "storage" entity): keys the bloom
        # filters and the perfect-hash indexes pruned, keys the indexes
        # located, row-cache hits and misses
        self._bloom_useful = self.metrics.counter("bloom_useful_count")
        self._phash_useful = self.metrics.counter("phash_useful_count")
        self._phash_located = self.metrics.counter("phash_located_count")
        self._row_cache_hits = self.metrics.counter("row_cache_hit")
        self._row_cache_misses = self.metrics.counter("row_cache_miss")
        # follower-read counters, incremented by the hosting stub's
        # consistency gate (node-wide twins on the "storage" entity):
        # reads this secondary answered, reads it bounced
        # ERR_STALE_REPLICA, and the bounces a lapsed beacon lease caused
        self._follower_reads = self.metrics.counter("follower_read_count")
        self._stale_bounces = self.metrics.counter("stale_bounce_count")
        self._lease_rejects = self.metrics.counter(
            "read_lease_reject_count")
        # where first-touch static masks of planned blocks were computed:
        # on the host from the encoded form, or on the device for a block
        # of a raw run or an encoded block with malformed rows
        self._mask_routes = {k: self.metrics.counter(name)
                             for k, name in _MASK_ROUTE_METRICS.items()}
        # resident index memory, bloom against phash bytes, refreshed
        # whenever the probe structures rebuild (the run set changed)
        self._index_bloom_bytes = self.metrics.gauge("index_bloom_bytes")
        self._index_phash_bytes = self.metrics.gauge("index_phash_bytes")
        # slow-read dumps: replica.slow_query_threshold_ms sets the
        # threshold
        self.slow_log = SlowQueryLog()
        self._scan_log_key = f"scan_batch.{app_id}.{pidx}"
        self._get_log_key = f"point_get_batch.{app_id}.{pidx}"
        self._read_latency = self.metrics.percentile("read_latency_ms")
        # on-demand hotkey detection (hotkey_collector.h:93): the request
        # stream feeds capture while a detection runs
        self.hotkey_collectors = {"read": HotkeyCollector(),
                                  "write": HotkeyCollector()}
        # the partition's workload shape: op mix, batch and value sizes,
        # scan selectivity, hot-hashkey share
        self.workload = WorkloadStats(app_id, pidx, self.hotkey_collectors)
        self.write_service.workload = self.workload
        # point_stats, mask_routes and abnormal_read_count count from
        # this server's start (the entity is shared by every server of
        # this (app, pidx) in the process)
        self._stat_base = (self._counts(_POINT_STAT_METRICS),
                           self._counts(_MASK_ROUTE_METRICS),
                           self._abnormal_reads.value())
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
        # pushdown value-filter masks: (ckey, value filter) -> bool[count]
        self._vmask_cache: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._vmask_cache_cap = 8192
        # (store, generation, {key -> location}): the batched point-read
        # path's per-generation location cache
        self._point_cache = None
        # (store, generation, phash flag, bloom MultiProbe, columns,
        # PHashMultiProbe, columns): the run set's sidecars prepared for
        # the one-call batched probes
        self._index_probe_cache = None
        # per-table dynamic app-envs (src/common/replica_envs.h:39-83),
        # set through update_app_envs; the compaction filter's context
        self.app_envs: dict = {}
        self._default_ttl = 0
        self._compaction_rules = None   # compiled rules_filter
        # request gates: "", "all", "read" or "write" denied, and the
        # (delay bucket, reject bucket) of each throttle, or None
        self._deny_client = ""
        self._write_throttle = None
        self._read_throttle = None
        self._usage_scenario = "normal"
        # env-triggered manual compaction: the newest trigger seen, and
        # whether a run is in flight
        self._mc_trigger_seen = 0
        self._mc_running = False
        # external publish subscribers (the resident image,
        # parallel/mesh_resident.py): called at the end of
        # _on_store_publish, after the server's own cache eviction; an
        # engine swap keeps them, since lsm.on_publish always points here
        self.publish_listeners: list = []
        self.install_engine(self.engine)

    def _counts(self, names: dict) -> dict:
        return {k: self.metrics.counter(name).value()
                for k, name in names.items()}

    @property
    def abnormal_read_count(self) -> int:
        """Expired records reads met and did not serve, since this
        server started."""
        return self._abnormal_reads.value() - self._stat_base[2]

    @property
    def point_stats(self) -> dict:
        """The batched point-read counters since this server started,
        read from the partition's metric entity."""
        base = self._stat_base[0]
        return {k: v - base[k]
                for k, v in self._counts(_POINT_STAT_METRICS).items()}

    @property
    def mask_routes(self) -> dict:
        """First-touch static masks of planned blocks by route, since
        this server started."""
        base = self._stat_base[1]
        return {k: v - base[k]
                for k, v in self._counts(_MASK_ROUTE_METRICS).items()}

    def install_engine(self, engine: StorageEngine) -> None:
        """Wire a storage engine into this server: write service,
        auto-compaction filter context, and the store publish hook that
        keeps the serving caches from pinning dead runs."""
        self.engine = engine
        ws = getattr(self, "write_service", None)
        if ws is not None:
            ws.engine = engine
        # auto-compaction runs with THIS partition's filter context (TTL
        # + stale-split + user rules), as every rocksdb compaction runs
        # the filter in the reference
        engine.auto_compact_ctx = lambda: {
            "default_ttl": self._default_ttl,
            "pidx": self.pidx,
            "partition_version": self.partition_version,
            "validate_hash": self.validate_partition_hash,
            "rules_filter": self._compaction_rules,
        }
        engine.lsm.on_publish = self._on_store_publish
        # write-through row-cache invalidation, before the write is acked
        engine.on_write_keys = self._invalidate_rows
        ROW_CACHE.invalidate_gid((self.app_id, self.pidx))

    def _invalidate_rows(self, keys) -> None:
        lsm = self.engine.lsm
        ROW_CACHE.invalidate((self.app_id, self.pidx), lsm.store_uid,
                             lsm.generation, keys)

    def _on_store_publish(self, live_paths: set) -> None:
        """Compaction publish: drop cache entries of runs that left. Warm
        flavours survive: the prefresher evaluates the new blocks."""
        with self._mask_lock:
            for mkey in [k for k in self._mask_cache
                         if k[0][0] not in live_paths]:
                del self._mask_cache[mkey]
            for vkey in [k for k in self._vmask_cache
                         if k[0][0] not in live_paths]:
                del self._vmask_cache[vkey]
            for ckey in [k for k in self._device_block_cache
                         if k[0] not in live_paths]:
                del self._device_block_cache[ckey]
        # per-second and per-generation caches: rebound wholesale (cheap
        # to rebuild, and safe against a concurrent reader)
        self._live_cache = {}
        self._plan_cache = None
        self._point_cache = None
        self._plan_expired_cache = (None, {})
        ROW_CACHE.invalidate_gid((self.app_id, self.pidx))
        for fn in list(self.publish_listeners):
            fn(live_paths)

    # env key -> (derived attribute, default): when a FULL env set
    # arrives, a previously set key now absent resets to its default
    _ENV_DEFAULTS = {
        "replica.deny_client_request": ("_deny_client", ""),
        "replica.write_throttling": ("_write_throttle", None),
        "replica.read_throttling": ("_read_throttle", None),
        "default_ttl": ("_default_ttl", 0),
        "rocksdb.usage_scenario": ("_usage_scenario", "normal"),
        "user_specified_compaction": ("_compaction_rules", None),
        "replica.slow_query_threshold_ms": ("_slow_threshold_ms", 20.0),
    }
    def update_app_envs(self, envs: dict, full_set: bool = False) -> None:
        """Apply per-table dynamic settings: `default_ttl`,
        `user_specified_compaction`, `manual_compact.once.trigger_time`,
        `replica.deny_client_request` (the value after its last `*`),
        `replica.{write,read}_throttling`, `rocksdb.usage_scenario` and
        `replica.slow_query_threshold_ms` (the slow log's). Validation is
        two-phase: every value parses first, then everything applies — a
        malformed env never leaves half-applied state.

        `full_set=True`: `envs` is the table's complete env map, so keys
        set before and absent now reset to their defaults."""
        staged = []
        if full_set:
            for key, (attr, dflt) in self._ENV_DEFAULTS.items():
                if key in self.app_envs and key not in envs:
                    staged.append((attr, dflt))
        for key, value in envs.items():
            try:
                if key == "replica.deny_client_request":
                    staged.append(("_deny_client",
                                   value.split("*")[-1] if value else ""))
                elif key == "replica.write_throttling":
                    staged.append(("_write_throttle",
                                   parse_throttle_env(value)))
                elif key == "replica.read_throttling":
                    staged.append(("_read_throttle",
                                   parse_throttle_env(value)))
                elif key == "default_ttl":
                    staged.append(("_default_ttl", int(value)))
                elif key == "user_specified_compaction":
                    staged.append((
                        "_compaction_rules",
                        compile_rules(value, device=self.device)
                        if value else None))
                elif key == "manual_compact.once.trigger_time":
                    # unix seconds (`date +%s`) or pegasus-epoch seconds,
                    # normalized to the pegasus epoch
                    ts = int(value) if value else 0
                    if ts > PEGASUS_EPOCH_BEGIN:
                        ts -= PEGASUS_EPOCH_BEGIN
                    staged.append(("_mc_once_trigger", ts))
                elif key == "replica.slow_query_threshold_ms":
                    staged.append(("_slow_threshold_ms", float(value)))
                elif key == "rocksdb.usage_scenario":
                    if value not in ("normal", "prefer_write", "bulk_load"):
                        raise ValueError("unknown scenario")
                    staged.append(("_usage_scenario", value))
            except Exception as exc:
                raise ValueError(f"invalid app-env {key}={value!r}: {exc}") \
                    from exc
        for attr, parsed in staged:
            if attr == "_slow_threshold_ms":
                self.slow_log.threshold_ms = parsed
            elif attr == "_mc_once_trigger":
                self._maybe_start_manual_compact(parsed)
            elif attr == "_usage_scenario":
                self._apply_usage_scenario(parsed)
            else:
                setattr(self, attr, parsed)
        if full_set:
            self.app_envs = dict(envs)
        else:
            self.app_envs.update(envs)

    def _maybe_start_manual_compact(self, trigger_ts: int) -> None:
        """Env-driven manual compaction (pegasus_manual_compact_service,
        the `manual_compact.once.trigger_time` env): a trigger newer than
        the last one seen starts one asynchronous full compaction;
        re-deliveries of the same value are idempotent, and a trigger
        arriving while a run is in flight is absorbed. A trigger older
        than the store's recorded compaction finish time is already
        satisfied. A trigger the cluster stagger denies is deferred, not
        consumed, so its re-delivery tries again.

        The compaction runs on its own thread: manual_compact merges off
        the write lock from an immutable snapshot and revalidates the run
        set at publish, so serving continues meanwhile."""
        if trigger_ts <= 0 or trigger_ts <= self._mc_trigger_seen:
            return
        if trigger_ts <= self.engine.lsm.compact_finish_time:
            self._mc_trigger_seen = trigger_ts
            return
        if self._mc_running:
            self._mc_trigger_seen = trigger_ts
            return
        if not GOVERNOR.heavy_allowed():
            GOVERNOR.note_deferred()
            return
        self._mc_trigger_seen = trigger_ts
        self._mc_running = True
        GOVERNOR.begin_heavy()

        def run() -> None:
            try:
                # a recent trigger doubles as the table-shared filter
                # timestamp, so sibling partitions filter under identical
                # params; a stale or skewed one falls back to the clock
                shared_now = (trigger_ts
                              if abs(epoch_now() - trigger_ts) <= 600
                              else None)
                self.manual_compact(now=shared_now)
            finally:
                self._mc_running = False
                GOVERNOR.end_heavy()

        threading.Thread(
            target=run, daemon=True,
            name=f"manual-compact-{self.app_id}.{self.pidx}").start()

    def _apply_usage_scenario(self, scenario: str) -> None:
        """The usage-scenario tuning (pegasus_server_impl.cpp:1758): normal
        serves balanced; prefer_write buffers more before flushing;
        bulk_load buffers most and defers auto-compaction until the load
        ends. bulk_load leaves the L0 trigger as it was."""
        self._usage_scenario = scenario
        eng = self.engine
        if scenario == "normal":
            eng.memtable_flush_trigger = 100_000
            eng.auto_compact = True
            eng.lsm._l0_trigger = 4
        elif scenario == "prefer_write":
            eng.memtable_flush_trigger = 250_000
            eng.auto_compact = True
            eng.lsm._l0_trigger = 8
        else:  # bulk_load
            eng.memtable_flush_trigger = 500_000
            eng.auto_compact = False

    def _gate(self, bucket, denied: bool) -> int:
        """The deny and throttle gate (replica_2pc.cpp:117-207,
        replica_throttle.cpp): a denied request, or one a reject-mode
        throttle refuses, is TryAgain; a delay-mode throttle over its
        budget sleeps (at most 0.1 s) and serves."""
        if denied:
            return int(StorageStatus.TRY_AGAIN)
        if bucket is not None:
            delay_b, reject_b = bucket
            if reject_b is not None and not reject_b.try_consume():
                return int(StorageStatus.TRY_AGAIN)
            if reject_b is None and delay_b is not None:
                wait = delay_b.consume_or_delay()
                if wait > 0:
                    time.sleep(min(wait, 0.1))
        return int(StorageStatus.OK)

    def _write_gate(self) -> int:
        return self._gate(self._write_throttle,
                          self._deny_client in ("all", "write"))

    def _read_gate(self) -> int:
        return self._gate(self._read_throttle,
                          self._deny_client in ("all", "read"))

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
            _SPLIT_FENCE_REJECTS.increment()
            return int(ErrorCode.ERR_PARENT_PARTITION_MISUSED)
        return 0

    # ---- write handlers ----------------------------------------------

    def on_put(self, key: bytes, user_data: bytes, ttl_seconds: int = 0,
               decree: Optional[int] = None,
               partition_hash: Optional[int] = None) -> int:
        gate = self._write_gate()
        if gate:
            return gate
        hc = self.hotkey_collectors["write"]
        if hc.state.value != "stopped":
            hc.capture([restore_key(key)[0]])
        with self._write_lock:
            gate = self._hash_gate(partition_hash)
            if gate:
                return gate
            d = self._next_decree() if decree is None else decree
            self.cu.add_write(len(key) + len(user_data))
            return self.write_service.put(key, user_data,
                                          expire_ts_from_ttl(ttl_seconds), d)

    def on_remove(self, key: bytes, decree: Optional[int] = None,
                  partition_hash: Optional[int] = None) -> int:
        gate = self._write_gate()
        if gate:
            return gate
        with self._write_lock:
            gate = self._hash_gate(partition_hash)
            if gate:
                return gate
            d = self._next_decree() if decree is None else decree
            self.cu.add_write(len(key))
            return self.write_service.remove(key, d)

    def on_multi_put(self, req: MultiPutRequest,
                     decree: Optional[int] = None,
                     partition_hash: Optional[int] = None) -> int:
        gate = self._write_gate()
        if gate:
            return gate
        with self._write_lock:
            gate = self._hash_gate(partition_hash)
            if gate:
                return gate
            d = self._next_decree() if decree is None else decree
            self.cu.add_write(sum(len(kv.key) + len(kv.value)
                                  for kv in req.kvs) + len(req.hash_key))
            return self.write_service.multi_put(req, d)

    def on_multi_remove(self, req: MultiRemoveRequest,
                        decree: Optional[int] = None,
                        partition_hash: Optional[int] = None
                        ) -> Tuple[int, int]:
        gate = self._write_gate()
        if gate:
            return gate, 0
        with self._write_lock:
            gate = self._hash_gate(partition_hash)
            if gate:
                return gate, 0
            d = self._next_decree() if decree is None else decree
            self.cu.add_write(len(req.hash_key)
                              + sum(len(sk) for sk in req.sort_keys))
            return self.write_service.multi_remove(req, d)

    def _atomic_write(self, fused, resp_type, req, decree, partition_hash,
                      cu_size: int):
        """The gates of incr / check_and_set / check_and_mutate in the
        reference's order (write gate, then the hash gate under the write
        lock), then the bill of `cu_size` bytes and the fused
        translate-and-apply."""
        gate = self._write_gate()
        if gate:
            return resp_type(error=gate)
        with self._write_lock:
            gate = self._hash_gate(partition_hash)
            if gate:
                return resp_type(error=gate)
            d = self._next_decree() if decree is None else decree
            self.cu.add_write(cu_size)
            return fused(req, d)

    def on_incr(self, req: IncrRequest,
                decree: Optional[int] = None,
                partition_hash: Optional[int] = None) -> IncrResponse:
        return self._atomic_write(self.write_service.incr, IncrResponse,
                                  req, decree, partition_hash, len(req.key))

    def on_check_and_set(self, req: CheckAndSetRequest,
                         decree: Optional[int] = None,
                         partition_hash: Optional[int] = None
                         ) -> CheckAndSetResponse:
        return self._atomic_write(
            self.write_service.check_and_set, CheckAndSetResponse, req,
            decree, partition_hash,
            len(req.hash_key) + len(req.set_sort_key) + len(req.set_value))

    def on_check_and_mutate(self, req: CheckAndMutateRequest,
                            decree: Optional[int] = None,
                            partition_hash: Optional[int] = None
                            ) -> CheckAndMutateResponse:
        return self._atomic_write(
            self.write_service.check_and_mutate, CheckAndMutateResponse, req,
            decree, partition_hash,
            len(req.hash_key) + sum(len(m.sort_key) + len(m.value)
                                    for m in req.mutate_list))

    # ---- point reads --------------------------------------------------

    def on_get(self, key: bytes,
               partition_hash: Optional[int] = None) -> Tuple[int, bytes]:
        """Parity: on_get (pegasus_server_impl.cpp:418): expired records
        are NotFound and counted as abnormal reads. The solo path fills
        the same PerfContext fields as the batched one (LSMStore.get and
        SSTable.get tick the ambient context), and the slow log's
        observe_simple attaches it."""
        hc = self.hotkey_collectors["read"]
        if hc.state.value != "stopped":
            hc.capture([restore_key(key)[0]])
        gate = self._read_gate() or self._hash_gate(partition_hash)
        if gate:
            return gate, b""
        pc = perf.current()
        if pc is None:
            pc = perf.start("point_get")
        t0 = time.perf_counter()
        with perf.activate(pc):
            now = epoch_now()
            hit = self.engine.get(key)
            status = int(StorageStatus.OK)
            data = b""
            if hit is None:
                status = int(StorageStatus.NOT_FOUND)
            else:
                value, ets = hit
                if check_if_ts_expired(now, ets):
                    self._abnormal_reads.increment()
                    if pc is not None:
                        pc.expired_rows += 1
                    status = int(StorageStatus.NOT_FOUND)
                else:
                    data = extract_user_data(self.data_version, value)
                    self.cu.add_read(len(key) + len(data))
            if pc is not None:
                pc.ops += 1
                pc.keys_resolved += 1
                pc.rows_evaluated += 1
                pc.placement = pc.placement or "native"
                if status == int(StorageStatus.OK):
                    pc.rows_survived += 1
                    pc.bytes_returned += len(key) + len(data)
                sp = current_span()
                if sp is not None:
                    perf.merge_span_perf(sp.tags, pc)
            self.workload.note_point(1, 1, [len(data)] if data else ())
            self.slow_log.observe_simple(
                f"point_get.{self.app_id}.{self.pidx}",
                (time.perf_counter() - t0) * 1000.0)
        return status, data

    def on_ttl(self, key: bytes,
               partition_hash: Optional[int] = None) -> Tuple[int, int]:
        """(error, ttl seconds), -1 for no TTL (parity on_ttl:1092)."""
        gate = self._read_gate() or self._hash_gate(partition_hash)
        if gate:
            return gate, 0
        now = epoch_now()
        hit = self.engine.get(key)
        if hit is None:
            return int(StorageStatus.NOT_FOUND), 0
        _, ets = hit
        if check_if_ts_expired(now, ets):
            self._abnormal_reads.increment()
            return int(StorageStatus.NOT_FOUND), 0
        return int(StorageStatus.OK), (ets - now) if ets > 0 else -1

    def on_batch_get(self, req: BatchGetRequest) -> BatchGetResponse:
        """Parity: on_batch_get (pegasus_server_impl.cpp:906). After a
        split, a key this partition no longer owns rejects the whole batch
        (the client grouped it under the old partition count)."""
        gate = self._read_gate()
        if gate:
            return BatchGetResponse(error=gate)
        if self.validate_partition_hash:
            for fk in req.keys:
                h = key_hash_parts(fk.hash_key, fk.sort_key)
                if (h & self.partition_version) != self.pidx:
                    return BatchGetResponse(
                        error=int(ErrorCode.ERR_PARENT_PARTITION_MISUSED))
        now = epoch_now()
        resp = BatchGetResponse()
        size = 0
        for fk in req.keys:
            key = generate_key(fk.hash_key, fk.sort_key)
            hit = self.engine.get(key)
            if hit is None:
                continue
            value, ets = hit
            if check_if_ts_expired(now, ets):
                self._abnormal_reads.increment()
                continue
            data = extract_user_data(self.data_version, value)
            resp.data.append(FullData(fk.hash_key, fk.sort_key, data))
            size += len(key) + len(data)
        self.cu.add_read(size)
        return resp

    def on_multi_get(self, req: MultiGetRequest) -> MultiGetResponse:
        """Parity: on_multi_get (pegasus_server_impl.cpp:496), under the
        op's PerfContext and the slow log."""
        self.hotkey_collectors["read"].capture([req.hash_key])
        t0 = time.perf_counter()
        pc = perf.current()
        if pc is None:
            pc = perf.start("multi_get")
        try:
            with perf.activate(pc):
                resp = self._on_multi_get(req)
                if pc is not None:
                    pc.ops += 1
                    pc.rows_survived += len(resp.kvs)
                    pc.placement = pc.placement or "native"
                    sp = current_span()
                    if sp is not None:
                        perf.merge_span_perf(sp.tags, pc)
                return resp
        finally:
            elapsed_ms = (time.perf_counter() - t0) * 1000.0
            self._read_latency.set(elapsed_ms)
            with perf.activate(pc):
                self.slow_log.observe_simple(
                    f"multi_get.{self.app_id}.{self.pidx}", elapsed_ms,
                    {"hash_key": req.hash_key.decode(errors="replace")})

    def _on_multi_get(self, req: MultiGetRequest) -> MultiGetResponse:
        gate = self._read_gate()
        if gate:
            resp = MultiGetResponse()
            resp.error = gate
            return resp
        now = epoch_now()
        resp = MultiGetResponse()
        if not req.hash_key:
            resp.error = int(StorageStatus.INVALID_ARGUMENT)
            return resp

        # explicit sort keys -> point lookups (reference uses DB::MultiGet)
        if req.sort_keys:
            size = 0
            for sk in req.sort_keys:
                hit = self.engine.get(generate_key(req.hash_key, sk))
                if hit is None:
                    continue
                value, ets = hit
                if check_if_ts_expired(now, ets):
                    self._abnormal_reads.increment()
                    continue
                data = (b"" if req.no_value
                        else extract_user_data(self.data_version, value))
                resp.kvs.append(KeyValue(sk, data))
                size += len(sk) + len(data)
            self.cu.add_read(size)
            self.workload.note_point(1, len(req.sort_keys),
                                     [len(kv.value) for kv in resp.kvs[:8]])
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

        limiter = RangeReadLimiter(clock_ns=self.clock_ns)
        records, exhausted, resume_key = self._batched_scan(
            start_key, stop_key or None, now,
            FilterSpec.none(self.device),
            FilterSpec.make(req.sort_key_filter_type,
                            req.sort_key_filter_pattern, self.device),
            validate_hash=False, limiter=limiter,
            max_records=req.max_kv_count, max_bytes=req.max_kv_size,
            reverse=req.reverse, with_values=not req.no_value)
        size = 0
        for key, data, _ets in records:
            sk = restore_key(key)[1]
            resp.kvs.append(KeyValue(sk, data))
            size += len(sk) + len(data)
        if req.reverse:
            resp.kvs.reverse()  # response is ascending by sort key
        self.cu.add_read(size)
        # range-mode multi_get is a ranged read: its examined-vs-returned
        # ratio feeds the scan selectivity profile
        self.workload.note_scan(1, limiter.iteration_count, len(records))
        resp.error = (int(StorageStatus.OK) if exhausted
                      else int(StorageStatus.INCOMPLETE))
        if not exhausted and not req.reverse and resume_key is not None:
            resp.resume_sort_key = restore_key(resume_key)[1]
        return resp

    def on_sortkey_count(self, hash_key: bytes) -> Tuple[int, int]:
        """Parity: on_sortkey_count (pegasus_server_impl.cpp:1018): the
        live records under a hash key, INCOMPLETE past the range-read
        budget."""
        gate = self._read_gate()
        if gate:
            return gate, 0
        stop_key = generate_next_bytes(hash_key)
        records, exhausted, _ = self._batched_scan(
            generate_key(hash_key, b""), stop_key or None, epoch_now(),
            FilterSpec.none(self.device), FilterSpec.none(self.device),
            validate_hash=False,
            limiter=RangeReadLimiter(clock_ns=self.clock_ns),
            max_records=-1, max_bytes=-1, with_values=False)
        if not exhausted:
            return int(StorageStatus.INCOMPLETE), len(records)
        return int(StorageStatus.OK), len(records)

    # ---- batched point reads: a flush of get / ttl / multi_get(sort
    # keys) / batch_get resolves overlay hits on the host, locates base
    # keys through the per-generation location cache and the run set's
    # sidecars, gathers co-located values with one native call per
    # block; plan / point_chunks / finish split so that the node-level
    # read coordinator can stack the gathers across partitions ---------

    POINT_CACHE_CAP = 65536
    # keys in one op before its blocks go through the native page gather
    # (the co-located multi_get / batch_get shape); below it a direct
    # heap slice a row beats the per-chunk ctypes call
    POINT_GATHER_MIN = 16

    def on_point_read_batch(self, ops) -> list:
        """Solo-node form of the batched point-read path. `ops`:
        [(op, args, partition_hash)] with op in get / ttl / multi_get
        (explicit sort keys) / batch_get; one result per op, equal to the
        corresponding single-request handler's."""
        return self.serve_get_batch(self.plan_get_batch(ops))

    def serve_get_batch(self, state) -> list:
        """Phases 2 and 3 for one partition: gather this batch's
        co-located values (one native call per block) and assemble the
        responses."""
        chunks = self.point_chunks(state)
        pg = None
        if chunks:
            pg, _size, _last = page.build_page(
                chunks, header_length(self.data_version))
        return self.finish_get_batch(state, pg, 0)

    def plan_get_batch(self, ops, now: Optional[int] = None) -> dict:
        """Phase 1: gates, key decomposition and location.

        Per-op gates replicate the solo handlers (per-key split staleness
        for batch_get, batched through host_key_hash_lo). Unique keys
        resolve once: the row cache, then the overlay (memtable before
        runs), then the location cache, then one sidecar probe of the
        flush's disk-bound keys and batched block probes. A publish
        racing the plan (generation moved) re-resolves every key through
        the per-key safe order and caches nothing.

        A PerfContext rides the flush: ambient while planning, so the
        storage layer's block and sidecar hooks tick it, and kept in the
        state for finish_get_batch; an outer ambient context (explain)
        is reused instead."""
        pc = perf.current()
        if pc is None:
            pc = perf.start("point_get_batch")
        with perf.activate(pc):
            return self._plan_get_batch_inner(ops, now, pc)

    def _plan_get_batch_inner(self, ops, now, ppc) -> dict:
        t0 = time.perf_counter()
        # the batched read's stage chain: the slow log shows where a read
        # stalled, and the stages annotate the active trace span
        tracer = LatencyTracer(self._get_log_key)
        tracer.perf = ppc
        now = epoch_now() if now is None else now
        lsm = self.engine.lsm
        gen = lsm.generation  # read before the overlay and run snapshots
        results: list = [None] * len(ops)
        op_keys: list = [None] * len(ops)
        probes: List[Tuple[bytes, bool]] = []
        capture_hks: list = []
        wide = False  # any op wide enough for the native gather path
        hc = self.hotkey_collectors["read"]
        hc_running = hc.state.value != "stopped"
        for i, (op, args, ph) in enumerate(ops):
            if op in ("get", "ttl"):
                gate = self._read_gate() or self._hash_gate(ph)
                if gate:
                    results[i] = (gate, b"") if op == "get" else (gate, 0)
                    continue
                if op == "get" and hc_running:
                    capture_hks.append(restore_key(args)[0])
                op_keys[i] = (args,)
                probes.append((args, op == "get"))
            elif op == "multi_get":
                capture_hks.append(args.hash_key)
                gate = self._read_gate() or self._hash_gate(ph)
                if gate:
                    resp = MultiGetResponse()
                    resp.error = gate
                    results[i] = resp
                    continue
                if not args.hash_key:
                    resp = MultiGetResponse()
                    resp.error = int(StorageStatus.INVALID_ARGUMENT)
                    results[i] = resp
                    continue
                keys = tuple(generate_key(args.hash_key, sk)
                             for sk in args.sort_keys)
                op_keys[i] = keys
                want = not args.no_value
                if want and len(keys) >= self.POINT_GATHER_MIN:
                    wide = True
                probes.extend((k, want) for k in keys)
            elif op == "batch_get":
                gate = self._read_gate()
                if gate:
                    resp = BatchGetResponse()
                    resp.error = gate
                    results[i] = resp
                    continue
                if self.validate_partition_hash and args.keys:
                    # per-key staleness gate, one vectorized crc pass
                    lo = host_key_hash_lo(
                        [fk.hash_key for fk in args.keys],
                        [fk.sort_key for fk in args.keys])
                    pv = np.uint32(self.partition_version & 0xFFFFFFFF)
                    if np.any((lo & pv) != np.uint32(self.pidx)):
                        resp = BatchGetResponse()
                        resp.error = int(
                            ErrorCode.ERR_PARENT_PARTITION_MISUSED)
                        results[i] = resp
                        continue
                keys = tuple(generate_key(fk.hash_key, fk.sort_key)
                             for fk in args.keys)
                op_keys[i] = keys
                if len(keys) >= self.POINT_GATHER_MIN:
                    wide = True
                probes.extend((k, True) for k in keys)
            else:
                raise ValueError(f"unknown point-read op {op!r}")
        if capture_hks:
            hc.capture(capture_hks)
        tracer.add_point("plan")

        memget = lsm.memtable.get
        l0 = lsm.l0
        runs = lsm.l1_runs
        pc = self._point_cache
        if pc is None or pc[0] is not lsm or pc[1] != gen:
            pc = self._point_cache = (lsm, gen, {})
        loc_cache = pc[2]
        gid = (self.app_id, self.pidx)
        suid = lsm.store_uid
        rc = ROW_CACHE
        rc_on = rc.enabled
        # the invalidation epoch observed before any LSM read: admission
        # hands it back, and the cache refuses the rows if a write or a
        # publish invalidated this partition in between
        rc_epoch = rc.epoch(gid) if rc_on else 0
        rc_hits = rc_misses = 0
        rc_cached = None
        if rc_on and probes:
            ukeys = list(dict.fromkeys(k for k, _nv in probes))
            rc_cached = rc.get_many(gid, suid, gen, ukeys)
            rc_hits = len(rc_cached)
            rc_misses = len(ukeys) - rc_hits
        uniq: dict = {}
        base_pending: list = []  # missed the row cache and the overlay
        ov_hits = 0
        for key, _nv in probes:
            if key in uniq:
                continue
            if rc_cached is not None:
                ent = rc_cached.get(key)
                if ent is not None:
                    uniq[key] = ("ov", ent[0], ent[1])
                    continue
            hit = memget(key)
            if hit is not None:
                ov_hits += 1
                uniq[key] = (None if hit[0] is TOMBSTONE
                             else ("ov", hit[0], hit[1]))
                continue
            uniq[key] = None  # placeholder until base resolution
            base_pending.append(key)

        # the disk-bound residue: one full-key hash pass feeds both
        # sidecar probes, one native bloom call for filter-only tables and
        # one native perfect-hash call for indexed tables, answering the
        # whole (key x L0 table / L1 run) candidacy and location matrix
        # before any block is decoded
        probe = None   # (matrix bytes, {id(table) -> col}, {key -> base})
        pprobe = None  # (loc memoryview, hit bytes, cols, probe, rows)
        bloom_useful = 0
        useful_box = [0, 0]  # [phash-pruned, phash-located]
        want_phash = phash_probe_enabled()
        if base_pending and (bloom_probe_enabled() or want_phash):
            mp, cols, pp, pcols = self._index_probes(lsm, gen, want_phash)
            if (mp is not None and bloom_probe_enabled()) or pp is not None:
                from pegasus_tpu_torch.ops.predicates import bloom_key_hashes

                hashes = bloom_key_hashes(base_pending)
                key_row = {k: i for i, k in enumerate(base_pending)}
            if mp is not None and bloom_probe_enabled():
                mat = mp.probe(hashes)
                nfil = mp.n
                probe = (mat, cols,
                         {k: i * nfil for i, k in enumerate(base_pending)})
            tracer.add_point("bloom")
            if pp is not None:
                pmat, pmask = pp.probe(hashes)
                pprobe = (pmat, pmask, pcols, pp, key_row)
            tracer.add_point("phash_probe")
        else:
            tracer.add_point("bloom")
            tracer.add_point("phash_probe")
        pending = base_pending
        if pending and l0:
            pending, bloom_useful = self._probe_l0(
                l0, pending, probe, uniq, pprobe, useful_box)
        if pending:
            still = []
            for key in pending:
                ent = loc_cache.get(key, _POINT_MISS)
                if ent is not _POINT_MISS:
                    uniq[key] = ent
                else:
                    still.append(key)
            pending = still
        if pending:
            bloom_useful += self._locate_points(runs, pending, uniq, probe,
                                                pprobe, useful_box)
        if lsm.generation != gen:
            # a flush or compaction published mid-plan: re-resolve every
            # key through the per-key safe order and cache nothing
            for key in list(uniq):
                hit = lsm.get(key)
                uniq[key] = (None if hit is None
                             else ("ov", hit[0], hit[1]))
        else:
            if pending and self._point_cache is pc:
                for key in pending:
                    loc_cache[key] = uniq[key]
                while len(loc_cache) > self.POINT_CACHE_CAP:
                    loc_cache.pop(next(iter(loc_cache)))
            if rc_on and base_pending:
                self._maybe_admit_rows(rc, gid, suid, gen, rc_epoch,
                                       base_pending, uniq, hc)
        phash_useful = useful_box[0]
        if bloom_useful:
            self._bloom_useful.increment(bloom_useful)
            _STORAGE_BLOOM_USEFUL.increment(bloom_useful)
        if phash_useful:
            self._phash_useful.increment(phash_useful)
            PHASH_USEFUL.increment(phash_useful)
        if useful_box[1]:
            self._phash_located.increment(useful_box[1])
            PHASH_HIT.increment(useful_box[1])
        if rc_hits:
            self._row_cache_hits.increment(rc_hits)
        if rc_misses:
            self._row_cache_misses.increment(rc_misses)
        if ppc is not None:
            # the flush's cost vector, one attribute pass a plan (block
            # and byte counts ticked ambient by the storage layer)
            ppc.ops += len(ops)
            ppc.keys_resolved += len(uniq)
            ppc.overlay_hits += ov_hits
            ppc.runs_considered += len(l0) + len(runs)
            ppc.bloom_pruned += bloom_useful
            ppc.phash_pruned += phash_useful
            ppc.phash_located += useful_box[1]
            ppc.row_cache_hit += rc_hits
            ppc.row_cache_miss += rc_misses
            # point reads are host work, never a device round-trip
            ppc.placement = ppc.placement or "native"
        tracer.add_point("block_probe")
        return {"ops": ops, "results": results, "op_keys": op_keys,
                "uniq": uniq, "now": now, "t0": t0, "wide": wide,
                "tracer": tracer, "perf": ppc}

    def _index_probes(self, lsm, gen: int, want_phash: bool):
        """The run set's sidecars prepared for the one-call batched
        probes: (bloom MultiProbe, {id(table) -> filter column},
        PHashMultiProbe, {id(table) -> index column}). With phash probing
        on, indexed tables are left out of the bloom probe: the perfect
        hash answers candidacy and location in one gather. Rebuilt once
        per store generation; the rebuild sets the index memory gauges."""
        c = self._index_probe_cache
        if c is not None and c[0] is lsm and c[1] == gen \
                and c[2] == want_phash:
            return c[3], c[4], c[5], c[6]
        filters = []
        cols: dict = {}
        indexes = []
        pcols: dict = {}
        bloom_bytes = phash_bytes = 0
        for t in list(lsm.l0) + list(lsm.l1_runs):
            if t.bloom is not None:
                bloom_bytes += t.bloom.bits.nbytes
            if t.phash is not None:
                phash_bytes += t.phash.mem_bytes()
            if want_phash and t.phash is not None:
                pcols[id(t)] = len(indexes)
                indexes.append(t.phash)
            elif t.bloom is not None:
                cols[id(t)] = len(filters)
                filters.append(t.bloom)
        mp = MultiProbe(filters) if filters else None
        pp = PHashMultiProbe(indexes) if indexes else None
        self._index_bloom_bytes.set(bloom_bytes)
        self._index_phash_bytes.set(phash_bytes)
        self._index_probe_cache = (lsm, gen, want_phash, mp, cols, pp, pcols)
        return mp, cols, pp, pcols

    def _probe_l0(self, l0, keys: list, probe, uniq: dict,
                  pprobe=None, useful_box=None) -> Tuple[list, int]:
        """Resolve `keys` through the L0 tables newest first (the first
        table hit wins, the solo-get order). A 0 bloom cell or a 0
        perfect-hash mask cell is a definitive absent with no block
        touched; a located cell reads its (block, slot) row directly, one
        row compare rejecting a fingerprint collision. Tables with
        neither structure gate on their key fences. Returns (unresolved
        keys, bloom-pruned count); perfect-hash pruned and located counts
        accumulate into `useful_box`."""
        useful = 0
        p_useful = 0
        p_hits = 0
        if probe is not None:
            mat, cols, key_row = probe
        else:
            mat = cols = key_row = None
        if pprobe is not None:
            pmat, pmask, pcols, pp, pkey_row = pprobe
            npt = pp.n
        else:
            pmat = pmask = pcols = pp = pkey_row = None
            npt = 0
        pairs = [(t, cols.get(id(t)) if cols is not None else None,
                  pcols.get(id(t)) if pcols is not None else None,
                  t.phash.slot_bits if t.phash is not None else 0)
                 for t in l0]
        out_keys = []
        for k in keys:
            row = key_row[k] if key_row is not None else 0
            prow = pkey_row[k] * npt if pkey_row is not None else 0
            resolved = False
            for table, col, pcol, sb in pairs:
                if pcol is not None:
                    cell = prow + pcol
                    if not pmask[cell]:
                        p_useful += 1
                        continue
                    loc = pmat[cell]
                    bi = loc >> sb
                    slot = loc & ((1 << sb) - 1)
                    if bi >= len(table.blocks) \
                            or slot >= table.blocks[bi].count:
                        h = table.get(k)  # corrupt loc: the bisect path
                    else:
                        blk = table.read_block(bi)
                        if blk.key_at(slot) != k:
                            p_useful += 1  # collision: absent here
                            continue
                        p_hits += 1
                        h = ((None, 0) if blk.is_tombstone(slot)
                             else (blk.value_at(slot),
                                   int(blk.expire_ts[slot])))
                elif col is not None:
                    if not mat[row + col]:
                        useful += 1
                        continue
                    h = table.get(k)
                else:
                    fk = table.first_key
                    if fk is None or k < fk or k > table.last_key:
                        continue
                    h = table.get(k)
                if h is not None:
                    uniq[k] = (None if h[0] is None
                               else ("ov", h[0], h[1]))
                    resolved = True
                    break
            if not resolved:
                out_keys.append(k)
        if useful_box is not None:
            useful_box[0] += p_useful
            useful_box[1] += p_hits
        return out_keys, useful

    def _maybe_admit_rows(self, rc, gid, suid: int, gen: int, epoch: int,
                          keys: list, uniq: dict, hc) -> None:
        """Offer this flush's base-resolved rows (L0/L1 hits) to the node
        row cache; admission is repeat-gated inside the cache, a finished
        hotkey detection fast-admits its hashkey, and `epoch` voids it if
        a write invalidated this partition since planning began."""
        cands = [k for k in keys if uniq.get(k)]
        if not cands:
            return  # absent and tombstoned rows are never cached
        hot = hc.hot_hash_key()
        fast = ()
        if hot is not None:
            fast = {k for k in cands if restore_key(k)[0] == hot}
        granted = rc.note_and_check_many(gid, cands, fast)
        if not granted:
            return
        items = []
        for key in granted:
            ent = uniq[key]
            if ent[0] == "ov":
                value, ets = ent[1], int(ent[2])
            else:
                _t, blk, row = ent
                value = blk.value_at(row)
                ets = int(blk.expire_ts[row])
            items.append((key, value, ets))
        rc.admit_many(gid, suid, gen, items, epoch=epoch)

    def _locate_points(self, runs, keys: list, out: dict,
                       probe=None, pprobe=None, useful_box=None) -> int:
        """Batch-locate keys in the non-overlapping L1 runs: bisect each
        key to its run, then answer its candidacy from the flush's
        sidecar matrices. An indexed run answers candidacy and location
        in one cell (a located row is verified by one vectorized compare
        per touched block, ops.predicates.phash_verify_rows); filter-only
        runs keep the bloom cell, bisect and probe_rows; runs with
        neither bisect. out[key] = ("l1", blk, row) | None. Returns the
        bloom-pruned count."""
        if not runs:
            for key in keys:
                out[key] = None
            return 0
        if probe is not None:
            mat, cols, key_row = probe
        else:
            mat = cols = key_row = None
        if pprobe is not None:
            pmat, pmask, pcols, pp, pkey_row = pprobe
            npt = pp.n
        else:
            pmat = pmask = pcols = pp = pkey_row = None
            npt = 0
        run_last = [r.last_key or b"" for r in runs]
        by_run: "OrderedDict[int, list]" = OrderedDict()
        for key in keys:
            ri = bisect.bisect_left(run_last, key)
            if ri >= len(runs) or (runs[ri].first_key or b"") > key:
                out[key] = None
                continue
            by_run.setdefault(ri, []).append(key)
        useful = 0
        p_useful = 0
        by_block: "OrderedDict[tuple, list]" = OrderedDict()
        by_slot: "OrderedDict[tuple, list]" = OrderedDict()
        for ri, ks in by_run.items():
            run = runs[ri]
            pcol = pcols.get(id(run)) if pcols is not None else None
            if pcol is not None:
                sb = run.phash.slot_bits
                sm = (1 << sb) - 1
                nblocks = len(run.blocks)
                blocks = run.blocks
                for k in ks:
                    cell = pkey_row[k] * npt + pcol
                    if not pmask[cell]:
                        p_useful += 1
                        out[k] = None
                        continue
                    loc = pmat[cell]
                    bi = loc >> sb
                    slot = loc & sm
                    if bi >= nblocks or slot >= blocks[bi].count:
                        # corrupt loc: this key takes the bisect path
                        bj = run._block_for_key(k)
                        if bj is None:
                            out[k] = None
                        else:
                            by_block.setdefault((ri, bj), []).append(k)
                        continue
                    by_slot.setdefault((ri, bi), []).append((k, slot))
                continue
            col = cols.get(id(run)) if cols is not None else None
            if col is not None:
                kept = []
                for k in ks:
                    if mat[key_row[k] + col]:
                        kept.append(k)
                    else:
                        useful += 1
                        out[k] = None
                ks = kept
            for key in ks:
                bi = run._block_for_key(key)
                if bi is None:
                    out[key] = None
                    continue
                by_block.setdefault((ri, bi), []).append(key)
        if by_slot:
            from pegasus_tpu_torch.ops.predicates import phash_verify_rows
        for (ri, bi), pairs in by_slot.items():
            blk = runs[ri].read_block(bi)
            rows = np.fromiter((s for _k, s in pairs), dtype=np.int64,
                               count=len(pairs))
            ok = phash_verify_rows(blk.keys, blk.key_len, rows,
                                   [k for k, _s in pairs])
            verified = 0
            for (key, slot), good in zip(pairs, ok):
                if not good:
                    p_useful += 1  # fingerprint collision: absent
                    out[key] = None
                    continue
                verified += 1
                if blk.is_tombstone(slot):
                    out[key] = None
                else:
                    out[key] = ("l1", blk, slot)
            if useful_box is not None:
                useful_box[1] += verified
        for (ri, bi), ks in by_block.items():
            blk = runs[ri].read_block(bi)
            for key, row in zip(ks, page.probe_rows(blk, ks)):
                row = int(row)
                if row < 0 or blk.is_tombstone(row):
                    out[key] = None
                else:
                    out[key] = ("l1", blk, row)
        if useful_box is not None:
            useful_box[0] += p_useful
        return useful

    def point_chunks(self, state) -> list:
        """Phase 2: this batch's L1 value-gather work as [(blk, ascending
        rows)] chunks for one page.build_page call. Only alive rows that
        a wide op wants the value of are gathered; the node-level
        coordinator concatenates these chunks across partitions."""
        if not state["wide"]:
            state["page_pos"] = {}
            state["chunk_rows"] = 0
            return []
        now = state["now"]
        uniq = state["uniq"]
        gmin = self.POINT_GATHER_MIN
        by_block: "OrderedDict[int, list]" = OrderedDict()
        blocks: dict = {}
        seen: set = set()
        for i, (op, args, _ph) in enumerate(state["ops"]):
            keys = state["op_keys"][i]
            if (state["results"][i] is not None or keys is None
                    or len(keys) < gmin or op == "ttl"
                    or (op == "multi_get" and args.no_value)):
                continue
            for key in keys:
                if key in seen:
                    continue
                seen.add(key)
                ent = uniq.get(key)
                if not ent or ent[0] != "l1":
                    continue
                _tag, blk, row = ent
                if not blk.alive_mask(now)[row]:
                    continue  # expired rows are never gathered
                bid = id(blk)
                blocks[bid] = blk
                by_block.setdefault(bid, []).append((row, key))
        chunks = []
        pos = 0
        page_pos: dict = {}
        for bid, entries in by_block.items():
            entries.sort()
            rows = np.fromiter((r for r, _k in entries), dtype=np.int64,
                               count=len(entries))
            for j, (_r, key) in enumerate(entries):
                page_pos[key] = pos + j
            chunks.append((blocks[bid], rows))
            pos += len(entries)
        state["page_pos"] = page_pos
        state["chunk_rows"] = pos
        return chunks

    def finish_get_batch(self, state, pg=None, base: int = 0) -> list:
        """Phase 3: per-op responses equal to the solo handlers', with the
        flush's expired, CU and workload accounting batched. `pg` /
        `base`: the (possibly cross-partition) build_page result and this
        state's first row in it."""
        with perf.activate(state.get("perf")):
            return self._finish_get_batch_inner(state, pg, base)

    def _finish_get_batch_inner(self, state, pg, base: int) -> list:
        ops = state["ops"]
        results = state["results"]
        op_keys = state["op_keys"]
        uniq = state["uniq"]
        now = state["now"]
        tracer = state.get("tracer")
        if tracer is not None:
            # the (possibly cross-partition) value gather ran between the
            # phases
            tracer.add_point("decode")
        page_pos = state.get("page_pos") or {}
        dv = self.data_version
        hdr = header_length(dv)
        expired_total = 0
        cu_total = 0
        looked = 0
        survived = 0
        bytes_out = 0
        vsizes: list = []  # a bounded value-size sample (workload stats)

        def lookup(key, want_value):
            """(found, data, ets) with solo-handler TTL semantics."""
            nonlocal expired_total, looked
            looked += 1
            ent = uniq.get(key)
            if ent is None:
                return False, b"", 0
            if ent[0] == "ov":
                _t, value, ets = ent
                if check_if_ts_expired(now, ets):
                    expired_total += 1
                    return False, b"", 0
                return True, (extract_user_data(dv, value)
                              if want_value else b""), ets
            _t, blk, row = ent
            # a block whose alive mask the scan path built for this
            # second answers from one cell of it
            cmp = blk._cmp
            ets = int(blk.expire_ts[row])
            if cmp is not None and cmp[0] == now:
                alive = bool(cmp[1][row])
            else:
                alive = not check_if_ts_expired(now, ets)
            if not alive:
                expired_total += 1
                return False, b"", 0
            if not want_value:
                return True, b"", ets
            pos = page_pos.get(key)
            if pos is not None:
                return True, pg.value_at(base + pos), ets
            # sparse block: a direct header-stripped heap slice
            vo = blk.value_offs
            heap = blk.value_heap
            v0 = int(vo[row]) + hdr
            v1 = int(vo[row + 1])
            data = (heap[v0:v1].tobytes()
                    if isinstance(heap, np.ndarray) else heap[v0:v1])
            return True, data, ets

        out = []
        for i, (op, args, _ph) in enumerate(ops):
            if results[i] is not None:
                out.append(results[i])
                continue
            if op == "get":
                key = op_keys[i][0]
                found, data, _ets = lookup(key, True)
                if not found:
                    out.append((int(StorageStatus.NOT_FOUND), b""))
                else:
                    survived += 1
                    bytes_out += len(key) + len(data)
                    if len(vsizes) < 8:
                        vsizes.append(len(data))
                    cu_total += cu_units(len(key) + len(data))
                    out.append((int(StorageStatus.OK), data))
            elif op == "ttl":
                found, _data, ets = lookup(op_keys[i][0], False)
                if not found:
                    out.append((int(StorageStatus.NOT_FOUND), 0))
                else:
                    survived += 1
                    out.append((int(StorageStatus.OK),
                                (ets - now) if ets > 0 else -1))
            elif op == "multi_get":
                resp = MultiGetResponse()
                want = not args.no_value
                size = 0
                for sk, key in zip(args.sort_keys, op_keys[i]):
                    found, data, _ets = lookup(key, want)
                    if not found:
                        continue
                    survived += 1
                    if len(vsizes) < 8:
                        vsizes.append(len(data))
                    resp.kvs.append(KeyValue(sk, data))
                    size += len(sk) + len(data)
                cu_total += cu_units(size)
                bytes_out += size
                resp.error = int(StorageStatus.OK)
                out.append(resp)
            else:  # batch_get
                resp = BatchGetResponse()
                size = 0
                for fk, key in zip(args.keys, op_keys[i]):
                    found, data, _ets = lookup(key, True)
                    if not found:
                        continue
                    survived += 1
                    if len(vsizes) < 8:
                        vsizes.append(len(data))
                    resp.data.append(FullData(fk.hash_key, fk.sort_key,
                                              data))
                    size += len(key) + len(data)
                cu_total += cu_units(size)
                bytes_out += size
                out.append(resp)
        if expired_total:
            self._abnormal_reads.increment(expired_total)
        self.cu.add_read_units(cu_total)
        self.workload.note_point(len(ops), len(uniq), vsizes)
        pc = state.get("perf")
        if pc is not None:
            pc.rows_evaluated += looked
            pc.rows_survived += survived
            pc.expired_rows += expired_total
            pc.bytes_returned += bytes_out
            sp = tracer.span if tracer is not None else None
            if sp is not None:
                # merged, not assigned: a carrier span collects every
                # partition's flush vector
                perf.merge_span_perf(sp.tags, pc)
        elapsed_ms = (time.perf_counter() - state["t0"]) * 1000.0
        self._read_latency.set(elapsed_ms)
        if tracer is not None:
            tracer.add_point("finish")
            self.slow_log.observe(tracer,
                                  {"ops": len(ops), "keys": len(uniq)})
        elif elapsed_ms >= self.slow_log.threshold_ms:
            self.slow_log.observe_simple(
                self._get_log_key, elapsed_ms,
                {"ops": len(ops), "keys": len(uniq)})
        return out

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
        value_filter=None,
        pd_stats=None,
    ) -> Tuple[List[Tuple[bytes, bytes, int]], bool, Optional[bytes]]:
        """Core ranged read. Returns (records, exhausted, resume_key):
        (key, user_data, expire_ts) triples passing every predicate,
        whether the range completed, and where a follow-up continues.
        `value_filter`: a pushdown value predicate (type, pattern) ANDed
        into the keep mask; `pd_stats["pruned"]` counts the rows it
        rejected."""
        sorted_runs = None if reverse else self.engine.lsm.sorted_runs()
        if sorted_runs is not None:
            return self._columnar_scan(sorted_runs, start_key, stop_key,
                                       now, hash_filter, sort_filter,
                                       validate_hash, limiter, max_records,
                                       max_bytes, with_values,
                                       value_filter, pd_stats)

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
                if value_filter is not None:
                    ud = extract_user_data(self.data_version, value)
                    if not host_match_filter(ud, value_filter[0],
                                             value_filter[1]):
                        if pd_stats is not None:
                            pd_stats["pruned"] = \
                                pd_stats.get("pruned", 0) + 1
                        continue
                    data = ud if with_values else b""
                else:
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
        value_filter=None,
        pd_stats=None,
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
            for (ckey, blk, lo, hi), static_keep in zip(window, keeps):
                n = blk.count
                ets = blk.expire_ts
                alive = host_alive_mask(ets, now)
                expired = int(np.count_nonzero(~alive[lo:hi]))
                if expired:
                    self._abnormal_reads.increment(expired)
                keep = static_keep[:n] & alive
                if value_filter is not None:
                    # the pushdown value leg joins the mask algebra,
                    # cached per (block, pattern) like the static keep
                    vmask = self._value_mask(ckey, blk, value_filter)
                    before = int(np.count_nonzero(keep[lo:hi]))
                    keep = keep & vmask[:n]
                    if pd_stats is not None:
                        pd_stats["pruned"] = (
                            pd_stats.get("pruned", 0) + before
                            - int(np.count_nonzero(keep[lo:hi])))
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
            # the reference's reject-all gate still counts the expired
            expired = sum(1 for b in batch if check_if_ts_expired(now, b[2]))
            if expired:
                self._abnormal_reads.increment(expired)
            return np.zeros(len(batch), dtype=bool)
        block = build_record_block([b[0] for b in batch],
                                   [b[2] for b in batch],
                                   device=self.device)
        status = scan_table([block], [self.pidx], hash_filter, sort_filter,
                            validate_hash, self.partition_version,
                            now=now).cpu().numpy()
        expired = int(np.count_nonzero(status == STATUS_EXPIRED))
        if expired:
            self._abnormal_reads.increment(expired)
        return status == STATUS_KEEP

    # ---- scanners -----------------------------------------------------

    def on_get_scanner(self, req: GetScannerRequest) -> ScanResponse:
        """Parity: on_get_scanner (pegasus_server_impl.cpp:1151)."""
        gate = self._read_gate()
        if gate:
            resp = ScanResponse()
            resp.error = gate
            return resp
        start_key = req.start_key or b""
        if start_key and not req.start_inclusive:
            start_key = _after(start_key)
        stop_key = req.stop_key or b""
        if stop_key and req.stop_inclusive:
            stop_key = _after(stop_key)
        return self._serve_scan_batch(req, start_key, stop_key)

    def on_scan(self, context_id: int) -> ScanResponse:
        """Parity: on_scan (pegasus_server_impl.cpp:1399)."""
        gate = self._read_gate()
        if gate:
            resp = ScanResponse()
            resp.error = gate
            return resp
        ctx = self._scan_cache.take(context_id)
        if ctx is None:
            resp = ScanResponse()
            resp.error = int(StorageStatus.NOT_FOUND)
            resp.context_id = SCAN_CONTEXT_ID_NOT_EXIST
            return resp
        return self._serve_scan_batch(ctx.request, ctx.resume_key,
                                      ctx.stop_key, agg_state=ctx.agg_state)

    def on_clear_scanner(self, context_id: int) -> None:
        self._scan_cache.remove(context_id)

    # ---- scan pushdown (ops/pushdown.py) ------------------------------

    def _pushdown_of(self, req: GetScannerRequest):
        """The request's PushdownSpec when this server evaluates it, else
        None: no spec, an empty one, or the `scan_pushdown_enabled` kill
        switch off (the spec is ignored, pushdown_applied stays False and
        the client evaluates locally)."""
        spec = req.pushdown
        if spec is None:
            return None
        if not FLAGS.get("pegasus.server", "scan_pushdown_enabled"):
            return None
        spec.check()  # ValueError on a malformed spec
        if spec.value_filter is None and not spec.aggregate:
            return None
        return spec

    def _value_mask(self, ckey, blk, vf) -> np.ndarray:
        """bool[count] value-filter keep mask of one SST block, cached per
        (block, filter). Reading blk.value_heap inflates a lazy
        compressed heap, which the filter needs anyway."""
        vkey = (ckey, vf)
        with self._mask_lock:
            hit = self._vmask_cache.get(vkey)
            if hit is not None:
                self._vmask_cache.move_to_end(vkey)
                return hit
        heap = blk.value_heap
        t0 = time.perf_counter()
        mask = pushdown_ops.value_filter_mask(
            heap, blk.value_offs, header_length(self.data_version), vf[0],
            vf[1])
        # the host mask's wall time; the placement cost model (and its
        # prediction) arrives with ops/placement.py
        measured = time.perf_counter() - t0
        pc = perf.current()
        if pc is not None:
            pc.measured_kernel_ms += measured * 1000.0
            pc.placement = pc.placement or "numpy"
        with self._mask_lock:
            self._vmask_cache[vkey] = mask
            while len(self._vmask_cache) > self._vmask_cache_cap:
                self._vmask_cache.popitem(last=False)
        return mask

    def _serve_scan_batch(self, req: GetScannerRequest, start_key: bytes,
                          stop_key: bytes, agg_state=None) -> ScanResponse:
        """One scan page, under the page's PerfContext and stage chain
        (plan, block_scan, assemble), which the slow log observes."""
        t0 = time.perf_counter()
        tracer = LatencyTracer(f"scan.{self.app_id}.{self.pidx}")
        pc = perf.current()
        if pc is None:
            pc = perf.start("scan_page")
        tracer.perf = pc
        try:
            with perf.activate(pc):
                return self._serve_scan_batch_inner(req, start_key,
                                                    stop_key, tracer,
                                                    agg_state)
        finally:
            elapsed_ms = (time.perf_counter() - t0) * 1000.0
            self._read_latency.set(elapsed_ms)
            sp = tracer.span
            if pc is not None and sp is not None:
                perf.merge_span_perf(sp.tags, pc)
            self.slow_log.observe(tracer)

    def _serve_scan_batch_inner(self, req: GetScannerRequest,
                                start_key: bytes, stop_key: bytes,
                                tracer, agg_state=None) -> ScanResponse:
        """One scan page. A pushdown value filter prunes rows inside the
        page; an aggregate folds them into a partial
        (_pushdown_aggregate_page)."""
        pd = self._pushdown_of(req)
        if pd is not None and pd.aggregate:
            return self._pushdown_aggregate_page(req, pd, start_key,
                                                 stop_key, tracer, agg_state)
        vf = pd.value_filter if pd is not None else None
        pd_stats: dict = {}
        now = epoch_now()
        resp = ScanResponse()
        limiter = RangeReadLimiter(clock_ns=self.clock_ns)
        batch_size = min(req.batch_size if req.batch_size > 0 else 1000,
                         SCAN_BATCH_CAP)
        if req.only_return_count:
            batch_size = -1  # count the whole (limiter-bounded) range
        tracer.add_point("plan")
        records, exhausted, resume_key = self._batched_scan(
            start_key, stop_key or None, now,
            FilterSpec.make(req.hash_key_filter_type,
                            req.hash_key_filter_pattern, self.device),
            FilterSpec.make(req.sort_key_filter_type,
                            req.sort_key_filter_pattern, self.device),
            validate_hash=(req.validate_partition_hash
                           and self.validate_partition_hash),
            limiter=limiter, max_records=batch_size,
            max_bytes=-1 if req.only_return_count else SCAN_BYTES_CAP,
            with_values=not req.no_value and not req.only_return_count,
            value_filter=vf, pd_stats=pd_stats)
        tracer.add_point("block_scan")
        if pd is not None:
            tracer.add_point("pushdown")
        if req.only_return_count:
            resp.kv_count = len(records)
        else:
            size = 0
            for key, data, ets in records:
                kv = KeyValue(key, data)
                if req.return_expire_ts:
                    kv.expire_ts_seconds = ets
                resp.kvs.append(kv)
                size += len(key) + len(data)
            self.cu.add_read(size)
        tracer.add_point("assemble")
        pruned = pd_stats.get("pruned", 0)
        pc = tracer.perf
        if pc is not None:
            pc.ops += 1
            pc.rows_evaluated += limiter.iteration_count
            pc.rows_survived += len(records)
            pc.keys_resolved += len(records)
            pc.bytes_returned += sum(len(k) + len(d)
                                     for k, d, _e in records)
            pc.pushdown_rows_pruned += pruned
        self.workload.note_scan(1, limiter.iteration_count, len(records))
        if pd is not None:
            self.workload.note_pushdown(1, pruned, 0)
            resp.pushdown_applied = True
        resp.error = int(StorageStatus.OK)
        if exhausted or req.one_page:
            # one_page: the client promised not to page further
            resp.context_id = SCAN_CONTEXT_ID_COMPLETED
        else:
            resp.context_id = self._scan_cache.put(ScanContext(
                request=req, resume_key=resume_key or start_key,
                stop_key=stop_key))
        return resp

    def _pushdown_aggregate_page(self, req: GetScannerRequest, pd,
                                 start_key: bytes, stop_key: bytes,
                                 tracer, agg_state=None) -> ScanResponse:
        """Aggregate-mode pushdown: fold one (limiter-bounded) slice of the
        range into the partition's partial aggregate instead of returning
        rows. The partial rides in the scan context across pages and
        ships only on the final page. On a fully compacted store the
        survivors of the cached static masks and the host TTL mask fold
        columnar; otherwise the merged records fold row by row."""
        now = epoch_now()
        resp = ScanResponse()
        limiter = RangeReadLimiter(clock_ns=self.clock_ns)
        vf = pd.value_filter
        pd_stats: dict = {}
        state = (agg_state if agg_state is not None
                 else pushdown_ops.AggState(pd))
        folded0 = state.count
        hash_filter = FilterSpec.make(req.hash_key_filter_type,
                                      req.hash_key_filter_pattern,
                                      self.device)
        sort_filter = FilterSpec.make(req.sort_key_filter_type,
                                      req.sort_key_filter_pattern,
                                      self.device)
        validate = bool(req.validate_partition_hash
                        and self.validate_partition_hash)
        hdr = header_length(self.data_version)
        stop = stop_key or None
        tracer.add_point("plan")
        exhausted = True
        resume_key: Optional[bytes] = None
        sorted_runs = self.engine.lsm.sorted_runs()
        if sorted_runs is not None:
            filter_key = hash_filter.key + sort_filter.key
            with self._mask_lock:
                self._register_flavor(validate, filter_key,
                                      time.monotonic())

            # the resident arm: a fresh whole-range aggregate on an
            # attached table folds off the table-wide round (count and
            # sum from its per-partition counts and lanes, top_k and
            # sample from its mask through the same AggState fold). A
            # decline (paging budget, overlay, stale slab, the placement
            # gate) falls through to the host arm unchanged.
            if agg_state is None and not start_key and stop is None:
                from pegasus_tpu_torch.parallel.mesh_resident import (
                    MESH_SERVING,
                )

                mesh = (MESH_SERVING.try_aggregate(
                            self, req, pd, validate, filter_key, now)
                        if MESH_SERVING.enabled else None)
                if mesh is not None:
                    return self._mesh_aggregate_page(resp, mesh, tracer)

            def ranged_blocks():
                for run in sorted_runs:
                    if stop is not None and (run.first_key or b"") >= stop:
                        continue
                    if start_key and (run.last_key or b"") < start_key:
                        continue
                    for bm_blk in run.iter_blocks(start_key, stop):
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
                    if stop is not None and bm.last_key >= stop:
                        hi = blk.lower_bound(stop)
                    limiter.add_count(hi - lo)
                    window.append(((run.path, bm.offset), blk, lo, hi))
                if not window:
                    break
                keeps = self._static_keep_window(window, validate,
                                                 filter_key)
                for (ckey, blk, lo, hi), static_keep in zip(window, keeps):
                    n = blk.count
                    alive = host_alive_mask(blk.expire_ts, now)
                    expired = int(np.count_nonzero(~alive[lo:hi]))
                    if expired:
                        self._abnormal_reads.increment(expired)
                    keep = static_keep[:n] & alive
                    if vf is not None:
                        vmask = self._value_mask(ckey, blk, vf)
                        before = int(np.count_nonzero(keep[lo:hi]))
                        keep = keep & vmask[:n]
                        pd_stats["pruned"] = (
                            pd_stats.get("pruned", 0) + before
                            - int(np.count_nonzero(keep[lo:hi])))
                    sel = np.flatnonzero(keep[lo:hi]) + lo
                    if sel.size:
                        if pd.aggregate == "count":
                            state.fold_columnar(sel)
                        else:
                            state.fold_columnar(
                                sel, heap=blk.value_heap,
                                value_offs=blk.value_offs, hdr=hdr,
                                key_at=blk.key_at)
                    if not limiter.valid():
                        resume_key = _after(blk.key_at(n - 1))
                        exhausted = False
                        stopped = True
                        break
        else:
            # the iterator merge already applies newest-wins shadowing
            # and tombstones, so row folds over its survivors are exact
            records, exhausted, resume_key = self._batched_scan(
                start_key, stop, now, hash_filter, sort_filter, validate,
                limiter, max_records=-1, max_bytes=-1,
                with_values=(pd.aggregate != "count"), value_filter=vf,
                pd_stats=pd_stats)
            for key, data, _ets in records:
                state.fold_row(key, data)
        tracer.add_point("block_scan")
        tracer.add_point("pushdown")
        folded = state.count - folded0
        pruned = pd_stats.get("pruned", 0)
        pc = tracer.perf
        if pc is not None:
            pc.ops += 1
            pc.rows_evaluated += limiter.iteration_count
            pc.rows_survived += folded
            pc.keys_resolved += folded
            pc.rows_aggregated += folded
            pc.pushdown_rows_pruned += pruned
            pc.placement = pc.placement or "numpy"
        self.workload.note_scan(1, limiter.iteration_count, folded)
        self.workload.note_pushdown(1, pruned, folded)
        resp.pushdown_applied = True
        resp.error = int(StorageStatus.OK)
        if exhausted or req.one_page:
            resp.context_id = SCAN_CONTEXT_ID_COMPLETED
            resp.agg = state.to_wire()
        else:
            # not final: no partial on the wire; it continues here under
            # a fresh context id
            resp.context_id = self._scan_cache.put(ScanContext(
                request=req, resume_key=resume_key or start_key,
                stop_key=stop_key, agg_state=state))
        tracer.add_point("assemble")
        return resp

    def _mesh_aggregate_page(self, resp: ScanResponse, mesh: dict,
                             tracer) -> ScanResponse:
        """The final (only) page of an aggregate the resident image
        answered (MESH_SERVING.try_aggregate's result `mesh`)."""
        state = mesh["agg_state"]
        if mesh["expired"]:
            self._abnormal_reads.increment(mesh["expired"])
        tracer.add_point("block_scan")
        tracer.add_point("pushdown")
        folded = mesh["folded"]
        pruned = mesh["pruned"]
        pc = tracer.perf
        if pc is not None:
            pc.ops += 1
            pc.rows_evaluated += mesh["rows_evaluated"]
            pc.rows_survived += folded
            pc.keys_resolved += folded
            pc.rows_aggregated += folded
            pc.pushdown_rows_pruned += pruned
            pc.placement = "mesh"
            pc.mesh_partitions += mesh["partitions"]
            pc.mesh_wave_ms += mesh["wave_ms"]
            pc.predicted_kernel_ms += mesh["predicted_ms"]
            pc.measured_kernel_ms += mesh["measured_ms"]
        self.workload.note_scan(1, mesh["rows_evaluated"], folded)
        self.workload.note_pushdown(1, pruned, folded)
        resp.pushdown_applied = True
        resp.error = int(StorageStatus.OK)
        resp.context_id = SCAN_CONTEXT_ID_COMPLETED
        resp.agg = state.to_wire()
        tracer.add_point("assemble")
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
        validate flag, one key filter, one pushdown value filter, no
        count-only request and no pushdown aggregate. Each unique block the batch touches gets one static
        mask evaluation in its lifetime; per-request boundary trimming
        happens on the host against the cached mask. Anything else is
        served request by request (partition_server.py:2480 of the JAX
        package)."""
        state = self.plan_scan_batch(reqs)
        if state is None:
            return [self.on_get_scanner(r) for r in reqs]
        if "precomputed" in state:  # the read gate refused the batch
            return state["precomputed"]
        keep_masks = self.eval_planned_masks(state)
        return self.finish_scan_batch(state, keep_masks)

    def plan_scan_batch(self, reqs: List[GetScannerRequest],
                        now: Optional[int] = None, flavor=None):
        """Phase 1: qualify the batch and plan each request's blocks.
        None: the caller serves per request; {"precomputed": responses}:
        the read gate refused the batch (one gate a batch, as the JAX
        package's :2524). `flavor` is the (validate, filter_key) the
        caller already grouped by (scan_coordinator), which skips the
        per-request re-derivation. The flush's PerfContext is created (or
        adopted from an ambient one: explain) here and rides the state
        through the mask-evaluation and finish phases."""
        pc = perf.current()
        if pc is None:
            pc = perf.start("scan_batch")
        with perf.activate(pc):
            return self._plan_scan_batch_inner(reqs, now, flavor, pc)

    def _plan_scan_batch_inner(self, reqs: List[GetScannerRequest], now,
                               flavor, ppc):
        t0 = time.perf_counter()
        tracer = LatencyTracer(self._scan_log_key)
        tracer.perf = ppc
        gate = self._read_gate()
        if gate:
            out = []
            for _r in reqs:
                resp = ScanResponse()
                resp.error = gate
                out.append(resp)
            return {"precomputed": out, "t0": t0}
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
        # pushdown on the batched path: one shared value filter rides the
        # live-mask machinery (it is part of the live-cache key);
        # aggregates serve per request (their reply is a partial, not a
        # page), as do batches mixing value filters
        pdl = [self._pushdown_of(r) for r in reqs]
        vfs = {pd.value_filter if pd is not None else None for pd in pdl}
        simple = (runs and overlay_count <= self.OVERLAY_MERGE_LIMIT
                  and len(validates) == 1 and len(filters) == 1
                  and all(f[0] in _KNOWN_FILTERS and f[2] in _KNOWN_FILTERS
                          for f in filters)
                  and not any(r.only_return_count for r in reqs)
                  and len(vfs) == 1
                  and not any(pd is not None and pd.aggregate
                              for pd in pdl))
        if not simple:
            return None
        now = epoch_now() if now is None else now
        validate = validates.pop()
        filter_key = filters.pop()
        vf = vfs.pop()
        overlay = (self._overlay_snapshot(now, validate, filter_key,
                                          value_filter=vf)
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
        tracer.add_point("plan")
        if ppc is not None:
            ppc.ops += len(reqs)
            ppc.blocks_planned += len(unique)
            ppc.runs_considered += len(runs)
        return {"reqs": reqs, "req_plans": req_plans, "unique": unique,
                "validate": validate, "now": now, "overlay": overlay,
                "filter_key": filter_key, "vf": vf, "pd_list": pdl,
                "t0": t0, "tracer": tracer, "perf": ppc}

    def planned_misses(self, state) -> "OrderedDict[tuple, object]":
        """Unique planned blocks whose static masks are not cached: the
        device work left, as ckey -> device block (uploaded here through
        the block cache). The cached masks, and the masks of compressed
        blocks evaluated here on the host from their encoded form, go to
        state["cached_keep"]. Masks are `now`-independent, so a block
        misses only on first touch after a flush or compaction, or for a
        new filter. The batch's flavour is registered for the
        MaskPrefresher."""
        keep_masks = {}
        misses: "OrderedDict[tuple, object]" = OrderedDict()
        validate = state["validate"]
        filter_key = state["filter_key"]
        with self._mask_lock:
            self._register_flavor(validate, filter_key, time.monotonic())
            for ckey, (run, bm, blk) in state["unique"].items():
                mkey = (ckey, self.partition_version, validate,
                        filter_key)
                cached = self._mask_cache.get(mkey)
                if cached is not None:
                    self._mask_cache.move_to_end(mkey)
                    keep_masks[ckey] = cached
                    continue
                misses[ckey] = (run, bm, blk)
        pv = self.partition_version
        routes = self._mask_routes
        encoded = 0
        for ckey, (run, bm, blk) in list(misses.items()):
            # direct compute on compressed blocks: the static keep (hash
            # validation, hashkey and sortkey filters) evaluates on the
            # host against the encoded form, with no device round-trip
            keep, route = self._encoded_static_mask(run, bm, validate,
                                                    filter_key, pv)
            routes[route].increment()
            if keep is not None:
                keep_masks[ckey] = keep
                self.store_mask_for(ckey, validate, filter_key, keep,
                                    computed_pv=pv)
                del misses[ckey]
                encoded += 1
                continue
            misses[ckey] = self._device_cached_block(ckey, blk)
        pc = state.get("perf")
        if pc is not None and encoded:
            # encoded-domain host probes: the "numpy" compute class; a
            # later device wave overwrites it
            pc.placement = "numpy"
        state["cached_keep"] = keep_masks
        return misses

    def _encoded_static_mask(self, run, bm, validate: bool, filter_key,
                             pv: int):
        """(bool[n] static keep | None, route) of one planned block via
        the encoded probe (ops.predicates.encoded_static_keep); None when
        the run is uncompressed or the block holds malformed rows. The
        route names where the mask is computed (see `mask_routes`). A
        run replaced mid-plan still reads: its map outlives the file."""
        if run.codec is None:
            return None, "device_raw"
        enc = run.read_block_encoded(run.block_index(bm))
        keep = encoded_static_keep(enc, validate, self.pidx, pv, filter_key)
        if keep is None:
            return None, "device_malformed"
        return keep, "encoded"

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
        stacked launches, under the state's PerfContext (the wave records
        its placement and measured kernel time there); returns ckey ->
        static keep mask."""
        with perf.activate(state.get("perf")):
            misses = self.planned_misses(state)
            keep_masks = state["cached_keep"]
            for ckey, keep in self._eval_blocks_stacked(
                    misses, state["filter_key"], state["validate"]):
                keep_masks[ckey] = keep
                self.store_mask(state, ckey, keep)
        tracer = state.get("tracer")
        if tracer is not None:
            tracer.add_point("block_probe")
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
        vf = state["vf"]
        live_masks = {}
        live_ptrs = {}
        alive_all = {}
        exp_full = {}
        pushdown_pruned = 0
        cache = self._live_cache
        for ckey, (_run, _bm, blk) in unique.items():
            static = keep_masks[ckey]
            # (block, flavour mask, second) cache: TTL validity is one
            # second, so every batch within it reuses static AND alive;
            # the entry pins the static array it was built from, since
            # id() alone could be a recycled address after an evict
            lkey = (ckey, id(static), vf)
            hit = cache.get(lkey)
            if hit is not None and hit[0] == now and hit[1] is static:
                _now, _st, alive, exp, live, lptr, prn = hit
            else:
                alive = blk.alive_mask(now)
                # whole-block expired count once per unique block;
                # requests spanning the whole block reuse it
                exp = len(alive) - int(np.count_nonzero(alive))
                live = static[:blk.count] & alive
                prn = 0
                if vf is not None:
                    # the shared pushdown value filter joins the live
                    # mask; pruned = key-alive rows the value filter drops
                    before = int(np.count_nonzero(live))
                    live = live & self._value_mask(ckey, blk,
                                                   vf)[:blk.count]
                    prn = before - int(np.count_nonzero(live))
                # .ctypes.data costs ~a µs: once per (block, flavour,
                # second), not per request window
                lptr = live.ctypes.data
                if len(cache) >= 4096:
                    cache.pop(next(iter(cache)))
                cache[lkey] = (now, static, alive, exp, live, lptr, prn)
            pushdown_pruned += prn
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
        state["pushdown_pruned"] = pushdown_pruned
        state["live_masks"] = live_masks
        state["alive_all"] = alive_all
        state["exp_full"] = exp_full
        state["windows"] = windows
        state["fast"] = fast
        tracer = state.get("tracer")
        if tracer is not None:
            if vf is not None:
                tracer.add_point("pushdown")
            tracer.add_point("decode")
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
        total_rows = 0
        total_bytes = 0
        total_read_cu = 0

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
            total_rows += len(kvs)
            total_bytes += size
            # the per-request CU floor: units() a request, summed
            total_read_cu += cu_units(size)
            resp = ScanResponse()
            resp.kvs = kvs
            # pd_list aligns with req_plans; len(out) is this request's
            # index
            resp.pushdown_applied = state["pd_list"][len(out)] is not None
            resp.error = int(StorageStatus.OK)
            if exhausted or req.one_page:
                resp.context_id = SCAN_CONTEXT_ID_COMPLETED
            else:
                resp.context_id = self._scan_cache.put(ScanContext(
                    request=req, resume_key=resume_key or start_key,
                    stop_key=stop_key))
            out.append(resp)
        # the batch's accounting, one counter touch a state
        if total_expired:
            self._abnormal_reads.increment(total_expired)
        self.cu.add_read_units(total_read_cu)
        # mask-evaluated rows: every row of every unique planned block
        # (the masks cover whole blocks); survivors over evaluated is the
        # table's scan selectivity
        unique = state["unique"]
        rows_eval = sum(b.count for _r, _bm, b in unique.values())
        self.workload.note_scan(len(req_plans), rows_eval, total_rows)
        pd_pruned = state.get("pushdown_pruned", 0)
        n_pushdown = sum(1 for pd in state["pd_list"] if pd is not None)
        if n_pushdown:
            self.workload.note_pushdown(n_pushdown, pd_pruned, 0)
        pc = state.get("perf")
        tracer = state.get("tracer")
        if pc is not None:
            pc.rows_evaluated += rows_eval
            pc.rows_survived += total_rows
            pc.expired_rows += total_expired
            pc.bytes_returned += total_bytes
            pc.keys_resolved += total_rows
            pc.pushdown_rows_pruned += pd_pruned
            sp = tracer.span if tracer is not None else None
            if sp is not None:
                perf.merge_span_perf(sp.tags, pc)
        elapsed_ms = (time.perf_counter() - state["t0"]) * 1000.0
        self._read_latency.set(elapsed_ms)
        if tracer is not None:
            tracer.add_point("finish")
            self.slow_log.observe(
                tracer, {"scans": len(req_plans),
                         "unique_blocks": len(unique)})
        return out

    def _overlay_snapshot(self, now: int, validate: bool, filter_key,
                          value_filter=None):
        """(sorted keys, key -> None | (user data, expire_ts)) of the
        memtable + L0 overlay, newest wins, with the scan predicates (TTL,
        stale-split hash, the batch's key filter) evaluated on the host:
        the overlay is small by the fast path's qualifier, so a launch
        would cost more than it filters. A key failing the key filter is
        left out (its base copies fail the same filter in the mask); an
        expired, tombstoned or foreign row stays as a hidden shadow
        (None) that hides the base row of its key, and so does a row the
        pushdown value filter rejects (the base may hold an older value
        of the key that would pass)."""
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
                self._abnormal_reads.increment()
                out[key] = None  # expired: hidden, and shadows the base
                continue
            if validate and not check_key_hash(key, self.pidx,
                                               self.partition_version):
                out[key] = None
                continue
            data = extract_user_data(self.data_version, value)
            if value_filter is not None and not host_match_filter(
                    data, value_filter[0], value_filter[1]):
                out[key] = None  # value-rejected: hidden, still shadows
                continue
            out[key] = (data, ets)
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

    def checkpoint(self, dest_dir: str) -> int:
        """A frozen snapshot under the single-writer lock (the flush and
        the walk of the run set must not interleave with an env-triggered
        compaction's publish)."""
        with self._write_lock:
            return self.engine.checkpoint(dest_dir)

    def update_partition_count(self, new_count: int) -> None:
        """Partition-count flip after a split (parity: the group
        partition-count update in replica_split_manager.h:76-123):
        routing and the ownership predicate follow the new count, so the
        stale half is hidden from every scan at once and dropped by the
        next manual compaction. Static masks are keyed by the
        partition_version they were computed under; the caches that hold
        rows or plans resolved under the old routing are dropped."""
        if new_count < self.partition_count:
            raise ValueError("partition count can only grow")
        self.partition_count = new_count
        self.partition_version = new_count - 1
        self.validate_partition_hash = (
            new_count > 1 and (new_count & (new_count - 1)) == 0)
        self._live_cache = {}
        self._plan_cache = None
        self._point_cache = None
        self._plan_expired_cache = (None, {})
        ROW_CACHE.invalidate_gid((self.app_id, self.pidx))

    def manual_compact(self, default_ttl: Optional[int] = None,
                       rules_filter=None,
                       now: Optional[int] = None) -> None:
        """Parity: pegasus_manual_compact_service (manual CompactRange).
        `default_ttl` and `rules_filter` default to the table's app-envs
        (`default_ttl`, `user_specified_compaction`); `now` pins the
        filter timestamp (epoch_now() inside the engine by default).

        The writer critical section is narrow: the overlay is frozen with
        one flush under _write_lock, the merge runs from that immutable
        snapshot with writes flowing, and _write_lock is retaken only for
        the publish cut-over (with the run-set revalidation of
        lsm._publish_l1). engine.compact_lock serializes compactions; the
        write path's auto-compaction skips its trigger while this runs."""
        if default_ttl is None:
            default_ttl = self._default_ttl
        if rules_filter is None:
            rules_filter = self._compaction_rules
        with self.engine.compact_lock:
            with self._write_lock:
                # post-freeze writes land in the fresh memtable / newer
                # L0s, which the publish leaves untouched
                self.engine.flush()
            self.engine.manual_compact(
                default_ttl=default_ttl, pidx=self.pidx,
                partition_version=self.partition_version,
                validate_hash=self.validate_partition_hash,
                rules_filter=rules_filter, now=now,
                publish_lock=self._write_lock)
