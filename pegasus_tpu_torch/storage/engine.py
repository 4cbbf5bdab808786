"""StorageEngine: WAL + LSM with decree watermark discipline.

Parity: src/server/rocksdb_wrapper.{h,cpp} + src/base/meta_store.{h,cpp} —
every committed write batch carries its decree, so any flushed state knows
exactly which decree it contains:

- write_batch(items, decree): one WAL frame (decree-stamped) + memtable
  apply; last_committed_decree advances.
- flush(): memtable -> L0 SST whose meta records {last_flushed_decree,
  data_version}; the WAL truncates after the SST is durable.
- boot: last_flushed_decree = max over SST metas, then replay WAL frames
  with decree > last_flushed_decree into the memtable.
- manual_compact(): full compaction through the TTL / default-TTL /
  user-rules / stale-split filter evaluated on the engine's device
  (src/server/pegasus_manual_compact_service.h:48): a merge over the
  overlay (ops/compaction.compaction_filter_block per batch), or, for a
  pure-L1 store, the bulk block-level path (_manual_compact_bulk) whose
  masks come from the compaction-filter kernel on the card — or from the
  raw columns on the host for compressed blocks when no ruleset touches
  key bytes, as the JAX package routes them.
- write_batch() flushes a full memtable and auto-compacts a deep L0 with
  the installed filter context (`auto_compact_ctx`).
- checkpoint() / restore_from_checkpoint(): a flushed copy of the SST
  files and manifest, and an engine opened on one (a split's child is a
  checkpoint of its parent); ingest_sst_file() adopts an external SST as
  the newest L0 run under its decree.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from pegasus_tpu_torch.base.value_schema import epoch_now
from pegasus_tpu_torch.ops.compaction import (
    compaction_eval_drain,
    compaction_eval_submit,
    compaction_filter_block,
    encoded_drop_mask,
)
from pegasus_tpu_torch.ops.record_block import build_record_block
from pegasus_tpu_torch.storage.compact_governor import GOVERNOR
from pegasus_tpu_torch.storage.compact_pipeline import (
    CompactPipeline,
    pipeline_depth,
    pipeline_enabled,
    pipeline_window,
    stage_threads_enabled,
    transform_workers,
    window_count,
)
from pegasus_tpu_torch.storage.lsm import LSMStore
from pegasus_tpu_torch.storage.sstable import SSTable, SSTableWriter
from pegasus_tpu_torch.storage.wal import OP_DEL, WalRecord, WriteAheadLog
from pegasus_tpu_torch.utils.device import resolve_device
from pegasus_tpu_torch.utils.metrics import METRICS


def _copy_store_files(src_dir: str, dest_dir: str) -> None:
    """The SST files and the manifest: without the manifest a multi-run
    store would reopen through the legacy newest-L1-wins recovery and
    drop runs."""
    for name in os.listdir(src_dir):
        if name.endswith(".sst") or name == "MANIFEST.json":
            shutil.copy2(os.path.join(src_dir, name),
                         os.path.join(dest_dir, name))


@dataclass
class WriteBatchItem:
    op: int                 # OP_PUT | OP_DEL
    key: bytes
    value: bytes = b""      # full pegasus-encoded value for puts
    expire_ts: int = 0


class StorageEngine:
    def __init__(self, data_dir: str, data_version: int = 1,
                 block_capacity: int = 1024,
                 values_carry_expire_header: bool = False,
                 device=None) -> None:
        self.data_dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        self.data_version = data_version
        # the compaction filter's device: the card unless told otherwise
        self.device = resolve_device(device)
        # the engine's expire_ts column is authoritative; values are
        # opaque here. Servers storing pegasus-encoded values set this so
        # compaction TTL rewrites also patch the embedded header.
        self.values_carry_expire_header = values_carry_expire_header
        self.lsm = LSMStore(os.path.join(data_dir, "sst"),
                            block_capacity=block_capacity)

        # recover the decree watermark from SST metas; data_version comes
        # from the table with the newest watermark
        self.last_flushed_decree = 0
        for table in list(self.lsm.l0) + list(self.lsm.l1_runs):
            d = int(table.meta.get("last_flushed_decree", 0))
            if d >= self.last_flushed_decree and "data_version" in table.meta:
                self.data_version = int(table.meta["data_version"])
            self.last_flushed_decree = max(self.last_flushed_decree, d)
        self.last_committed_decree = self.last_flushed_decree

        # auto-maintenance: a memtable of this many records flushes, and
        # with `auto_compact` the flush that leaves lsm._l0_trigger L0
        # tables compacts (the usage scenario tunes all three)
        self.memtable_flush_trigger = 100_000
        self.auto_compact = True
        self.auto_compact_ctx = None  # the server installs its filter context
        # serializes compactions: the env-triggered manual path holds it
        # across its (unlocked) merge; the write path's auto-compaction
        # try-acquires and skips when a manual run is in flight (blocking
        # there would deadlock write-lock -> compact-lock against the
        # manual path's compact-lock -> write-lock publish ordering)
        self.compact_lock = threading.Lock()
        # flush and compaction event metrics (pegasus_event_listener),
        # under the JAX package's names on this store's "engine" entity;
        # the compaction ones also as attributes, with the last bulk
        # compaction's pipeline (its stall counters)
        ev = METRICS.entity("engine", data_dir, {"dir": data_dir})
        self._ev_flush_count = ev.counter("flush_count")
        self._ev_flush_bytes = ev.counter("flush_bytes")
        self._ev_flush_ms = ev.percentile("flush_duration_ms")
        self._ev_compact_count = ev.counter("compaction_count")
        self._ev_compact_bytes = ev.counter("compaction_bytes")
        self._ev_compact_ms = ev.percentile("compaction_duration_ms")
        self.compact_count = 0
        self.compact_bytes = 0
        self.compact_ms = 0.0  # the last compaction's duration
        self.last_pipeline = None

        # replay WAL beyond the flushed watermark
        self._wal_path = os.path.join(data_dir, "wal.log")
        for decree, records in WriteAheadLog.replay(self._wal_path):
            if decree <= self.last_flushed_decree:
                continue
            for r in records:
                if r.op == OP_DEL:
                    self.lsm.delete(r.key)
                else:
                    self.lsm.put(r.key, r.value, r.expire_ts)
            self.last_committed_decree = max(self.last_committed_decree, decree)
        self.wal = WriteAheadLog(self._wal_path)
        # called with the keys of every applied write batch
        self.on_write_keys = None

    def close(self) -> None:
        self.wal.close()
        self.lsm.close()

    # ---- write path ---------------------------------------------------

    def write_batch(self, items: Sequence[WriteBatchItem], decree: int,
                    sync: bool = False, wal_flush: bool = True) -> None:
        """Apply one decree's mutations atomically (WAL first).
        `wal_flush=False` leaves the WAL frame in the IO buffer instead
        of flushing per decree — only valid under replication, where
        the private log (hardened by the group-commit window before any
        ack) covers everything this WAL could recover."""
        if decree <= self.last_committed_decree:
            raise ValueError(
                f"decree {decree} <= last committed {self.last_committed_decree}")
        self.wal.append_batch(
            decree,
            [WalRecord(i.op, i.key, i.value, i.expire_ts) for i in items],
            sync=sync, flush=wal_flush)
        for i in items:
            if i.op == OP_DEL:
                self.lsm.delete(i.key)
            else:
                self.lsm.put(i.key, i.value, i.expire_ts)
        self.last_committed_decree = decree
        # write-through hook (the node row cache drops these keys before
        # the write is acknowledged)
        hook = self.on_write_keys
        if hook is not None and items:
            hook([i.key for i in items])
        self._maybe_maintain()

    def _maybe_maintain(self) -> None:
        """Auto flush + compaction (rocksdb's write-buffer flush and
        level-0 compaction trigger): without it a write-heavy table never
        flushes. Callers hold the single-writer context already."""
        if len(self.lsm.memtable) < self.memtable_flush_trigger:
            return
        self.flush()
        if self.auto_compact and self.lsm.should_compact():
            if not self.compact_lock.acquire(blocking=False):
                return  # manual compaction in flight covers this trigger
            try:
                ctx = (self.auto_compact_ctx() if self.auto_compact_ctx
                       else {})
                self.manual_compact(**ctx)
            finally:
                self.compact_lock.release()

    def flush(self) -> bool:
        """Memtable -> durable L0 SST stamped with the decree watermark."""
        t0 = time.perf_counter()
        table = self.lsm.flush(meta={
            "last_flushed_decree": self.last_committed_decree,
            "data_version": self.data_version,
        })
        if table is None:
            return False
        self.last_flushed_decree = self.last_committed_decree
        self.wal.truncate()
        self._ev_flush_count.increment()
        self._ev_flush_ms.set((time.perf_counter() - t0) * 1000.0)
        self._ev_flush_bytes.increment(os.path.getsize(table.path))
        return True

    # ---- read path ----------------------------------------------------

    def get(self, key: bytes) -> Optional[Tuple[bytes, int]]:
        return self.lsm.get(key)

    def iterate(self, start: bytes = b"", stop: Optional[bytes] = None,
                reverse: bool = False):
        return self.lsm.iterate(start, stop, reverse)

    # ---- checkpoint (parity: replication_app_base.h:171-236 + rocksdb
    # Checkpoint::CreateCheckpoint usage in pegasus_server_impl) ----------

    def checkpoint(self, dest_dir: str) -> int:
        """Flush, then copy a consistent snapshot of the store (its SST
        files and manifest) into `dest_dir`. Returns the decree the
        checkpoint contains."""
        self.flush()
        os.makedirs(dest_dir, exist_ok=True)
        _copy_store_files(os.path.join(self.data_dir, "sst"), dest_dir)
        return self.last_flushed_decree

    @staticmethod
    def restore_from_checkpoint(checkpoint_dir: str, data_dir: str,
                                device=None) -> "StorageEngine":
        """Open a fresh engine on `device` whose state is the checkpoint's
        content (parity: storage_apply_checkpoint,
        pegasus_server_impl.cpp:1624)."""
        sst_dir = os.path.join(data_dir, "sst")
        shutil.rmtree(sst_dir, ignore_errors=True)
        os.makedirs(sst_dir, exist_ok=True)
        _copy_store_files(checkpoint_dir, sst_dir)
        wal = os.path.join(data_dir, "wal.log")
        if os.path.exists(wal):
            os.remove(wal)
        return StorageEngine(data_dir, device=device)

    # ---- ingestion (parity: rocksdb_wrapper.cpp:248-266
    # IngestExternalFile with the decree watermark carried atomically) --

    def ingest_sst_file(self, path: str, decree: int) -> None:
        """Adopt an externally built SST as the newest L0 run, its meta
        rewritten to carry the ingesting decree. The memtable is flushed
        first, so earlier unflushed writes neither get skipped by WAL
        recovery nor outrank the newer ingested run."""
        if decree <= self.last_committed_decree:
            raise ValueError(
                f"ingest decree {decree} <= last committed "
                f"{self.last_committed_decree}")
        self.flush()
        src = SSTable(path)

        def build(dest: str, meta) -> None:
            writer = SSTableWriter(dest, meta=meta)
            for key, value, ets in src.iterate():
                writer.add(key, value or b"", ets, tombstone=value is None)
            writer.finish()

        try:
            self.lsm.ingest(build, meta={
                "last_flushed_decree": decree,
                "data_version": self.data_version,
            })
        finally:
            src.close()
        self.last_committed_decree = decree
        self.last_flushed_decree = decree

    # ---- compaction ---------------------------------------------------

    def _manual_compact_bulk(self, now_s: int, default_ttl: int,
                             pidx: int, partition_version: int,
                             do_validate: bool, operations,
                             publish_lock=None) -> None:
        """Block-level compaction over a pure-L1 store.

        Pipelined (default): the block-read, filter and write stages run
        on their own threads joined by bounded queues
        (storage/compact_pipeline.py), the read stage paying the
        CompactionGovernor's token bucket. Serial (flag off): a windowed
        loop with one window of device lookahead. Both produce the
        identical (block, mask) stream, so the output bytes match.

        Routing, as the JAX package's: a compressed block is masked on
        the host from its raw expire_ts and hash_lo columns
        (encoded_drop_mask) when there is no ruleset — no key decode and
        no launch; blocks of uncompressed runs, and every block when a
        ruleset is present, are decoded and evaluated by the
        compaction-filter kernel on the engine's device, in chunks of up
        to COMPACT_CHUNK_ROWS rows.

        Resident: when the table's blocks live in its resident image
        (parallel/mesh_resident.py) and the placement gate says one round
        pays, the whole store's drop masks come back from ONE round shared
        by every sibling partition compacting under the same filter
        parameters, and submit_window serves each window from them with
        no launch. A decline is the gate's None; an error raises."""
        from pegasus_tpu_torch.parallel.mesh_resident import MESH_SERVING

        ttl_may_change = bool(default_ttl) or bool(
            operations and any(op.op == "update_ttl" for op in operations))
        entries = self.lsm.bulk_compact_entries()
        # the resident FILTER pre-pass: every block's drop mask up front;
        # the READ stage below still pays the governor, the WRITE stage is
        # unchanged
        mesh_masks = None
        if entries:
            mesh_masks = MESH_SERVING.try_compact_masks(
                self.lsm, entries, now_s, default_ttl, pidx,
                partition_version, do_validate, operations,
                want_ets=ttl_may_change,
                n_windows=window_count(len(entries)))
        meta = {
            # snapshot mode: the output only covers decrees flushed at
            # freeze time — claiming last_committed would make boot skip
            # the WAL frames of writes that raced the merge
            "last_flushed_decree": (
                self.last_flushed_decree if publish_lock is not None
                else self.last_committed_decree),
            "data_version": self.data_version,
            "manual_compact_finish_time": epoch_now(),
        }

        def direct(run) -> bool:
            return (operations is None
                    and getattr(run, "codec", None) is not None)

        def load(entry):
            """READ stage: one block off disk, paced by the governor."""
            run, i, bm = entry
            GOVERNOR.acquire(bm.size)
            if direct(run):
                return (run, i, run.read_block_encoded(i), True)
            return (run, i, run.read_block(i), False)

        def submit_window(items):
            """FILTER stage phase 1: launch without waiting."""
            if mesh_masks is not None:
                served = {}
                for run, i, _blk, _d in items:
                    m = mesh_masks.get((run, i))
                    if m is None:
                        break
                    served[(run, i)] = m
                else:
                    # the whole window was filtered by the resident
                    # round: nothing in flight, forward it to WRITE
                    return items, [], served
            blocks = [((run, i), blk, pidx)
                      for run, i, blk, is_direct in items
                      if not is_direct]
            host_done = {}
            for run, i, blk, is_direct in items:
                if is_direct:
                    host_done[(run, i)] = encoded_drop_mask(
                        blk, now_s, default_ttl, pidx,
                        partition_version, do_validate,
                        want_ets=ttl_may_change)
            pend = compaction_eval_submit(
                blocks, now_s, default_ttl, partition_version,
                do_validate, operations=operations, device=self.device,
                want_ets=ttl_may_change) if blocks else []
            return items, pend, host_done

        def drain_window(token):
            """FILTER stage phase 2: materialize one window's masks."""
            items, pend, host_done = token
            got = {}
            for tag, drop, new_ets in compaction_eval_drain(
                    pend, want_ets=ttl_may_change):
                got[tag] = (drop, new_ets)
            out = []
            for run, i, blk, _is_direct in items:
                # host_done holds the host-direct masks and the resident
                # round's; launched chunks land in got
                m = host_done.get((run, i))
                if m is None:
                    m = got[(run, i)]
                drop, new_ets = m
                out.append((run, i, blk, drop, new_ets))
            return out

        if pipeline_enabled() and stage_threads_enabled():
            pipe = CompactPipeline(
                entries, load, submit_window, drain_window,
                window=pipeline_window(), depth=pipeline_depth(),
                # a window whose masks were all computed on the host at
                # submit has nothing in flight to hide: forward it now
                eager=lambda token: not token[1])
            self.last_pipeline = pipe
            results = pipe.results()
        else:
            def serial_results():
                # one window of lookahead, only for windows with a launch
                # in flight; host-direct windows yield at once
                w = pipeline_window()
                pending = None
                for off in range(0, len(entries), w):
                    token = submit_window(
                        [load(e) for e in entries[off:off + w]])
                    if pending is not None:
                        yield from drain_window(pending)
                        pending = None
                    if not token[1]:
                        yield from drain_window(token)
                    else:
                        pending = token
                if pending is not None:
                    yield from drain_window(pending)

            results = serial_results()

        self.lsm.bulk_compact_rewrite(
            results, meta, ttl_may_change=ttl_may_change,
            patch_headers=self.values_carry_expire_header,
            publish_lock=publish_lock,
            transform_workers=(transform_workers()
                               if pipeline_enabled() else 0))

    def manual_compact(self, default_ttl: int = 0, pidx: int = 0,
                       partition_version: int = -1,
                       validate_hash: bool = False,
                       rules_filter=None,
                       now: Optional[int] = None,
                       publish_lock=None) -> None:
        """Full compaction with the TTL / stale-split filter on the
        engine's device.

        `rules_filter(keys, expire_ts, now) -> (drop, new_ets)` is the
        optional user-specified compaction hook (ops/compaction_rules
        .compile_rules), applied after the default-TTL rewrite, before
        expiry — the reference's Filter() order
        (key_ttl_compaction_filter.h:71-90). A hook carrying a parsed
        ruleset (`.operations`) lets a pure-L1 store take the bulk path.

        `publish_lock` (narrow critical section): the caller froze the
        memtable with a flush and holds `compact_lock`; the merge runs
        over the immutable file snapshot with writes flowing and the lock
        is taken only for the publish cut-over."""
        now_s = epoch_now() if now is None else now
        # pv<0 / pidx>pv -> no stale-split dropping (keep), per
        # check_if_stale_split_data
        do_validate = bool(validate_hash and partition_version >= 0
                           and pidx <= partition_version)

        operations = getattr(rules_filter, "operations", None)
        if (self.lsm.bulk_compact_eligible()
                and (rules_filter is None or operations is not None)):
            self._compact_with_epilogue(
                lambda: self._manual_compact_bulk(
                    now_s, default_ttl, pidx, partition_version,
                    do_validate, operations, publish_lock=publish_lock),
                advance_watermark=publish_lock is None)
            return

        def record_filter(keys: List[bytes], ets: List[int]):
            n = len(keys)
            # 1. the default-TTL rewrite first; the user rules see the
            # rewritten TTLs (Filter():72-79). Wraps at 2^32, as the bulk
            # path does.
            ets_arr = np.asarray(ets, dtype=np.uint32)
            if default_ttl:
                ets_arr = np.where(
                    ets_arr == 0,
                    np.uint32((now_s + default_ttl) & 0xFFFFFFFF), ets_arr)
            # 2. the user-specified rules
            if rules_filter is not None:
                rule_drop, ets_arr = rules_filter(keys, ets_arr, now_s)
                ets_arr = np.asarray(ets_arr, dtype=np.uint32)
            else:
                rule_drop = np.zeros(n, dtype=bool)
            # 3. expiry + stale-split drop on the device (default_ttl 0:
            # the rewrite already happened, and a rule that cleared a TTL
            # must not be stamped again)
            cap = 1024
            while cap < n:
                cap <<= 1
            block = build_record_block(keys, ets_arr, capacity=cap,
                                       device=self.device)
            drop, new_ets = compaction_filter_block(
                block.hash_lo, block.expire_ts, block.valid, now_s, 0,
                pidx, max(partition_version, 0), do_validate)
            # stays on the device: the LSM moves it to the host after
            # gathering the next batch
            drop = drop[:n] | torch.from_numpy(
                np.asarray(rule_drop, dtype=bool)).to(drop.device)
            return drop, new_ets[:n]

        self._compact_with_epilogue(
            lambda: self.lsm.compact(
                record_filter=record_filter,
                patch_headers=self.values_carry_expire_header,
                publish_lock=publish_lock,
                meta={
                    # see _manual_compact_bulk: snapshot mode covers only
                    # the freeze-time watermark
                    "last_flushed_decree": (
                        self.last_flushed_decree
                        if publish_lock is not None
                        else self.last_committed_decree),
                    "data_version": self.data_version,
                    "manual_compact_finish_time": epoch_now(),
                }),
            advance_watermark=publish_lock is None)

    def _compact_with_epilogue(self, body,
                               advance_watermark: bool = True) -> None:
        """Bookkeeping after either compaction shape: advance the flushed
        watermark (everything committed is now in the SSTs), truncate the
        WAL, count the compaction.

        `advance_watermark=False` (snapshot mode): writes flowed during
        the merge, so committed > covered — the freeze flush already
        advanced the watermark and truncated the WAL for everything the
        compaction merged, and the newer writes' WAL frames must survive
        for crash recovery."""
        t0 = time.perf_counter()
        body()
        if advance_watermark:
            self.last_flushed_decree = self.last_committed_decree
            self.wal.truncate()
        self.compact_count += 1
        self.compact_ms = (time.perf_counter() - t0) * 1000.0
        nbytes = sum(os.path.getsize(t.path) for t in self.lsm.l1_runs)
        self.compact_bytes += nbytes
        self._ev_compact_count.increment()
        self._ev_compact_ms.set(self.compact_ms)
        self._ev_compact_bytes.increment(nbytes)
