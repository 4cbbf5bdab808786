"""Replica: one PacificA participant for one partition.

Parity: src/replica/replica.h + replica_2pc.cpp + replica_config.cpp +
replica_learn.cpp. Core invariants mirrored:

- Roles PS_PRIMARY / PS_SECONDARY / PS_POTENTIAL_SECONDARY / PS_INACTIVE /
  PS_ERROR, changed only by ballot-bumping config assignments from meta
  (here: `assign_config`).
- Write path (replica_2pc.cpp:113,328): primary assigns decree =
  max_prepared + 1, prepares locally (prepare list + private log), sends
  PREPARE to every secondary AND every potential secondary whose learn
  has reached the prepare-start point; commits when ALL of them ack
  (PacificA: unanimous ack of the configuration, not majority —
  `ack_prepare_message` waits for every member; a dead member is removed
  by reconfiguration, not voted around).
- Secondaries advance their commit point from the piggy-backed
  last_committed in each prepare (COMMIT_TO_DECREE_HARD,
  replica_2pc.cpp:709) and from group checks (replica_check.cpp:212).
- Reads served by the primary only, gated on a caught-up commit point
  (replica.cpp:407-426).
- Learning (replica_learn.cpp:88,361): a potential secondary catches up
  via LT_LOG (mutations read back from the primary's private log) or
  LT_APP (checkpoint copy + log tail), then notifies completion and is
  upgraded by a config change.

Determinism: translate-at-apply for atomic ops is deterministic across
replicas because the decree order, the mutation's primary-assigned
timestamp, and the derived `now` are identical everywhere.
"""

from __future__ import annotations

import enum
import os
import shutil
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from pegasus_tpu_torch.base.value_schema import PEGASUS_EPOCH_BEGIN
from pegasus_tpu_torch.replica.mutation import (
    ATOMIC_OPS,
    BATCHABLE_OPS,
    Mutation,
    WriteOp,
)
from pegasus_tpu_torch.replica.mutation_log import MutationLog
from pegasus_tpu_torch.replica.prepare_list import (
    COMMIT_ALL_READY,
    COMMIT_TO_DECREE_HARD,
    COMMIT_TO_DECREE_SOFT,
    PrepareList,
)
from pegasus_tpu_torch.rpc.codec import (
    OP_CAM,
    OP_CAS,
    OP_DUP_PUT,
    OP_DUP_REMOVE,
    OP_INCR,
    OP_INGEST,
    OP_MULTI_PUT,
    OP_MULTI_REMOVE,
    OP_PUT,
    OP_REMOVE,
)
from pegasus_tpu_torch.server.partition_server import PartitionServer
from pegasus_tpu_torch.utils.errors import ErrorCode
from pegasus_tpu_torch.utils.thread_check import SerialAccessChecker


def _serial(fn):
    """Guard a replica entry point with the single-writer checker
    (parity: _checker.only_one_thread_access(), replica_2pc.cpp:115):
    concurrent entry from a second thread = a missing node lock, raised
    loudly at the site instead of corrupting replication state."""
    def wrapped(self, *args, **kwargs):
        with self._access:
            return fn(self, *args, **kwargs)
    wrapped.__name__ = fn.__name__
    wrapped.__doc__ = fn.__doc__
    return wrapped

PREPARE_LIST_CAPACITY = 1024


class ReplicaBusyError(RuntimeError):
    """Write-queue overload: the mutation queue is full, or a
    non-batchable op is stuck behind an in-flight round. RETRYABLE —
    the stub maps it to ERR_BUSY so the client's backoff machinery
    handles write overload exactly like read shedding (never
    ERR_INVALID_STATE, which would burn a config refresh per retry)."""


class PartitionStatus(enum.IntEnum):
    INACTIVE = 0
    ERROR = 1
    PRIMARY = 2
    SECONDARY = 3
    POTENTIAL_SECONDARY = 4


@dataclass
class ReplicaConfig:
    """Parity: partition_configuration (idl/dsn.layer2.thrift:34-46)."""

    ballot: int
    primary: str
    secondaries: List[str] = field(default_factory=list)


# learn types (parity: replica_learn.cpp LT_CACHE/LT_LOG/LT_APP)
LT_LOG = "log"
LT_APP = "app"


class Replica:
    """One partition's consensus participant. Messages travel through a
    transport with `send(src, dst, msg_type, payload)`; the owner
    registers `on_message` as the receive handler."""

    def __init__(self, name: str, data_dir: str, transport,
                 app_id: int = 1, pidx: int = 0, partition_count: int = 1,
                 clock: Optional[Callable[[], float]] = None,
                 cluster_id: int = 1, device=None) -> None:
        """`device=None` serves the partition on the card and raises
        without CUDA; `device="cpu"` runs the plain torch path."""
        self.name = name
        self.data_dir = data_dir
        self.transport = transport
        self.clock = clock or time.time
        self.server = PartitionServer(
            os.path.join(data_dir, "app"), app_id=app_id, pidx=pidx,
            partition_count=partition_count, cluster_id=cluster_id,
            device=device)
        self.log = MutationLog(os.path.join(data_dir, "plog", "mlog.bin"))

        self.status = PartitionStatus.INACTIVE
        self.config = ReplicaConfig(ballot=0, primary="", secondaries=[])
        self._access = SerialAccessChecker(
            f"replica {app_id}.{pidx}@{name}")
        # fail-point site names are hot-path lookups: built once
        self._fp_primary_plog = f"{name}::primary_plog_append"
        self.prepare_list = PrepareList(
            self.server.engine.last_committed_decree, PREPARE_LIST_CAPACITY,
            self._apply_mutation)
        # boot: re-prepare logged mutations beyond the applied decree, and
        # seed the monotonic-timestamp floor from replayed mutations (a
        # restarted primary must not mint timestamps at or below ones it
        # already shipped to duplication followers)
        for mu in self.log.replay(self.log.path):
            if mu.decree > self.prepare_list.last_committed_decree:
                self.prepare_list.prepare(mu)
            self._boot_timestamp_floor = max(
                getattr(self, "_boot_timestamp_floor", 0),
                mu.timestamp_us + max(len(mu.ops), 1) - 1)

        # primary-assigned mutation timestamps must be strictly monotonic
        # (duplication conflict resolution and timetag uniqueness depend on
        # it; the reference guarantees this per-primary) — seeded from the
        # log replay above so restarts don't regress the floor
        self._last_timestamp_us = getattr(self, "_boot_timestamp_floor", 0)
        # duplicators attach here; log GC must not outrun their progress
        self.duplicators: List = []
        # decree -> the write's 2PC span ctx (sampled writes only):
        # duplication parents its dup.ship spans here so a traced write
        # renders as ONE stitched tree across clusters. Bounded — only
        # as large as tracing is actually sampling.
        from collections import OrderedDict

        self.dup_trace_ctxs: "OrderedDict[int, tuple]" = OrderedDict()
        # primary-side state (parity: primary_context, replica_context.h)
        self._pending_acks: Dict[int, Set[str]] = {}
        self._client_callbacks: Dict[int, Callable[[List[Any]], None]] = {}
        self._learners: Dict[str, int] = {}  # learner -> prepare_start decree
        self._learn_ckpt_dirs: Dict[str, str] = {}  # learner -> frozen ckpt
        # reads/checkpoints gate on this after a promotion (replica.cpp:426)
        self._promotion_watermark = 0
        # follower reads: when this replica last observed itself caught up
        # to the primary's advertised commit point (stamped in _on_prepare
        # and _on_group_check on the SECONDARY side). bounded_stale ops
        # compare `now - _fresh_as_of` against their max_lag_ms bound; a
        # replica that has never synced is infinitely stale by definition
        self._fresh_as_of = float("-inf")
        # lazily hydrated from the .ingested_loads marker (bulk load dedup)
        self._ingested_load_ids: Set[int] = set()
        # decree -> responses computed at idempotent translation time
        # (the logged dup-puts apply as ints; the client wants the
        # original atomic op's response object)
        self._idempotent_responses: Dict[int, List[Any]] = {}
        # the mutation-queue batch: (op_count, callback) spans + the ops
        # accumulated while a 2PC round is in flight
        self._write_queue: List[Tuple[int, Optional[Callable]]] = []
        self._queued_ops: List[WriteOp] = []
        # per-mutation latency tracers (parity: every mutation carries a
        # latency_tracer, replica_2pc.cpp:338-359; slow dumps via
        # dump_trace_points). Write traces share the server's slow log so
        # ONE app-env threshold (replica.slow_query_threshold_ms) governs
        # reads and writes alike
        self._traces: Dict[int, Any] = {}
        # distributed tracing: per-peer prepare hop spans, keyed
        # (decree, peer) — opened at prepare send, closed at ack (the
        # hop whose self-time exposes a lagging secondary)
        self._prepare_spans: Dict[Tuple[int, str], Any] = {}
        self._write_latency = None  # lazy per-table percentile
        self.slow_log = self.server.slow_log
        # node-level write flush window (group_commit.WriteFlushWindow),
        # set by the hosting stub: plog appends stage under its shared
        # flush/fsync and prepare/ack sends aggregate per peer. None =
        # immediate legacy behavior (directly-driven replicas).
        self.plog_sink = None
        # node-level "write" metric entity (stub-provided; None in
        # directly-driven replicas); the queue-depth percentile caches
        # lazily — it sits on the per-write hot path
        self.write_metrics = None
        self._queue_depth_metric = None
        # whether learn checkpoint paths are reachable via the local
        # filesystem (single host / shared fs). Multi-host deployments set
        # False on the stub and checkpoints travel via the file-transfer
        # service (nfs_node.h:84 parity)
        self.shared_fs = True
        self.on_remote_checkpoint: Optional[Callable] = None
        # callbacks to the control plane (meta); tests wire these
        self.on_learn_completed: Optional[Callable[[str], None]] = None
        self.on_replication_error: Optional[Callable[[str, int], None]] = None

    # ---- lifecycle ----------------------------------------------------

    def close(self) -> None:
        self.log.close()
        self.server.close()

    @property
    def ballot(self) -> int:
        return self.config.ballot

    @property
    def last_committed_decree(self) -> int:
        return self.prepare_list.last_committed_decree

    def last_prepared_decree(self) -> int:
        return self.prepare_list.max_decree()

    def ready_to_serve(self) -> bool:
        """Reads/checkpoints allowed only once the promotion-time prepare
        window has re-committed (parity: replica.cpp:426 — the gate that
        keeps a fresh primary from serving state missing acked writes)."""
        return self.last_committed_decree >= self._promotion_watermark

    def staleness_s(self, now: float) -> float:
        """Seconds since this replica last proved itself caught up to the
        primary's advertised commit point. A PRIMARY is fresh by
        definition (it IS the commit point); a secondary's freshness is
        stamped when a prepare/group_check shows it committed everything
        the primary had committed at send time — so the bound is the
        primary→secondary sync cadence, not the mutation rate."""
        if self.status == PartitionStatus.PRIMARY:
            return 0.0
        return max(0.0, now - self._fresh_as_of)

    # ---- config (driven by meta / tests) ------------------------------

    @_serial
    def assign_config(self, config: ReplicaConfig) -> None:
        """Parity: replica_config.cpp ballot-gated role changes."""
        if config.ballot < self.config.ballot:
            return  # stale proposal
        self.config = config
        if config.primary == self.name:
            if self.status != PartitionStatus.PRIMARY:
                self.status = PartitionStatus.PRIMARY
                # serving gate (parity: replica.cpp:426): reads and
                # checkpoints must wait until everything prepared at
                # promotion time has re-committed under the new ballot —
                # an acked write can live in the window as prepared-only
                self._promotion_watermark = self.last_prepared_decree()
                # a new primary must not carry uncommitted decrees from an
                # older window beyond what it can now re-propose; reconcile
                # by re-preparing its own window under the new ballot
                self._reprepare_window()
            else:
                # membership change while primary. First retire learner
                # entries that this config PROMOTES to secondary — they
                # were kept in _learners through the promotion gap so no
                # prepare could miss them, but leaving them forever means
                # a LATER config that removes the node still finds it in
                # _learners and keeps demanding its acks (observed: a
                # shed ex-learner wedging every subsequent write).
                for node in list(self._learners):
                    if node in config.secondaries:
                        del self._learners[node]
                # open decrees stop waiting for ex-members
                members = set(config.secondaries) | set(self._learners)
                for decree in sorted(self._pending_acks):
                    self._pending_acks[decree] &= members
                for decree in sorted(self._pending_acks):
                    if not self._pending_acks[decree]:
                        del self._pending_acks[decree]
                        self._on_decree_ready(decree)
        elif self.name in config.secondaries:
            self.status = PartitionStatus.SECONDARY
            self._clear_primary_state()
        else:
            self.status = PartitionStatus.INACTIVE
            self._clear_primary_state()

    def _clear_primary_state(self) -> None:
        self._pending_acks.clear()
        self._client_callbacks.clear()
        self._traces.clear()
        for psp in self._prepare_spans.values():
            psp.finish()  # hops die with the primaryship; record them
        self._prepare_spans.clear()
        # queued writes die unacked with the primaryship (clients retry)
        self._write_queue.clear()
        self._queued_ops.clear()
        self._idempotent_responses.clear()
        self._learners.clear()
        # learn snapshots for in-flight learners die with the primaryship
        # (each is a full SST copy; completion will never fire to GC them)
        for ckpt in self._learn_ckpt_dirs.values():
            shutil.rmtree(ckpt, ignore_errors=True)
        self._learn_ckpt_dirs.clear()

    def _reprepare_window(self) -> None:
        """New primary: re-send every prepared-but-uncommitted mutation
        under its (new) ballot so the group converges (parity: the
        reconfiguration path re-proposes the open window)."""
        for d in range(self.last_committed_decree + 1,
                       self.last_prepared_decree() + 1):
            mu = self.prepare_list.get_mutation_by_decree(d)
            if mu is None:
                continue
            remu = replace(mu, ballot=self.config.ballot,
                           last_committed=self.last_committed_decree)
            self.prepare_list.prepare(remu)
            self._log_append(remu)
            targets = self._prepare_targets(remu.decree)
            if targets:
                self._pending_acks[remu.decree] = set(targets)

            def _ship(remu=remu, targets=targets) -> None:
                self._send_prepares(remu)
                if not targets:
                    # never leave an empty entry (it would count toward
                    # the pipelining depth forever and wedge the queue)
                    self._on_decree_ready(remu.decree)

            self._after_durable(_ship)

    # ---- group-commit plumbing ----------------------------------------

    def _log_append(self, mu: Mutation) -> None:
        """Plog append through the node's group-commit window when one
        is open (one shared flush/fsync per window); immediate append
        otherwise."""
        sink = self.plog_sink
        if sink is not None:
            sink.append(self.log, mu)
        else:
            self.log.append(mu)

    def _after_durable(self, fn: Callable[[], None]) -> None:
        """Run `fn` only once every mutation staged in the current
        flush window is durable — the ack-after-durable contract under
        group commit. Immediate when no window is open (the append
        already flushed)."""
        sink = self.plog_sink
        if sink is not None:
            sink.after_durable(fn)
        else:
            fn()

    # ---- client write path (primary) ----------------------------------

    # writes queued while a 2PC round is in flight coalesce into ONE
    # following mutation (parity: mutation_queue batching — requests with
    # rpc_request_is_write_allow_batch join the pending mutation,
    # mutation.cpp:390,553; the queue drains when the window moves)
    MAX_BATCH_OPS = 128
    # in-flight 2PC rounds allowed before writes start coalescing (the
    # bounded-staleness pipelining window)
    PIPELINE_DEPTH = 2

    @_serial
    def client_write(self, ops: List[WriteOp],
                     callback: Optional[Callable[[List[Any]], None]] = None
                     ) -> int:
        """Parity: on_client_write -> init_prepare (replica_2pc.cpp:113,328).
        Returns the assigned decree (-1 when queued behind an in-flight
        round), or raises on gate failure."""
        if self.status != PartitionStatus.PRIMARY:
            raise RuntimeError(f"{self.name}: not primary")
        if any(wo.op in ATOMIC_OPS for wo in ops) and len(ops) > 1:
            raise ValueError("atomic ops cannot batch with other writes")
        if self.write_metrics is not None:
            if self._queue_depth_metric is None:
                self._queue_depth_metric = self.write_metrics.percentile(
                    "pipeline_queue_depth")
            self._queue_depth_metric.set(len(self._queued_ops))
        if (self._write_queue
                or len(self._pending_acks) >= self.PIPELINE_DEPTH):
            # the window is at its pipelining depth (or earlier writes
            # already queued — a later write must NOT overtake them, or
            # two puts to one key could apply in reversed order):
            # coalesce batchable writes into the NEXT mutation (bounded
            # staleness, replica_2pc.cpp:366); non-batchable ones and a
            # full batch busy-reject for a client retry
            if (all(wo.op in BATCHABLE_OPS for wo in ops)
                    and sum(n for n, _cb in self._write_queue)
                    + len(ops) <= self.MAX_BATCH_OPS):
                self._write_queue.append((len(ops), callback))
                self._queued_ops.extend(ops)
                return -1
            raise ReplicaBusyError(
                f"{self.name}: write queue busy (retry)")
        decree = self.last_prepared_decree() + 1
        ts = max(int(self.clock() * 1_000_000), self._last_timestamp_us + 1)
        idem_responses = None
        # forced translation (parity: the atomic-idempotent toggle,
        # enable/disable/get_atomic_idempotent): the app-env makes atomic
        # ops ship as concrete puts even without active duplication
        force_idem = (self.server.app_envs.get(
            "replica.atomic_idempotent") == "true")
        if ((self.duplicators or force_idem)
                and any(wo.op in (OP_INCR, OP_CAS, OP_CAM)
                        for wo in ops)):
            # idempotent translation (parity: make_idempotent,
            # replica_2pc.cpp:283 + idempotent_writer.h): a duplicated
            # table must log atomic ops as the CONCRETE puts they
            # resolve to, or the follower would re-execute them. The
            # read-translate is only sound against fully-applied state:
            # an open window could hold a conflicting earlier write, so
            # busy-reject and let the client retry after it drains.
            if self.last_committed_decree != self.last_prepared_decree():
                raise ReplicaBusyError(
                    f"{self.name}: atomic write on a duplicated table "
                    f"must wait for the in-flight window")
            ops, idem_responses = self._make_idempotent(ops, ts)
            # per-item microseconds were handed out above: re-reserve by
            # the OUTPUT count so the next mutation's timetags can't tie
            self._last_timestamp_us = max(self._last_timestamp_us,
                                          ts + max(len(ops), 1) - 1)
        # reserve one microsecond PER OP: duplication stamps op i with
        # ts + i, and the next mutation must not overlap those timetags
        self._last_timestamp_us = ts + max(len(ops), 1) - 1
        from pegasus_tpu_torch.utils import tracing
        from pegasus_tpu_torch.utils.latency_tracer import LatencyTracer

        # the write's own span (child of the carrier RPC's dispatch
        # span): it outlives this call — acks arrive in later dispatches
        # — and closes when the client reply goes out, so the reply send
        # carries this trace's context (and its tail-keep bit) upstream
        wspan = tracing.child_of(
            tracing.current_span(),
            f"2pc.{self.server.app_id}.{self.server.pidx}.d{decree}")
        if wspan is not None:
            self.dup_trace_ctxs[decree] = wspan.ctx()
            while len(self.dup_trace_ctxs) > 1024:
                self.dup_trace_ctxs.popitem(last=False)
        tracer = LatencyTracer(f"write.{self.server.app_id}."
                               f"{self.server.pidx}.d{decree}",
                               span=wspan)
        self._traces[decree] = tracer
        if idem_responses is not None:
            self._idempotent_responses[decree] = idem_responses
        mu = Mutation(
            ballot=self.config.ballot, decree=decree,
            last_committed=self.last_committed_decree,
            timestamp_us=ts, ops=ops)
        # fault site: the PRIMARY's own plog write (parity: the 200-series
        # disk faults hit the primary too — a primary that cannot log must
        # not ack, and must not send prepares it hasn't durably staged)
        from pegasus_tpu_torch.utils.fail_point import fail_point

        if fail_point(self._fp_primary_plog) is not None:
            self._traces.pop(decree, None)
            self._idempotent_responses.pop(decree, None)
            raise RuntimeError(
                f"{self.name}: primary plog append failed (fault)")
        self.prepare_list.prepare(mu)
        tracer.add_point("prepare_local")
        self._log_append(mu)
        tracer.add_point("append_plog")
        if callback is not None:
            self._client_callbacks[decree] = callback
        targets = self._prepare_targets(decree)
        if targets:
            self._pending_acks[decree] = set(targets)

        # the requesting tenant (bound ambient by the stub's write
        # handler): re-bound around the deferred prepare fan-out so the
        # aggregated 2PC legs keep their tenant tag — the window flush
        # runs them long after this call's binding unwound
        from pegasus_tpu_torch.server import tenancy

        wtenant = tenancy.current()

        def _ship() -> None:
            # runs after the group-commit window hardened the plog (a
            # primary must not send prepares — or ack a zero-member
            # round — before its own log write is durable)
            tracer.add_point("plog_durable")
            with tenancy.bind(wtenant):
                self._send_prepares(mu)
            tracer.add_point("prepares_sent")
            if not targets:
                # no members to wait on: ready now. (Never leave an
                # EMPTY entry in _pending_acks — it would count toward
                # the pipelining depth forever and wedge the queue.)
                self._on_decree_ready(decree)

        self._after_durable(_ship)
        return decree

    def _prepare_targets(self, decree: int) -> List[str]:
        targets = list(self.config.secondaries)
        targets.extend(l for l, start in self._learners.items()
                       if decree >= start)
        return targets

    def _send_prepares(self, mu: Mutation) -> None:
        from pegasus_tpu_torch.utils import tracing

        targets = self._prepare_targets(mu.decree)
        if not targets:
            return  # single-replica: skip the dead encode entirely
        blob = mu.encode()
        tracer = self._traces.get(mu.decree)
        wspan = tracer.span if tracer is not None else None
        for dst in targets:
            psp = None
            if wspan is not None:
                key = (mu.decree, dst)
                psp = self._prepare_spans.get(key)
                if psp is None:
                    # per-peer prepare hop: send -> ack received. Its
                    # SELF time is the wire+peer latency — the span a
                    # lagging secondary shows up in. Re-sends (group
                    # check recovery) extend the same span.
                    psp = tracing.child_of(wspan, f"prepare.{dst}")
                    self._prepare_spans[key] = psp
            with tracing.activate(psp):
                self.transport.send(self.name, dst, "prepare", blob)

    # ---- 2PC message handlers -----------------------------------------

    def on_message(self, src: str, msg_type: str, payload: Any) -> None:
        handler = getattr(self, f"_on_{msg_type}", None)
        if handler is None:
            raise ValueError(f"unknown message type {msg_type}")
        handler(src, payload)

    @_serial
    def _on_prepare(self, src: str, blob: bytes) -> None:
        """Parity: on_prepare (replica_2pc.cpp:532)."""
        mu = Mutation.decode(blob)
        if mu.ballot < self.config.ballot:
            self.transport.send(self.name, src, "prepare_ack", {
                "decree": mu.decree, "ballot": self.config.ballot,
                "err": int(ErrorCode.ERR_INVALID_STATE)})
            return
        if mu.ballot > self.config.ballot:
            # newer configuration exists that we haven't heard about from
            # meta yet; adopt the ballot so older primaries are fenced
            # (reference: the prepare carries the config, replica updates)
            self.config = replace(self.config, ballot=mu.ballot, primary=src)
        if self.status not in (PartitionStatus.SECONDARY,
                               PartitionStatus.POTENTIAL_SECONDARY):
            self.transport.send(self.name, src, "prepare_ack", {
                "decree": mu.decree, "ballot": mu.ballot,
                "err": int(ErrorCode.ERR_INVALID_STATE)})
            return
        if self.status == PartitionStatus.SECONDARY:
            # gap check: a missed prepare (dropped message) leaves a hole a
            # full secondary can never commit across — it must be removed
            # and re-added through the learner flow (PacificA
            # reconfiguration, not voting). A POTENTIAL_SECONDARY is
            # allowed holes: its learn_response fills them.
            for d in range(self.last_committed_decree + 1, mu.decree):
                if self.prepare_list.get_mutation_by_decree(d) is None:
                    self.transport.send(self.name, src, "prepare_ack", {
                        "decree": mu.decree, "ballot": mu.ballot,
                        "err": int(ErrorCode.ERR_INCONSISTENT_STATE)})
                    return
        self.prepare_list.prepare(mu)
        # SAFETY: ack OK only if OUR stored mutation for this decree is the
        # one this primary sent — prepare() keeps a higher-ballot mutation,
        # and acking a discarded prepare would let a deposed primary
        # commit content the group never stored.
        stored = self.prepare_list.get_mutation_by_decree(mu.decree)
        accepted = (stored is not None and stored.ballot == mu.ballot) \
            or mu.decree <= self.last_committed_decree
        if not accepted:
            self.transport.send(self.name, src, "prepare_ack", {
                "decree": mu.decree, "ballot": self.config.ballot,
                "err": int(ErrorCode.ERR_INVALID_STATE)})
            return
        # fail point (parity: the disk-fault injection sites around log
        # writes — the .act 200-series exercise this): a configured
        # write-fault NAKs the prepare like a real aio failure would
        from pegasus_tpu_torch.utils.fail_point import fail_point

        if fail_point(f"{self.name}::plog_append") is not None:
            self.transport.send(self.name, src, "prepare_ack", {
                "decree": mu.decree, "ballot": self.config.ballot,
                "err": int(ErrorCode.ERR_FILE_OPERATION_FAILED)})
            return
        self._log_append(mu)
        # advance commit point from the piggy-backed primary commit
        mode = (COMMIT_TO_DECREE_HARD
                if self.status == PartitionStatus.SECONDARY
                else COMMIT_TO_DECREE_SOFT)
        self.prepare_list.commit(min(mu.last_committed, mu.decree - 1), mode)
        # follower-read freshness: this prepare proves we now hold every
        # decree the primary had committed when it sent (the piggy-backed
        # last_committed), so stamp the staleness clock
        if (self.status == PartitionStatus.SECONDARY
                and self.last_committed_decree >= mu.last_committed):
            self._fresh_as_of = self.clock()
        # the OK ack waits for the group-commit window's shared
        # flush/fsync: "appended before it can be acked" must mean
        # DURABLY appended, or a crash mid-window could lose a
        # mutation the primary already counted as replicated here
        self._after_durable(lambda: self.transport.send(
            self.name, src, "prepare_ack", {
                "decree": mu.decree, "ballot": mu.ballot,
                "err": int(ErrorCode.ERR_OK)}))

    @_serial
    def _on_prepare_ack(self, src: str, ack: dict) -> None:
        """Parity: on_prepare_reply (replica_2pc.cpp:731)."""
        if self.status != PartitionStatus.PRIMARY:
            return
        decree = ack["decree"]
        if ack["err"] != int(ErrorCode.ERR_OK):
            # a member failed this prepare: PacificA removes it via
            # reconfiguration; surface to the control plane
            if self.on_replication_error is not None:
                self.on_replication_error(src, decree)
            return
        pending = self._pending_acks.get(decree)
        if pending is None:
            return
        pending.discard(src)
        tracer = self._traces.get(decree)
        if tracer is not None:
            tracer.add_point(f"ack.{src}")
        psp = self._prepare_spans.pop((decree, src), None)
        if psp is not None:
            psp.finish()
        if not pending:
            del self._pending_acks[decree]
            self._on_decree_ready(decree)

    def _on_decree_ready(self, decree: int) -> None:
        self.prepare_list.mark_ready(decree)
        self.prepare_list.commit(decree, COMMIT_ALL_READY)
        self._drain_write_queue()

    def _drain_write_queue(self) -> None:
        """The round finished: ship everything queued behind it as ONE
        mutation whose responses split back per original request."""
        if (not self._write_queue or self._pending_acks
                or self.status != PartitionStatus.PRIMARY):
            return
        spans = self._write_queue
        ops = self._queued_ops
        self._write_queue = []
        self._queued_ops = []

        def split_responses(responses: List[Any]) -> None:
            off = 0
            for n, cb in spans:
                if cb is not None:
                    cb(responses[off:off + n])
                off += n

        self.client_write(ops, split_responses)

    def _on_group_check(self, src: str, payload: dict) -> None:
        """Parity: on_group_check (replica_check.cpp:212) — heartbeat from
        the primary carrying its commit point."""
        if payload["ballot"] < self.config.ballot:
            return
        target = min(payload["last_committed"], self.last_prepared_decree())
        if target > self.last_committed_decree:
            self.prepare_list.commit(target, COMMIT_TO_DECREE_HARD)
        # follower-read freshness: caught up to the primary's advertised
        # commit point as of this heartbeat → reset the staleness clock
        if (self.status == PartitionStatus.SECONDARY
                and self.last_committed_decree >= payload["last_committed"]):
            self._fresh_as_of = self.clock()
        self.transport.send(self.name, src, "group_check_ack", {
            "ballot": payload["ballot"],
            "last_committed": self.last_committed_decree})

    def _on_group_check_ack(self, src: str, payload: dict) -> None:
        pass  # liveness bookkeeping arrives with the failure detector

    def broadcast_group_check(self) -> None:
        """Primary heartbeat (parity: group-check timer). Doubles as the
        lost-ack recovery path: any decree still waiting on acks has its
        prepare re-sent to the members that haven't answered (prepare is
        idempotent on the receiver; a re-ack drains the pending set)."""
        if self.status != PartitionStatus.PRIMARY:
            return
        for dst in self.config.secondaries:
            self.transport.send(self.name, dst, "group_check", {
                "ballot": self.config.ballot,
                "last_committed": self.last_committed_decree})
        for decree, pending in sorted(self._pending_acks.items()):
            mu = self.prepare_list.get_mutation_by_decree(decree)
            if mu is None:
                continue
            blob = mu.encode()
            for dst in pending:
                self.transport.send(self.name, dst, "prepare", blob)

    # ---- apply --------------------------------------------------------

    def _apply_mutation(self, mu: Mutation) -> None:
        """Committed mutation -> one engine batch (parity:
        replication_app_base::apply_mutation ->
        on_batched_write_requests)."""
        ws = self.server.write_service
        # deterministic 'now' derived from the primary-assigned timestamp
        now = max(0, mu.timestamp_us // 1_000_000 - PEGASUS_EPOCH_BEGIN)
        ts = mu.timestamp_us
        items: List = []
        responses: List[Any] = []
        # timetags already written EARLIER IN THIS MUTATION per key: a
        # batched dup mutation may touch one key twice, and the engine
        # won't see the first write until apply_items at the end
        dup_floors: Dict[bytes, int] = {}
        cu = self.server.cu  # capacity-unit metering (parity: every
        # write handler feeds capacity_unit_calculator.h:62-104)
        hc = self.server.hotkey_collectors["write"]
        if hc.state.value != "stopped":
            from pegasus_tpu_torch.base.key_schema import restore_key as _rk

            hks = []
            for wo in mu.ops:
                if wo.op in (OP_PUT, OP_REMOVE, OP_DUP_PUT,
                             OP_DUP_REMOVE):
                    hks.append(_rk(wo.request[0])[0])
                elif wo.op in (OP_MULTI_PUT, OP_MULTI_REMOVE):
                    hks.append(wo.request.hash_key)
            hc.capture(hks)
        if len(mu.ops) == 1 and mu.ops[0].op == OP_INGEST:
            # bulk-load ingestion rides alone (ATOMIC_OPS) and takes the
            # write lock only around the engine mutation — its
            # block-service download must not stall the partition
            responses.append(
                self._apply_ingest(mu.ops[0].request, mu.decree))
            callback = self._client_callbacks.pop(mu.decree, None)
            if callback is not None:
                callback(responses)
            return
        # The engine-reading translations (timetags, incr/cas current
        # values) AND the batch apply run under the server's
        # single-writer lock: the env-triggered manual compaction
        # thread takes the same lock (partition_server.manual_compact),
        # and without this exclusion a compaction's overlay reset wipes
        # any mutation applied after its merge snapshot began — acked
        # writes silently lost (found by the combined-chaos drive:
        # sustained load + env compaction on a live onebox).
        from pegasus_tpu_torch.server.capacity_units import units as _cu_units

        with self.server._write_lock:
            # vectorized translate: homogeneous PUT/REMOVE runs go
            # through one run-translate pass (single timetag sweep —
            # byte-identical output) and CU accounting batches into ONE
            # counter touch per mutation instead of one per op (the
            # LUDA observation: per-record write-path work collapses
            # once the records travel in batches, arXiv:2004.03054)
            ok = int(ErrorCode.ERR_OK)
            ops = mu.ops
            n_ops = len(ops)
            cu_total = 0
            i = 0
            while i < n_ops:
                wo = ops[i]
                if wo.op == OP_PUT:
                    j = i + 1
                    while j < n_ops and ops[j].op == OP_PUT:
                        j += 1
                    reqs = [w.request for w in ops[i:j]]
                    cu_total += sum(_cu_units(len(k) + len(ud))
                                    for k, ud, _ets in reqs)
                    items.extend(ws.translate_put_run(reqs, ts))
                    responses.extend([ok] * (j - i))
                    i = j
                    continue
                if wo.op == OP_REMOVE:
                    j = i + 1
                    while j < n_ops and ops[j].op == OP_REMOVE:
                        j += 1
                    keys = [w.request[0] for w in ops[i:j]]
                    cu_total += sum(_cu_units(len(k)) for k in keys)
                    items.extend(ws.translate_remove_run(keys))
                    responses.extend([ok] * (j - i))
                    i = j
                    continue
                if wo.op == OP_MULTI_PUT:
                    cu_total += _cu_units(len(wo.request.hash_key) + sum(
                        len(kv.key) + len(kv.value)
                        for kv in wo.request.kvs))
                    err, its = ws.translate_multi_put(wo.request, ts, now)
                    responses.append(err)
                elif wo.op == OP_MULTI_REMOVE:
                    cu_total += _cu_units(len(wo.request.hash_key) + sum(
                        len(sk) for sk in wo.request.sort_keys))
                    err, count, its = ws.translate_multi_remove(wo.request)
                    responses.append((err, count))
                elif wo.op == OP_INCR:
                    cu_total += _cu_units(len(wo.request.key))
                    resp, its = ws.translate_incr(wo.request, ts, now)
                    resp.decree = mu.decree
                    responses.append(resp)
                elif wo.op == OP_CAS:
                    resp, its = ws.translate_check_and_set(
                        wo.request, ts, now)
                    resp.decree = mu.decree
                    responses.append(resp)
                elif wo.op == OP_CAM:
                    resp, its = ws.translate_check_and_mutate(
                        wo.request, ts, now)
                    resp.decree = mu.decree
                    responses.append(resp)
                elif wo.op == OP_DUP_PUT:
                    key, user_data, expire_ts, timetag = wo.request
                    applied, its = ws.translate_duplicate_put(
                        key, user_data, expire_ts, timetag,
                        dup_floors.get(key, 0))
                    if applied:
                        dup_floors[key] = timetag
                    responses.append(int(applied))
                elif wo.op == OP_DUP_REMOVE:
                    key, timetag = wo.request
                    applied, its = ws.translate_duplicate_remove(
                        key, timetag, dup_floors.get(key, 0))
                    if applied:
                        dup_floors[key] = timetag
                    responses.append(int(applied))
                else:
                    raise ValueError(f"unknown op {wo.op}")
                items.extend(its)
                i += 1
            cu.add_write_units(cu_total)
            sink = self.plog_sink
            if sink is not None and sink.wal_flush_deferred():
                # the engine-WAL frame rides the IO buffer: the ack's
                # durability lives in the private log (hardened before
                # this callback ran), and every decree this WAL could
                # recover replays from the plog anyway — see
                # WriteFlushWindow.wal_flush_deferred
                ws.apply_items(items, mu.decree, wal_flush=False)
            else:
                ws.apply_items(items, mu.decree)
        from pegasus_tpu_torch.utils import tracing

        tracer = self._traces.pop(mu.decree, None)
        wspan = tracer.span if tracer is not None else None
        if wspan is not None:
            # members that never acked (removed mid-round): close their
            # hop spans at apply so the trace is whole
            for key in [k for k in self._prepare_spans
                        if k[0] == mu.decree]:
                self._prepare_spans.pop(key).finish()
        if tracer is not None:
            tracer.add_point("committed_applied")
        callback = self._client_callbacks.pop(mu.decree, None)
        override = self._idempotent_responses.pop(mu.decree, None)
        if callback is not None:
            # the client reply goes out under the write's span so it
            # carries this trace's context — and, when any hop crossed
            # the slow threshold, the tail-keep bit — back upstream
            with tracing.activate(wspan):
                callback(override if override is not None else responses)
        if tracer is not None:
            tracer.add_point("replied")
            from pegasus_tpu_torch.utils import perf_context as perf

            if perf.enabled():
                # the write's cost vector: rows applied and the
                # group-commit wait (append_plog -> plog_durable is
                # exactly the shared-fsync flush-window interval) —
                # rides the slow-log entry and the 2PC span like the
                # read paths' contexts
                pc = perf.PerfContext("write")
                pc.ops = 1
                pc.rows_evaluated = len(mu.ops)
                pc.rows_survived = len(mu.ops)
                stages = dict((s, t) for s, t in tracer.points)
                if "append_plog" in stages and "plog_durable" in stages:
                    pc.queue_wait_ms = max(
                        0.0, (stages["plog_durable"]
                              - stages["append_plog"]) * 1000.0)
                tracer.perf = pc
                if wspan is not None:
                    perf.merge_span_perf(wspan.tags, pc)
            self.slow_log.observe(tracer)
            if self._write_latency is None:
                self._write_latency = self.server.metrics.percentile(
                    "write_latency_ms")
            self._write_latency.set(tracer.total_ms())
        if wspan is not None:
            wspan.finish()

    def has_ingested(self, load_id: int) -> bool:
        """Group-visible ingest dedup: the marker is written by EVERY
        member at apply time, so whoever becomes primary after a failover
        knows the load already committed and will not replicate a second
        OP_INGEST (which could resurrect keys deleted in between)."""
        if load_id in self._ingested_load_ids:
            return True
        marker = os.path.join(self.data_dir, ".ingested_loads")
        if os.path.exists(marker):
            import json as _json

            with open(marker) as f:
                self._ingested_load_ids = set(_json.load(f))
        return load_id in self._ingested_load_ids

    def _record_ingested(self, load_id: int) -> None:
        import json as _json

        self.has_ingested(load_id)  # hydrate from disk first
        self._ingested_load_ids.add(load_id)
        marker = os.path.join(self.data_dir, ".ingested_loads")
        tmp = marker + ".tmp"
        with open(tmp, "w") as f:
            _json.dump(sorted(self._ingested_load_ids), f)
        os.replace(tmp, marker)

    def _make_idempotent(self, ops: List[WriteOp], ts: int):
        """The (single — atomic ops never batch) atomic op -> the
        concrete dup-tagged puts/removes it resolves to, plus the
        response object to hand the client. Each output op gets ITS OWN
        microsecond (ts + i): two mutates of the same sort key in one
        check_and_mutate must not tie on timetag, or the dup floor would
        silently drop the later one. The caller re-reserves the
        timestamp range by the OUTPUT count."""
        from pegasus_tpu_torch.base.value_schema import (
            extract_user_data,
            generate_timetag,
        )
        from pegasus_tpu_torch.storage.wal import OP_PUT as ITEM_PUT

        ws = self.server.write_service
        now = max(0, ts // 1_000_000 - PEGASUS_EPOCH_BEGIN)
        assert len(ops) == 1, "atomic ops never batch"
        wo = ops[0]
        if wo.op == OP_INCR:
            resp, items = ws.translate_incr(wo.request, ts, now)
        elif wo.op == OP_CAS:
            resp, items = ws.translate_check_and_set(wo.request, ts, now)
        else:
            resp, items = ws.translate_check_and_mutate(wo.request, ts,
                                                        now)
        out_ops: List[WriteOp] = []
        for i, it in enumerate(items):
            if it.op == ITEM_PUT:
                user_data = extract_user_data(ws.data_version, it.value)
                out_ops.append(WriteOp(
                    OP_DUP_PUT,
                    (it.key, user_data, it.expire_ts,
                     generate_timetag(ts + i, ws.cluster_id, False))))
            else:
                out_ops.append(WriteOp(
                    OP_DUP_REMOVE,
                    (it.key,
                     generate_timetag(ts + i, ws.cluster_id, True))))
        # the op may resolve to NO writes (failed check / error): the
        # mutation ships empty and the decree still advances
        return out_ops, [resp]

    def _apply_ingest(self, request, decree: int) -> int:
        """Download this partition's staged SST and ingest it at `decree`."""
        import json as _json
        import tempfile

        from pegasus_tpu_torch.server.bulk_load import (
            BULK_LOAD_FILE,
            BULK_LOAD_INFO,
        )
        from pegasus_tpu_torch.storage.block_service import block_service_for
        from pegasus_tpu_torch.utils.errors import StorageStatus

        root, src_app, load_id = request
        if self.has_ingested(load_id):
            # replayed or duplicated ingest mutation: decree advances,
            # data does not re-apply
            self.server.write_service.apply_items([], decree)
            return int(StorageStatus.OK)
        bs = block_service_for(root)
        info = _json.loads(bs.read_file(f"{src_app}/{BULK_LOAD_INFO}"))
        if info["partition_count"] != self.server.partition_count:
            # still stamp the decree: the mutation is committed groupwide
            # and the watermark must advance identically on every member
            self.server.write_service.apply_items([], decree)
            return int(StorageStatus.INVALID_ARGUMENT)
        remote = f"{src_app}/{self.server.pidx}/{BULK_LOAD_FILE}"
        if not bs.exists(remote):
            with self.server._write_lock:
                self.server.write_service.apply_items([], decree)
            return int(StorageStatus.OK)  # nothing staged for this pidx
        try:
            with tempfile.TemporaryDirectory(prefix="pegingest") as tmp:
                local = os.path.join(tmp, "ingest.sst")
                # the (possibly slow) block-service download runs
                # UNLOCKED; only the engine mutation itself needs the
                # single-writer exclusion (same split as bulk_load.py)
                bs.download(remote, local)
                with self.server._write_lock:
                    self.server.engine.ingest_sst_file(local, decree)
            self._record_ingested(load_id)
        except (OSError, ValueError):
            # staged files must stay immutable+present for the whole load
            # (same contract as the reference). If they vanish mid-apply,
            # STILL stamp the decree — a committed mutation must advance
            # the watermark identically on every member — and surface the
            # failure so meta aborts the load.
            with self.server._write_lock:
                self.server.write_service.apply_items([], decree)
            return int(StorageStatus.IO_ERROR)
        return int(StorageStatus.OK)

    # ---- learning (parity: replica_learn.cpp) -------------------------

    @_serial
    def add_learner(self, learner: str) -> None:
        """Primary: start shipping new prepares to the learner and tell it
        to init_learn (parity: RPC_LEARN_ADD_LEARNER)."""
        if self.status != PartitionStatus.PRIMARY:
            raise RuntimeError("only the primary adds learners")
        self._learners[learner] = self.last_prepared_decree() + 1
        self.transport.send(self.name, learner, "add_learner", {
            "ballot": self.config.ballot,
            "partition_count": self.server.partition_count})

    def _on_add_learner(self, src: str, payload: dict) -> None:
        if payload["ballot"] < self.config.ballot:
            return
        self.status = PartitionStatus.POTENTIAL_SECONDARY
        self.config = replace(self.config, ballot=payload["ballot"],
                              primary=src)
        self.transport.send(self.name, src, "learn_request", {
            "last_committed": self.last_committed_decree})

    def _on_learn_request(self, src: str, payload: dict) -> None:
        """Primary chooses the learn type (parity: on_learn :361)."""
        from pegasus_tpu_torch.utils.fail_point import fail_point

        if fail_point(f"{self.name}::learn_checkpoint") is not None:
            # checkpoint materialization failed on the learn source: no
            # response — the learner stays POTENTIAL_SECONDARY and the
            # guardian's next add-learner proposal retries the learn
            return
        learner_lc = payload["last_committed"]
        gc_floor = self.server.engine.last_flushed_decree
        if learner_lc >= gc_floor:
            # private log covers the gap -> ship mutations (LT_LOG; the
            # reference's LT_CACHE case folds in: cached mutations are in
            # the log too)
            # ship the whole tail INCLUDING the uncommitted window: the
            # learner must hold every in-flight decree or the first new
            # prepare after its registration point would hit a gap
            mutations = self.log.read_range(learner_lc + 1)
            self.transport.send(self.name, src, "learn_response", {
                "type": LT_LOG,
                "mutations": [mu.encode() for mu in mutations],
                "last_committed": self.last_committed_decree,
            })
        else:
            # gap extends below the log GC floor -> checkpoint copy
            # (LT_APP). Materialize a frozen snapshot via
            # engine.checkpoint() and advertise THAT path — never the live
            # sst dir: a concurrent flush/compaction deletes old L0/L1
            # files mid-copy, so a learner walking the live dir can fail
            # or capture a mixed-generation file set. The reference copies
            # a checkpoint.<decree> dir (replica_learn.cpp:504 +
            # nfs/nfs_node.h:84); the snapshot is GC'd on learn
            # completion/abort.
            ckpt_dir = os.path.join(self.server.engine.data_dir,
                                    f"learn.ckpt.{src}")
            shutil.rmtree(ckpt_dir, ignore_errors=True)
            ckpt_decree = self.server.checkpoint(ckpt_dir)
            self._learn_ckpt_dirs[src] = ckpt_dir
            self.transport.send(self.name, src, "learn_response", {
                "type": LT_APP,
                "checkpoint_dir": ckpt_dir,
                "checkpoint_node": self.name,
                "checkpoint_decree": ckpt_decree,
                "mutations": [mu.encode() for mu in self.log.read_range(
                    ckpt_decree + 1)],
                "last_committed": self.last_committed_decree,
            })

    def _on_learn_response(self, src: str, payload: dict) -> None:
        """Learner applies learned state (parity: on_learn_reply :571,
        on_copy_remote_state_completed :1001). An LT_APP checkpoint on a
        DIFFERENT host (no shared fs) is pulled asynchronously through
        the file-transfer service first — the nfs copy_remote_files leg."""
        from pegasus_tpu_torch.utils.fail_point import fail_point

        if fail_point(f"{self.name}::learn_apply") is not None:
            # aio failure applying learned state: abort THIS attempt;
            # the replica stays POTENTIAL_SECONDARY and a later
            # add-learner round retries from scratch
            return
        if payload["type"] == LT_APP:
            ckpt = payload["checkpoint_dir"]
            if not (self.shared_fs and os.path.exists(ckpt)):
                if self.on_remote_checkpoint is not None:
                    self.on_remote_checkpoint(src, payload)
                    return  # complete_remote_learn resumes after the copy
                return  # unreachable checkpoint and no transfer: give up
            self._apply_learned_checkpoint(ckpt,
                                           payload["checkpoint_decree"])
        self._finish_learn(src, payload)

    def complete_remote_learn(self, src: str, payload: dict,
                              local_ckpt_dir: str) -> None:
        """File-transfer completion: apply the fetched checkpoint and
        finish the learn exactly like the shared-fs path."""
        self._apply_learned_checkpoint(local_ckpt_dir,
                                       payload["checkpoint_decree"])
        self._finish_learn(src, payload)

    def _finish_learn(self, src: str, payload: dict) -> None:
        for blob in payload["mutations"]:
            mu = Mutation.decode(blob)
            if mu.decree <= self.last_committed_decree:
                continue
            self.prepare_list.prepare(mu)
            self._log_append(mu)
        self.prepare_list.commit(payload["last_committed"],
                                 COMMIT_TO_DECREE_HARD)
        # completion claims the learner HOLDS the tail — wait for the
        # window's shared flush like any other post-append ack
        self._after_durable(lambda: self.transport.send(
            self.name, src, "learn_completion", {}))

    def _apply_learned_checkpoint(self, checkpoint_dir: str,
                                  checkpoint_decree: int) -> None:
        """Replace local storage with the learned checkpoint (parity:
        storage_apply_checkpoint, replication_app_base.h:229)."""
        from pegasus_tpu_torch.storage.engine import StorageEngine

        app_dir = self.server.engine.data_dir
        self.server.engine.close()
        sst_dir = os.path.join(app_dir, "sst")
        shutil.rmtree(sst_dir, ignore_errors=True)
        # decrypt/re-encrypt aware: primary and learner hold different
        # data keys when at-rest encryption is on
        from pegasus_tpu_torch.storage.efile import copy_data_tree
        copy_data_tree(checkpoint_dir, sst_dir)
        wal = os.path.join(app_dir, "wal.log")
        if os.path.exists(wal):
            os.remove(wal)
        self.server.install_engine(StorageEngine(
            app_dir, device=self.server.device))
        if self.server.engine.last_committed_decree < checkpoint_decree:
            raise RuntimeError(
                f"learned checkpoint reaches decree "
                f"{self.server.engine.last_committed_decree}, primary "
                f"advertised {checkpoint_decree}")
        self.prepare_list.reset(self.server.engine.last_committed_decree)

    def _on_learn_completion(self, src: str, payload: dict) -> None:
        """Primary: learner caught up; hand to the control plane for the
        config change that upgrades it (parity:
        RPC_LEARN_COMPLETION_NOTIFY -> meta config update)."""
        ckpt = self._learn_ckpt_dirs.pop(src, None)
        if ckpt is not None:
            shutil.rmtree(ckpt, ignore_errors=True)
        if self.on_learn_completed is not None:
            self.on_learn_completed(src)

    # ---- maintenance --------------------------------------------------

    def flush_and_gc_log(self) -> None:
        """Make storage durable, then GC the private log below the durable
        decree — capped by duplication progress: unshipped mutations must
        survive GC or duplication stalls forever (parity: the reference
        holds plog GC back by the dup confirmed decree,
        mutation_log.h:213 + duplication progress plumbing)."""
        from pegasus_tpu_torch.utils.fail_point import fail_point

        if fail_point(f"{self.name}::checkpoint") is not None:
            # a failed checkpoint must leave the WAL un-GC'd: nothing
            # durable moved, so recovery still replays everything
            return
        # PartitionServer.flush carries the single-writer exclusion: a
        # flush swaps the memtable, which must not interleave with the
        # async compaction thread's own overlay reset
        self.server.flush()
        floor = self.server.engine.last_flushed_decree
        for dup in self.duplicators:
            floor = min(floor, dup.confirmed_decree)
        self.log.gc(floor)
