"""Cross-cluster duplication: tail the private log, batch, ship, confirm.

Parity: src/replica/duplication/ — the per-replica pipeline
(replica_duplicator.h:79): load_mutation (tail the private log from the
last confirmed decree, load_from_private_log.h:47) -> mutation_batch ->
ship_mutation (duplication_pipeline.h:66) through a pluggable backend
(mutation_duplicator.h, implemented for Pegasus targets by
pegasus_mutation_duplicator.h:56 shipping via the remote cluster's
client). Progress (confirmed decree) is reported upward the way
duplication_sync_timer syncs it to meta.

Conflict handling on the follower: value-v1 timetags decide
(base/pegasus_value_schema.h:175-209) — the shipped write applies only if
its timetag beats the follower's current record (WriteService.duplicate_*).

Limitation (parity note): non-idempotent atomic ops (incr/cas/cam) must
be translated to idempotent puts BEFORE duplication, as the reference
does with idempotent_writer (replica/idempotent_writer.h); this pipeline
refuses to ship raw atomic mutations.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from pegasus_tpu_torch.base.key_schema import generate_key, key_hash
from pegasus_tpu_torch.base.value_schema import (
    PEGASUS_EPOCH_BEGIN,
    expire_ts_from_ttl,
    generate_timetag,
)
from pegasus_tpu_torch.replica.mutation import ATOMIC_OPS, Mutation
from pegasus_tpu_torch.rpc.codec import (
    OP_MULTI_PUT,
    OP_MULTI_REMOVE,
    OP_PUT,
    OP_REMOVE,
)

DS_INIT = "init"
DS_START = "start"
DS_PAUSE = "pause"
DS_REMOVED = "removed"


@dataclass
class DuplicationInfo:
    """Parity: duplication_info (meta/duplication/duplication_info.h) —
    id, follower cluster, status, per-partition confirmed decrees."""

    dupid: int
    follower_cluster: str
    status: str = DS_START
    progress: Dict[int, int] = field(default_factory=dict)  # pidx -> decree


class TableShipper:
    """Applies shipped mutations to a follower table, routing every key by
    the FOLLOWER's partition count (clusters may differ) and resolving
    conflicts via timetags (parity: pegasus_mutation_duplicator sending
    duplicate-tagged writes through the remote client).

    `source_cluster_id` is the master cluster's id — it rides in every
    shipped timetag so equal-timestamp master-master writes still resolve
    deterministically (the cluster-id tiebreak in the timetag layout)."""

    def __init__(self, follower_table, source_cluster_id: int = 1) -> None:
        self.table = follower_table
        self.source_cluster_id = source_cluster_id

    def ship(self, mu: Mutation) -> int:
        """Ships one mutation; returns how many writes applied (lost
        conflicts still confirm — they were delivered)."""
        applied = 0
        # the mutation's own timestamp anchors TTL arithmetic: shipping
        # delay must not restart TTL clocks on the follower
        mu_now = max(0, mu.timestamp_us // 1_000_000 - PEGASUS_EPOCH_BEGIN)
        for i, wo in enumerate(mu.ops):
            # per-op timetags stay unique + ordered within the mutation
            # (the primary reserves len(ops) microseconds per mutation)
            timetag = generate_timetag(mu.timestamp_us + i,
                                       self.source_cluster_id, False)
            applied += self._ship_op(wo.op, wo.request, timetag, mu_now)
        return applied

    def _server_for(self, key: bytes):
        pidx = key_hash(key) % self.table.partition_count
        return self.table.partitions[pidx]

    def _ship_op(self, op: int, req, timetag: int, mu_now: int) -> int:
        if op in ATOMIC_OPS:
            raise ValueError(
                "atomic mutations must be idempotent-translated before "
                "duplication (reference: idempotent_writer)")
        applied = 0
        if op == OP_PUT:
            key, user_data, expire_ts = req
            server = self._server_for(key)
            with server._write_lock:
                applied += server.write_service.duplicate_put(
                    key, user_data, expire_ts, timetag,
                    server._next_decree())
        elif op == OP_REMOVE:
            (key,) = req
            server = self._server_for(key)
            with server._write_lock:
                applied += server.write_service.duplicate_remove(
                    key, timetag, server._next_decree())
        elif op == OP_MULTI_PUT:
            expire_ts = expire_ts_from_ttl(req.expire_ts_seconds, now=mu_now)
            for kv in req.kvs:
                key = generate_key(req.hash_key, kv.key)
                server = self._server_for(key)
                with server._write_lock:
                    applied += server.write_service.duplicate_put(
                        key, kv.value, expire_ts, timetag,
                        server._next_decree())
        elif op == OP_MULTI_REMOVE:
            for sk in req.sort_keys:
                key = generate_key(req.hash_key, sk)
                server = self._server_for(key)
                with server._write_lock:
                    applied += server.write_service.duplicate_remove(
                        key, timetag, server._next_decree())
        else:
            raise ValueError(f"unknown op {op}")
        return applied


class ReplicaDuplicator:
    """The per-partition pipeline owner (parity: replica_duplicator.h:79).

    `shipper` is any object with ship(mutation) — a TableShipper for
    in-proc follower clusters, an RPC client for remote ones.
    """

    def __init__(self, replica, shipper, dupid: int = 1,
                 confirmed_decree: int = 0,
                 on_progress: Optional[Callable[[int, int], None]] = None
                 ) -> None:
        self.replica = replica
        self.shipper = shipper
        self.dupid = dupid
        self.confirmed_decree = confirmed_decree
        self.on_progress = on_progress  # (dupid, confirmed) -> meta sync
        # incremental log tailing state (parity: load_from_private_log);
        # reset when the log is rewritten by GC
        self._log_offset = 0
        self._log_generation = self.replica.log.generation
        # registering holds the replica's log GC back to our progress
        self.replica.duplicators.append(self)

    def sync_round(self) -> int:
        """One load->ship->confirm round (parity: duplication_sync_timer).
        Tails the private log incrementally; ships committed mutations
        beyond the confirmed decree; returns how many shipped.

        Offset discipline: the offset only advances past frames that were
        actually consumed (shipped, or skippable as <= confirmed). A frame
        whose decree is still uncommitted, or a ship failure, stops the
        round WITHOUT advancing — the next round re-reads from there.
        Committed re-proposed frames (same decree, higher ballot) carry
        identical ops, so shipping the first-seen committed frame is safe.
        """
        last_committed = self.replica.last_committed_decree
        log = self.replica.log
        if log.generation != self._log_generation:
            self._log_offset = 0
            self._log_generation = log.generation
        shipped = 0
        for mu, frame_end in log.read_tail(self._log_offset):
            if mu.decree > last_committed:
                break  # not committed yet: do NOT advance past it
            if mu.decree > self.confirmed_decree:
                self.shipper.ship(mu)  # a raise leaves the offset put
                self.confirmed_decree = mu.decree
                shipped += 1
            self._log_offset = frame_end
        if shipped and self.on_progress is not None:
            self.on_progress(self.dupid, self.confirmed_decree)
        return shipped
