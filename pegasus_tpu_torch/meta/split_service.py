"""Meta-side partition split orchestration.

Parity: src/meta/meta_split_service.h:34 — drives the in-place 2x
partition-count doubling: commands every parent partition's primary to
spawn its child (replica_split_manager.h:58 does the replica-side state
copy + catch-up), registers each child partition as it reports in, and
flips the app's partition count once EVERY child is registered. The
flip propagates through config proposals; parents drop their write
fence on receiving the new count, and clients pick it up via the
partition-hash gate + config refresh (ERR_PARENT_PARTITION_MISUSED).

Split state is persisted: a meta restart mid-split keeps driving it.
"""

from __future__ import annotations

from typing import Dict

from pegasus_tpu_torch.meta.server_state import PartitionConfig
from pegasus_tpu_torch.utils.errors import ErrorCode, PegasusError


class MetaSplitService:
    def __init__(self, meta) -> None:
        self.meta = meta
        # app_id -> {old_count, new_count, registered: [child_pidx]}
        self._splits: Dict[int, dict] = {}
        self._load()

    def _load(self) -> None:
        raw = self.meta.state._storage.get("/split/inflight") or {}
        self._splits = {int(k): v for k, v in raw.items()}

    def _save(self) -> None:
        self.meta.state._storage.set_batch({"/split/inflight": {
            str(k): v for k, v in self._splits.items()}})

    # ---- control surface (parity: RPC_CM_START_PARTITION_SPLIT) --------

    def start_partition_split(self, app_name: str) -> int:
        app = self.meta.state.find_app(app_name)
        if app is None:
            raise PegasusError(ErrorCode.ERR_APP_NOT_EXIST, app_name)
        if app.app_id in self._splits:
            raise PegasusError(ErrorCode.ERR_SPLITTING, app_name)
        if app.partition_count & (app.partition_count - 1):
            raise PegasusError(
                ErrorCode.ERR_INVALID_PARAMETERS,
                "split requires a power-of-two partition count")
        # serialize against the balancer: a copy-secondary move in
        # flight on this app rides the learner flow, and the count flip
        # would land it on a pre-split config (the mirror guard of
        # MetaService.rebalance skipping splitting apps)
        pending = sorted(g for g in set(self.meta._pending_moves)
                         | set(self.meta._pending_learns)
                         if g[0] == app.app_id)
        if pending:
            raise PegasusError(
                ErrorCode.ERR_INVALID_STATE,
                f"balancer/learner moves pending on {app_name}: "
                f"{pending} — retry once they land")
        # only split a HEALTHY table: every parent needs an alive
        # primary to checkpoint from (a quarantined/dead partition is
        # mid-repair — splitting would copy from nothing or race the
        # re-learn), and a restoring partition has no data yet
        for pidx in range(app.partition_count):
            gpid = (app.app_id, pidx)
            if gpid in self.meta.pending_restores:
                raise PegasusError(ErrorCode.ERR_INVALID_STATE,
                                   f"partition {pidx} is restoring")
            pc = self.meta.state.get_partition(app.app_id, pidx)
            if not pc.primary or not self.meta.fd.is_alive(pc.primary):
                raise PegasusError(
                    ErrorCode.ERR_INVALID_STATE,
                    f"partition {pidx} has no alive primary "
                    "(unhealthy/quarantined) — split refused")
        self._splits[app.app_id] = {
            "old_count": app.partition_count,
            "new_count": app.partition_count * 2,
            "registered": [],
        }
        self._save()
        self._drive(app.app_id)
        return app.partition_count * 2

    def split_status(self, app_name: str) -> dict:
        app = self.meta.state.find_app(app_name)
        if app is None:
            raise PegasusError(ErrorCode.ERR_APP_NOT_EXIST, app_name)
        info = self._splits.get(app.app_id)
        if info is None:
            return {"splitting": False,
                    "partition_count": app.partition_count}
        return {"splitting": True, "old_count": info["old_count"],
                "registered": sorted(info["registered"])}

    # ---- driving -------------------------------------------------------

    def _drive(self, app_id: int) -> None:
        info = self._splits.get(app_id)
        if info is None:
            return
        for pidx in range(info["old_count"]):
            child_pidx = pidx + info["old_count"]
            if child_pidx in info["registered"]:
                continue
            pc = self.meta.state.get_partition(app_id, pidx)
            if not pc.primary:
                continue
            self.meta.net.send(self.meta.name, pc.primary, "start_split", {
                "gpid": (app_id, pidx),
                "child_gpid": (app_id, child_pidx),
                "new_count": info["new_count"]})

    def is_parent_fenced(self, app_id: int, pidx: int) -> bool:
        """A parent whose child has registered must stay write-fenced on
        WHOEVER is its primary until the flip: a failover would otherwise
        hand primaryship to an unfenced node whose writes to the child
        half silently vanish at the flip. The flag rides in every config
        proposal, so a new primary is fenced in the same message that
        promotes it."""
        info = self._splits.get(app_id)
        return (info is not None
                and pidx + info["old_count"] in info["registered"])

    def on_register_child(self, src: str, payload: dict) -> None:
        """Parity: register_child_on_meta — the child partition enters the
        cluster state; the count flips once every child is in."""
        child = tuple(payload["child_gpid"])
        app_id = child[0]
        info = self._splits.get(app_id)
        if info is None:
            return
        app = self.meta.state.apps.get(app_id)
        if app is None:
            return
        if child[1] not in info["registered"]:
            info["registered"].append(child[1])
            # the child starts primary-only on the node that built it;
            # the guardian restores the replication level after the flip
            self.meta.state.set_partition_raw(
                app_id, child[1],
                PartitionConfig(ballot=1, primary=payload["primary"],
                                secondaries=[]))
            self._save()
            # re-propose the parent config ballot+1 carrying the fence
            # flag — the CURRENT primary (which may have changed since
            # the drain) learns it must stay fenced until the flip
            parent_pidx = child[1] - info["old_count"]
            pc = self.meta.state.get_partition(app_id, parent_pidx)
            new_pc = PartitionConfig(ballot=pc.ballot + 1,
                                     primary=pc.primary,
                                     secondaries=list(pc.secondaries))
            self.meta.state.update_partition(app_id, parent_pidx, new_pc)
            self.meta._propose(app_id, parent_pidx, new_pc)
        if len(info["registered"]) == info["old_count"]:
            self._finish(app_id, info)

    def _unregister_child(self, app_id: int, info: dict,
                          child_pidx: int) -> None:
        """Forget a registered child (its only replica died or
        quarantined pre-flip): clear its config, unfence + re-propose
        the parent so a fresh spawn re-registers it. The parent still
        holds the full pre-split key range until the post-flip
        compaction GC, so nothing is lost."""
        info["registered"].remove(child_pidx)
        self.meta.state.set_partition_raw(app_id, child_pidx,
                                          PartitionConfig())
        parent_pidx = child_pidx - info["old_count"]
        pc = self.meta.state.get_partition(app_id, parent_pidx)
        new_pc = PartitionConfig(ballot=pc.ballot + 1,
                                 primary=pc.primary,
                                 secondaries=list(pc.secondaries))
        self.meta.state.update_partition(app_id, parent_pidx, new_pc)
        self.meta._propose(app_id, parent_pidx, new_pc)

    def on_replica_corrupted(self, gpid, src_node: str) -> bool:
        """PR 5 quarantine firing mid-split: when the corrupt replica is
        a REGISTERED (pre-flip, single-replica) child, the usual
        remove-and-relearn cure cannot apply — there is no healthy peer
        of the child to learn from. Unregister it and re-drive the
        parent, which re-spawns the child from its own (healthy) state.
        Returns True when the report was consumed here."""
        app_id, pidx = gpid
        info = self._splits.get(app_id)
        if info is None or pidx not in info["registered"]:
            return False
        pc = self.meta.state.get_partition(app_id, pidx)
        if pc.primary != src_node:
            return False  # stale/duplicate report for a re-spawned child
        self._unregister_child(app_id, info, pidx)
        self._save()
        self._drive(app_id)
        return True

    def _finish(self, app_id: int, info: dict) -> None:
        # a registered child whose (single-replica) primary died before
        # the flip would be an empty partition after it — unregister and
        # let the tick re-split it from the parent, which still holds the
        # full pre-split key range until the post-flip compaction GC
        dead = [cp for cp in info["registered"]
                if not self.meta.fd.is_alive(
                    self.meta.state.get_partition(app_id, cp).primary)]
        if dead:
            for cp in dead:
                self._unregister_child(app_id, info, cp)
            self._save()
            self._drive(app_id)
            return
        app = self.meta.state.apps[app_id]
        app.partition_count = info["new_count"]
        self.meta.state.put_app(app)
        del self._splits[app_id]
        self._save()
        # propagate the flip: every partition (parents AND children) gets
        # a proposal carrying the new count; parents unfence on receipt
        for pidx in range(info["new_count"]):
            pc = self.meta.state.get_partition(app_id, pidx)
            self.meta._propose(app_id, pidx, pc)

    def tick(self) -> None:
        for app_id in list(self._splits):
            self._drive(app_id)
