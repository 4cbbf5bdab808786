"""Meta-side backup orchestration.

Parity: src/meta/meta_backup_service.h:360 (policy scheduler + one-shot
backups) and backup_engine.h:68 (per-partition progress tracking). The
replica side (checkpoint → block-service upload) already exists in
server/backup.py; this service owns WHICH partitions back up, retries
through failovers, persists in-flight state so a meta restart resumes,
and stamps the completion metadata.

Protocol:
    meta  → primary : "backup_partition" {gpid, backup_id, policy, root}
    primary → meta  : "backup_partition_done" {gpid, backup_id, decree}
Retries ride the meta tick: any still-pending partition is re-sent to
its CURRENT primary (idempotent server-side — re-uploading a checkpoint
overwrites the same remote path).

Restore: `create_app_from_backup` makes a primary-only table whose
primaries download their checkpoint before the guardian is allowed to
add learners (otherwise a learner could copy the pre-restore empty
state and later serve it).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Set, Tuple

from pegasus_tpu_torch.server.backup import BackupEngine, BackupPolicy
from pegasus_tpu_torch.storage.block_service import block_service_for
from pegasus_tpu_torch.utils.errors import ErrorCode, PegasusError

Gpid = Tuple[int, int]


class MetaBackupService:
    def __init__(self, meta) -> None:
        self.meta = meta
        # persisted: policies + in-flight backups survive a meta restart
        self._policies: Dict[str, dict] = {}
        self._inflight: Dict[int, dict] = {}
        # finished ids (bounded): lets backup_status tell "done" from
        # "never heard of it" — an unknown id must NOT read as complete
        self._completed: Dict[int, dict] = {}
        self._last_policy_run: Dict[str, float] = {}
        self._load()

    # ---- persistence ---------------------------------------------------

    def _load(self) -> None:
        st = self.meta.state._storage
        self._policies = st.get("/backup/policies") or {}
        raw = st.get("/backup/inflight") or {}
        self._inflight = {int(k): v for k, v in raw.items()}
        done = st.get("/backup/completed") or {}
        self._completed = {int(k): v for k, v in done.items()}

    def _save(self) -> None:
        self.meta.state._storage.set_batch({
            "/backup/policies": self._policies,
            "/backup/inflight": {str(k): v
                                 for k, v in self._inflight.items()},
            "/backup/completed": {str(k): v
                                  for k, v in self._completed.items()},
        })

    # ---- policies (parity: add/ls/modify policy RPCs) ------------------

    def add_policy(self, name: str, app_names: List[str], root: str,
                   interval_seconds: int = 86400,
                   backup_history_count: int = 3) -> None:
        if name in self._policies:
            raise PegasusError(ErrorCode.ERR_LOCK_ALREADY_EXIST, name)
        if interval_seconds < 1 or backup_history_count < 1:
            raise PegasusError(
                ErrorCode.ERR_INVALID_PARAMETERS,
                f"interval {interval_seconds} / history "
                f"{backup_history_count}")
        self._policies[name] = {
            "name": name, "app_names": list(app_names), "root": root,
            "interval_seconds": interval_seconds,
            "backup_history_count": backup_history_count,
            "enabled": True,
        }
        self._save()

    def list_policies(self) -> List[dict]:
        return list(self._policies.values())

    def query_policy(self, name: str) -> dict:
        pol = self._policies.get(name)
        if pol is None:
            raise PegasusError(ErrorCode.ERR_OBJECT_NOT_FOUND, name)
        recent = [{"backup_id": bid, **info}
                  for bid, info in self._completed.items()
                  if info["policy"] == name][-8:]
        return dict(pol, recent_backups=recent)

    def modify_policy(self, name: str,
                      add_apps: Optional[List[str]] = None,
                      remove_apps: Optional[List[str]] = None,
                      interval_seconds: Optional[int] = None,
                      backup_history_count: Optional[int] = None) -> dict:
        """Parity: modify_backup_policy — add/remove covered tables,
        retune the schedule."""
        pol = self._policies.get(name)
        if pol is None:
            raise PegasusError(ErrorCode.ERR_OBJECT_NOT_FOUND, name)
        for a in add_apps or []:
            if a not in pol["app_names"]:
                pol["app_names"].append(a)
        for a in remove_apps or []:
            if a in pol["app_names"]:
                pol["app_names"].remove(a)
        if interval_seconds is not None:
            if interval_seconds < 1:
                raise PegasusError(ErrorCode.ERR_INVALID_PARAMETERS,
                                   f"interval {interval_seconds}")
            pol["interval_seconds"] = interval_seconds
        if backup_history_count is not None:
            if backup_history_count < 1:
                raise PegasusError(ErrorCode.ERR_INVALID_PARAMETERS,
                                   f"history count {backup_history_count}")
            pol["backup_history_count"] = backup_history_count
        self._save()
        return pol

    def on_app_renamed(self, old_name: str, new_name: str) -> None:
        """Keep name-keyed policy coverage intact across a rename."""
        changed = False
        for pol in self._policies.values():
            if old_name in pol["app_names"]:
                pol["app_names"] = [new_name if a == old_name else a
                                    for a in pol["app_names"]]
                changed = True
        if changed:
            self._save()

    def enable_policy(self, name: str, enabled: bool) -> None:
        """Parity: enable/disable_backup_policy — a disabled policy keeps
        its history and config but schedules nothing."""
        pol = self._policies.get(name)
        if pol is None:
            raise PegasusError(ErrorCode.ERR_OBJECT_NOT_FOUND, name)
        pol["enabled"] = enabled
        self._save()

    # ---- one-shot backup ----------------------------------------------

    def start_backup(self, app_name: str, root: str,
                     policy: str = "manual",
                     backup_id: Optional[int] = None) -> int:
        app = self.meta.state.find_app(app_name)
        if app is None:
            raise PegasusError(ErrorCode.ERR_APP_NOT_EXIST, app_name)
        backup_id = backup_id or int(time.time() * 1000)
        while backup_id in self._inflight:
            backup_id += 1  # same-millisecond starts must not collide
        self._inflight[backup_id] = {
            "app_id": app.app_id, "app_name": app_name,
            "partition_count": app.partition_count,
            "policy": policy, "root": root,
            "pending": list(range(app.partition_count)),
            "decrees": {},
        }
        self._save()
        self._drive_backup(backup_id)
        return backup_id

    def backup_status(self, backup_id: int) -> dict:
        info = self._inflight.get(backup_id)
        if info is not None:
            return {"backup_id": backup_id, "complete": False,
                    "pending": list(info["pending"])}
        if backup_id in self._completed:
            return {"backup_id": backup_id, "complete": True,
                    "pending": []}
        return {"backup_id": backup_id, "complete": False,
                "pending": [], "unknown": True}

    def _drive_backup(self, backup_id: int) -> None:
        info = self._inflight[backup_id]
        for pidx in list(info["pending"]):
            pc = self.meta.state.get_partition(info["app_id"], pidx)
            if not pc.primary:
                continue
            self.meta.net.send(self.meta.name, pc.primary,
                               "backup_partition", {
                                   "gpid": (info["app_id"], pidx),
                                   "backup_id": backup_id,
                                   "policy": info["policy"],
                                   "root": info["root"]})

    def on_backup_partition_done(self, payload: dict) -> None:
        backup_id = payload["backup_id"]
        info = self._inflight.get(backup_id)
        if info is None:
            return
        gpid = tuple(payload["gpid"])
        if gpid[1] in info["pending"]:
            info["pending"].remove(gpid[1])
            info["decrees"][str(gpid[1])] = payload["decree"]
        if not info["pending"]:
            engine = BackupEngine(block_service_for(info["root"]),
                                  info["policy"])
            engine.finish_backup(backup_id, info["app_id"],
                                 info["app_name"],
                                 info["partition_count"])
            hist = self._policies.get(info["policy"], {}).get(
                "backup_history_count")
            if hist:
                try:
                    engine.gc_old_backups(hist)
                except IOError:
                    # history GC is best-effort housekeeping: a blob-
                    # store fault here must not wedge the backup's
                    # COMPLETION bookkeeping (the next policy-driven
                    # backup retries the GC)
                    pass
            del self._inflight[backup_id]
            self._completed[backup_id] = {
                "root": info["root"], "policy": info["policy"],
                "app_name": info["app_name"]}
            # bounded history, oldest-FINISHED first (dict insertion
            # order — ids may be caller-supplied and not time-ordered)
            while len(self._completed) > 256:
                self._completed.pop(next(iter(self._completed)))
        self._save()

    # ---- restore (parity: server_state_restore.cpp) --------------------

    def create_app_from_backup(self, new_name: str, root: str,
                               policy: str, backup_id: int,
                               replica_count: int = 3) -> int:
        engine = BackupEngine(block_service_for(root), policy)
        meta_blob = engine.read_backup_metadata(backup_id)
        app_id = self.meta.create_app(
            new_name, meta_blob["partition_count"], replica_count,
            restore_from={"root": root, "policy": policy,
                          "backup_id": backup_id,
                          "src_app_id": meta_blob["app_id"]})
        return app_id

    def drive_restores(self) -> None:
        """Tick: (re)send restore commands for pending partitions."""
        for gpid, info in list(self.meta.pending_restores.items()):
            pc = self.meta.state.get_partition(*gpid)
            if not pc.primary:
                continue
            self.meta.net.send(self.meta.name, pc.primary,
                               "restore_partition", {
                                   "gpid": gpid,
                                   "backup_id": info["backup_id"],
                                   "policy": info["policy"],
                                   "root": info["root"],
                                   "src_app_id": info["src_app_id"]})

    def on_restore_partition_done(self, payload: dict) -> None:
        self.meta.pending_restores.pop(tuple(payload["gpid"]), None)
        self.meta.persist_pending_restores()

    # ---- timer ---------------------------------------------------------

    def tick(self) -> None:
        now = self.meta.clock()
        for name, pol in self._policies.items():
            if not pol.get("enabled", True):
                continue
            last = self._last_policy_run.get(name)
            if last is not None and now - last < pol["interval_seconds"]:
                continue
            self._last_policy_run[name] = now
            for app_name in pol["app_names"]:
                if self.meta.state.find_app(app_name) is not None:
                    self.start_backup(app_name, pol["root"], name)
        for backup_id in list(self._inflight):
            self._drive_backup(backup_id)
        self.drive_restores()
