"""Meta-side duplication bookkeeping.

Parity: src/meta/duplication/meta_duplication_service.h +
duplication_info.h — dup add/query/remove, per-partition confirmed-
decree bookkeeping persisted in meta state (synced up from primaries the
way duplication_sync_timer reports, meta_service.cpp RPC_CM_DUPLICATION_
SYNC), and re-homing: every tick re-sends dup_add to each partition's
CURRENT primary, so a failover moves the shipping session to the new
primary which resumes from the persisted confirmed decree.
"""

from __future__ import annotations

from typing import Dict, List

from pegasus_tpu_torch.utils.errors import ErrorCode, PegasusError


class MetaDuplicationService:
    def __init__(self, meta) -> None:
        self.meta = meta
        # dupid -> {app_id, app_name, follower_meta, follower_app, status,
        #           progress: {str(pidx): confirmed_decree}}
        self._dups: Dict[int, dict] = {}
        self._next_dupid = 1
        # (dupid, pidx) -> latest per-session health entry from the
        # config-sync `dup` block (lag, shipped bytes, errors, last
        # error), stamped with this meta's receive clock — the
        # cluster-wide dup health surface AND the failover drill's
        # drain evidence (a drain is judged only on reports newer than
        # the fence, so a pre-fence snapshot can never fake "drained")
        self._health: Dict[tuple, dict] = {}
        # app_name -> failover drill state machine (persisted: a meta
        # failover mid-drill resumes fencing/draining where it stood)
        self._failover: Dict[str, dict] = {}
        self._load()

    def _load(self) -> None:
        raw = self.meta.state._storage.get("/duplication/dups") or {}
        self._dups = {int(k): v for k, v in raw.items()}
        self._next_dupid = max(self._dups, default=0) + 1
        self._failover = dict(self.meta.state._storage.get(
            "/duplication/failover") or {})

    def _save(self) -> None:
        self.meta.state._storage.set_batch({
            "/duplication/dups": {
                str(k): v for k, v in self._dups.items()},
            "/duplication/failover": dict(self._failover)})

    # ---- control surface (parity: dup add/query/remove RPCs) ----------

    def add_duplication(self, app_name: str, follower_meta: str,
                        follower_app: str,
                        bootstrap_root: str = "") -> int:
        """`bootstrap_root`: when set, pre-existing data is synced first
        (parity: the reference's DS_PREPARE stage — the follower table is
        created FROM a checkpoint of the master, then incremental log
        shipping starts from the checkpoint decrees; meta_duplication_
        service's follower-table creation). Empty = incremental-only (the
        follower table must already exist)."""
        app = self.meta.state.find_app(app_name)
        if app is None:
            raise PegasusError(ErrorCode.ERR_APP_NOT_EXIST, app_name)
        for info in self._dups.values():
            if (info["app_id"] == app.app_id
                    and info["follower_meta"] == follower_meta
                    and info["follower_app"] == follower_app):
                raise PegasusError(ErrorCode.ERR_DUP_EXIST, app_name)
        dupid = self._next_dupid
        self._next_dupid += 1
        self._dups[dupid] = {
            "app_id": app.app_id, "app_name": app_name,
            "follower_meta": follower_meta, "follower_app": follower_app,
            "status": "bootstrap" if bootstrap_root else "start",
            "bootstrap_root": bootstrap_root,
            "backup_id": 0, "restore_sent": False,
            "progress": {str(p): 0 for p in range(app.partition_count)},
        }
        if bootstrap_root:
            self._dups[dupid]["backup_id"] = (
                self.meta.backup.start_backup(
                    app_name, bootstrap_root, policy=f"dup{dupid}"))
        self._save()
        if not bootstrap_root:
            self._drive(dupid)
        return dupid

    def _tick_bootstrap(self, dupid: int, info: dict) -> None:
        """DS_PREPARE: wait for the master checkpoint, ask the follower
        cluster's meta to create the table from it (RETRIED every tick
        until its admin reply confirms — a dropped message or transient
        error must not stall the dup forever), then seed progress with
        the checkpoint decrees and go incremental."""
        st = self.meta.backup.backup_status(info["backup_id"])
        if not st["complete"]:
            return
        # re-send each tick until on_admin_reply flips the status; the
        # follower's ERR_APP_EXIST makes the retry idempotent
        self.meta.net.send(self.meta.name, info["follower_meta"],
                           "admin", {
                               "rid": f"dupboot-{dupid}",
                               "cmd": "restore_app",
                               "args": {
                                   "new_name": info["follower_app"],
                                   "root": info["bootstrap_root"],
                                   "policy": f"dup{dupid}",
                                   "backup_id": info["backup_id"]}})

    def on_admin_reply(self, payload: dict) -> None:
        """Completion signal for the bootstrap's restore_app verb."""
        import json as _json

        from pegasus_tpu_torch.storage.block_service import block_service_for

        rid = payload.get("rid")
        if not isinstance(rid, str) or not rid.startswith("dupboot-"):
            return
        dupid = int(rid.split("-", 1)[1])
        info = self._dups.get(dupid)
        if info is None or info["status"] != "bootstrap":
            return
        if payload["err"] not in (0, int(ErrorCode.ERR_APP_EXIST)):
            if payload["err"] in (int(ErrorCode.ERR_INVALID_PARAMETERS),
                                  int(ErrorCode.ERR_FILE_OPERATION_FAILED)):
                # permanent: surface it instead of retrying forever
                info["status"] = "failed"
                info["error"] = str(payload.get("result"))
                self._save()
            return  # transient failures: the tick re-sends
        policy = f"dup{dupid}"
        bs = block_service_for(info["bootstrap_root"])
        for pidx_s in list(info["progress"]):
            meta_blob = _json.loads(bs.read_file(
                f"{policy}/{info['backup_id']}/{info['app_id']}/"
                f"{pidx_s}/meta.json"))
            info["progress"][pidx_s] = meta_blob["decree"]
        info["status"] = "start"
        self._save()
        self._drive(dupid)

    def list_all(self) -> List[dict]:
        """Every duplication on the cluster (parity: shell `dups` —
        the cluster-wide listing, vs query_dup's per-table view)."""
        return [dict(info, dupid=dupid)
                for dupid, info in sorted(self._dups.items())]

    def query_duplication(self, app_name: str) -> List[dict]:
        app = self.meta.state.find_app(app_name)
        if app is None:
            raise PegasusError(ErrorCode.ERR_APP_NOT_EXIST, app_name)
        return [dict(info, dupid=dupid)
                for dupid, info in self._dups.items()
                if info["app_id"] == app.app_id]

    def remove_duplication(self, dupid: int) -> None:
        info = self._dups.pop(dupid, None)
        self._save()
        if info is None:
            return
        self._stop_sessions(dupid, info)

    def _stop_sessions(self, dupid: int, info: dict) -> None:
        for pidx in range(len(info["progress"])):
            pc = self.meta.state.get_partition(info["app_id"], pidx)
            for node in pc.members():
                self.meta.net.send(self.meta.name, node, "dup_remove", {
                    "gpid": (info["app_id"], pidx), "dupid": dupid})

    def pause_duplication(self, dupid: int) -> None:
        """Parity: the shell's pause_dup (dup status DS_PAUSE). Replica
        sessions are torn down; confirmed progress stays at meta, so
        resuming re-ships from the confirmed decree (idempotent on the
        follower via timetags)."""
        info = self._dups.get(dupid)
        if info is None:
            raise PegasusError(ErrorCode.ERR_OBJECT_NOT_FOUND, str(dupid))
        if info["status"] != "start":
            raise PegasusError(
                ErrorCode.ERR_INVALID_STATE,
                f"dup {dupid} is {info['status']}, not started")
        info["status"] = "pause"
        self._save()
        self._stop_sessions(dupid, info)

    def resume_duplication(self, dupid: int) -> None:
        """Parity: start_dup on a paused duplication (DS_PAUSE->DS_START)."""
        info = self._dups.get(dupid)
        if info is None:
            raise PegasusError(ErrorCode.ERR_OBJECT_NOT_FOUND, str(dupid))
        if info["status"] != "pause":
            raise PegasusError(
                ErrorCode.ERR_INVALID_STATE,
                f"dup {dupid} is {info['status']}, not paused")
        info["status"] = "start"
        self._save()
        self._drive(dupid)

    def set_fail_mode(self, dupid: int, fail_mode: str) -> None:
        """Parity: set_dup_fail_mode FAIL_SLOW|FAIL_SKIP
        (duplication_info fail_mode): slow = retry the same mutation
        forever; skip = give up on a mutation after bounded retries and
        advance (data loss accepted by the operator)."""
        if fail_mode not in ("slow", "skip"):
            raise PegasusError(ErrorCode.ERR_INVALID_PARAMETERS, fail_mode)
        info = self._dups.get(dupid)
        if info is None:
            raise PegasusError(ErrorCode.ERR_OBJECT_NOT_FOUND, str(dupid))
        info["fail_mode"] = fail_mode
        self._save()
        if info["status"] == "start":
            self._drive(dupid)  # re-announce so live sessions pick it up

    # ---- progress sync (parity: RPC_CM_DUPLICATION_SYNC) ---------------

    def on_duplication_sync(self, payload: dict) -> None:
        info = self._dups.get(payload["dupid"])
        if info is None:
            return
        gpid = tuple(payload["gpid"])
        key = str(gpid[1])
        if payload["confirmed"] > info["progress"].get(key, 0):
            info["progress"][key] = payload["confirmed"]
            self._save()

    # ---- cluster-wide dup health (rides the config-sync report) --------

    def on_report(self, node: str, payload: dict) -> None:
        """Per-session health entries from a node's config-sync `dup`
        block. Only sessions of dups this meta owns are kept (a stale
        node may still report a removed dup for a tick or two)."""
        for entry in payload.get("dup") or ():
            dupid = entry.get("dupid")
            if dupid not in self._dups:
                continue
            gpid = entry.get("gpid") or (0, 0)
            self._health[(dupid, int(gpid[1]))] = dict(
                entry, node=node, at=self.meta.clock())

    def dup_stats(self, app_name: str = "") -> List[dict]:
        """Cluster-wide duplication health: one row per dup with its
        per-partition lag/shipping entries merged in (the `shell
        dup_stats` surface; collector scrapes the node twin verb)."""
        out = []
        for dupid, info in sorted(self._dups.items()):
            if app_name and info["app_name"] != app_name:
                continue
            parts = {str(p): h for (d, p), h in self._health.items()
                     if d == dupid}
            lag_decrees = [h.get("lag_decrees", 0)
                           for h in parts.values()]
            lag_ms = [h.get("lag_ms", 0.0) for h in parts.values()]
            out.append({
                "dupid": dupid,
                "app_name": info["app_name"],
                "follower_meta": info["follower_meta"],
                "follower_app": info["follower_app"],
                "status": info["status"],
                "fail_mode": info.get("fail_mode", "slow"),
                "progress": dict(info["progress"]),
                "max_lag_decrees": max(lag_decrees, default=0),
                "max_lag_ms": max(lag_ms, default=0.0),
                "shipped_bytes": sum(h.get("shipped_bytes", 0)
                                     for h in parts.values()),
                "error_count": sum(h.get("error_count", 0)
                                   for h in parts.values()),
                "skip_count": sum(h.get("skip_count", 0)
                                  for h in parts.values()),
                "partitions": parts,
                "failover": self._failover.get(info["app_name"]),
            })
        return out

    # ---- controlled failover drill (`shell dup_failover <table>`) ------

    def start_failover(self, app_name: str) -> dict:
        """Fence the source table (client writes get typed
        ERR_DUP_FENCED, retryable), drain every partition's duplication
        to `confirmed == last_committed`, then flip the follower table
        writable (clear any `dup.fence` env over there). Asynchronous —
        meta's tick drives the phases; poll `dup_failover_status`."""
        app = self.meta.state.find_app(app_name)
        if app is None:
            raise PegasusError(ErrorCode.ERR_APP_NOT_EXIST, app_name)
        dupids = [d for d, info in self._dups.items()
                  if info["app_name"] == app_name
                  and info["status"] == "start"]
        if not dupids:
            raise PegasusError(
                ErrorCode.ERR_INVALID_STATE,
                f"no started duplication on {app_name}")
        st = self._failover.get(app_name)
        if st is not None and st["phase"] != "done":
            return self.failover_status(app_name)  # already in flight
        self._failover[app_name] = {
            "phase": "draining",
            "fence_at": self.meta.clock(),
            "dupids": dupids,
            "flip_acked": [],
        }
        # the fence propagates like every app env: config-sync replies
        # carry the authoritative set, replicas gate on it
        self.meta.update_app_envs(app_name, {"dup.fence": "write"})
        self._save()
        return self.failover_status(app_name)

    def failover_status(self, app_name: str) -> dict:
        st = self._failover.get(app_name)
        if st is None:
            raise PegasusError(ErrorCode.ERR_OBJECT_NOT_FOUND,
                               f"no failover drill on {app_name}")
        detail = []
        for dupid in st["dupids"]:
            info = self._dups.get(dupid)
            if info is None:
                continue
            for pidx_s in info["progress"]:
                h = self._health.get((dupid, int(pidx_s)), {})
                # drain evidence must be POSITIVE: the report says the
                # replica had the fence applied when it was built (a
                # report merely received after fence_at may predate the
                # env landing — a not-yet-fenced replica could still
                # have acked a write after building it), and with the
                # fence on, confirmed == last_committed proves every
                # acked write shipped
                post_fence = (h.get("at", 0.0) > st["fence_at"]
                              and bool(h.get("fenced")))
                detail.append({
                    "dupid": dupid, "pidx": int(pidx_s),
                    "confirmed": h.get("confirmed", 0),
                    "last_committed": h.get("last_committed", 0),
                    "post_fence": post_fence,
                    "drained": (post_fence
                                and h.get("confirmed", -1)
                                == h.get("last_committed", -2)),
                })
        out = {"app_name": app_name, "phase": st["phase"],
               "partitions": detail,
               "drained": bool(detail)
               and all(d["drained"] for d in detail)}
        if st.get("flip_errors"):
            out["flip_errors"] = dict(st["flip_errors"])
        return out

    def _tick_failover(self) -> None:
        for app_name, st in list(self._failover.items()):
            if st["phase"] == "draining":
                status = self.failover_status(app_name)
                if not status["drained"]:
                    continue
                st["phase"] = "flipping"
                self._save()
            if st["phase"] == "flipping":
                # flip the follower table writable: clear any drill
                # fence on the follower side. Re-sent every tick until
                # the follower meta's admin reply confirms (a dropped
                # message must not wedge the drill).
                for dupid in st["dupids"]:
                    info = self._dups.get(dupid)
                    if info is None or dupid in st["flip_acked"]:
                        continue
                    self.meta.net.send(
                        self.meta.name, info["follower_meta"], "admin", {
                            "rid": f"dupflip-{dupid}",
                            "cmd": "del_app_envs",
                            "args": {
                                "app_name": info["follower_app"],
                                "keys": ["dup.fence"]}})
                if all(d in st["flip_acked"] or d not in self._dups
                       for d in st["dupids"]):
                    st["phase"] = "done"
                    st["done_at"] = self.meta.clock()
                    self._save()

    def on_flip_reply(self, payload: dict) -> None:
        """Completion signal for the drill's follower-side flip."""
        rid = payload.get("rid")
        if not isinstance(rid, str) or not rid.startswith("dupflip-"):
            return
        dupid = int(rid.split("-", 1)[1])
        info = self._dups.get(dupid)
        if info is None:
            return
        st = self._failover.get(info["app_name"])
        if st is None or st["phase"] != "flipping":
            return
        # del_app_envs on a table without the env is a clean no-op
        # (n=0). ERR_APP_NOT_EXIST means a mis-set follower_app: stop
        # retrying (the table will never appear) but RECORD the error
        # so dup_failover_status shows the broken flip instead of a
        # silently clean drill
        if payload["err"] == int(ErrorCode.ERR_APP_NOT_EXIST):
            st.setdefault("flip_errors", {})[str(dupid)] = (
                f"follower app {info['follower_app']!r} does not exist "
                f"on {info['follower_meta']}")
        elif payload["err"] != 0:
            return  # transient: the tick re-sends
        if dupid not in st["flip_acked"]:
            st["flip_acked"].append(dupid)
            self._save()

    # ---- driving -------------------------------------------------------

    def _drive(self, dupid: int) -> None:
        info = self._dups[dupid]
        for pidx_s, confirmed in info["progress"].items():
            pidx = int(pidx_s)
            pc = self.meta.state.get_partition(info["app_id"], pidx)
            if not pc.primary:
                continue
            self.meta.net.send(self.meta.name, pc.primary, "dup_add", {
                "gpid": (info["app_id"], pidx), "dupid": dupid,
                "follower_meta": info["follower_meta"],
                "follower_app": info["follower_app"],
                "confirmed": confirmed,
                "fail_mode": info.get("fail_mode", "slow")})

    def tick(self) -> None:
        for dupid, info in list(self._dups.items()):
            if info["status"] == "bootstrap":
                self._tick_bootstrap(dupid, info)
            elif info["status"] == "start":
                self._drive(dupid)
        self._tick_failover()
