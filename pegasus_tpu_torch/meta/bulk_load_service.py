"""Meta-side bulk-load orchestration.

Parity: src/meta/meta_bulk_load_service.h:143 — the per-partition
download→ingest state machine with rolling ingestion concurrency
(meta_bulk_load_ingestion_context.*). The data move itself is a
replicated OP_INGEST mutation through 2PC (replica_2pc.cpp:211-230), so
every member ingests at the same decree; this service owns WHICH
partitions ingest, how many at once, retries across failovers, and
persisted progress so a meta restart resumes the load.

Protocol:
    meta  → primary : "trigger_ingest" {gpid, root, src_app}
    primary → meta  : "ingest_done" {gpid, err}
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

from pegasus_tpu_torch.storage.block_service import block_service_for
from pegasus_tpu_torch.utils.errors import ErrorCode, PegasusError

Gpid = Tuple[int, int]


class MetaBulkLoadService:
    def __init__(self, meta, max_concurrent: int = 2) -> None:
        self.meta = meta
        self.max_concurrent = max_concurrent
        # app_id -> {root, src_app, pending: [pidx], inflight: [pidx]}
        self._loads: Dict[int, dict] = {}
        self._failed: Dict[int, str] = {}  # app_id -> failure reason
        self._load_state()

    def _load_state(self) -> None:
        raw = self.meta.state._storage.get("/bulk_load/inflight") or {}
        self._loads = {int(k): v for k, v in raw.items()}
        fraw = self.meta.state._storage.get("/bulk_load/failed") or {}
        self._failed = {int(k): v for k, v in fraw.items()}

    def _save(self) -> None:
        self.meta.state._storage.set_batch({
            "/bulk_load/inflight": {str(k): v
                                    for k, v in self._loads.items()},
            "/bulk_load/failed": {str(k): v
                                  for k, v in self._failed.items()},
        })

    # ---- control surface ----------------------------------------------

    def start_bulk_load(self, app_name: str, root: str,
                        src_app: Optional[str] = None) -> int:
        from pegasus_tpu_torch.server.bulk_load import BULK_LOAD_INFO

        app = self.meta.state.find_app(app_name)
        if app is None:
            raise PegasusError(ErrorCode.ERR_APP_NOT_EXIST, app_name)
        if app.app_id in self._loads:
            raise PegasusError(ErrorCode.ERR_BUSY, "bulk load in progress")
        src_app = src_app or app_name
        bs = block_service_for(root)
        info = json.loads(bs.read_file(f"{src_app}/{BULK_LOAD_INFO}"))
        if info["partition_count"] != app.partition_count:
            raise PegasusError(
                ErrorCode.ERR_INVALID_PARAMETERS,
                f"staged for {info['partition_count']} partitions, table "
                f"has {app.partition_count}")
        # clear the old failure record only now — a retry that fails
        # VALIDATION above must not make the old failure read as success
        self._failed.pop(app.app_id, None)
        self._loads[app.app_id] = {
            "root": root, "src_app": src_app,
            "load_id": int(self.meta.clock() * 1000),
            "pending": list(range(app.partition_count)), "inflight": []}
        self._save()
        self._drive(app.app_id)
        return app.app_id

    def bulk_load_status(self, app_name: str) -> dict:
        app = self.meta.state.find_app(app_name)
        if app is None:
            raise PegasusError(ErrorCode.ERR_APP_NOT_EXIST, app_name)
        if app.app_id in self._failed:
            return {"complete": False, "failed": True,
                    "reason": self._failed[app.app_id],
                    "pending": [], "inflight": []}
        info = self._loads.get(app.app_id)
        if info is None:
            return {"complete": True, "failed": False,
                    "pending": [], "inflight": []}
        return {"complete": False, "failed": False,
                "paused": bool(info.get("paused")),
                "pending": list(info["pending"]),
                "inflight": list(info["inflight"])}

    def _find_load(self, app_name: str) -> Tuple[int, dict]:
        app = self.meta.state.find_app(app_name)
        if app is None:
            raise PegasusError(ErrorCode.ERR_APP_NOT_EXIST, app_name)
        info = self._loads.get(app.app_id)
        if info is None:
            raise PegasusError(ErrorCode.ERR_INVALID_STATE,
                               f"no bulk load in progress on {app_name}")
        return app.app_id, info

    def pause_bulk_load(self, app_name: str) -> None:
        """Parity: pause_bulk_load — in-flight partition ingests finish,
        no new ones start until restart."""
        app_id, info = self._find_load(app_name)
        info["paused"] = True
        self._save()

    def restart_bulk_load(self, app_name: str) -> None:
        app_id, info = self._find_load(app_name)
        info["paused"] = False
        self._save()
        self._drive(app_id)

    def cancel_bulk_load(self, app_name: str) -> None:
        """Parity: cancel_bulk_load — abandon the remaining partitions.
        Already-ingested partitions keep their data (the reference's
        cancel likewise leaves ingested SSTs in place); the operator
        clears or re-runs as needed."""
        app_id, info = self._find_load(app_name)
        self._failed[app_id] = "canceled by operator"
        del self._loads[app_id]
        self._save()

    def clear_bulk_load(self, app_name: str) -> None:
        """Parity: clear_bulk_load — drop any load state / failure record
        so a fresh start_bulk_load begins clean."""
        app = self.meta.state.find_app(app_name)
        if app is None:
            raise PegasusError(ErrorCode.ERR_APP_NOT_EXIST, app_name)
        self._loads.pop(app.app_id, None)
        self._failed.pop(app.app_id, None)
        self._save()

    # ---- state machine -------------------------------------------------

    def _drive(self, app_id: int) -> None:
        """Fill the rolling window (parity: the ingestion context caps
        concurrent ingests so compaction debt stays bounded)."""
        info = self._loads.get(app_id)
        if info is None or info.get("paused"):
            return
        while (info["pending"]
               and len(info["inflight"]) < self.max_concurrent):
            pidx = info["pending"].pop(0)
            info["inflight"].append(pidx)
        for pidx in info["inflight"]:
            pc = self.meta.state.get_partition(app_id, pidx)
            if not pc.primary:
                continue
            self.meta.net.send(self.meta.name, pc.primary,
                               "trigger_ingest", {
                                   "gpid": (app_id, pidx),
                                   "load_id": info.get("load_id", 0),
                                   "root": info["root"],
                                   "src_app": info["src_app"]})
        self._save()

    def on_ingest_done(self, payload: dict) -> None:
        gpid = tuple(payload["gpid"])
        info = self._loads.get(gpid[0])
        if info is None:
            return
        if payload.get("err", 0) != 0:
            # permanent per-partition failure (e.g. version mismatch):
            # abort the whole load with a VISIBLE failure record,
            # matching the reference's BLS_FAILED state
            self._failed[gpid[0]] = (
                f"partition {gpid[1]} ingest failed "
                f"(err {payload['err']})")
            del self._loads[gpid[0]]
            self._save()
            return
        if gpid[1] in info["inflight"]:
            info["inflight"].remove(gpid[1])
        if not info["pending"] and not info["inflight"]:
            del self._loads[gpid[0]]
            self._save()
        else:
            self._drive(gpid[0])

    def tick(self) -> None:
        for app_id in list(self._loads):
            self._drive(app_id)
