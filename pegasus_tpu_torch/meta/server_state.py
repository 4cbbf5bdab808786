"""Cluster state: tables + partition configurations, persisted.

Parity: src/meta/server_state.{h,cpp} — all app_state (table metadata,
envs, status incl. the dropped-recall window) and every partition's
partition_configuration (ballot, primary, secondaries,
idl/dsn.layer2.thrift:34-46), persisted to the meta storage tree and
mutated only through ballot-bumping updates.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from pegasus_tpu_torch.meta.meta_storage import MetaStorage

AS_AVAILABLE = "available"
AS_DROPPED = "dropped"


@dataclass
class PartitionConfig:
    ballot: int = 0
    primary: str = ""
    secondaries: List[str] = field(default_factory=list)

    def to_json(self) -> dict:
        return {"ballot": self.ballot, "primary": self.primary,
                "secondaries": list(self.secondaries)}

    @staticmethod
    def from_json(d: dict) -> "PartitionConfig":
        return PartitionConfig(d["ballot"], d["primary"],
                               list(d["secondaries"]))

    def members(self) -> List[str]:
        return ([self.primary] if self.primary else []) + list(self.secondaries)


@dataclass
class AppState:
    app_id: int
    app_name: str
    partition_count: int
    status: str = AS_AVAILABLE
    envs: Dict[str, str] = field(default_factory=dict)
    max_replica_count: int = 3

    def to_json(self) -> dict:
        return {"app_id": self.app_id, "app_name": self.app_name,
                "partition_count": self.partition_count,
                "status": self.status, "envs": dict(self.envs),
                "max_replica_count": self.max_replica_count}

    @staticmethod
    def from_json(d: dict) -> "AppState":
        return AppState(d["app_id"], d["app_name"], d["partition_count"],
                        d["status"], dict(d["envs"]),
                        d.get("max_replica_count", 3))


class ServerState:
    def __init__(self, storage: MetaStorage) -> None:
        self._storage = storage
        self.apps: Dict[int, AppState] = {}
        self.configs: Dict[int, List[PartitionConfig]] = {}
        self._load()

    def _load(self) -> None:
        for app_id_s in self._storage.children("/apps"):
            app_id = int(app_id_s)
            data = self._storage.get(f"/apps/{app_id}")
            if data is None:
                continue
            app = AppState.from_json(data)
            self.apps[app_id] = app
            pcs = []
            for pidx in range(app.partition_count):
                pc = self._storage.get(f"/apps/{app_id}/{pidx}")
                pcs.append(PartitionConfig.from_json(pc) if pc
                           else PartitionConfig())
            self.configs[app_id] = pcs

    def next_app_id(self) -> int:
        return max(self.apps, default=0) + 1

    def find_app(self, app_name: str) -> Optional[AppState]:
        for app in self.apps.values():
            if app.app_name == app_name and app.status == AS_AVAILABLE:
                return app
        return None

    def find_dropped_app(self, app_name: str) -> Optional[AppState]:
        for app in self.apps.values():
            if app.app_name == app_name and app.status == AS_DROPPED:
                return app
        return None

    def put_app(self, app: AppState,
                configs: Optional[List[PartitionConfig]] = None) -> None:
        self.apps[app.app_id] = app
        updates = {f"/apps/{app.app_id}": app.to_json()}
        if configs is not None:
            self.configs[app.app_id] = configs
            for pidx, pc in enumerate(configs):
                updates[f"/apps/{app.app_id}/{pidx}"] = pc.to_json()
        self._storage.set_batch(updates)

    def update_partition(self, app_id: int, pidx: int,
                         pc: PartitionConfig) -> None:
        """Persist-then-publish: the new config hits reliable storage
        before anyone can observe it (reference ordering in
        server_state config updates)."""
        self._storage.set(f"/apps/{app_id}/{pidx}", pc.to_json())
        self.configs[app_id][pidx] = pc

    def set_partition_raw(self, app_id: int, pidx: int,
                          pc: PartitionConfig) -> None:
        """update_partition for an index beyond the app's current count —
        partition split registers child configs BEFORE the count flips
        (parity: meta_split_service child registration)."""
        self._storage.set(f"/apps/{app_id}/{pidx}", pc.to_json())
        self._extend_configs(app_id, pidx)
        self.configs[app_id][pidx] = pc

    def _extend_configs(self, app_id: int, pidx: int) -> None:
        """Grow the in-memory list to cover `pidx`, loading any persisted
        beyond-count entries from storage — a meta restart mid-split must
        not blank child configs registered before the restart (boot only
        loads indices < partition_count)."""
        configs = self.configs[app_id]
        while len(configs) <= pidx:
            data = self._storage.get(f"/apps/{app_id}/{len(configs)}")
            configs.append(PartitionConfig.from_json(data) if data
                           else PartitionConfig())

    def get_partition(self, app_id: int, pidx: int) -> PartitionConfig:
        if pidx >= len(self.configs[app_id]):
            self._extend_configs(app_id, pidx)
        return self.configs[app_id][pidx]
