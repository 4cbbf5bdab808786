"""Onebox: a whole cluster in one process rooted at a directory.

Parity: the reference's onebox mode (run.sh:60-66 start_onebox — N meta +
M replica processes on one machine) as used by every function test. Here
the catalog (table name -> app_id/partition_count) persists in a JSON
file and tables open lazily; the shell and function-style tests drive it.

`Onebox(root, device=None)` hands `device` to every Table it opens:
None serves on the card (and raises without CUDA), "cpu" on the host.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from pegasus_tpu_torch.client import PegasusClient, Table


class Onebox:
    def __init__(self, root: str, device=None) -> None:
        self.root = root
        self.device = device
        os.makedirs(root, exist_ok=True)
        self._catalog_path = os.path.join(root, "catalog.json")
        self._catalog: Dict[str, dict] = {}
        self._tables: Dict[str, Table] = {}
        if os.path.exists(self._catalog_path):
            with open(self._catalog_path) as f:
                self._catalog = json.load(f)

    def _persist(self) -> None:
        with open(self._catalog_path, "w") as f:
            json.dump(self._catalog, f, indent=1)

    def create_table(self, name: str, partition_count: int = 8) -> Table:
        if name in self._catalog:
            raise ValueError(f"table {name} exists")
        app_id = max((t["app_id"] for t in self._catalog.values()),
                     default=0) + 1
        self._catalog[name] = {"app_id": app_id,
                               "partition_count": partition_count}
        self._persist()
        return self.open_table(name)

    def open_table(self, name: str) -> Table:
        if name not in self._catalog:
            raise KeyError(f"no such table: {name}")
        t = self._tables.get(name)
        if t is None:
            info = self._catalog[name]
            t = Table(os.path.join(self.root, name),
                      app_id=info["app_id"], app_name=name,
                      partition_count=info["partition_count"],
                      device=self.device)
            if info.get("envs"):
                t.update_app_envs(info["envs"])
            self._tables[name] = t
        return t

    def split_table(self, name: str) -> int:
        """2x partition split, persisted in the catalog. Returns the new
        partition count."""
        t = self.open_table(name)
        t.split()
        self._catalog[name]["partition_count"] = t.partition_count
        self._persist()
        return t.partition_count

    def update_app_envs(self, name: str, envs: Dict[str, str]) -> None:
        """Persisted env update (parity: envs live in meta state and are
        re-delivered through config-sync after restarts)."""
        t = self.open_table(name)
        t.update_app_envs(envs)  # validates before we persist
        self._catalog[name].setdefault("envs", {}).update(envs)
        self._persist()

    def drop_table(self, name: str) -> None:
        if name not in self._catalog:
            raise KeyError(f"no such table: {name}")
        t = self._tables.pop(name, None)
        if t is not None:
            t.close()
        import shutil
        shutil.rmtree(os.path.join(self.root, name), ignore_errors=True)
        del self._catalog[name]
        self._persist()

    def list_tables(self) -> List[dict]:
        return [{"name": name, **info}
                for name, info in sorted(self._catalog.items())]

    def client(self, name: str) -> PegasusClient:
        return PegasusClient(self.open_table(name))

    def close(self) -> None:
        for t in self._tables.values():
            t.close()
        self._tables.clear()
