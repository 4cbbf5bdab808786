"""Cold backup + restore over the block service.

Parity: the replica-side backup flow (src/replica/backup/
cold_backup_context.*, replica_backup_manager.*) and the meta-side
policy/one-shot orchestration (src/meta/meta_backup_service.h:360,
backup_engine.h:68), plus restore (src/replica/replica_restore.cpp,
meta/server_state_restore.cpp: a new table created "from cold backup"
downloads its checkpoint from the block service).

Remote layout (policy-compatible shape):
    <root>/<policy>/<backup_id>/<app_id>/<pidx>/<sst files + meta.json>
    <root>/<policy>/<backup_id>/backup_metadata.json
"""

from __future__ import annotations

import json
import os

from pegasus_tpu_torch.storage.efile import open_data_file
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from pegasus_tpu_torch.storage.block_service import BlockService
from pegasus_tpu_torch.storage.engine import StorageEngine


@dataclass
class BackupPolicy:
    """Parity: policy (meta_backup_service.h) — which apps, where, how
    often, how many kept."""

    name: str
    app_ids: List[int]
    interval_seconds: int = 86400
    backup_history_count: int = 3


class BackupEngine:
    """One-shot backup of a table across its partitions (parity:
    backup_engine.h:68 driving per-partition checkpoint uploads)."""

    def __init__(self, block_service: BlockService, policy_name: str) -> None:
        self.bs = block_service
        self.policy_name = policy_name

    def backup_partition(self, backup_id: int, app_id: int, pidx: int,
                         engine: StorageEngine, server=None) -> int:
        """Checkpoint one partition and upload it. Returns the decree.
        `server`: the owning PartitionServer when available — its
        checkpoint() carries the single-writer lock against the async
        env-compaction thread; bare engines (offline tooling) snapshot
        directly."""
        with tempfile.TemporaryDirectory(prefix="pegbk") as tmp:
            decree = (server.checkpoint(tmp) if server is not None
                      else engine.checkpoint(tmp))
            self.upload_checkpoint(backup_id, app_id, pidx, tmp, decree)
            return decree

    def upload_checkpoint(self, backup_id: int, app_id: int, pidx: int,
                          ckpt_dir: str, decree: int) -> None:
        """Upload a materialized checkpoint dir (the slow half — safe to
        run off the replica's dispatch thread; only the checkpoint itself
        needs engine serialization)."""
        base = f"{self.policy_name}/{backup_id}/{app_id}/{pidx}"
        files = []
        for name in sorted(os.listdir(ckpt_dir)):
            with open_data_file(os.path.join(ckpt_dir, name), "rb") as f:
                self.bs.write_file(f"{base}/{name}", f.read())
            files.append(name)
        self.bs.write_file(f"{base}/meta.json", json.dumps({
            "decree": decree, "files": files}).encode())

    def finish_backup(self, backup_id: int, app_id: int, app_name: str,
                      partition_count: int) -> None:
        self.bs.write_file(
            f"{self.policy_name}/{backup_id}/backup_metadata.json",
            json.dumps({
                "backup_id": backup_id, "app_id": app_id,
                "app_name": app_name, "partition_count": partition_count,
                "complete": True}).encode())

    def list_backups(self) -> List[int]:
        out = []
        for name in self.bs.list_dir(self.policy_name):
            if name.isdigit() and self.bs.exists(
                    f"{self.policy_name}/{name}/backup_metadata.json"):
                out.append(int(name))
        return sorted(out)

    def gc_old_backups(self, keep: int) -> List[int]:
        """Parity: policy backup_history_count GC."""
        backups = self.list_backups()
        dropped = backups[:-keep] if keep > 0 else []
        for backup_id in dropped:
            self.bs.remove_path(f"{self.policy_name}/{backup_id}")
        return dropped

    def restore_partition(self, backup_id: int, app_id: int, pidx: int,
                          data_dir: str, device=None) -> StorageEngine:
        """Download one partition's checkpoint and open an engine on it,
        on `device` (None is the card)."""
        base = f"{self.policy_name}/{backup_id}/{app_id}/{pidx}"
        meta = json.loads(self.bs.read_file(f"{base}/meta.json"))
        with tempfile.TemporaryDirectory(prefix="pegrs") as tmp:
            for name in meta["files"]:
                self.bs.download(f"{base}/{name}", os.path.join(tmp, name))
            return StorageEngine.restore_from_checkpoint(tmp, data_dir,
                                                         device=device)

    def read_backup_metadata(self, backup_id: int) -> dict:
        return json.loads(self.bs.read_file(
            f"{self.policy_name}/{backup_id}/backup_metadata.json"))


class BackupScheduler:
    """Policy-driven periodic backups (parity: the policy scheduler loop
    in meta_backup_service). Call tick(now) from a timer; each due policy
    produces one backup of each of its tables via the provided
    `backup_table(policy, backup_id, app_id)` callback."""

    def __init__(self, backup_table, clock) -> None:
        self._policies: Dict[str, BackupPolicy] = {}
        self._last_run: Dict[str, float] = {}
        self._backup_table = backup_table
        self._clock = clock

    def add_policy(self, policy: BackupPolicy) -> None:
        if policy.name in self._policies:
            raise ValueError(f"policy {policy.name} exists")
        self._policies[policy.name] = policy

    def policies(self) -> List[BackupPolicy]:
        return list(self._policies.values())

    def tick(self) -> List[int]:
        now = self._clock()
        started = []
        for policy in self._policies.values():
            last = self._last_run.get(policy.name)
            if last is not None and now - last < policy.interval_seconds:
                continue
            self._last_run[policy.name] = now
            backup_id = int(now * 1000) or 1
            for app_id in policy.app_ids:
                self._backup_table(policy, backup_id, app_id)
            started.append(backup_id)
        return started
