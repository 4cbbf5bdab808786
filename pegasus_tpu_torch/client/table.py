"""Table: a partitioned rrdb app.

In-process stand-in for the cluster side of the reference's client stack:
the partition resolver maps pegasus_key_hash(key) % partition_count to a
partition (src/client/partition_resolver.cpp:48,
pegasus_client_impl.cpp:124) and dispatches to that partition's primary,
here a local PartitionServer on the table's device.
"""

from __future__ import annotations

import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack
from typing import Dict, List, Optional, Tuple

from pegasus_tpu_torch.base.key_schema import key_hash_parts
from pegasus_tpu_torch.server.partition_server import PartitionServer
from pegasus_tpu_torch.utils.device import resolve_device


def compact_partitions_parallel(servers, parallel: Optional[int] = None,
                                **compact_kwargs) -> None:
    """Manually compact many PartitionServers on a small thread pool
    (parity: the manual compact service's max_concurrent_running_count):
    each partition's disk passes and kernel waits release the interpreter
    lock, so 8 at once keep the card and the disk queue busy."""
    if parallel is None:
        parallel = 8
    with ThreadPoolExecutor(max_workers=max(1, parallel)) as ex:
        for f in [ex.submit(s.manual_compact, **compact_kwargs)
                  for s in servers]:
            f.result()


class Table:
    def __init__(self, data_dir: str, app_id: int = 1, app_name: str = "temp",
                 partition_count: int = 8, data_version: int = 1,
                 device=None) -> None:
        """`device=None` serves every partition on the card and raises
        without CUDA; `device="cpu"` serves on the host."""
        if partition_count < 1:
            raise ValueError("partition_count must be >= 1")
        self.device = resolve_device(device)
        self.data_dir = data_dir
        self.app_id = app_id
        self.app_name = app_name
        self.partition_count = partition_count
        self.data_version = data_version
        self.partitions: Dict[int, PartitionServer] = {
            pidx: self._open_partition(pidx, partition_count)
            for pidx in range(partition_count)}

    def _open_partition(self, pidx: int, count: int) -> PartitionServer:
        return PartitionServer(
            os.path.join(self.data_dir, f"{self.app_id}.{pidx}"),
            app_id=self.app_id, pidx=pidx, partition_count=count,
            data_version=self.data_version, device=self.device)

    def resolve(self, hash_key: bytes,
                sort_key: bytes = b"") -> PartitionServer:
        """Route by pegasus_key_hash of the full key: single-key ops pass
        their sort_key, multi-key ops pass b"", as the reference client
        builds its tmp_key (pegasus_client_impl.cpp:212)."""
        return self.route(hash_key, sort_key)[0]

    def route(self, hash_key: bytes,
              sort_key: bytes = b"") -> Tuple[PartitionServer, int]:
        """(server, partition_hash): the hash rides with the request, and
        the server checks it against its post-split partition_version
        (parity: the rpc-header partition_hash, rpc_message.h:81-126)."""
        h = key_hash_parts(hash_key, sort_key)
        return self.partitions[h % self.partition_count], h

    def all_partitions(self) -> List[PartitionServer]:
        return [self.partitions[i] for i in range(self.partition_count)]

    def flush_all(self) -> None:
        for p in self.all_partitions():
            p.flush()

    def manual_compact_all(self, default_ttl=None, rules_filter=None,
                           parallel: int = 8) -> None:
        """None defaults defer to each partition's app-envs."""
        compact_partitions_parallel(
            self.all_partitions(), parallel=parallel,
            default_ttl=default_ttl, rules_filter=rules_filter)

    def update_app_envs(self, envs: dict) -> None:
        """Propagate per-table envs to every partition (parity: meta
        config-sync pushing app-envs to replicas)."""
        for p in self.all_partitions():
            p.update_app_envs(envs)

    def split(self) -> None:
        """In-place 2x partition split (parity: replica/split/
        replica_split_manager.h:58): each child copies its parent's
        state, the group flips to the doubled count, and the stale half
        of every partition is hidden from scans by the ownership
        predicate and dropped at the next manual compaction
        (key_ttl_compaction_filter.h:114-121).

        Every parent's write lock is held from the first checkpoint to
        the count flip, so a write is either in its child's copy or routed
        by the new count; a failure rolls back, leaving no child open and
        no child directory. Scanners opened before the split keep their
        old partition groups: re-open them after it."""
        old_count = self.partition_count
        if old_count & (old_count - 1):
            # the ownership predicate is an &-mask
            raise ValueError(
                f"partition split requires a power-of-two count, "
                f"have {old_count}")
        new_count = old_count * 2
        created = []
        touched_dirs = []
        with ExitStack() as stack:
            for pidx in range(old_count):  # pidx order, the only multi-lock
                stack.enter_context(self.partitions[pidx]._write_lock)
            try:
                for pidx in range(old_count):
                    parent = self.partitions[pidx]
                    child_pidx = pidx + old_count
                    child_dir = os.path.join(self.data_dir,
                                             f"{self.app_id}.{child_pidx}")
                    # cleared before anything is written: a failed earlier
                    # attempt must not leave SSTs a retry would merge
                    touched_dirs.append(child_dir)
                    shutil.rmtree(child_dir, ignore_errors=True)
                    parent.engine.checkpoint(os.path.join(child_dir, "sst"))
                    child = self._open_partition(child_pidx, new_count)
                    created.append((child_pidx, child))
                    if parent.app_envs:
                        child.update_app_envs(dict(parent.app_envs))
            except BaseException:
                for _, child in created:
                    child.close()
                for child_dir in touched_dirs:
                    shutil.rmtree(child_dir, ignore_errors=True)
                raise
            for child_pidx, child in created:
                self.partitions[child_pidx] = child
            for p in self.partitions.values():
                p.update_partition_count(new_count)
            self.partition_count = new_count

    def close(self) -> None:
        for p in self.partitions.values():
            p.close()

    def drop(self) -> None:
        self.close()
        shutil.rmtree(self.data_dir, ignore_errors=True)
