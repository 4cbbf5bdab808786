"""StorageEngine: WAL + LSM with decree watermark discipline.

Parity: src/server/rocksdb_wrapper.{h,cpp} + src/base/meta_store.{h,cpp} —
every committed write batch carries its decree, so any flushed state knows
exactly which decree it contains:

- write_batch(items, decree): one WAL frame (decree-stamped) + memtable
  apply; last_committed_decree advances.
- flush(): memtable -> L0 SST whose meta records {last_flushed_decree,
  data_version}; the WAL truncates after the SST is durable.
- boot: last_flushed_decree = max over SST metas, then replay WAL frames
  with decree > last_flushed_decree into the memtable.
- manual_compact(): full merge through the TTL / stale-split filter
  (ops/compaction.compaction_filter_block) evaluated on the engine's
  device (src/server/pegasus_manual_compact_service.h:48).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from pegasus_tpu_torch.base.value_schema import epoch_now
from pegasus_tpu_torch.ops.compaction import compaction_filter_block
from pegasus_tpu_torch.ops.record_block import build_record_block
from pegasus_tpu_torch.storage.lsm import LSMStore
from pegasus_tpu_torch.storage.wal import OP_DEL, WalRecord, WriteAheadLog
from pegasus_tpu_torch.utils.device import resolve_device


@dataclass
class WriteBatchItem:
    op: int                 # OP_PUT | OP_DEL
    key: bytes
    value: bytes = b""      # full pegasus-encoded value for puts
    expire_ts: int = 0


class StorageEngine:
    def __init__(self, data_dir: str, data_version: int = 1,
                 values_carry_expire_header: bool = False,
                 device=None) -> None:
        self.data_dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        self.data_version = data_version
        # the compaction filter's device: the card unless told otherwise
        self.device = resolve_device(device)
        # the engine's expire_ts column is authoritative; values are
        # opaque here. Servers storing pegasus-encoded values set this so
        # compaction TTL rewrites also patch the embedded header.
        self.values_carry_expire_header = values_carry_expire_header
        self.lsm = LSMStore(os.path.join(data_dir, "sst"))

        # recover the decree watermark from SST metas; data_version comes
        # from the table with the newest watermark
        self.last_flushed_decree = 0
        for table in list(self.lsm.l0) + list(self.lsm.l1_runs):
            d = int(table.meta.get("last_flushed_decree", 0))
            if d >= self.last_flushed_decree and "data_version" in table.meta:
                self.data_version = int(table.meta["data_version"])
            self.last_flushed_decree = max(self.last_flushed_decree, d)
        self.last_committed_decree = self.last_flushed_decree

        # replay WAL beyond the flushed watermark
        self._wal_path = os.path.join(data_dir, "wal.log")
        for decree, records in WriteAheadLog.replay(self._wal_path):
            if decree <= self.last_flushed_decree:
                continue
            for r in records:
                if r.op == OP_DEL:
                    self.lsm.delete(r.key)
                else:
                    self.lsm.put(r.key, r.value, r.expire_ts)
            self.last_committed_decree = max(self.last_committed_decree, decree)
        self.wal = WriteAheadLog(self._wal_path)
        # called with the keys of every applied write batch
        self.on_write_keys = None

    def close(self) -> None:
        self.wal.close()
        self.lsm.close()

    # ---- write path ---------------------------------------------------

    def write_batch(self, items: Sequence[WriteBatchItem], decree: int,
                    sync: bool = False) -> None:
        """Apply one decree's mutations atomically (WAL first)."""
        if decree <= self.last_committed_decree:
            raise ValueError(
                f"decree {decree} <= last committed {self.last_committed_decree}")
        self.wal.append_batch(
            decree,
            [WalRecord(i.op, i.key, i.value, i.expire_ts) for i in items],
            sync=sync)
        for i in items:
            if i.op == OP_DEL:
                self.lsm.delete(i.key)
            else:
                self.lsm.put(i.key, i.value, i.expire_ts)
        self.last_committed_decree = decree
        # write-through hook (the node row cache drops these keys before
        # the write is acknowledged)
        hook = self.on_write_keys
        if hook is not None and items:
            hook([i.key for i in items])

    def flush(self) -> bool:
        """Memtable -> durable L0 SST stamped with the decree watermark."""
        table = self.lsm.flush(meta={
            "last_flushed_decree": self.last_committed_decree,
            "data_version": self.data_version,
        })
        if table is None:
            return False
        self.last_flushed_decree = self.last_committed_decree
        self.wal.truncate()
        return True

    # ---- read path ----------------------------------------------------

    def get(self, key: bytes) -> Optional[Tuple[bytes, int]]:
        return self.lsm.get(key)

    def iterate(self, start: bytes = b"", stop: Optional[bytes] = None,
                reverse: bool = False):
        return self.lsm.iterate(start, stop, reverse)

    # ---- compaction ---------------------------------------------------

    def manual_compact(self, default_ttl: int = 0, pidx: int = 0,
                       partition_version: int = -1,
                       validate_hash: bool = False,
                       now: Optional[int] = None) -> None:
        """Full merge compaction with the TTL / stale-split filter; the
        caller excludes writers for its duration."""
        now_s = epoch_now() if now is None else now
        # pv<0 / pidx>pv -> no stale-split dropping (keep), per
        # check_if_stale_split_data
        do_validate = bool(validate_hash and partition_version >= 0
                           and pidx <= partition_version)

        def record_filter(keys: List[bytes], ets: List[int]):
            block = build_record_block(keys, ets, device=self.device)
            return compaction_filter_block(
                block.hash_lo, block.expire_ts, block.valid, now_s,
                default_ttl, pidx, max(partition_version, 0), do_validate)

        self.lsm.compact(
            record_filter=record_filter,
            patch_headers=self.values_carry_expire_header,
            meta={
                "last_flushed_decree": self.last_committed_decree,
                "data_version": self.data_version,
                "manual_compact_finish_time": epoch_now(),
            })
        self.last_flushed_decree = self.last_committed_decree
        self.wal.truncate()
