"""Bulk load: ingest externally-generated SST files from the block service.

Parity: src/replica/bulk_load/replica_bulk_loader.h:49 (replica side:
download SSTs from the block service, verify, ingest through the write
path) + src/meta/meta_bulk_load_service.h:143 (per-partition
download->ingest state machine with rolling concurrency). The external
generator produces one columnar SST per target partition under

    <root>/<app_name>/<pidx>/bulk_load.sst          (+ .md5 sidecars)
    <root>/<app_name>/bulk_load_info.json           {partition_count, ...}

`SSTGenerator` is the offline-writer the reference leaves to Spark
pipelines: it partitions records by the TARGET table's partition count and
emits per-partition sorted columnar SSTs ready to ingest.
"""

from __future__ import annotations

import enum
import json
import os
import tempfile
from typing import Dict, Iterable, List, Optional, Tuple

from pegasus_tpu_torch.base.key_schema import generate_key, partition_index
from pegasus_tpu_torch.base.value_schema import generate_value
from pegasus_tpu_torch.storage.block_service import BlockService
from pegasus_tpu_torch.storage.sstable import SSTableWriter

BULK_LOAD_INFO = "bulk_load_info.json"
BULK_LOAD_FILE = "bulk_load.sst"


class BulkLoadStatus(enum.Enum):
    INVALID = "invalid"
    DOWNLOADING = "downloading"
    INGESTING = "ingesting"
    SUCCEED = "succeed"
    FAILED = "failed"


class SSTGenerator:
    """Offline: records -> per-partition columnar SSTs in a block service."""

    def __init__(self, block_service: BlockService, app_name: str,
                 partition_count: int, data_version: int = 1) -> None:
        self.bs = block_service
        self.app_name = app_name
        self.partition_count = partition_count
        self.data_version = data_version

    def generate(self, records: Iterable[Tuple[bytes, bytes, bytes, int]]
                 ) -> Dict[int, int]:
        """records: (hash_key, sort_key, value, expire_ts). Returns per-
        partition record counts."""
        # routing MUST match the single-key write path (pegasus_key_hash
        # of the full key, Table.resolve(hk, sk)), or empty-hashkey records
        # would land where reads never look; dict insertion keeps the LAST
        # occurrence of duplicates
        buckets: Dict[int, Dict[bytes, Tuple[bytes, int]]] = {}
        for hk, sk, value, ets in records:
            key = generate_key(hk, sk)
            pidx = partition_index(hk, self.partition_count, sk)
            buckets.setdefault(pidx, {})[key] = (
                generate_value(self.data_version, value, ets), ets)
        counts = {}
        with tempfile.TemporaryDirectory(prefix="pegbl") as tmp:
            for pidx, rows in buckets.items():
                local = os.path.join(tmp, f"{pidx}.sst")
                writer = SSTableWriter(local)
                for key in sorted(rows):
                    value, ets = rows[key]
                    writer.add(key, value, ets)
                writer.finish()
                self.bs.upload(local,
                               f"{self.app_name}/{pidx}/{BULK_LOAD_FILE}")
                counts[pidx] = len(rows)
        self.bs.write_file(f"{self.app_name}/{BULK_LOAD_INFO}", json.dumps({
            "app_name": self.app_name,
            "partition_count": self.partition_count,
            "data_version": self.data_version,
        }).encode())
        return counts


class BulkLoader:
    """Online: drive download+ingest across a table's partitions (the
    meta bulk-load state machine, collapsed to the in-proc table)."""

    def __init__(self, block_service: BlockService) -> None:
        self.bs = block_service
        self.status: Dict[int, BulkLoadStatus] = {}

    def load_into(self, table, app_name: Optional[str] = None) -> int:
        """Ingest every partition's staged SST; returns records ingested.
        The staged partition_count must match the table's (the reference
        rejects mismatched bulk loads)."""
        app_name = app_name or table.app_name
        info = json.loads(self.bs.read_file(f"{app_name}/{BULK_LOAD_INFO}"))
        if info["partition_count"] != table.partition_count:
            raise ValueError(
                f"bulk load built for {info['partition_count']} partitions, "
                f"table has {table.partition_count}")
        if info.get("data_version", 1) != table.data_version:
            raise ValueError(
                f"bulk load encoded with data_version "
                f"{info.get('data_version')}, table uses "
                f"{table.data_version}")
        total = 0
        with tempfile.TemporaryDirectory(prefix="pegbl") as tmp:
            for pidx in range(table.partition_count):
                remote = f"{app_name}/{pidx}/{BULK_LOAD_FILE}"
                if not self.bs.exists(remote):
                    self.status[pidx] = BulkLoadStatus.SUCCEED
                    continue  # no data staged for this partition
                self.status[pidx] = BulkLoadStatus.DOWNLOADING
                local = os.path.join(tmp, f"{pidx}.sst")
                try:
                    self.bs.download(remote, local)
                    self.status[pidx] = BulkLoadStatus.INGESTING
                    server = table.partitions[pidx]
                    with server._write_lock:
                        server.engine.ingest_sst_file(
                            local, server.engine.last_committed_decree + 1)
                    from pegasus_tpu_torch.storage.sstable import SSTable
                    t = SSTable(local)
                    total += t.total_count
                    t.close()
                    self.status[pidx] = BulkLoadStatus.SUCCEED
                except Exception:
                    self.status[pidx] = BulkLoadStatus.FAILED
                    raise
        return total
