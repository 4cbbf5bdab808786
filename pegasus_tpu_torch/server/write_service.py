"""Write service: translate client writes into engine batches, then apply.

Parity: src/server/pegasus_write_service.{h,cpp} — `translate_*` turns
client requests into WriteBatchItems and `apply_items` commits one engine
batch per decree (the batch_prepare/batch_commit shape). The port serves
put, remove and multi_put.
"""

from __future__ import annotations

import time
from typing import List, Tuple

from pegasus_tpu_torch.base.key_schema import generate_key
from pegasus_tpu_torch.base.value_schema import (
    expire_ts_from_ttl,
    generate_timetag,
    generate_value,
)
from pegasus_tpu_torch.server.types import MultiPutRequest
from pegasus_tpu_torch.storage.engine import StorageEngine, WriteBatchItem
from pegasus_tpu_torch.storage.wal import OP_DEL, OP_PUT
from pegasus_tpu_torch.utils.errors import StorageStatus


class WriteService:
    """All writes for one partition; the caller provides the decree and
    holds the single-writer lock."""

    def __init__(self, engine: StorageEngine, data_version: int = 1,
                 cluster_id: int = 1) -> None:
        self.engine = engine
        self.data_version = data_version
        self.cluster_id = cluster_id

    def _timetag(self) -> int:
        if self.data_version < 1:
            return 0
        return generate_timetag(int(time.time() * 1_000_000),
                                self.cluster_id, False)

    # -- translate phase ------------------------------------------------

    def translate_put_run(self, reqs: List[Tuple[bytes, bytes, int]]
                          ) -> List[WriteBatchItem]:
        """A run of puts [(key, user_data, expire_ts)] sharing one timetag
        (every op of a mutation shares one timestamp)."""
        timetag = self._timetag()
        ver = self.data_version
        return [WriteBatchItem(OP_PUT, key,
                               generate_value(ver, ud, ets, timetag), ets)
                for key, ud, ets in reqs]

    def translate_multi_put(self, req: MultiPutRequest
                            ) -> Tuple[int, List[WriteBatchItem]]:
        if not req.kvs:
            return int(StorageStatus.INVALID_ARGUMENT), []
        expire_ts = expire_ts_from_ttl(req.expire_ts_seconds)
        return int(StorageStatus.OK), self.translate_put_run(
            [(generate_key(req.hash_key, kv.key), kv.value, expire_ts)
             for kv in req.kvs])

    # -- apply phase ----------------------------------------------------

    def apply_items(self, items: List[WriteBatchItem], decree: int) -> None:
        """One engine batch per decree; an empty item list still advances
        the decree (reference empty_put, pegasus_write_service.cpp:210)."""
        self.engine.write_batch(items, decree)

    # -- fused convenience (standalone mode) ----------------------------

    def put(self, key: bytes, user_data: bytes, expire_ts: int,
            decree: int) -> int:
        self.apply_items(self.translate_put_run([(key, user_data, expire_ts)]),
                         decree)
        return int(StorageStatus.OK)

    def remove(self, key: bytes, decree: int) -> int:
        self.apply_items([WriteBatchItem(OP_DEL, key)], decree)
        return int(StorageStatus.OK)

    def multi_put(self, req: MultiPutRequest, decree: int) -> int:
        err, items = self.translate_multi_put(req)
        if err == int(StorageStatus.OK):
            self.apply_items(items, decree)
        return err
