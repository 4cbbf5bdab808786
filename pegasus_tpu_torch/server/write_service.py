"""Write service: translate client writes into engine batches, then apply.

Parity: src/server/pegasus_write_service.{h,cpp} +
pegasus_write_service_impl.h — `translate_*` turns client requests into
WriteBatchItems (the atomic ops are read-modify-write evaluated here,
under the single-writer-per-partition invariant) and `apply_items`
commits one engine batch per decree (the batch_prepare/batch_commit
shape). The standalone server fuses the two per request.

The timetag's timestamp and the `now` an expiry is judged against come
from the caller when given (`timestamp_us`, `now`), so a replica, or a
test, writes the same value bytes as another.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

from pegasus_tpu_torch.base.key_schema import generate_key
from pegasus_tpu_torch.base.value_schema import (
    check_if_ts_expired,
    epoch_now,
    expire_ts_from_ttl,
    extract_timetag,
    extract_user_data,
    generate_timetag,
    generate_value,
)
from pegasus_tpu_torch.server.types import (
    CasCheckType,
    CheckAndMutateRequest,
    CheckAndMutateResponse,
    CheckAndSetRequest,
    CheckAndSetResponse,
    IncrRequest,
    IncrResponse,
    MultiPutRequest,
    MultiRemoveRequest,
    MutateOperation,
)
from pegasus_tpu_torch.storage.engine import StorageEngine, WriteBatchItem
from pegasus_tpu_torch.storage.wal import OP_DEL, OP_PUT
from pegasus_tpu_torch.utils.errors import StorageStatus

_INT64_MIN = -(1 << 63)
_INT64_MAX = (1 << 63) - 1


def _ttl_expire_ts(ttl_seconds: int, now: int) -> int:
    """`now + ttl` as the uint32 expire_ts column holds it (the kernels
    add in uint32_t)."""
    return expire_ts_from_ttl(ttl_seconds, now) & 0xFFFFFFFF


def cas_check_passed(check_type: int, operand: bytes,
                     value: Optional[bytes]) -> bool:
    """Evaluate a cas_check_type against the current check value.

    Parity: pegasus_write_service_impl.h validate_check — `value` is None
    when the record doesn't exist. Raises ValueError for malformed int
    compares (mapped to kInvalidArgument by callers).
    """
    ct = CasCheckType(check_type)
    exists = value is not None
    if ct == CasCheckType.CT_NO_CHECK:
        return True
    if ct == CasCheckType.CT_VALUE_NOT_EXIST:
        return not exists
    if ct == CasCheckType.CT_VALUE_NOT_EXIST_OR_EMPTY:
        return not exists or value == b""
    if ct == CasCheckType.CT_VALUE_EXIST:
        return exists
    if ct == CasCheckType.CT_VALUE_NOT_EMPTY:
        return exists and value != b""
    if not exists:
        return False
    if ct == CasCheckType.CT_VALUE_MATCH_ANYWHERE:
        return operand in value
    if ct == CasCheckType.CT_VALUE_MATCH_PREFIX:
        return value.startswith(operand)
    if ct == CasCheckType.CT_VALUE_MATCH_POSTFIX:
        return value.endswith(operand)
    if ct == CasCheckType.CT_VALUE_BYTES_LESS:
        return value < operand
    if ct == CasCheckType.CT_VALUE_BYTES_LESS_OR_EQUAL:
        return value <= operand
    if ct == CasCheckType.CT_VALUE_BYTES_EQUAL:
        return value == operand
    if ct == CasCheckType.CT_VALUE_BYTES_GREATER_OR_EQUAL:
        return value >= operand
    if ct == CasCheckType.CT_VALUE_BYTES_GREATER:
        return value > operand
    # int compares: both sides must parse as int64 (reference buf2int64;
    # failure -> kInvalidArgument)
    v = _parse_int64(value)
    o = _parse_int64(operand)
    if ct == CasCheckType.CT_VALUE_INT_LESS:
        return v < o
    if ct == CasCheckType.CT_VALUE_INT_LESS_OR_EQUAL:
        return v <= o
    if ct == CasCheckType.CT_VALUE_INT_EQUAL:
        return v == o
    if ct == CasCheckType.CT_VALUE_INT_GREATER_OR_EQUAL:
        return v >= o
    return v > o  # CT_VALUE_INT_GREATER


def _parse_int64(data: bytes) -> int:
    s = data.decode("ascii", errors="strict")
    if not s or s.strip() != s:
        raise ValueError(f"not an int64: {data!r}")
    v = int(s)  # raises ValueError on garbage
    if not (_INT64_MIN <= v <= _INT64_MAX):
        raise ValueError("int64 out of range")
    return v


class WriteService:
    """All writes for one partition; the caller provides the decree and
    holds the single-writer lock."""

    def __init__(self, engine: StorageEngine, data_version: int = 1,
                 cluster_id: int = 1) -> None:
        self.engine = engine
        self.data_version = data_version
        self.cluster_id = cluster_id
        # the owning partition's WorkloadStats (set by PartitionServer):
        # apply_items is the funnel every write shape routes through, so
        # the op-mix and batch-size profile feeds here once a mutation
        self.workload = None

    # -- helpers --------------------------------------------------------

    def _timetag(self, timestamp_us: Optional[int] = None) -> int:
        if self.data_version < 1:
            return 0
        ts = (timestamp_us if timestamp_us is not None
              else int(time.time() * 1_000_000))
        return generate_timetag(ts, self.cluster_id, False)

    def _make_value(self, user_data: bytes, expire_ts: int,
                    timestamp_us: Optional[int]) -> bytes:
        return generate_value(self.data_version, user_data, expire_ts,
                              self._timetag(timestamp_us))

    def _visible(self, key: bytes, now: int
                 ) -> Optional[Tuple[bytes, int]]:
        hit = self.engine.get(key)
        if hit is None:
            return None
        value, ets = hit
        if check_if_ts_expired(now, ets):
            return None
        return value, ets

    def _visible_user_data(self, key: bytes, now: int) -> Optional[bytes]:
        hit = self._visible(key, now)
        if hit is None:
            return None
        return extract_user_data(self.data_version, hit[0])

    # -- translate phase ------------------------------------------------

    def translate_put(self, key: bytes, user_data: bytes, expire_ts: int,
                      timestamp_us: Optional[int] = None
                      ) -> List[WriteBatchItem]:
        value = self._make_value(user_data, expire_ts, timestamp_us)
        return [WriteBatchItem(OP_PUT, key, value, expire_ts)]

    def translate_remove(self, key: bytes) -> List[WriteBatchItem]:
        return [WriteBatchItem(OP_DEL, key)]

    def translate_put_run(self, reqs: List[Tuple[bytes, bytes, int]],
                          timestamp_us: Optional[int] = None
                          ) -> List[WriteBatchItem]:
        """A run of puts [(key, user_data, expire_ts)] sharing one timetag
        (every op of a mutation shares one timestamp)."""
        timetag = self._timetag(timestamp_us)
        ver = self.data_version
        return [WriteBatchItem(OP_PUT, key,
                               generate_value(ver, ud, ets, timetag), ets)
                for key, ud, ets in reqs]

    def translate_remove_run(self, keys: List[bytes]
                             ) -> List[WriteBatchItem]:
        return [WriteBatchItem(OP_DEL, key) for key in keys]

    def translate_multi_put(self, req: MultiPutRequest,
                            timestamp_us: Optional[int] = None,
                            now: Optional[int] = None
                            ) -> Tuple[int, List[WriteBatchItem]]:
        if not req.kvs:
            return int(StorageStatus.INVALID_ARGUMENT), []
        expire_ts = expire_ts_from_ttl(req.expire_ts_seconds, now)
        return int(StorageStatus.OK), self.translate_put_run(
            [(generate_key(req.hash_key, kv.key), kv.value, expire_ts)
             for kv in req.kvs], timestamp_us)

    def translate_multi_remove(self, req: MultiRemoveRequest
                               ) -> Tuple[int, int, List[WriteBatchItem]]:
        if not req.sort_keys:
            return int(StorageStatus.INVALID_ARGUMENT), 0, []
        items = self.translate_remove_run(
            [generate_key(req.hash_key, sk) for sk in req.sort_keys])
        return int(StorageStatus.OK), len(items), items

    def translate_incr(self, req: IncrRequest,
                       timestamp_us: Optional[int] = None,
                       now: Optional[int] = None
                       ) -> Tuple[IncrResponse, List[WriteBatchItem]]:
        """Parity: pegasus_write_service_impl.h incr — missing/expired
        record counts as 0; non-numeric or overflow -> kInvalidArgument;
        expire_ts_seconds: 0 keeps the old TTL, >0 resets, <0 clears."""
        now = epoch_now() if now is None else now
        resp = IncrResponse()
        old = self._visible(req.key, now)
        if old is None:
            old_int, old_ets = 0, 0
        else:
            raw, old_ets = old
            data = extract_user_data(self.data_version, raw)
            if data == b"":
                old_int = 0
            else:
                try:
                    old_int = _parse_int64(data)
                except ValueError:
                    resp.error = int(StorageStatus.INVALID_ARGUMENT)
                    return resp, []
        new_int = old_int + req.increment
        if not (_INT64_MIN <= new_int <= _INT64_MAX):
            resp.error = int(StorageStatus.INVALID_ARGUMENT)
            resp.new_value = old_int
            return resp, []
        if req.expire_ts_seconds == 0:
            new_ets = old_ets
        elif req.expire_ts_seconds > 0:
            new_ets = _ttl_expire_ts(req.expire_ts_seconds, now)
        else:
            new_ets = 0
        resp.error = int(StorageStatus.OK)
        resp.new_value = new_int
        return resp, self.translate_put(req.key, str(new_int).encode(),
                                        new_ets, timestamp_us)

    def _check(self, req, now: int, resp) -> bool:
        """The shared check of check_and_set and check_and_mutate: fills
        the check value into `resp` when asked and the error when the
        check fails or is malformed."""
        check_key = generate_key(req.hash_key, req.check_sort_key)
        check_value = self._visible_user_data(check_key, now)
        if req.return_check_value:
            resp.check_value_returned = True
            if check_value is not None:
                resp.check_value_exist = True
                resp.check_value = check_value
        try:
            passed = cas_check_passed(req.check_type, req.check_operand,
                                      check_value)
        except ValueError:
            resp.error = int(StorageStatus.INVALID_ARGUMENT)
            return False
        if not passed:
            resp.error = int(StorageStatus.TRY_AGAIN)
            return False
        resp.error = int(StorageStatus.OK)
        return True

    def translate_check_and_set(self, req: CheckAndSetRequest,
                                timestamp_us: Optional[int] = None,
                                now: Optional[int] = None
                                ) -> Tuple[CheckAndSetResponse,
                                           List[WriteBatchItem]]:
        now = epoch_now() if now is None else now
        resp = CheckAndSetResponse()
        if not self._check(req, now, resp):
            return resp, []
        set_sort_key = (req.set_sort_key if req.set_diff_sort_key
                        else req.check_sort_key)
        expire_ts = (_ttl_expire_ts(req.set_expire_ts_seconds, now)
                     if req.set_expire_ts_seconds > 0 else 0)
        return resp, self.translate_put(
            generate_key(req.hash_key, set_sort_key), req.set_value,
            expire_ts, timestamp_us)

    def translate_check_and_mutate(self, req: CheckAndMutateRequest,
                                   timestamp_us: Optional[int] = None,
                                   now: Optional[int] = None
                                   ) -> Tuple[CheckAndMutateResponse,
                                              List[WriteBatchItem]]:
        """The mutations go into one batch in list order, so the last op
        on a sort key wins."""
        now = epoch_now() if now is None else now
        resp = CheckAndMutateResponse()
        if not req.mutate_list:
            resp.error = int(StorageStatus.INVALID_ARGUMENT)
            return resp, []
        if not self._check(req, now, resp):
            return resp, []
        items: List[WriteBatchItem] = []
        for m in req.mutate_list:
            key = generate_key(req.hash_key, m.sort_key)
            if m.operation == MutateOperation.MO_DELETE:
                items.append(WriteBatchItem(OP_DEL, key))
            else:
                ets = (_ttl_expire_ts(m.set_expire_ts_seconds, now)
                       if m.set_expire_ts_seconds > 0 else 0)
                items.append(WriteBatchItem(
                    OP_PUT, key, self._make_value(m.value, ets, timestamp_us),
                    ets))
        return resp, items

    # -- duplicated writes (parity: the duplicate-apply variants in
    # pegasus_write_service_impl + value timetag conflict resolution,
    # base/pegasus_value_schema.h:175-209) ------------------------------

    def _existing_timetag(self, key: bytes) -> int:
        hit = self.engine.get(key)
        if hit is None:
            return 0
        value, _ = hit
        if self.data_version < 1 or len(value) < 12:
            return 0
        return extract_timetag(self.data_version, value)

    def translate_duplicate_put(self, key: bytes, user_data: bytes,
                                expire_ts: int, timetag: int,
                                floor_tag: int = 0):
        """(applied, items) for a shipped write: applies iff its timetag
        wins (larger timestamp, then cluster id — master-master conflict
        resolution). `floor_tag` lets a caller batching several dup ops in
        one mutation account for an earlier write to the same key that is
        not in the engine yet."""
        if timetag <= max(self._existing_timetag(key), floor_tag):
            return False, []
        value = generate_value(self.data_version, user_data, expire_ts,
                               timetag)
        return True, [WriteBatchItem(OP_PUT, key, value, expire_ts)]

    def translate_duplicate_remove(self, key: bytes, timetag: int,
                                   floor_tag: int = 0):
        if timetag <= max(self._existing_timetag(key), floor_tag):
            return False, []
        return True, [WriteBatchItem(OP_DEL, key)]

    def duplicate_put(self, key: bytes, user_data: bytes, expire_ts: int,
                      timetag: int, decree: int) -> bool:
        """translate_duplicate_put + apply (the in-process shipper path);
        the decree advances even on a lost conflict."""
        applied, items = self.translate_duplicate_put(key, user_data,
                                                      expire_ts, timetag)
        self.apply_items(items, decree)
        return applied

    def duplicate_remove(self, key: bytes, timetag: int, decree: int) -> bool:
        applied, items = self.translate_duplicate_remove(key, timetag)
        self.apply_items(items, decree)
        return applied

    # -- apply phase ----------------------------------------------------

    def apply_items(self, items: List[WriteBatchItem], decree: int,
                    wal_flush: bool = True) -> None:
        """One engine batch per decree; an empty item list still advances
        the decree (reference empty_put, pegasus_write_service.cpp:210).
        `wal_flush=False` defers the engine-WAL flush into the caller's
        group-commit window."""
        wl = self.workload
        if wl is not None and items:
            wl.note_write(1, len(items),
                          [len(it.value) for it in items[:8]])
        self.engine.write_batch(items, decree, wal_flush=wal_flush)

    # -- fused convenience (standalone mode) ----------------------------

    def put(self, key: bytes, user_data: bytes, expire_ts: int,
            decree: int) -> int:
        self.apply_items(self.translate_put(key, user_data, expire_ts),
                         decree)
        return int(StorageStatus.OK)

    def remove(self, key: bytes, decree: int) -> int:
        self.apply_items(self.translate_remove(key), decree)
        return int(StorageStatus.OK)

    def multi_put(self, req: MultiPutRequest, decree: int) -> int:
        err, items = self.translate_multi_put(req)
        if err == int(StorageStatus.OK):
            self.apply_items(items, decree)
        return err

    def multi_remove(self, req: MultiRemoveRequest, decree: int
                     ) -> Tuple[int, int]:
        err, count, items = self.translate_multi_remove(req)
        if err == int(StorageStatus.OK):
            self.apply_items(items, decree)
        return err, count

    def incr(self, req: IncrRequest, decree: int) -> IncrResponse:
        resp, items = self.translate_incr(req)
        if resp.error == int(StorageStatus.OK):
            self.apply_items(items, decree)
            resp.decree = decree
        return resp

    def check_and_set(self, req: CheckAndSetRequest, decree: int
                      ) -> CheckAndSetResponse:
        resp, items = self.translate_check_and_set(req)
        if resp.error == int(StorageStatus.OK):
            self.apply_items(items, decree)
            resp.decree = decree
        return resp

    def check_and_mutate(self, req: CheckAndMutateRequest, decree: int
                         ) -> CheckAndMutateResponse:
        resp, items = self.translate_check_and_mutate(req)
        if resp.error == int(StorageStatus.OK):
            self.apply_items(items, decree)
            resp.decree = decree
        return resp
