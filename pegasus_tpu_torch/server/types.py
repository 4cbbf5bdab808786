"""rrdb request/response structs served by the port's PartitionServer.

Parity: idl/rrdb.thrift — the same field sets and semantics as
pegasus_tpu/server/types.py: the single and multi writes, the atomic
writes (incr, check_and_set, check_and_mutate), the point and range reads
and the scanner.
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from pegasus_tpu_torch.ops.predicates import FT_NO_FILTER


class CasCheckType(enum.IntEnum):
    """idl/rrdb.thrift:35-62."""

    CT_NO_CHECK = 0
    CT_VALUE_NOT_EXIST = 1
    CT_VALUE_NOT_EXIST_OR_EMPTY = 2
    CT_VALUE_EXIST = 3
    CT_VALUE_NOT_EMPTY = 4
    CT_VALUE_MATCH_ANYWHERE = 5
    CT_VALUE_MATCH_PREFIX = 6
    CT_VALUE_MATCH_POSTFIX = 7
    CT_VALUE_BYTES_LESS = 8
    CT_VALUE_BYTES_LESS_OR_EQUAL = 9
    CT_VALUE_BYTES_EQUAL = 10
    CT_VALUE_BYTES_GREATER_OR_EQUAL = 11
    CT_VALUE_BYTES_GREATER = 12
    CT_VALUE_INT_LESS = 13
    CT_VALUE_INT_LESS_OR_EQUAL = 14
    CT_VALUE_INT_EQUAL = 15
    CT_VALUE_INT_GREATER_OR_EQUAL = 16
    CT_VALUE_INT_GREATER = 17


class MutateOperation(enum.IntEnum):
    MO_PUT = 0
    MO_DELETE = 1


@dataclass(slots=True)
class KeyValue:
    key: bytes                    # sort_key in multi_* responses
    value: bytes = b""
    expire_ts_seconds: Optional[int] = None


_EMPTY_OFFS = b"\x00\x00\x00\x00"


@dataclass
class ScanPage:
    """A whole response page as four packed blobs instead of a list of
    KeyValue, as the batched scan path assembles it (server/page.py over
    native/packer.cpp). It supports the sequence protocol (len, index,
    iteration yield KeyValue), so every `kvs` consumer works unchanged.

    key_offs/val_offs are little-endian uint32[n+1]; ets (present only
    when the scanner asked for expire timestamps) is uint32[n].
    """

    key_offs: bytes = _EMPTY_OFFS
    key_blob: bytes = b""
    val_offs: bytes = _EMPTY_OFFS
    val_blob: bytes = b""
    ets: bytes = b""

    def _offs(self):
        ko = self.__dict__.get("_ko")
        if ko is None:
            ko = np.frombuffer(self.key_offs, dtype="<u4")
            self.__dict__["_ko"] = ko
            self.__dict__["_vo"] = np.frombuffer(self.val_offs,
                                                 dtype="<u4")
        return ko, self.__dict__["_vo"]

    def __len__(self) -> int:
        return max(0, len(self.key_offs) // 4 - 1)

    def __bool__(self) -> bool:
        return len(self) > 0

    def key_at(self, i: int) -> bytes:
        ko, _ = self._offs()
        return self.key_blob[ko[i]:ko[i + 1]]

    def value_at(self, i: int) -> bytes:
        _, vo = self._offs()
        return self.val_blob[vo[i]:vo[i + 1]]

    def ets_at(self, i: int) -> Optional[int]:
        if not self.ets:
            return None
        return struct.unpack_from("<I", self.ets, 4 * i)[0]

    def __getitem__(self, i):
        n = len(self)
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(n))]
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        return KeyValue(self.key_at(i), self.value_at(i), self.ets_at(i))

    def __iter__(self):
        ko, vo = self._offs()
        kb, vb = self.key_blob, self.val_blob
        if self.ets:
            ets = np.frombuffer(self.ets, dtype="<u4")
            for i in range(len(self)):
                yield KeyValue(kb[ko[i]:ko[i + 1]], vb[vo[i]:vo[i + 1]],
                               int(ets[i]))
        else:
            for i in range(len(self)):
                yield KeyValue(kb[ko[i]:ko[i + 1]], vb[vo[i]:vo[i + 1]])


@dataclass
class MultiPutRequest:
    hash_key: bytes
    kvs: List[KeyValue]           # sort_key -> value
    expire_ts_seconds: int = 0


@dataclass
class MultiRemoveRequest:
    hash_key: bytes
    sort_keys: List[bytes]


@dataclass
class MultiGetRequest:
    hash_key: bytes
    sort_keys: List[bytes] = field(default_factory=list)
    max_kv_count: int = -1        # <= 0 means no limit
    max_kv_size: int = -1
    no_value: bool = False
    start_sortkey: bytes = b""
    stop_sortkey: bytes = b""     # empty = to the last sort key
    start_inclusive: bool = True
    stop_inclusive: bool = False
    sort_key_filter_type: int = FT_NO_FILTER
    sort_key_filter_pattern: bytes = b""
    reverse: bool = False


@dataclass
class MultiGetResponse:
    error: int = 0
    kvs: List[KeyValue] = field(default_factory=list)
    # set on INCOMPLETE (forward range mode): the sort key a follow-up
    # page should start FROM (inclusive)
    resume_sort_key: Optional[bytes] = None


@dataclass
class FullKey:
    hash_key: bytes
    sort_key: bytes


@dataclass
class FullData:
    hash_key: bytes
    sort_key: bytes
    value: bytes


@dataclass
class BatchGetRequest:
    keys: List[FullKey]


@dataclass
class BatchGetResponse:
    error: int = 0
    data: List[FullData] = field(default_factory=list)


@dataclass
class IncrRequest:
    key: bytes                    # full encoded key
    increment: int
    expire_ts_seconds: int = 0    # 0 keep, >0 reset, <0 clear


@dataclass
class IncrResponse:
    error: int = 0
    new_value: int = 0
    decree: int = -1


@dataclass
class CheckAndSetRequest:
    hash_key: bytes
    check_sort_key: bytes
    check_type: int
    check_operand: bytes = b""
    set_diff_sort_key: bool = False
    set_sort_key: bytes = b""
    set_value: bytes = b""
    set_expire_ts_seconds: int = 0
    return_check_value: bool = False


@dataclass
class CheckAndSetResponse:
    error: int = 0
    check_value_returned: bool = False
    check_value_exist: bool = False
    check_value: bytes = b""
    decree: int = -1


@dataclass
class Mutate:
    operation: int                # MutateOperation
    sort_key: bytes
    value: bytes = b""
    set_expire_ts_seconds: int = 0


@dataclass
class CheckAndMutateRequest:
    hash_key: bytes
    check_sort_key: bytes
    check_type: int
    check_operand: bytes = b""
    mutate_list: List[Mutate] = field(default_factory=list)
    return_check_value: bool = False


@dataclass
class CheckAndMutateResponse:
    error: int = 0
    check_value_returned: bool = False
    check_value_exist: bool = False
    check_value: bytes = b""
    decree: int = -1


@dataclass
class GetScannerRequest:
    start_key: bytes = b""        # full encoded keys
    stop_key: bytes = b""
    start_inclusive: bool = True
    stop_inclusive: bool = False
    batch_size: int = 1000
    no_value: bool = False
    hash_key_filter_type: int = FT_NO_FILTER
    hash_key_filter_pattern: bytes = b""
    sort_key_filter_type: int = FT_NO_FILTER
    sort_key_filter_pattern: bytes = b""
    validate_partition_hash: bool = False
    return_expire_ts: bool = False
    full_scan: bool = False
    only_return_count: bool = False
    # one-shot ranged read: serve a single page and never cache a scan
    # context (the YCSB-E "scan N records" shape)
    one_page: bool = False
    # server-side pushdown (ops/pushdown.PushdownSpec): a value-region
    # filter and/or an aggregate evaluated inside the scan-page path
    pushdown: Optional[Any] = None


@dataclass
class ScanRequest:
    context_id: int


@dataclass
class ScanResponse:
    error: int = 0
    kvs: List[KeyValue] = field(default_factory=list)
    context_id: int = -1
    kv_count: int = -1
    pushdown_applied: bool = False
    agg: Optional[Dict[str, Any]] = None

    def wire_bytes(self) -> int:
        """Approximate serialized size of this response (what a
        scanner's `shipped_bytes` accumulates)."""
        n = 24  # error/context_id/kv_count/flags framing
        kvs = self.kvs
        if isinstance(kvs, ScanPage):
            n += (len(kvs.key_offs) + len(kvs.key_blob)
                  + len(kvs.val_offs) + len(kvs.val_blob)
                  + len(kvs.ets))
        else:
            for kv in kvs:
                n += 8 + len(kv.key) + len(kv.value)
        if self.agg is not None:
            n += 64
            for it in self.agg.get("items") or ():
                n += 16 + sum(len(x) for x in it
                              if isinstance(x, (bytes, bytearray)))
        return n


# scan context ids (parity: src/base/pegasus_const.h SCAN_CONTEXT_ID_*)
SCAN_CONTEXT_ID_COMPLETED = -1
SCAN_CONTEXT_ID_NOT_EXIST = -2
