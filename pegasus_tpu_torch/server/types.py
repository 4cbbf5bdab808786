"""rrdb request/response structs served by the port's PartitionServer.

Parity: idl/rrdb.thrift — the same field sets and semantics as
pegasus_tpu/server/types.py, limited to put / multi_put / remove / get /
multi_get / get_scanner / scan / clear_scanner.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from pegasus_tpu_torch.ops.predicates import FT_NO_FILTER


@dataclass(slots=True)
class KeyValue:
    key: bytes                    # sort_key in multi_* responses
    value: bytes = b""
    expire_ts_seconds: Optional[int] = None


@dataclass
class MultiPutRequest:
    hash_key: bytes
    kvs: List[KeyValue]           # sort_key -> value
    expire_ts_seconds: int = 0


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
    # server-side pushdown spec: this server does not evaluate pushdown,
    # so it ignores the field and leaves `pushdown_applied` False — the
    # soft version gate on which clients fall back to local evaluation
    pushdown: Optional[Any] = None


@dataclass
class ScanResponse:
    error: int = 0
    kvs: List[KeyValue] = field(default_factory=list)
    context_id: int = -1
    kv_count: int = -1
    pushdown_applied: bool = False
    agg: Optional[Dict[str, Any]] = None


# scan context ids (parity: src/base/pegasus_const.h SCAN_CONTEXT_ID_*)
SCAN_CONTEXT_ID_COMPLETED = -1
SCAN_CONTEXT_ID_NOT_EXIST = -2
