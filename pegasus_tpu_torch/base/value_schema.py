"""Pegasus value schema (v0/v1/v2).

Parity: src/base/pegasus_value_schema.h —
- v0 (:160): ``[expire_ts(u32 BE)] [user_data]``
- v1 (:212): ``[expire_ts(u32 BE)] [timetag(u64 BE)] [user_data]`` where
  timetag = timestamp_us(56b) | cluster_id(7b) | deleted_tag(1b) (:44-47).
- v2 (src/base/value_schema_v2.cpp:89-94): the v1 byte layout.
- expiry predicate (:113): expired iff expire_ts > 0 and expire_ts <= now.

expire_ts is seconds since the Pegasus epoch, 2016-01-01T00:00:00Z
(base/pegasus_utils.h).
"""

from __future__ import annotations

import struct
import time
from typing import Optional

PEGASUS_EPOCH_BEGIN = 1451606400  # 2016-01-01 00:00:00 UTC
DATA_VERSION_MAX = 1

_TIMESTAMP_MASK = (1 << 56) - 1


def epoch_now(unix_now: Optional[float] = None) -> int:
    """Seconds since the Pegasus epoch (parity: utils::epoch_now)."""
    t = time.time() if unix_now is None else unix_now
    return max(0, int(t) - PEGASUS_EPOCH_BEGIN)


def expire_ts_from_ttl(ttl_seconds: int, now: Optional[int] = None) -> int:
    """rrdb `expire_ts_seconds` semantics: 0 = no TTL; >0 = now + ttl."""
    if ttl_seconds <= 0:
        return 0
    return (epoch_now() if now is None else now) + ttl_seconds


def generate_timetag(timestamp_us: int, cluster_id: int, deleted: bool) -> int:
    return (timestamp_us << 8) | ((cluster_id & 0x7F) << 1) | int(deleted)


def extract_timestamp_from_timetag(timetag: int) -> int:
    """The 56-bit microsecond timestamp of a timetag."""
    return (timetag >> 8) & _TIMESTAMP_MASK


def generate_value(version: int, user_data: bytes, expire_ts: int,
                   timetag: int = 0) -> bytes:
    if version == 0:
        return struct.pack(">I", expire_ts) + user_data
    if version in (1, 2):
        return struct.pack(">IQ", expire_ts, timetag) + user_data
    raise ValueError(f"unsupported value schema version: {version}")


def header_length(version: int) -> int:
    return 4 if version == 0 else 12


def extract_expire_ts(version: int, raw_value: bytes) -> int:
    (expire_ts,) = struct.unpack_from(">I", raw_value)
    return expire_ts


def extract_timetag(version: int, raw_value: bytes) -> int:
    if version < 1:
        raise ValueError("timetag requires value schema v1+")
    (timetag,) = struct.unpack_from(">Q", raw_value, 4)
    return timetag


def extract_user_data(version: int, raw_value: bytes) -> bytes:
    return raw_value[header_length(version):]


def update_expire_ts(version: int, raw_value: bytes, new_expire_ts: int) -> bytes:
    if len(raw_value) < 4:
        raise ValueError("value must include expire_ts header")
    return struct.pack(">I", new_expire_ts) + raw_value[4:]


def check_if_ts_expired(epoch_now_s: int, expire_ts: int) -> bool:
    return expire_ts > 0 and expire_ts <= epoch_now_s


def check_if_record_expired(version: int, epoch_now_s: int,
                            raw_value: bytes) -> bool:
    return check_if_ts_expired(epoch_now_s, extract_expire_ts(version, raw_value))
