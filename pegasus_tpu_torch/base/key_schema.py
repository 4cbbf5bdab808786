"""Pegasus key schema: ``[hash_key_len(u16 BE)] [hash_key] [sort_key]``.

Parity: src/base/pegasus_key_schema.h —
- pegasus_generate_key (:41): 2-byte big-endian hashkey length prefix.
- pegasus_generate_next_blob (:64,:86): smallest key strictly greater than
  every key with the given prefix (strip trailing 0xFF, increment last byte).
- pegasus_restore_key (:102).
- pegasus_key_hash (:150): crc64 of hashkey, or of sortkey when the hashkey
  is empty.
- check_pegasus_key_hash (:176): `hash & partition_version == pidx`.

Routing: partition_index = crc64 % partition_count
(src/client/partition_resolver.cpp:48-50).
"""

from __future__ import annotations

import struct
from typing import Tuple

from pegasus_tpu_torch.base.crc import crc64

HASH_KEY_LEN_MAX = 0xFFFF - 1


def generate_key(hash_key: bytes, sort_key: bytes = b"") -> bytes:
    if len(hash_key) >= 0xFFFF:
        raise ValueError("hash key length must be < 65535")
    return struct.pack(">H", len(hash_key)) + hash_key + sort_key


def restore_key(key: bytes) -> Tuple[bytes, bytes]:
    if len(key) < 2:
        raise ValueError("key too short")
    (hash_key_len,) = struct.unpack_from(">H", key)
    if len(key) < 2 + hash_key_len:
        raise ValueError("key shorter than its hash_key_len header")
    return key[2:2 + hash_key_len], key[2 + hash_key_len:]


def generate_next_bytes(hash_key: bytes, sort_key: bytes | None = None) -> bytes:
    """Adjacent next key after every key prefixed by (hash_key[, sort_key]):
    drop trailing 0xFF bytes, then increment the last remaining byte."""
    buf = bytearray(generate_key(hash_key, sort_key or b""))
    i = len(buf) - 1
    while i >= 0 and buf[i] == 0xFF:
        i -= 1
    if i < 0:
        return b""  # all 0xFF: no strictly-greater key; unbounded scan
    buf[i] += 1
    return bytes(buf[:i + 1])


def key_hash(key: bytes) -> int:
    """crc64(hashkey) of an encoded key, or crc64(sortkey) if the hashkey
    is empty (parity: pegasus_key_hash, pegasus_key_schema.h:150)."""
    if len(key) < 2:
        raise ValueError("key too short")
    (hash_key_len,) = struct.unpack_from(">H", key)
    if hash_key_len > 0:
        if len(key) < 2 + hash_key_len:
            raise ValueError("key shorter than its hash_key_len header")
        return crc64(key[2:2 + hash_key_len])
    return crc64(key[2:])


def hash_key_hash(hash_key: bytes) -> int:
    """crc64 of a bare hashkey."""
    return crc64(hash_key)


def key_hash_parts(hash_key: bytes, sort_key: bytes = b"") -> int:
    """key_hash(generate_key(hash_key, sort_key)) without building the key."""
    return crc64(hash_key) if hash_key else crc64(sort_key)


def partition_index(hash_key: bytes, partition_count: int,
                    sort_key: bytes = b"") -> int:
    """Routing: pegasus_key_hash(generate_key(hash_key, sort_key)) % count
    (pegasus_client_impl.cpp:124,273); an empty hash key routes by the
    sort key, the same hash the scan validation predicate uses."""
    return key_hash_parts(hash_key, sort_key) % partition_count


def check_key_hash(key: bytes, pidx: int, partition_version: int) -> bool:
    """True iff this partition should serve `key` (post-split stale check).
    Callers must ensure partition_version >= 0."""
    return (key_hash(key) & partition_version) == pidx
