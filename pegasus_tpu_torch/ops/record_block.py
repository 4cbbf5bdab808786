"""Columnar record blocks — the unit of device dispatch.

    keys        uint8[capacity, key_width]   encoded keys, zero-padded
    key_len     int32[capacity]
    hashkey_len int32[capacity]              decoded from the 2-byte header
    expire_ts   int32[capacity]              uint32 bits from the value header
    valid       bool[capacity]               padding / malformed-row mask
    hash_lo     int32[capacity] | None       uint32 bits: lo lane of pegasus_key_hash

The uint32 columns ride as int32 bit patterns, four bytes a record as on
disk: the kernel reads them as uint32_t. torch's CPU uint32 has no
ordering compares or shifts, so plain torch code widens them with
`u32` before comparing. A block carries `hash_lo` (computed on the host
at pack time, as the SST writer does, or read from its SST block), so
the scan kernel validates partition ownership with one compare; a block
from a file without the column (PGT1) has `hash_lo` None, and the scan
predicate hashes its keys where it validates (the kernel's key-hash
instance on the card, ops/device_crc.key_hash_device in the plain
version). Key widths are bucketed to powers of two (min 32).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from pegasus_tpu_torch.base.crc import crc64_batch

_MIN_WIDTH = 32
_MAX_WIDTH = 1 << 16

# host-to-device copies of record-block columns, always counted: the
# merge path's candidate blocks (build_record_block) and the device
# block cache's uploads of SST blocks (block_from_columns)
H2D = {"copies": 0, "bytes": 0}


class RecordBlock(NamedTuple):
    keys: torch.Tensor         # uint8[B, K]
    key_len: torch.Tensor      # int32[B]
    hashkey_len: torch.Tensor  # int32[B]
    expire_ts: torch.Tensor    # int32[B], uint32 bits
    valid: torch.Tensor        # bool[B]
    hash_lo: "torch.Tensor | None"  # int32[B], uint32 bits; None: hashed

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def key_width(self) -> int:
        return self.keys.shape[1]

    @property
    def device(self) -> torch.device:
        return self.keys.device

    def count(self) -> int:
        return int(self.valid.sum())


def next_bucket(n: int) -> int:
    """Smallest power-of-two width >= n (>= 32)."""
    w = _MIN_WIDTH
    while w < n:
        w <<= 1
    if w > _MAX_WIDTH:
        raise ValueError(f"key width {n} exceeds maximum {_MAX_WIDTH}")
    return w


def u32(t: torch.Tensor) -> torch.Tensor:
    """int64 values of a tensor of uint32 bit patterns (int32 or wider)."""
    return t.to(torch.int64) & 0xFFFFFFFF


def bits32(a) -> np.ndarray:
    """int32 bit patterns of uint32 values given in any integer dtype."""
    return (np.asarray(a).astype(np.int64) & 0xFFFFFFFF).astype(
        np.uint32).view(np.int32)


def hash_lo_column(keys: np.ndarray, key_len: np.ndarray) -> np.ndarray:
    """uint32[B] lo lane of pegasus_key_hash per padded key row: crc64 of
    the hashkey, or of the sortkey when the hashkey is empty
    (pegasus_key_schema.h:150) — the column SST blocks store."""
    keys = np.ascontiguousarray(keys, dtype=np.uint8)
    key_len = np.asarray(key_len, dtype=np.int64)
    hkl = (keys[:, 0].astype(np.int64) << 8) | keys[:, 1].astype(np.int64)
    region_len = np.maximum(np.where(hkl > 0, hkl, key_len - 2), 0)
    return (crc64_batch(keys, region_len, start=2)
            & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _to_block(keys: np.ndarray, key_len: np.ndarray,
              hashkey_len: np.ndarray, expire_ts: np.ndarray,
              valid: np.ndarray, hash_lo: np.ndarray,
              device) -> RecordBlock:
    to_device = torch.device(device).type != "cpu"

    def t(a, dtype):
        a = np.ascontiguousarray(a, dtype=dtype)
        if to_device:
            H2D["copies"] += 1
            H2D["bytes"] += a.nbytes
        return torch.from_numpy(a).to(device)

    return RecordBlock(t(keys, np.uint8), t(key_len, np.int32),
                       t(hashkey_len, np.int32),
                       t(bits32(expire_ts), np.int32), t(valid, np.bool_),
                       None if hash_lo is None
                       else t(bits32(hash_lo), np.int32))


def well_formed(keys: np.ndarray, key_len: np.ndarray) -> np.ndarray:
    """bool[n]: rows of zero-padded keys uint8[n, W] whose 2-byte
    hash-key-length header fits the body (a key of 2 bytes or more, and
    a header no longer than the rest). A block built for a `now` launch
    marks every other row invalid."""
    key_len = np.asarray(key_len)
    if keys.shape[1] < 2:
        return np.zeros(keys.shape[0], dtype=bool)
    hkl = (keys[:, 0].astype(np.int32) << 8) | keys[:, 1].astype(np.int32)
    return (key_len >= 2) & (hkl <= key_len - 2)


def build_record_block(keys: Sequence[bytes], expire_ts: Sequence[int],
                       capacity: int | None = None,
                       key_width: int | None = None,
                       device="cpu") -> RecordBlock:
    """Pack encoded keys + decoded expire_ts into a padded columnar block
    on `device`. Malformed rows (shorter than the 2-byte header, or a
    header longer than the body) are marked invalid."""
    n = len(keys)
    if capacity is None:
        capacity = n
    if n > capacity:
        raise ValueError(f"{n} records exceed block capacity {capacity}")
    lens = np.fromiter((len(k) for k in keys), dtype=np.int64, count=n)
    max_len = int(lens.max()) if n else 2
    if key_width is None:
        key_width = next_bucket(max_len)
    elif max_len > key_width:
        raise ValueError(f"key of {max_len} bytes exceeds key_width {key_width}")

    arr = np.zeros((capacity, key_width), dtype=np.uint8)
    if n:
        flat = np.frombuffer(b"".join(keys), dtype=np.uint8)
        rows = np.repeat(np.arange(n), lens)
        starts = np.cumsum(lens) - lens
        cols = np.arange(flat.size) - np.repeat(starts, lens)
        arr[rows, cols] = flat
    key_len = np.zeros(capacity, dtype=np.int32)
    key_len[:n] = lens
    hkl = (arr[:, 0].astype(np.int32) << 8) | arr[:, 1].astype(np.int32)
    valid = np.zeros(capacity, dtype=bool)
    valid[:n] = well_formed(arr[:n], lens)
    hashkey_len = np.where(valid, hkl, 0)
    ets = np.zeros(capacity, dtype=np.int64)
    ets[:n] = np.fromiter(expire_ts, dtype=np.int64, count=n)
    return _to_block(arr, key_len, hashkey_len, ets, valid,
                     hash_lo_column(arr, key_len), device)


def block_from_columns(keys: np.ndarray, key_len: np.ndarray,
                       expire_ts: np.ndarray,
                       hash_lo: np.ndarray | None = None,
                       capacity: int | None = None,
                       device="cpu") -> RecordBlock:
    """Block from already-columnar storage (an SST block), zero-padded to
    `capacity` rows and placed on `device`. A block without a stored
    hash_lo column keeps `hash_lo` None: the scan predicate hashes its
    keys on the block's device, never here on the host."""
    keys = np.ascontiguousarray(keys, dtype=np.uint8)
    n = keys.shape[0]
    pad = (capacity or n) - n
    key_len = np.asarray(key_len, dtype=np.int32)
    hashkey_len = (keys[:, 0].astype(np.int32) << 8) | keys[:, 1].astype(
        np.int32)
    hashkey_len = np.where(key_len >= 2, hashkey_len, 0)
    valid = key_len >= 2
    return _to_block(np.pad(keys, ((0, pad), (0, 0))),
                     np.pad(key_len, (0, pad)),
                     np.pad(hashkey_len, (0, pad)),
                     np.pad(bits32(expire_ts), (0, pad)),
                     np.pad(valid, (0, pad)),
                     None if hash_lo is None
                     else np.pad(bits32(hash_lo), (0, pad)),
                     device)
