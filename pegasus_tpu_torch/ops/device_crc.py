"""crc64 of key regions as plain torch ops, in two uint32 lanes.

The port's counterpart of the JAX package's ops/device_crc.py, and the
plain version of the scan kernel's key-hash instance
(csrc/scan_predicate.cu with csrc/key_hash.cuh) and of the compaction
kernel's key hash. Bit-identical to base.crc (dsn::utils::crc64_calc,
src/utils/crc.cpp:464) and to the JAX functions, including their
handling of rows whose region reaches past the padded width K: the byte
loop runs K steps, each reading position clip(start + j, 0, K - 1), and
a row stops once j reaches its length.

The lanes are carried in int64 tensors holding 32-bit values (torch's
CPU uint32 has no shifts); `crc64_device` returns them as int32 bit
patterns, the port's convention for uint32 columns (ops/record_block).

Used for blocks without a stored hash_lo column (PGT1 files): the
ownership check of a scan after a split (check_pegasus_key_hash,
src/base/pegasus_key_schema.h:176: crc64(hashkey) & partition_version ==
partition_index) and the compaction filter's stale-split drop.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from pegasus_tpu_torch.base.crc import TABLE64_NP

_M32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=8)
def _tables(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) halves of the crc64 table as int64 on `device`."""
    t = TABLE64_NP
    hi = torch.from_numpy((t >> np.uint64(32)).astype(np.int64))
    lo = torch.from_numpy((t & np.uint64(_M32)).astype(np.int64))
    return hi.to(device), lo.to(device)


def _bits32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns of int64 tensors holding uint32 values."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def crc64_device(data: torch.Tensor, lengths: torch.Tensor,
                 start=0) -> Tuple[torch.Tensor, torch.Tensor]:
    """crc64 over per-row byte regions of a padded block.

    data:    uint8[B, K]
    lengths: int[B], region byte count
    start:   int or int[B], region start offset
    Returns (hi, lo): int32[B] bit patterns of the 64-bit CRC's lanes."""
    dev = data.device
    b, k = data.shape
    table_hi, table_lo = _tables(dev)
    data64 = data.to(torch.int64)
    lengths = lengths.to(torch.int64)
    starts = torch.as_tensor(start, dtype=torch.int64, device=dev)
    starts = starts.expand(b) if starts.dim() == 0 else starts.to(
        torch.int64)
    hi = torch.full((b,), _M32, dtype=torch.int64, device=dev)
    lo = torch.full((b,), _M32, dtype=torch.int64, device=dev)
    for j in range(k):
        pos = torch.clamp(starts + j, 0, k - 1)
        byte = torch.gather(data64, 1, pos[:, None])[:, 0]
        idx = (lo ^ byte) & 0xFF
        nhi = (hi >> 8) ^ table_hi[idx]
        nlo = (((lo >> 8) | (hi << 24)) & _M32) ^ table_lo[idx]
        active = j < lengths
        hi = torch.where(active, nhi, hi)
        lo = torch.where(active, nlo, lo)
    return _bits32(hi ^ _M32), _bits32(lo ^ _M32)


def key_hash_device(keys: torch.Tensor, key_len: torch.Tensor,
                    hashkey_len: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-record pegasus_key_hash (src/base/pegasus_key_schema.h:150):
    crc64 of the hashkey region, or of the sortkey region when the
    hashkey is empty. Returns (hi, lo) int32 bit patterns."""
    key_len = key_len.to(torch.int64)
    hashkey_len = hashkey_len.to(torch.int64)
    region_len = torch.where(hashkey_len > 0, hashkey_len, key_len - 2)
    return crc64_device(keys, region_len, start=2)


def check_partition_hash_device(keys: torch.Tensor, key_len: torch.Tensor,
                                hashkey_len: torch.Tensor, pidx,
                                partition_version) -> torch.Tensor:
    """bool[B]: does this partition serve each record (the post-split
    check)? partition_version < 0 or pidx > partition_version is the
    caller's to handle (pegasus_server_impl.cpp:2399)."""
    _, lo = key_hash_device(keys, key_len, hashkey_len)
    pv = int(partition_version) & _M32
    return (lo.to(torch.int64) & _M32 & pv) == (int(pidx) & _M32)
