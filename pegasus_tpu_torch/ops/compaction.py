"""Compaction filter: TTL + default-TTL rewrite + stale-split drop.

Parity: KeyWithTTLCompactionFilter::Filter
(src/server/key_ttl_compaction_filter.h:55-121):
1. default_ttl != 0 and record has no TTL -> rewrite expire_ts to
   now + default_ttl (uint32 arithmetic, wrapping at 2^32).
2. drop iff expired(now) after the rewrite, OR the key is stale post-split
   data: validate_hash and the key's hash does not map to `pidx`
   (check_if_stale_split_data, :114-121).

Plain torch on the block's device; the key hash comes from the block's
precomputed `hash_lo` column, the same lo lane the JAX program derives
with key_hash_device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pegasus_tpu_torch.ops.predicates import ttl_expired
from pegasus_tpu_torch.ops.record_block import u32

_M32 = 0xFFFFFFFF


def compaction_filter_block(hash_lo: torch.Tensor, expire_ts: torch.Tensor,
                            valid: torch.Tensor, now: int, default_ttl: int,
                            pidx: int, partition_version: int,
                            validate_hash: bool
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (drop: bool[B], new_expire_ts: int64[B] of uint32 values).

    `partition_version` must be >= 0 when validate_hash is set (callers
    gate the pv<0 / pidx>pv cases to keep, as check_if_stale_split_data
    does)."""
    now &= _M32
    default_ttl &= _M32
    expire_ts = u32(expire_ts)
    if default_ttl:
        new_ets = torch.where(expire_ts == 0, (now + default_ttl) & _M32,
                              expire_ts)
    else:
        new_ets = expire_ts
    expired = ttl_expired(new_ets, now)
    if validate_hash:
        stale = (u32(hash_lo) & (partition_version & _M32)) != (pidx & _M32)
    else:
        stale = torch.zeros_like(valid)
    return (expired | stale) & valid, new_ets
