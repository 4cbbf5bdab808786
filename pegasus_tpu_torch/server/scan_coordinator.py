"""Stacked evaluation of many blocks' static scan masks.

Records of a predicate are independent, so blocks sharing (key width,
capacity) stack into one [S*cap, W] block and one kernel launch, with a
per-record partition-index column for the ownership check. One launch per
block would be launch-latency bound (see csrc/scan_predicate.cu).

Masks are static per (block, filter, partition_version): TTL expiry, the
only `now`-dependent predicate, is applied on the host from the block's
expire_ts column, so a block needs one evaluation in its lifetime.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from pegasus_tpu_torch.ops.predicates import (
    FT_NO_FILTER,
    FilterSpec,
    static_block_predicate,
)
from pegasus_tpu_torch.ops.record_block import RecordBlock

STACK_CHUNK = 16


def stacked_block_eval(blocks, validate: bool, pv: int, filter_key=None):
    """`blocks`: [(tag, device RecordBlock, pidx)] -> yields
    (tag, static_keep bool numpy[cap]). Every chunk is launched before the
    first result is copied to the host."""
    blocks = list(blocks)
    submitted = list(stacked_block_submit(blocks, validate, pv, filter_key))
    for group, cap, keep in submitted:
        keep_all = keep.cpu().numpy()
        for i, (tag, _d, _p) in enumerate(group):
            yield tag, keep_all[i * cap:(i + 1) * cap]


def stacked_block_submit(blocks, validate: bool, pv: int, filter_key=None):
    """Launch the static predicate of every chunk without waiting; yields
    (group, cap, keep device tensor)."""
    hft, hfp, sft, sfp = filter_key or (FT_NO_FILTER, b"",
                                        FT_NO_FILTER, b"")
    for group, cap, stacked, pidx in _stacked_chunks(blocks):
        dev = stacked.device
        keep = static_block_predicate(
            stacked, hash_filter=FilterSpec.make(hft, hfp, dev),
            sort_filter=FilterSpec.make(sft, sfp, dev),
            validate_hash=validate, pidx=pidx, partition_version=pv)
        yield group, cap, keep


def _stacked_chunks(blocks):
    """Yields (group, cap, stacked RecordBlock, pidx) with up to
    STACK_CHUNK blocks per group, bucketed by (key width, capacity) so
    mask slices align; pidx is the scalar of a single block or a
    per-record int32 column of a stack."""
    buckets: "OrderedDict[tuple, list]" = OrderedDict()
    for tag, dev, pidx in blocks:
        key = (int(dev.keys.shape[1]), int(dev.keys.shape[0]))
        buckets.setdefault(key, []).append((tag, dev, pidx))
    for (_w, cap), group in buckets.items():
        for off in range(0, len(group), STACK_CHUNK):
            chunk = group[off:off + STACK_CHUNK]
            if len(chunk) == 1:
                _tag, dev, pidx = chunk[0]
                yield chunk, cap, dev, pidx
                continue
            device = chunk[0][1].device
            pidx_col = torch.cat([
                torch.full((cap,), pidx, dtype=torch.int32, device=device)
                for _t, _d, pidx in chunk])
            stacked = RecordBlock(*(
                torch.cat([d[f] for _t, d, _p in chunk])
                for f in range(len(RecordBlock._fields))))
            yield chunk, cap, stacked, pidx_col
