"""Stacked evaluation of many blocks' static scan masks.

Records of a predicate are independent, so the blocks of a scan window
go to the scan-predicate kernel as one table of up to STACK_CHUNK
resident blocks, each with its own scalar pidx: one launch and one copy
of the bit-packed masks back to the host per table, no block copied.
One launch per block would be launch-latency bound (see
csrc/scan_predicate.cu).

Masks are static per (block, filter, partition_version): TTL expiry, the
only `now`-dependent predicate, is applied on the host from the block's
expire_ts column, so a block needs one evaluation in its lifetime.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from pegasus_tpu_torch.ops.fused_scan import MAX_TABLE_BLOCKS, scan_table
from pegasus_tpu_torch.ops.predicates import (
    FT_NO_FILTER,
    FilterSpec,
    static_block_predicate,
)

STACK_CHUNK = MAX_TABLE_BLOCKS


def stacked_block_eval(blocks, validate: bool, pv: int, filter_key=None):
    """`blocks`: [(tag, device RecordBlock, pidx)] -> yields
    (tag, static_keep bool numpy[cap]). Every table is launched before
    the first result is copied to the host."""
    submitted = list(stacked_block_submit(list(blocks), validate, pv,
                                          filter_key))
    for group, packed in submitted:
        host = packed.cpu().numpy()
        offset = 0
        for tag, dev, _p in group:
            cap = dev.capacity
            nbytes = -(-cap // 8)
            yield tag, np.unpackbits(host[offset:offset + nbytes],
                                     count=cap).astype(bool)
            offset += nbytes


def stacked_block_submit(blocks, validate: bool, pv: int, filter_key=None):
    """Launch the static predicate of every table without waiting; yields
    (group, packed keep masks on the device, block after block)."""
    hft, hfp, sft, sfp = filter_key or (FT_NO_FILTER, b"",
                                        FT_NO_FILTER, b"")
    for group in _tables(blocks):
        dev = group[0][1].device
        hash_f = FilterSpec.make(hft, hfp, dev)
        sort_f = FilterSpec.make(sft, sfp, dev)
        if len(group) == 1:
            # a block alone keeps the split gate of its scalar pidx, as
            # in the reference, where only a stack carries a pidx column
            _tag, block, pidx = group[0]
            packed = static_block_predicate(
                block, hash_filter=hash_f, sort_filter=sort_f,
                validate_hash=validate, pidx=pidx, partition_version=pv,
                pack=True)
        else:
            packed = scan_table([d for _t, d, _p in group],
                                [p for _t, _d, p in group], hash_f, sort_f,
                                validate, pv)
        yield group, packed


def _tables(blocks):
    """Groups of up to STACK_CHUNK blocks sharing (key width, capacity),
    one launch each. The capacity key keeps the reference's chunks, so a
    block is evaluated alone exactly where the reference's is."""
    buckets: "OrderedDict[tuple, list]" = OrderedDict()
    for tag, dev, pidx in blocks:
        buckets.setdefault((dev.key_width, dev.capacity), []).append(
            (tag, dev, pidx))
    for group in buckets.values():
        for off in range(0, len(group), STACK_CHUNK):
            yield group[off:off + STACK_CHUNK]
