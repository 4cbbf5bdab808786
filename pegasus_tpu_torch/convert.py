"""Carry state from the JAX package's representation into the port's.

A JAX `RecordBlock` given as numpy arrays (uint32 columns, `hash_lo`
possibly None) becomes the port's `RecordBlock` on a device (uint32
columns as int32 bit patterns, `hash_lo` always present), and a
`(filter_type, raw pattern)` pair becomes a `FilterSpec` there, a JAX
`PushdownSpec` the port's, and a ruleset the JAX package parsed the
JSON-shaped list the port's `parse_rules` takes. On-disk state needs no conversion: at any of
the three codecs (`none`, `dcz`, `dcz2`), with or without bloom and
perfect-hash sidecars, both packages read and write the same SST, WAL and
manifest files, so a store carries over as it is.
"""

from __future__ import annotations

import numpy as np

from pegasus_tpu_torch.ops.predicates import FilterSpec
from pegasus_tpu_torch.ops.pushdown import PushdownSpec
from pegasus_tpu_torch.ops.record_block import (
    RecordBlock,
    _to_block,
    hash_lo_column,
)
from pegasus_tpu_torch.utils.device import resolve_device


def record_block(block, device=None) -> RecordBlock:
    """Port RecordBlock on `device` (the card by default) from any object
    with the JAX block's fields (`keys`, `key_len`, `hashkey_len`,
    `expire_ts`, `valid`, `hash_lo`) holding numpy arrays. A missing
    `hash_lo` is computed on the host, the lane the JAX kernels hash on
    the device."""
    keys = np.asarray(block.keys, dtype=np.uint8)
    key_len = np.asarray(block.key_len)
    hash_lo = getattr(block, "hash_lo", None)
    if hash_lo is None:
        hash_lo = hash_lo_column(keys, key_len)
    return _to_block(keys, key_len, np.asarray(block.hashkey_len),
                     np.asarray(block.expire_ts), np.asarray(block.valid),
                     np.asarray(hash_lo),
                     resolve_device(device))


def filter_spec(filter_type: int, raw: bytes, device=None) -> FilterSpec:
    """Port FilterSpec for a JAX `FilterSpec`'s (filter_type, raw)."""
    return FilterSpec.make(filter_type, raw, resolve_device(device))


def pushdown_spec(spec) -> PushdownSpec:
    """Port PushdownSpec for any object with a JAX `PushdownSpec`'s
    fields."""
    return PushdownSpec(
        value_filter_type=int(spec.value_filter_type),
        value_filter_pattern=bytes(spec.value_filter_pattern),
        aggregate=str(spec.aggregate), k=int(spec.k), seed=int(spec.seed))


_MATCH_NAMES = {1: "anywhere", 2: "prefix", 3: "postfix"}


def rules_spec(operations) -> list:
    """The list of operation dicts that the port's
    `ops.compaction_rules.parse_rules` takes, for a ruleset parsed by
    either package (`compile_rules(...).operations`); both packages then
    give the ruleset the same content key. Patterns stay bytes."""
    out = []
    for op in operations:
        spec = {"op": op.op, "rules": []}
        if op.op == "update_ttl":
            spec["update_ttl_type"] = op.utot
            spec["value"] = int(op.value)
        for r in op.rules:
            if r.kind == "ttl_range":
                spec["rules"].append({"type": "ttl_range",
                                      "start_ttl": int(r.start_ttl),
                                      "stop_ttl": int(r.stop_ttl)})
            else:
                spec["rules"].append({
                    "type": r.kind,
                    "match": _MATCH_NAMES[int(r.filter.filter_type)],
                    "pattern": bytes(r.filter.raw)})
        out.append(spec)
    return out
