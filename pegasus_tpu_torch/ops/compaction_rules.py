"""User-specified compaction: declarative retention rules.

Parity: src/server/compaction_filter_rule.{h,cpp} +
compaction_operation.{h,cpp} (design doc
rfcs/2021-05-27-user-specified-compaction.md), as the JAX package's
ops/compaction_rules.py evaluates them:

- rules: hashkey_pattern / sortkey_pattern (SMT match anywhere/prefix/
  postfix) and ttl_range (matches records whose expire_ts lies in
  [now+start_ttl, now+stop_ttl], in wrapping uint32 arithmetic;
  start==stop==0 matches no-TTL records, compaction_filter_rule.cpp:75-90).
  An EMPTY pattern matches nothing here (string_pattern_match returns
  false, compaction_filter_rule.cpp:35) — the opposite of the scan path.
- operations AND their rules (compaction_operation.h:77):
  delete_key drops matching records; update_ttl rewrites expire_ts with
  op types FROM_NOW (now+value), FROM_CURRENT (current expire_ts+value,
  no-op on no-TTL records), TIMESTAMP (expire at unix ts `value`)
  (compaction_operation.cpp:77-103).
- evaluation order: operations run in sequence and judge their rules
  against the ORIGINAL expire_ts; the first matching delete wins; updates
  apply where matched and not deleted.

`apply_rules_ops` is the plain torch version, on any device; TTLs are
int64 tensors holding uint32 values (torch's CPU uint32 has no
comparisons). `compile_rules` gives the merge path's hook; on a CUDA
device its batches go through the hand-written compaction-filter kernel
(ops/fused_compaction.py), on the CPU through the plain version.
"""

from __future__ import annotations

import json
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from pegasus_tpu_torch.base.value_schema import PEGASUS_EPOCH_BEGIN
from pegasus_tpu_torch.ops import fused_compaction
from pegasus_tpu_torch.ops.predicates import (
    FT_MATCH_ANYWHERE,
    FT_MATCH_POSTFIX,
    FT_MATCH_PREFIX,
    FilterSpec,
    match_filter,
)
from pegasus_tpu_torch.ops.record_block import build_record_block, u32
from pegasus_tpu_torch.utils.device import resolve_device

_M32 = 0xFFFFFFFF

_MATCH_TYPES = {
    "anywhere": FT_MATCH_ANYWHERE,
    "prefix": FT_MATCH_PREFIX,
    "postfix": FT_MATCH_POSTFIX,
    # reference enum spellings (SMT_MATCH_*) accepted too
    "SMT_MATCH_ANYWHERE": FT_MATCH_ANYWHERE,
    "SMT_MATCH_PREFIX": FT_MATCH_PREFIX,
    "SMT_MATCH_POSTFIX": FT_MATCH_POSTFIX,
}

UTOT_FROM_NOW = "from_now"
UTOT_FROM_CURRENT = "from_current"
UTOT_TIMESTAMP = "timestamp"
_UTOT_ALIASES = {
    "from_now": UTOT_FROM_NOW, "UTOT_FROM_NOW": UTOT_FROM_NOW,
    "from_current": UTOT_FROM_CURRENT, "UTOT_FROM_CURRENT": UTOT_FROM_CURRENT,
    "timestamp": UTOT_TIMESTAMP, "UTOT_TIMESTAMP": UTOT_TIMESTAMP,
}


class Rule:
    """One predicate, evaluated over a whole block."""

    def __init__(self, spec: dict) -> None:
        self.kind = spec["type"]
        if self.kind in ("hashkey_pattern", "FRT_HASHKEY_PATTERN",
                         "sortkey_pattern", "FRT_SORTKEY_PATTERN"):
            self.kind = ("hashkey_pattern" if "hash" in self.kind.lower()
                         else "sortkey_pattern")
            pattern = spec["pattern"]
            if isinstance(pattern, str):
                pattern = pattern.encode()
            self.filter = FilterSpec.make(_MATCH_TYPES[spec["match"]],
                                          pattern)
        elif self.kind in ("ttl_range", "FRT_TTL_RANGE"):
            self.kind = "ttl_range"
            self.start_ttl = int(spec["start_ttl"])
            self.stop_ttl = int(spec["stop_ttl"])
        else:
            raise ValueError(f"unknown rule type {spec['type']!r}")

    def evaluate(self, keys, key_len, hashkey_len, expire_ts, now: int
                 ) -> torch.Tensor:
        """bool[B]; `expire_ts` int64 of uint32 values."""
        if self.kind in ("hashkey_pattern", "sortkey_pattern"):
            # an empty pattern matches NOTHING here: without this an
            # empty-pattern delete_key rule would wipe the table
            if self.filter.pattern_len == 0:
                return torch.zeros(keys.shape[0], dtype=torch.bool,
                                   device=keys.device)
            f = FilterSpec.make(self.filter.filter_type, self.filter.raw,
                                keys.device)
            if self.kind == "hashkey_pattern":
                return match_filter(keys, torch.full_like(key_len, 2),
                                    hashkey_len, f.pattern, f.pattern_len,
                                    f.filter_type)
            start = 2 + hashkey_len
            return match_filter(keys, start, key_len - start, f.pattern,
                                f.pattern_len, f.filter_type)
        # ttl_range (compaction_filter_rule.cpp:75-90), uint32 wrapping
        now &= _M32
        no_ttl_match = ((expire_ts == 0) & (self.start_ttl == 0)
                        & (self.stop_ttl == 0))
        in_range = ((expire_ts >= ((now + self.start_ttl) & _M32))
                    & (expire_ts <= ((now + self.stop_ttl) & _M32)))
        return no_ttl_match | (in_range & (expire_ts != 0))


class Operation:
    def __init__(self, spec: dict) -> None:
        op = spec["op"] if "op" in spec else spec["type"]
        if op in ("delete_key", "COT_DELETE"):
            self.op = "delete_key"
        elif op in ("update_ttl", "COT_UPDATE_TTL"):
            self.op = "update_ttl"
            self.utot = _UTOT_ALIASES[spec["update_ttl_type"]]
            self.value = int(spec["value"])
        else:
            raise ValueError(f"unknown compaction op {op!r}")
        self.rules = [Rule(r) for r in spec["rules"]]
        if not self.rules:
            raise ValueError("compaction operation requires >= 1 rule")


def parse_rules(spec) -> List[Operation]:
    """Accepts a JSON string or a parsed list of operation dicts."""
    if isinstance(spec, (str, bytes)):
        spec = json.loads(spec)
    return [Operation(s) for s in spec]


def timestamp_ets(value: int) -> int:
    """expire_ts of a TIMESTAMP update: unix seconds to the pegasus
    epoch, floored at 0."""
    return max(0, value - PEGASUS_EPOCH_BEGIN) & _M32


def apply_rules_ops(operations, keys, key_len, hashkey_len, expire_ts,
                    valid, now: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply a parsed ruleset to one block: (drop bool[B], new_ets int64[B]
    of uint32 values).

    Every operation evaluates against the ORIGINAL (pre-rules) expire_ts
    — the reference fixes existing_value before its op loop
    (key_ttl_compaction_filter.h:94-108); only the output accumulates
    updates."""
    now &= _M32
    expire_ts = u32(expire_ts)
    drop = torch.zeros_like(valid)
    ets = expire_ts
    for op in operations:
        matched = valid & ~drop
        for rule in op.rules:
            matched = matched & rule.evaluate(keys, key_len, hashkey_len,
                                              expire_ts, now)
        if op.op == "delete_key":
            drop = drop | matched
            continue
        if op.utot == UTOT_FROM_NOW:
            new_ts = torch.full_like(expire_ts, (now + op.value) & _M32)
        elif op.utot == UTOT_FROM_CURRENT:
            # no-op for records without a TTL, judged on the original
            # value (compaction_operation.cpp:93-96)
            matched = matched & (expire_ts != 0)
            new_ts = (expire_ts + op.value) & _M32
        else:  # UTOT_TIMESTAMP: expire at unix ts `value`
            new_ts = torch.full_like(expire_ts, timestamp_ets(op.value))
        ets = torch.where(matched, new_ts, ets)
    return drop, ets


def compile_rules(spec, device=None) -> Callable:
    """Returns `rules_filter(keys, expire_ts, now) -> (drop, new_ets)`
    (numpy bool[n] and uint32[n]), StorageEngine.manual_compact's hook,
    evaluated on `device` (the card unless the caller names the CPU).
    The parsed ruleset is `rules_filter.operations`, so the bulk
    compactor evaluates it inside its own pass."""
    operations = parse_rules(spec)
    dev = resolve_device(device)

    def rules_filter(keys: Sequence[bytes], expire_ts, now: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        n = len(keys)
        # power-of-two capacity bucket, as the reference's
        cap = 1024
        while cap < n:
            cap <<= 1
        block = build_record_block(list(keys), list(np.asarray(expire_ts)),
                                   capacity=cap, device=dev)
        if dev.type == "cuda":
            drop, ets = fused_compaction.compaction_filter(
                block.keys, block.key_len, block.expire_ts, block.valid,
                None, 0, operations, now, 0, 0, validate_hash=False,
                expire=False, want_ets=True, pack=False)
            drop, ets = drop.cpu().numpy(), ets.cpu().numpy()
        else:
            drop, ets = apply_rules_ops(
                operations, block.keys, block.key_len, block.hashkey_len,
                block.expire_ts, block.valid, now)
            drop, ets = drop.numpy(), ets.numpy()
        return drop[:n], ets[:n].astype(np.uint32)

    rules_filter.operations = tuple(operations)
    return rules_filter
