"""Scan pushdown: value-region predicates + fused mask->aggregate folds.

The port's copy of pegasus_tpu/ops/pushdown.py (the same masks, partials
and finalized aggregates). A ``PushdownSpec`` rides the scan request, a
value-region filter leg joins the scan's mask algebra, and the mask feeds
a fused aggregate fold (count / sum(value_as_u64) / top-k by sortkey /
reservoir sample), so an aggregate-mode scan returns one partial per
partition instead of pages of rows.

Kernel notes:

- The value-region filter is host-side by construction: value heaps are
  NOT device-resident (RecordBlock carries keys/expire_ts only), and the
  match is compute-trivial per byte, so it runs on the host like the TTL
  mask and the point probes.
- Value regions skip the stored value header (``hdr`` =
  value_schema.header_length), so they do NOT tile the heap contiguously
  and the native ``region_filter_fn`` (which assumes ``offs[i] ==`` end
  of region i-1) cannot be reused directly; ``region_filter_ranges``
  below is the vectorized numpy twin over arbitrary (start, end) pairs —
  one AND-of-shifted-compares pass over the heap, then per-region
  prefix-sum / endpoint gathers. ``hdr == 0`` still takes the native
  kernel.
- Aggregates fold off raw columns without row materialization where
  possible: count/sum never build a row; top-k materializes at most k
  rows per block (blocks are key-sorted, so a block's top-k is its last
  k survivors); sample materializes at most k candidate rows per block
  (bottom-k by deterministic per-ordinal priority — a mergeable
  reservoir: uniform because the priorities behave randomly, and two
  partials merge by keeping the k smallest priorities).

Sum semantics: ``value_as_u64`` is the little-endian u64 of the first
min(8, len) USER bytes of the value, zero-padded; sums are modulo 2^64.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from pegasus_tpu_torch.ops.predicates import (
    FT_MATCH_ANYWHERE,
    FT_MATCH_POSTFIX,
    FT_MATCH_PREFIX,
    FT_NO_FILTER,
    _region_filter_host,
    host_match_filter,
)

_MASK64 = (1 << 64) - 1

# aggregate kinds ("" = filter-mode: rows come back, just fewer)
AGG_KINDS = ("", "count", "sum", "top_k", "sample")

_KNOWN_FILTER_TYPES = (FT_NO_FILTER, FT_MATCH_ANYWHERE, FT_MATCH_PREFIX,
                       FT_MATCH_POSTFIX)


@dataclasses.dataclass(frozen=True)
class PushdownSpec:
    """What the server should evaluate INSIDE the scan-page path.

    ``value_filter_*`` reuses the FilterSpec match types
    (ops/predicates.FT_*) against the USER bytes of each value; sortkey
    predicates already exist on the request itself
    (sort_key_filter_type/pattern) and compose with this. ``aggregate``
    turns the scan into one-partial-per-partition mode; ``k`` sizes
    top_k/sample; ``seed`` makes sample deterministic.
    """

    value_filter_type: int = FT_NO_FILTER
    value_filter_pattern: bytes = b""
    aggregate: str = ""
    k: int = 0
    seed: int = 0

    @property
    def value_filter(self) -> Optional[Tuple[int, bytes]]:
        """(type, pattern) normal form, or None when match-all (same
        collapse rule as _normalize_filter_key: empty pattern and
        FT_NO_FILTER both match everything)."""
        vft, vfp = self.value_filter_type, self.value_filter_pattern
        if vft == FT_NO_FILTER or not vfp:
            return None
        return (int(vft), bytes(vfp))

    @property
    def key(self) -> tuple:
        """Hashable normal-form identity (batch grouping / mask keys)."""
        vf = self.value_filter or (FT_NO_FILTER, b"")
        return vf + (self.aggregate, int(self.k), int(self.seed))

    def check(self) -> None:
        """Raise ValueError on a malformed spec (the stub maps that to
        ERR_INVALID_PARAMETERS, like any bad request field)."""
        if self.aggregate not in AGG_KINDS:
            raise ValueError(f"unknown pushdown aggregate "
                             f"{self.aggregate!r} (want one of "
                             f"{AGG_KINDS[1:]})")
        if self.aggregate in ("top_k", "sample") and self.k <= 0:
            raise ValueError(f"pushdown aggregate {self.aggregate!r} "
                             f"requires k > 0 (got {self.k})")
        if self.value_filter_type not in _KNOWN_FILTER_TYPES:
            raise ValueError(f"unknown value filter type "
                             f"{self.value_filter_type}")


# -- value-region filtering ------------------------------------------------

def _as_u8(heap) -> np.ndarray:
    arr = (np.frombuffer(heap, dtype=np.uint8)
           if isinstance(heap, (bytes, bytearray, memoryview))
           else np.asarray(heap))
    if arr.dtype != np.uint8:
        arr = arr.view(np.uint8)
    return arr


def region_filter_ranges(heap, starts: np.ndarray, ends: np.ndarray,
                         filter_type: int, pattern: bytes) -> np.ndarray:
    """bool[n] pattern match over byte ranges ``heap[starts[i]:ends[i]]``.

    The ragged-region twin of predicates._region_filter_host for regions
    that do NOT tile the heap contiguously (value regions skip the
    stored header). One vectorized AND-of-shifted-compares pass marks
    every heap position where the pattern starts (the numpy analogue of
    match_filter's ANYWHERE accumulation), then each region answers from
    endpoint gathers (PREFIX/POSTFIX) or a hit-count prefix sum
    (ANYWHERE). Device-kernel semantics: empty pattern matches
    everything; a region shorter than the pattern never matches.
    """
    starts = np.asarray(starts, dtype=np.int64)
    ends = np.asarray(ends, dtype=np.int64)
    n = len(starts)
    if filter_type == FT_NO_FILTER or not pattern:
        return np.ones(n, dtype=bool)
    p = len(pattern)
    lens = ends - starts
    fits = lens >= p
    hv = np.ascontiguousarray(_as_u8(heap))
    length = hv.size
    if length < p or not n:
        return np.zeros(n, dtype=bool)
    pat = np.frombuffer(bytes(pattern), dtype=np.uint8)
    hit = np.ones(length - p + 1, dtype=bool)
    for j in range(p):
        hit &= hv[j:length - p + 1 + j] == pat[j]
    top = length - p  # last valid window start
    if filter_type == FT_MATCH_PREFIX:
        pos = np.clip(starts, 0, top)
        return fits & (starts <= top) & hit[pos]
    if filter_type == FT_MATCH_POSTFIX:
        tail = ends - p
        pos = np.clip(tail, 0, top)
        return fits & (tail >= 0) & (tail <= top) & hit[pos]
    if filter_type == FT_MATCH_ANYWHERE:
        csum = np.concatenate(([0], np.cumsum(hit, dtype=np.int64)))
        lo = np.clip(starts, 0, top + 1)
        hi = np.maximum(np.clip(ends - p + 1, 0, top + 1), lo)
        return fits & ((csum[hi] - csum[lo]) > 0)
    raise ValueError(f"unknown filter type {filter_type}")


def value_filter_mask(heap, value_offs, hdr: int, filter_type: int,
                      pattern: bytes) -> np.ndarray:
    """bool[n] value-region keep mask for one columnar block.

    User region of row i is ``heap[value_offs[i]+hdr : value_offs[i+1]]``
    (``hdr`` = the stored expire/timetag header the scan strips before
    returning values). Like the static key masks, this is
    ``now``-independent and pure over the immutable block, so callers
    cache it per (block, filter).
    """
    offs = np.asarray(value_offs, dtype=np.int64)
    n = len(offs) - 1
    if filter_type == FT_NO_FILTER or not pattern:
        return np.ones(n, dtype=bool)
    hv = _as_u8(heap)
    if hdr == 0:
        # regions tile the heap contiguously: the native kernel applies
        return _region_filter_host(hv, offs, filter_type, pattern)
    starts = np.minimum(offs[:-1] + hdr, offs[1:])
    return region_filter_ranges(hv, starts, offs[1:], filter_type,
                                pattern)


# -- value_as_u64 ----------------------------------------------------------

def value_as_u64(user_data: bytes) -> int:
    """Scalar twin of values_as_u64 (overlay rows, client fallback)."""
    return int.from_bytes(bytes(user_data[:8]), "little")


def values_as_u64(heap, value_offs, hdr: int, rows) -> np.ndarray:
    """uint64[len(rows)]: little-endian u64 of the first min(8, len)
    USER bytes of each selected value, zero-padded — one vectorized
    gather, no per-row bytes objects."""
    rows = np.asarray(rows, dtype=np.int64)
    if rows.size == 0:
        return np.zeros(0, dtype=np.uint64)
    offs = np.asarray(value_offs, dtype=np.int64)
    hv = _as_u8(heap)
    starts = np.minimum(offs[rows] + hdr, offs[rows + 1])
    lens = np.minimum(offs[rows + 1] - starts, 8)
    lane = np.arange(8, dtype=np.int64)
    idx = starts[:, None] + lane[None, :]
    valid = lane[None, :] < lens[:, None]
    idx = np.clip(idx, 0, max(0, hv.size - 1))
    data = hv[idx] if hv.size else np.zeros_like(idx, dtype=np.uint8)
    lanes = np.where(valid, data, 0).astype(np.uint64)
    shifts = np.uint64(8) * np.arange(8, dtype=np.uint64)
    return (lanes << shifts[None, :]).sum(axis=1, dtype=np.uint64)


# -- reservoir priorities --------------------------------------------------

def _splitmix64(x) -> np.ndarray:
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z = x + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def _sample_priorities(seed: int, first_ordinal: int, m: int) -> np.ndarray:
    """uint64[m] deterministic per-row reservoir priorities: the sample
    is the k survivors with the SMALLEST priorities, which makes
    partials mergeable (union, keep k smallest) and the whole sample a
    pure function of (seed, survivor order)."""
    base = np.uint64((seed * 0x9E3779B97F4A7C15 + 0x2545F4914F6CDD1D)
                     & _MASK64)
    with np.errstate(over="ignore"):
        ordinals = base + np.arange(first_ordinal, first_ordinal + m,
                                    dtype=np.uint64)
    return _splitmix64(ordinals)


# -- the partial-aggregate accumulator -------------------------------------

class AggState:
    """One partition's partial aggregate, folded incrementally as scan
    pages evaluate. The wire form (``to_wire``) is a plain dict so it
    rides the in-process RPC payloads without new codec surface;
    ``merge_partials``/``finalize`` combine per-partition partials
    client- or coordinator-side.

    items layout: top_k -> [(key, value)] ascending by key (the k
    largest survive, trimmed from the front); sample -> [(pri, key,
    value)] ascending by priority (k smallest survive)."""

    __slots__ = ("kind", "k", "seed", "count", "total", "items", "seen")

    def __init__(self, spec: PushdownSpec) -> None:
        self.kind = spec.aggregate
        self.k = int(spec.k)
        self.seed = int(spec.seed)
        self.count = 0   # matching rows folded
        self.total = 0   # sum(value_as_u64) mod 2^64
        self.items: List[tuple] = []
        self.seen = 0    # reservoir ordinal cursor

    # ---- columnar fold (the scan-page fast path) ----------------------

    def fold_columnar(self, rows, heap=None, value_offs=None,
                      hdr: int = 0, key_at=None) -> None:
        """Fold one block's surviving row indices (``rows`` ascending —
        block key order). count/sum touch no row; top_k/sample
        materialize at most k rows each."""
        m = int(len(rows))
        if m == 0:
            return
        self.count += m
        if self.kind == "sum":
            vals = values_as_u64(heap, value_offs, hdr, rows)
            self.total = (self.total
                          + int(vals.sum(dtype=np.uint64))) & _MASK64
        elif self.kind == "top_k":
            rows = np.asarray(rows, dtype=np.int64)
            offs = np.asarray(value_offs, dtype=np.int64)
            hv = _as_u8(heap)
            for i in rows[-self.k:]:
                i = int(i)
                lo = min(int(offs[i]) + hdr, int(offs[i + 1]))
                self.items.append((key_at(i),
                                   hv[lo:int(offs[i + 1])].tobytes()))
            self.items.sort(key=lambda kv: kv[0])
            del self.items[:-self.k]
        elif self.kind == "sample":
            pris = _sample_priorities(self.seed, self.seen, m)
            self.seen += m
            if m > self.k:
                cand = np.sort(np.argpartition(pris, self.k - 1)[:self.k])
            else:
                cand = np.arange(m)
            rows = np.asarray(rows, dtype=np.int64)
            offs = np.asarray(value_offs, dtype=np.int64)
            hv = _as_u8(heap)
            for j in cand:
                i = int(rows[int(j)])
                lo = min(int(offs[i]) + hdr, int(offs[i + 1]))
                self.items.append((int(pris[int(j)]), key_at(i),
                                   hv[lo:int(offs[i + 1])].tobytes()))
            self.items.sort(key=lambda t: (t[0], t[1]))
            del self.items[self.k:]

    # ---- scalar fold (overlay rows, iterator fallback, client-side) ---

    def fold_row(self, key: bytes, user_data: bytes) -> None:
        self.count += 1
        if self.kind == "sum":
            self.total = (self.total + value_as_u64(user_data)) & _MASK64
        elif self.kind == "top_k":
            bisect.insort(self.items, (key, user_data))
            if len(self.items) > self.k:
                del self.items[0]
        elif self.kind == "sample":
            pri = int(_sample_priorities(self.seed, self.seen, 1)[0])
            self.seen += 1
            if len(self.items) < self.k or pri < self.items[-1][0]:
                bisect.insort(self.items, (pri, key, user_data))
                del self.items[self.k:]

    def to_wire(self) -> Dict[str, Any]:
        return {"kind": self.kind, "k": self.k, "seed": self.seed,
                "count": self.count, "total": self.total,
                "items": list(self.items), "seen": self.seen}


def merge_partials(spec: PushdownSpec,
                   parts: Iterable[Optional[Dict[str, Any]]]
                   ) -> Dict[str, Any]:
    """Fold per-partition wire partials into one combined wire dict
    (counts/sums add; top_k keeps the k largest keys of the union;
    sample keeps the k smallest priorities of the union)."""
    st = AggState(spec)
    for part in parts:
        if not part:
            continue
        st.count += int(part.get("count", 0))
        st.total = (st.total + int(part.get("total", 0))) & _MASK64
        st.seen += int(part.get("seen", 0))
        st.items.extend(tuple(it) for it in part.get("items") or ())
    if spec.aggregate == "top_k":
        st.items.sort(key=lambda kv: kv[0])
        del st.items[:-spec.k]
    elif spec.aggregate == "sample":
        st.items.sort(key=lambda t: (t[0], t[1]))
        del st.items[spec.k:]
    return st.to_wire()


def finalize(spec: PushdownSpec, wire: Dict[str, Any]):
    """Merged wire partial -> the user-facing aggregate value."""
    if spec.aggregate == "count":
        return int(wire["count"])
    if spec.aggregate == "sum":
        return int(wire["total"])
    if spec.aggregate == "top_k":
        # "top" first: descending by key
        return [(k, v) for k, v in reversed(wire["items"])]
    if spec.aggregate == "sample":
        return [(key, v) for _pri, key, v in wire["items"]]
    raise ValueError(f"not an aggregate spec: {spec.aggregate!r}")


def aggregate_rows(spec: PushdownSpec,
                   rows: Iterable[Tuple[bytes, bytes]]):
    """Client-side fallback: the whole spec (value filter and aggregate)
    over materialized (key, user_value) rows, as a client evaluates it
    when the server ignored the pushdown spec."""
    vf = spec.value_filter
    st = AggState(spec)
    for key, value in rows:
        if vf is not None and not host_match_filter(value, vf[0], vf[1]):
            continue
        st.fold_row(key, value)
    return finalize(spec, st.to_wire())
