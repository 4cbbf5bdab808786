"""Cluster-wide distributed tracing: trace context on every RPC,
tail-kept slow traces, cross-node stitching.

Parity/inspiration: the reference treats observability as a first-class
layer — every mutation carries an rDSN latency tracer whose stage chain
dumps when slow (src/utils/latency_tracer.h:94, replica_2pc.cpp:338-359).
This module extends that *per-process* stage chain into a *cross-process*
span tree:

- every sampled client op mints a ``(trace_id, span_id, flags)`` context
  that rides the RPC payload dict (key ``"trace"``) through BOTH
  transports (rpc/transport.py TCP and runtime/sim.py delivery);
- server-side, the transport dispatch opens a span per inbound request
  parented to the carried context; finer join points (per-op spans at
  the batching seams, 2PC per-peer prepare hops) parent to it; the
  already-present ``LatencyTracer`` stage points feed the bound span as
  annotations — one instrumentation layer, not two;
- spans land in a per-node bounded ring (drop-oldest). Sampling is
  head-based (``[pegasus.tracing] sample_ratio``, default 0 — zero spans,
  zero allocation) plus TAIL KEEP: a request that crosses
  ``slow_trace_ms`` pins its local spans out of the ring's churn and the
  keep decision rides the reply context upstream so every upstream hop
  pins too — slow traces are always whole;
- ``stitch()`` assembles dumps from many nodes into one rooted tree and
  aligns clocks per hop from the parent/child span endpoints (the
  send/recv pair observable at the transport), reporting a skew bound.

The span stack is thread-local: on the TCP transport the single
dispatcher thread owns it; in the sim everything nests on one thread and
push/pop order preserves correctness through recursive delivery.

The port's copy of the JAX package's utils/tracing.py, its imports rewritten to
pegasus_tpu_torch (it imports nothing of that package).
"""

from __future__ import annotations

import itertools
import random
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple

from pegasus_tpu_torch.utils.flags import FLAGS, define_flag

define_flag("pegasus.tracing", "sample_ratio", 0.0,
            "head-based sampling probability for new client ops "
            "(0 disables tracing entirely: no spans, no allocation)",
            mutable=True)
define_flag("pegasus.tracing", "slow_trace_ms", 20.0,
            "a sampled request slower than this is tail-kept: its spans "
            "pin out of the ring and the keep decision propagates "
            "upstream on the reply so slow traces are always whole",
            mutable=True)
define_flag("pegasus.tracing", "ring_capacity", 2048,
            "per-node span ring size (drop-oldest)", mutable=True)
define_flag("pegasus.tracing", "kept_traces", 64,
            "tail-kept slow traces retained per node (drop-oldest)",
            mutable=True)

# context flag bits
SAMPLED = 1
KEEP = 2

# spans per kept trace (a runaway trace must not pin unbounded memory)
KEPT_SPAN_CAP = 1024

# message types that are replies/acks: their carried context pins
# tail-keep but never opens a dispatch span (a reply is the END of a
# hop, not a new one)
_REPLY_SUFFIXES = ("_reply", "_ack")


def is_reply_type(name: str) -> bool:
    return name.endswith(_REPLY_SUFFIXES)


# ---- ids -----------------------------------------------------------------

_lock = threading.Lock()
_rng = random.Random()
_prefix = _rng.getrandbits(32)
_trace_ids = itertools.count(1)
_span_ids = itertools.count(1)
_hard_off = False  # bench baseline switch: bypass even the flag read


def seed(n: int) -> None:
    """Deterministic ids + sampling draws (tests / sim replays)."""
    global _rng, _prefix, _trace_ids, _span_ids
    with _lock:
        _rng = random.Random(n)
        _prefix = _rng.getrandbits(32)
        _trace_ids = itertools.count(1)
        _span_ids = itertools.count(1)


def hard_disable(off: bool) -> None:
    """Kill switch for the bench's no-tracing baseline: skips even the
    sample_ratio flag read on the client hot path."""
    global _hard_off
    _hard_off = off


def _new_trace_id() -> str:
    return f"{_prefix:08x}{next(_trace_ids):08x}"


def _new_span_id() -> int:
    return (_prefix << 24) | (next(_span_ids) & 0xFFFFFF)


def maybe_sample() -> bool:
    """One head-based sampling draw (client op mint)."""
    if _hard_off:
        return False
    ratio = FLAGS.get("pegasus.tracing", "sample_ratio")
    if ratio <= 0.0:
        return False
    return ratio >= 1.0 or _rng.random() < ratio


# ---- spans ---------------------------------------------------------------


class Span:
    __slots__ = ("ring", "trace_id", "span_id", "parent_id", "name",
                 "node", "start", "end", "annotations", "tags")

    def __init__(self, ring: "SpanRing", trace_id: str, span_id: int,
                 parent_id: Optional[int], name: str) -> None:
        self.ring = ring
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.node = ring.node
        self.start = ring.clock()
        self.end: Optional[float] = None
        self.annotations: List[Tuple[str, float]] = []
        self.tags: Dict[str, Any] = {}

    def annotate(self, stage: str, at: Optional[float] = None) -> None:
        self.annotations.append(
            (stage, self.ring.clock() if at is None else at))

    def elapsed_ms(self) -> float:
        return (self.ring.clock() - self.start) * 1000.0

    def ctx(self) -> Tuple[str, int, int]:
        """The wire context. The KEEP bit is computed HERE, at send
        time: a reply stamped while the local request already crossed
        the slow threshold (or its trace was already pinned) carries the
        tail-keep decision upstream."""
        flags = SAMPLED
        if (self.ring.is_kept(self.trace_id)
                or self.elapsed_ms()
                >= FLAGS.get("pegasus.tracing", "slow_trace_ms")):
            flags |= KEEP
        return (self.trace_id, self.span_id, flags)

    def finish(self) -> None:
        if self.end is not None:
            return  # idempotent (error paths may double-finish)
        self.end = self.ring.clock()
        self.ring.record(self)

    def to_dict(self) -> Dict[str, Any]:
        return {"trace": self.trace_id, "span": self.span_id,
                "parent": self.parent_id, "name": self.name,
                "node": self.node, "start": self.start,
                "end": self.end if self.end is not None else self.start,
                "ann": list(self.annotations),
                "tags": dict(self.tags)}


class SpanRing:
    """One node's span store: a drop-oldest ring of finished spans plus
    the pinned (tail-kept) slow traces, which survive ring churn."""

    def __init__(self, node: str, clock=time.time) -> None:
        from pegasus_tpu_torch.utils.metrics import METRICS

        self.node = node
        self.clock = clock
        self._ring: "deque[dict]" = deque()
        self._kept: "OrderedDict[str, List[dict]]" = OrderedDict()
        self._lock = threading.RLock()
        ent = METRICS.entity("tracing", node)
        self.kept_count = ent.counter("kept_trace_count")
        self.drop_count = ent.counter("span_drop_count")
        self.span_count = ent.counter("span_count")

    # -- recording --------------------------------------------------------

    def start(self, name: str, parent: Optional[Span] = None,
              parent_ctx: Optional[tuple] = None,
              trace_id: Optional[str] = None) -> Span:
        """A new span; the caller already decided it is sampled."""
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif parent_ctx is not None:
            trace_id, parent_id = parent_ctx[0], parent_ctx[1]
        else:
            trace_id, parent_id = trace_id or _new_trace_id(), None
        return Span(self, trace_id, _new_span_id(), parent_id, name)

    def record(self, span: Span) -> None:
        d = span.to_dict()
        pin_after = False
        with self._lock:
            self.span_count.increment()
            if span.trace_id in self._kept:
                kept = self._kept[span.trace_id]
                if len(kept) < KEPT_SPAN_CAP:
                    kept.append(d)
            else:
                self._ring.append(d)
                cap = FLAGS.get("pegasus.tracing", "ring_capacity")
                while len(self._ring) > cap:
                    self._ring.popleft()
                    self.drop_count.increment()
                # local tail-keep: this span alone crossed the slow
                # threshold -> pin its whole trace
                if (d["end"] - d["start"]) * 1000.0 >= FLAGS.get(
                        "pegasus.tracing", "slow_trace_ms"):
                    pin_after = True
        if pin_after:
            self.pin(span.trace_id)

    def pin(self, trace_id: str) -> None:
        """Tail keep: pull this trace's spans out of the churn ring into
        the kept store; spans recorded later join them directly."""
        with self._lock:
            if trace_id in self._kept:
                return
            mine = [d for d in self._ring if d["trace"] == trace_id]
            if mine:
                self._ring = deque(d for d in self._ring
                                   if d["trace"] != trace_id)
            self._kept[trace_id] = mine[:KEPT_SPAN_CAP]
            self.kept_count.increment()
            cap = FLAGS.get("pegasus.tracing", "kept_traces")
            while len(self._kept) > cap:
                self._kept.popitem(last=False)

    def is_kept(self, trace_id: str) -> bool:
        return trace_id in self._kept

    # -- read surfaces ----------------------------------------------------

    def dump(self, trace_id: Optional[str] = None) -> List[dict]:
        with self._lock:
            out = []
            for spans in self._kept.values():
                out.extend(spans)
            out.extend(self._ring)
        if trace_id is not None:
            out = [d for d in out if d["trace"] == trace_id]
        return out

    def slow_roots(self, limit: int = 16) -> List[dict]:
        """Summaries of the tail-kept traces, newest last: the root (or
        earliest) span per trace — what `shell traces --slow` lists."""
        with self._lock:
            items = list(self._kept.items())[-limit:]
        out = []
        for tid, spans in items:
            if not spans:
                out.append({"trace": tid, "name": "?", "node": self.node,
                            "start": 0.0, "total_ms": 0.0})
                continue
            roots = [s for s in spans if s["parent"] is None]
            root = min(roots or spans, key=lambda s: s["start"])
            out.append({"trace": tid, "name": root["name"],
                        "node": root["node"], "start": root["start"],
                        "total_ms": round(
                            (root["end"] - root["start"]) * 1000.0, 3)})
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._kept.clear()


# ---- registry ------------------------------------------------------------

_rings: Dict[str, SpanRing] = {}
_rings_lock = threading.Lock()


def ring_for(node: str, clock=None) -> SpanRing:
    """The node's ring (created on first use). Passing `clock` (re)binds
    the ring's timebase — the sim cluster points every node at its
    virtual clock so span timelines live in sim time."""
    with _rings_lock:
        ring = _rings.get(node)
        if ring is None:
            ring = _rings[node] = SpanRing(node, clock or time.time)
        elif clock is not None:
            ring.clock = clock
        return ring


def dump_all(trace_id: Optional[str] = None) -> List[dict]:
    """Every local ring's spans (the shell process's own client ring
    joins the fan-out dumps this way)."""
    with _rings_lock:
        rings = list(_rings.values())
    out: List[dict] = []
    for r in rings:
        out.extend(r.dump(trace_id))
    return out


def slow_roots_all(limit: int = 16) -> List[dict]:
    with _rings_lock:
        rings = list(_rings.values())
    out: List[dict] = []
    for r in rings:
        out.extend(r.slow_roots(limit))
    return sorted(out, key=lambda d: d["start"])[-limit:]


def drop_ring(node: str) -> None:
    """Remove one node's ring (a closed sim cluster drops the rings it
    registered so its clock closures — and through them the whole dead
    cluster — are not pinned in the process-global registry)."""
    with _rings_lock:
        _rings.pop(node, None)


def reset() -> None:
    """Drop every ring (test isolation; sim clusters re-register)."""
    with _rings_lock:
        _rings.clear()


# ---- ambient span stack (server-side dispatch) ---------------------------

_tls = threading.local()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def push(span: Span) -> None:
    _stack().append(span)


def pop(span: Span) -> None:
    st = _stack()
    if st and st[-1] is span:
        st.pop()
    elif span in st:  # defensive: unwind past a mispaired frame
        st.remove(span)


def current_span() -> Optional[Span]:
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None


def current_ctx() -> Optional[tuple]:
    """The wire context of the ambient span (None when untraced) — what
    the transports stamp onto outbound payload dicts."""
    st = getattr(_tls, "stack", None)
    return st[-1].ctx() if st else None


def annotate(stage: str) -> None:
    """Annotate the ambient span; a single attr check when untraced."""
    st = getattr(_tls, "stack", None)
    if st:
        st[-1].annotate(stage)


class activate:
    """Context manager: make `span` ambient (no-op for None)."""

    __slots__ = ("_span",)

    def __init__(self, span: Optional[Span]) -> None:
        self._span = span

    def __enter__(self):
        if self._span is not None:
            push(self._span)
        return self._span

    def __exit__(self, *exc) -> None:
        if self._span is not None:
            pop(self._span)


def child_of(parent: Optional[Span], name: str) -> Optional[Span]:
    """A child span on the parent's ring (None-propagating)."""
    if parent is None:
        return None
    return parent.ring.start(name, parent=parent)


# ---- transport hooks -----------------------------------------------------


def on_inbound_ctx(node: str, ctx) -> None:
    """Process a carried context on ANY inbound message: a KEEP bit pins
    the trace locally (upstream hops of a slow request pin theirs when
    the decision rides back on the reply)."""
    if ctx and (ctx[2] & KEEP):
        ring_for(node).pin(ctx[0])


def start_server_span(node: str, name: str, ctx) -> Optional[Span]:
    """Dispatch join point: open a span for an inbound request carrying
    a sampled context (replies/acks only pin, never span)."""
    if not ctx or not (ctx[2] & SAMPLED):
        return None
    ring = ring_for(node)
    if ctx[2] & KEEP:
        ring.pin(ctx[0])
    return ring.start(name, parent_ctx=ctx)


# ---- stitching -----------------------------------------------------------


def stitch(spans: List[dict]) -> Optional[dict]:
    """Assemble span dumps (from any number of nodes) into ONE rooted
    tree with per-hop clock alignment.

    Each tree node is the span dict plus:
      - ``offset``: seconds added to this span's local clock to land it
        on the ROOT's timebase (cumulative down the tree);
      - ``skew_ms``: half-width of the per-hop offset interval — the
        alignment uncertainty from transport asymmetry;
      - ``rel_ms`` / ``dur_ms`` / ``self_ms``: aligned start relative to
        the root, duration, and self time (duration minus children);
      - ``children``: sorted by aligned start.

    Alignment derives from the send/recv pair the transports already
    observe: a child hop's span must START after its parent span started
    and END before the parent ended (request left after the parent span
    opened; reply arrived before it closed), so the child->parent clock
    offset lies in ``[p.start - c.start, p.end - c.end]``; the midpoint
    aligns, the half-width bounds the skew. Async children that outlive
    their parent clamp to start-alignment and report the overrun as
    skew.
    """
    if not spans:
        return None
    by_id: Dict[int, dict] = {}
    for s in spans:
        prev = by_id.get(s["span"])
        # dedupe (duplicated deliveries / overlapping dumps): keep the
        # longer record — it saw more of the span's life
        if prev is None or (s["end"] - s["start"]) > (
                prev["end"] - prev["start"]):
            by_id[s["span"]] = s
    nodes = {sid: dict(s, children=[]) for sid, s in by_id.items()}
    roots = []
    for sid, n in nodes.items():
        p = n.get("parent")
        if p is not None and p in nodes:
            nodes[p]["children"].append(n)
        else:
            roots.append(n)
    if len(roots) > 1:
        # orphans (ring-dropped parents): synthesize a root so the
        # result is still ONE tree
        t0 = min(r["start"] for r in roots)
        t1 = max(r["end"] for r in roots)
        root = {"trace": roots[0]["trace"], "span": 0, "parent": None,
                "name": "(stitched)", "node": "?", "start": t0,
                "end": t1, "ann": [], "tags": {},
                "children": sorted(roots, key=lambda r: r["start"])}
    else:
        root = roots[0]

    def local_extent(n: dict) -> Tuple[float, float]:
        """Interval covered by this span plus its SAME-NODE descendants
        (one shared clock, so no alignment needed): the true window of
        this hop's local work, even when an async child outlives the
        span that spawned it."""
        ext = n.get("_lex")
        if ext is None:
            s, e = n["start"], n["end"]
            for c in n["children"]:
                if c["node"] == n["node"]:
                    cs, ce = local_extent(c)
                    s, e = min(s, cs), max(e, ce)
            ext = n["_lex"] = (s, e)
        return ext

    def align(n: dict, offset: float) -> None:
        n["offset"] = offset
        n["skew_ms"] = n.get("skew_ms", 0.0)
        n["dur_ms"] = round((n["end"] - n["start"]) * 1000.0, 3)
        _ps, pe = local_extent(n)
        for c in n["children"]:
            if c["node"] == n["node"]:
                d, skew = 0.0, 0.0  # same clock: no per-hop estimation
            else:
                # the hop bound: the child's local work started after
                # the parent span opened (request sent) and ended
                # before the parent's local work closed (reply seen)
                cs, ce = local_extent(c)
                lo = n["start"] - cs
                hi = pe - ce
                if hi >= lo:
                    d, skew = (lo + hi) / 2.0, (hi - lo) / 2.0
                else:  # one-way hop (no reply observed): align starts
                    d, skew = lo, (lo - hi) / 2.0
            c["skew_ms"] = round(skew * 1000.0, 3)
            align(c, offset + d)
        n["children"].sort(key=lambda c: c["start"] + c["offset"])

    def extent(n: dict) -> Tuple[float, float]:
        """Aligned interval covered by this span's whole subtree (an
        async child may outlive its parent span)."""
        s = n["start"] + n["offset"]
        e = n["end"] + n["offset"]
        for c in n["children"]:
            cs, ce = extent(c)
            s, e = min(s, cs), max(e, ce)
        n["_ext"] = (s, e)
        return s, e

    def self_time(n: dict) -> None:
        """Self time = own interval minus the union of child SUBTREE
        intervals — parallel children overlap and async children spill
        past their own span, so a plain duration sum misattributes."""
        for c in n["children"]:
            self_time(c)
        extent_ = [c["_ext"] for c in n["children"]] if n["children"] \
            else []
        s0 = n["start"] + n["offset"]
        e0 = n["end"] + n["offset"]
        covered = 0.0
        last = s0
        for cs, ce in sorted(extent_):
            cs, ce = max(cs, last), min(ce, e0)
            if ce > cs:
                covered += ce - cs
                last = ce
        n["self_ms"] = round(max(0.0, (e0 - s0) - covered) * 1000.0, 3)

    align(root, 0.0)
    extent(root)
    self_time(root)
    for n in list(walk_dict(root)):
        n.pop("_ext", None)
        n.pop("_lex", None)
    t_root = root["start"]

    def rel(n: dict) -> None:
        n["rel_ms"] = round(
            (n["start"] + n["offset"] - t_root) * 1000.0, 3)
        for c in n["children"]:
            rel(c)

    rel(root)
    return root


def walk_dict(tree: dict):
    """Yield every node of a stitched tree (pre-order)."""
    yield tree
    for c in tree["children"]:
        yield from walk_dict(c)


walk = walk_dict


def render(tree: Optional[dict], width: int = 48) -> str:
    """Text timeline of a stitched tree: one line per span with an
    aligned bar, duration, self time, and per-hop skew bound."""
    if tree is None:
        return "(no spans)"
    total = max(tree["dur_ms"], 1e-9)
    lines = [f"trace {tree['trace']}  total {tree['dur_ms']:.3f} ms"]

    def emit(n: dict, depth: int) -> None:
        left = int(n["rel_ms"] / total * width)
        bar_w = max(1, int(n["dur_ms"] / total * width))
        bar = " " * min(left, width - 1) + "#" * min(bar_w,
                                                     width - left)
        skew = (f" ±{n['skew_ms']:.3f}ms" if n.get("skew_ms") else "")
        ann = ""
        if n["ann"]:
            stages = ",".join(a[0] for a in n["ann"][:8])
            ann = f"  [{stages}]"
        lines.append(
            f"{'  ' * depth}{n['name']} @{n['node']}  "
            f"{n['dur_ms']:.3f}ms (self {n['self_ms']:.3f}ms){skew}"
            f"{ann}")
        pc = (n.get("tags") or {}).get("perf")
        if pc:
            # the op's PerfContext rode the span: counts, not just
            # durations (only the fields that moved; an all-zero
            # vector — a gate-rejected flush — prints nothing)
            moved = " ".join(
                f"{k}={v}" for k, v in pc.items()
                if k not in ("op", "placement")
                and v not in (0, 0.0, None))
            place = (f" [{pc['placement']}]"
                     if pc.get("placement") else "")
            if moved or place:
                lines.append(f"{'  ' * depth}  perf{place}: {moved}")
        lines.append(f"{'  ' * depth}|{bar:<{width}}|")
        for c in n["children"]:
            emit(c, depth + 1)

    emit(tree, 0)
    return "\n".join(lines)
