"""EXPLAIN: execute one op and render its plan with real counters.

`shell explain <table> <op-spec>` runs one captured op through the
REAL serving path (the batched point planner / the batched scan
planner — never a side path that could drift from production) with a
forced PerfContext and a zeroed slow-log threshold, then renders the
stage chain with the per-stage cost counters next to the timings —
the report a RocksDB operator gets from perf_context + EXPLAIN in a
SQL engine, for this engine's plan shapes.

`shell explain --from-trace <id>` rebuilds the same report from a kept
slow trace: the serving paths stamp their cost vector onto the op's
span (`span.tags["perf"]`), so any tail-kept slow trace already
carries everything this module needs — the after-the-fact explain for
an op nobody planned to debug.

The port's copy of the JAX package's server/explain.py, its imports rewritten to
pegasus_tpu_torch (it imports nothing of that package).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from pegasus_tpu_torch.utils import perf_context as perf

# which cost-vector fields belong to which stage of the known chains
# (plan/bloom/phash_probe/block_probe/decode/finish for point flushes;
# plan/block_scan|block_probe/decode/assemble|finish for scans)
STAGE_FIELDS: Dict[str, tuple] = {
    "plan": ("ops", "keys_resolved", "runs_considered", "overlay_hits",
             "row_cache_hit", "row_cache_miss"),
    "bloom": ("bloom_pruned",),
    "phash_probe": ("phash_pruned", "phash_located"),
    "block_probe": ("blocks_decoded", "block_cache_hit", "bytes_read",
                    "blocks_planned"),
    "block_scan": ("blocks_decoded", "block_cache_hit", "bytes_read",
                   "rows_evaluated", "mesh_partitions"),
    "pushdown": ("pushdown_rows_pruned", "rows_aggregated"),
    "decode": ("bytes_decoded",),
    "assemble": ("rows_survived", "bytes_returned"),
    "finish": ("rows_evaluated", "rows_survived", "expired_rows",
               "bytes_returned"),
}


def _summarize_result(op: str, result) -> Dict[str, Any]:
    if op in ("get", "ttl"):
        status, payload = result
        out = {"status": int(status)}
        if op == "get":
            out["value_bytes"] = len(payload)
        else:
            out["ttl"] = payload
        return out
    kvs = getattr(result, "kvs", None)
    if kvs is None:
        kvs = getattr(result, "data", None)
    out = {"error": int(getattr(result, "error", 0)),
           "rows": len(kvs) if kvs is not None else 0}
    if getattr(result, "pushdown_applied", False):
        out["pushdown_applied"] = True
    agg = getattr(result, "agg", None)
    if agg is not None:
        out["agg"] = {k: agg[k] for k in ("kind", "count", "total")
                      if agg.get(k) or k == "kind"}
    return out


def explain_op(server, op: str, args,
               partition_hash: Optional[int] = None) -> Dict[str, Any]:
    """Execute ONE op on `server` (a PartitionServer) under a forced
    PerfContext and return the explain report (stage chain + cost
    vector + placement audit). The op really executes — an explain of
    a write-heavy table's scan costs what the scan costs — through the
    REAL batched phases, reading the stage chain off the op's own
    tracer (never the shared slow ring, whose tail a concurrently
    served request could own)."""
    import time as _time

    from pegasus_tpu_torch.server.workload import DRIFT

    pc = perf.PerfContext(f"explain:{op}")
    tracer = None
    t0 = _time.perf_counter()
    with perf.activate(pc):
        if op in ("get", "ttl", "multi_get", "batch_get"):
            state = server.plan_get_batch([(op, args, partition_hash)])
            result = server.serve_get_batch(state)[0]
            tracer = state.get("tracer")
        elif op == "scan":
            state = server.plan_scan_batch([args])
            if state is None:
                # store shape can't take the batched path (big
                # overlay / exotic filter): solo serve — the cost
                # vector still fills, the stage chain doesn't
                result = server.on_get_scanner(args)
            elif "precomputed" in state:
                result = state["precomputed"][0]
            else:
                keep = server.eval_planned_masks(state)
                result = server.finish_scan_batch(state, keep)[0]
                tracer = state.get("tracer")
        else:
            raise ValueError(f"explain: unknown op {op!r}")
    wall_ms = (_time.perf_counter() - t0) * 1000.0
    report = tracer.report() if tracer is not None else {}
    return {
        "op": op,
        "gpid": [server.app_id, server.pidx],
        "total_ms": report.get("total_ms", round(wall_ms, 3)),
        "stages": report.get("stages", []),
        "perf": pc.to_dict(),
        "result": _summarize_result(op, result),
        "drift": DRIFT.status(),
    }


def op_from_spec(spec: Dict[str, Any]):
    """(op, op_args, partition_hash) from a compact spec dict
    ``{op, hash_key, sort_key?|sort_keys?, batch_size?}`` (keys utf-8
    strings) — shared by the shell's --root mode and the node's
    ``perf.explain`` verb so the two surfaces cannot drift."""
    from pegasus_tpu_torch.base.key_schema import (
        generate_key,
        generate_next_bytes,
        key_hash_parts,
    )

    op = spec.get("op", "get")
    hk = spec.get("hash_key", "").encode()
    if op in ("get", "ttl"):
        sk = spec.get("sort_key", "").encode()
        return op, generate_key(hk, sk), key_hash_parts(hk, sk)
    if op == "multi_get":
        from pegasus_tpu_torch.server.types import MultiGetRequest

        return op, MultiGetRequest(
            hash_key=hk,
            sort_keys=[s.encode()
                       for s in spec.get("sort_keys", [])]), \
            key_hash_parts(hk, b"")
    if op == "scan":
        from pegasus_tpu_torch.server.types import GetScannerRequest

        pushdown = None
        if spec.get("filter") or spec.get("agg"):
            from pegasus_tpu_torch.ops.predicates import FT_MATCH_ANYWHERE
            from pegasus_tpu_torch.ops.pushdown import PushdownSpec

            pushdown = PushdownSpec(
                value_filter_type=(FT_MATCH_ANYWHERE if spec.get("filter")
                                   else 0),
                value_filter_pattern=spec.get("filter", "").encode(),
                aggregate=spec.get("agg", ""),
                k=int(spec.get("k", 0)))
        return op, GetScannerRequest(
            start_key=generate_key(hk, b"") if hk else b"",
            stop_key=(generate_next_bytes(hk) if hk else b""),
            batch_size=int(spec.get("batch_size", 100)),
            one_page=True,
            pushdown=pushdown), None
    raise ValueError(f"explain: unknown op {op!r}")


def spec_from_words(words: List[str]) -> Dict[str, Any]:
    """The shell's positional op-spec -> spec dict:
    ``get <hk> [sk]`` / ``multi_get <hk> <sk> [sk...]`` /
    ``scan [hk] [batch_size]``."""
    if not words:
        raise ValueError("empty op spec")
    op = words[0]
    if op in ("get", "ttl"):
        if len(words) < 2:
            raise ValueError(f"usage: explain <table> {op} "
                             "<hash_key> [sort_key]")
        return {"op": op, "hash_key": words[1],
                "sort_key": words[2] if len(words) > 2 else ""}
    if op == "multi_get":
        if len(words) < 3:
            raise ValueError("usage: explain <table> multi_get "
                             "<hash_key> <sort_key> [sort_key...]")
        return {"op": op, "hash_key": words[1],
                "sort_keys": words[2:]}
    if op == "scan":
        spec: Dict[str, Any] = {"op": op}
        pos = 1
        for w in words[1:]:
            # pushdown spec words: filter=<pattern> pushes an ANYWHERE
            # value filter; agg=count|sum|top_k|sample (+ k=<n>)
            if "=" in w:
                key, _, val = w.partition("=")
                if key not in ("filter", "agg", "k", "batch_size"):
                    raise ValueError(f"explain scan: unknown option "
                                     f"{key!r} (filter|agg|k|batch_size)")
                spec[key] = int(val) if key in ("k", "batch_size") else val
                continue
            if pos == 1:
                spec["hash_key"] = w
            elif pos == 2:
                spec["batch_size"] = int(w)
            else:
                raise ValueError("usage: explain <table> scan [hash_key]"
                                 " [batch_size] [filter=<pat>]"
                                 " [agg=<kind>] [k=<n>]")
            pos += 1
        return spec
    raise ValueError(f"explain: unknown op {op!r} "
                     "(get|ttl|multi_get|scan)")


def from_trace(spans: List[dict], trace_id: str) -> Dict[str, Any]:
    """Rebuild explain reports from a (stitched or raw) span dump: every
    span carrying a perf tag becomes one op report, its stage chain
    recovered from the span's annotations."""
    ops = []
    for d in sorted(spans, key=lambda s: s.get("start", 0.0)):
        tags = d.get("tags") or {}
        pc = tags.get("perf")
        if pc is None:
            continue
        t0 = d.get("start", 0.0)
        stages = []
        prev = t0
        for stage, at in d.get("ann") or []:
            stages.append({"stage": stage,
                           "delta_ms": round((at - prev) * 1000.0, 3),
                           "at_ms": round((at - t0) * 1000.0, 3)})
            prev = at
        ops.append({
            "op": pc.get("op", d.get("name", "?")),
            "span": d.get("name"),
            "node": d.get("node"),
            "total_ms": round(
                (d.get("end", t0) - t0) * 1000.0, 3),
            "stages": stages,
            "perf": pc,
        })
    return {"trace": trace_id, "ops": ops}


def _stage_line(stage: Dict[str, Any], pc: Dict[str, Any],
                last: bool) -> str:
    name = stage.get("stage", "?")
    fields = STAGE_FIELDS.get(name, ())
    shown = " ".join(f"{f}={pc[f]}" for f in fields
                     if pc.get(f) not in (None, 0, 0.0))
    tee = "└─" if last else "├─"
    base = f"{tee} {name:<12} {stage.get('delta_ms', 0.0):8.3f} ms"
    return f"{base}  {shown}" if shown else base


def render_report(report: Dict[str, Any]) -> str:
    """One op's explain report as a tree: header, per-stage timings
    with that stage's counters, then the placement/kernel audit."""
    pc = report.get("perf") or {}
    gpid = report.get("gpid")
    where = (f" @ {gpid[0]}.{gpid[1]}" if gpid
             else f" @ {report.get('node', '?')}")
    lines = [f"EXPLAIN {report.get('op', '?')}{where} — "
             f"{report.get('total_ms', 0.0):.3f} ms"
             + (f", placement {pc.get('placement')}"
                if pc.get("placement") else "")
             + (f", served_by {pc.get('served_by')}"
                if pc.get("served_by") else "")]
    stages = report.get("stages") or []
    for i, st in enumerate(stages):
        lines.append("  " + _stage_line(st, pc, i == len(stages) - 1))
    # rows/bytes rollup + the unmapped remainder
    lines.append(
        f"  rows: evaluated={pc.get('rows_evaluated', 0)} "
        f"survived={pc.get('rows_survived', 0)} "
        f"expired={pc.get('expired_rows', 0)}   "
        f"bytes: read={pc.get('bytes_read', 0)} "
        f"decoded={pc.get('bytes_decoded', 0)} "
        f"returned={pc.get('bytes_returned', 0)}")
    if pc.get("measured_kernel_ms") or pc.get("predicted_kernel_ms"):
        lines.append(
            f"  kernel: predicted={pc.get('predicted_kernel_ms', 0.0)} ms "
            f"measured={pc.get('measured_kernel_ms', 0.0)} ms")
    if pc.get("mesh_partitions") or pc.get("mesh_wave_ms"):
        lines.append(
            f"  mesh: partitions={pc.get('mesh_partitions', 0)} "
            f"wave={pc.get('mesh_wave_ms', 0.0)} ms (resident SPMD "
            "dispatch answered this scan's waves)")
    if pc.get("queue_wait_ms"):
        lines.append(f"  queue_wait: {pc['queue_wait_ms']} ms")
    res = report.get("result")
    if res is not None:
        lines.append(f"  result: {res}")
    drift = report.get("drift")
    if drift and drift.get("classes"):
        lines.append(f"  cost-model drift: {drift['drift_ratio']}x "
                     "(measured/predicted, worst class)")
    return "\n".join(lines)


def render_trace_report(report: Dict[str, Any]) -> str:
    lines = [f"EXPLAIN --from-trace {report.get('trace')}: "
             f"{len(report.get('ops') or [])} op(s) with cost vectors"]
    for op in report.get("ops") or []:
        lines.append("")
        lines.append(render_report(dict(op, op=(
            f"{op.get('op')} [{op.get('span')} on {op.get('node')}]"))))
    if not report.get("ops"):
        lines.append("  (no spans with perf tags — was the op sampled "
                     "and served by an instrumented path?)")
    return "\n".join(lines)
