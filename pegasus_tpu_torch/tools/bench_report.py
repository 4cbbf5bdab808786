"""bench_report: fold the scattered BENCH_r*.json files into one
perf-trajectory table.

Every bench round writes a BENCH_r<NN>.json with a ``phases`` dict;
the trajectory across rounds (phase × round → headline ops/s, ratio vs
the prior round that measured that phase) previously lived only in
PERF.md prose. This tool derives it from the artifacts:

    python -m pegasus_tpu_torch.tools.bench_report [--dir REPO] [--json]

Per phase the HEADLINE metric is chosen by preference (the batched/
filtered number a round was run to prove, falling back to the first
numeric), so rounds that renamed their headline key still line up.
Absolute numbers across rounds ran on different boxes — the PERF.md
caveat — so the table prints the measured value AND the same-phase
ratio; trust trends, not cross-round absolutes.
"""

from __future__ import annotations

import json
import os
import re
import sys
from typing import Any, Dict, List, Optional, Tuple

_ROUND_RE = re.compile(r"^BENCH_r(\d+)\.json$")

# headline-metric preference per phase key suffix: first present+numeric
# wins. Ordered most-specific first; "qps"-ish generic keys last.
_HEADLINE_PREFS = (
    "aggregate_read_qps", "compliant_p99_ratio",
    "phash_qps", "filtered_qps", "row_cache_qps",
    "accel_qps", "read_qps", "write_qps", "qps", "records_per_s",
    "accel_records_per_s", "effective_gbps", "mesh_speedup",
    "pushdown_speedup", "filter_speedup", "speedup", "ratio",
)


def _numeric(v: Any) -> Optional[float]:
    if isinstance(v, bool):
        return None
    if isinstance(v, (int, float)):
        return float(v)
    return None


def headline(phase: Dict[str, Any]) -> Optional[Tuple[str, float]]:
    """(key, value) of one phase dict's headline metric."""
    for pref in _HEADLINE_PREFS:
        for k, v in phase.items():
            n = _numeric(v)
            if n is not None and (k == pref or k.endswith(pref)):
                return k, n
    for k in sorted(phase):
        n = _numeric(phase[k])
        if n is not None:
            return k, n
    return None


def load_rounds(bench_dir: str) -> List[Tuple[int, Dict[str, Any]]]:
    """[(round_number, phases dict)] for every BENCH_r*.json, sorted."""
    rounds = []
    for fn in sorted(os.listdir(bench_dir)):
        m = _ROUND_RE.match(fn)
        if not m:
            continue
        try:
            with open(os.path.join(bench_dir, fn)) as f:
                data = json.load(f)
        except (OSError, ValueError):
            continue  # torn artifact: skip, never crash the report
        phases = data.get("phases")
        if isinstance(phases, dict):
            rounds.append((int(m.group(1)), phases))
    rounds.sort()
    return rounds


def trajectory(bench_dir: str) -> Dict[str, Any]:
    """The folded table: phase -> [{round, metric, value, ratio}] where
    ratio compares against the PRIOR ROUND THAT MEASURED THE SAME
    METRIC of that phase (renamed headline keys restart the ratio
    chain rather than comparing apples to oranges)."""
    rounds = load_rounds(bench_dir)
    table: Dict[str, List[dict]] = {}
    for rnd, phases in rounds:
        for phase, body in sorted(phases.items()):
            if not isinstance(body, dict):
                continue
            hl = headline(body)
            if hl is None:
                continue
            key, value = hl
            rows = table.setdefault(phase, [])
            ratio = None
            for prior in reversed(rows):
                if prior["metric"] == key and prior["value"]:
                    ratio = round(value / prior["value"], 3)
                    break
            rows.append({"round": rnd, "metric": key,
                         "value": round(value, 3), "ratio": ratio})
    return {"rounds": [r for r, _p in rounds], "phases": table}


def render(report: Dict[str, Any]) -> str:
    lines = [f"perf trajectory over rounds {report['rounds']}"
             " (ratio = vs prior round measuring the same metric;"
             " boxes differ across rounds — trust trends)"]
    for phase, rows in sorted(report["phases"].items()):
        lines.append(f"{phase}:")
        for row in rows:
            ratio = (f"  ({row['ratio']:.3f}x)"
                     if row["ratio"] is not None else "")
            lines.append(
                f"  r{row['round']:>02}  {row['metric']:<28} "
                f"{row['value']:>14,.3f}{ratio}")
    return "\n".join(lines)


def main(argv=None) -> int:
    args = list(argv if argv is not None else sys.argv[1:])
    as_json = "--json" in args
    args = [a for a in args if a != "--json"]
    bench_dir = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if "--dir" in args:
        i = args.index("--dir")
        if i + 1 >= len(args):
            print("bench_report: --dir needs a directory argument")
            return 2
        bench_dir = args[i + 1]
    elif args:
        bench_dir = args[0]
    report = trajectory(bench_dir)
    if not report["phases"]:
        print(f"bench_report: no BENCH_r*.json under {bench_dir}")
        return 1
    if as_json:
        print(json.dumps(report, indent=1))
    else:
        print(render(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
