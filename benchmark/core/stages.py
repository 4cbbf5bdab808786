"""The task profiler's stages inside the node's client_scan_multi
handler (`utils/profiler.PROFILER.stage`): what the stage readers share,
and the device's idle time named by the stages.

A traced run's exec sums (`probe.ExecWall`) hold each stage beside the
message types, as a code `pegasus.<layer>.<step>` timed on the host.
The handler's leaf stages do not overlap and all lie inside its exec
wall; `pegasus.prefresh.*` is the MaskPrefresher's, on its own thread.
Where the program has no stages, every reader here returns None.
"""

from __future__ import annotations

from benchmark.core.probe import _range_at

HANDLER = "client_scan_multi"
LEAF_PREFIXES = ("pegasus.stub.", "pegasus.scan.", "pegasus.merge.")
# the node's other read handlers: they reach the same scan and merge
# steps (on_get_scanner, a ranged multi_get, sortkey_count, the pushdown
# aggregate), and the stages do not say which handler entered them
OTHER_READS = ("client_read", "client_read_batch")


def staged(run) -> bool:
    """Whether the window's leaf stages are all the handler's: some were
    entered, and no other read handler ran."""
    if any(run.exec_count.get(code) for code in OTHER_READS):
        return False
    return any(code.startswith(LEAF_PREFIXES) for code in run.exec_ms)


def stage_ms_per_call(run, codes):
    """The summed wall of the stages `codes` over the handler's messages
    (the divisor of stub_ms_per_call.scan); 0 for a stage the window
    never entered."""
    calls = run.exec_count.get(HANDLER, 0)
    if not calls or not staged(run):
        return None
    return sum(run.exec_ms.get(code, 0.0) for code in codes) / calls


def untraced_pct(run):
    """The share of the handler's exec wall outside its leaf stages."""
    wall = run.exec_ms.get(HANDLER, 0.0)
    if wall <= 0 or not staged(run):
        return None
    leaves = sum(ms for code, ms in run.exec_ms.items()
                 if code.startswith(LEAF_PREFIXES))
    return 100.0 * (wall - leaves) / wall


# ---- the device trace, read by stage -----------------------------------
#
# `probe.summarize` names each idle gap by the harness range around it
# and keeps no gap's bounds, so the gaps are cut here again, as it cuts
# them (tests/test_torch_scan_stages.py holds the two equal). Once
# summarize names gaps by stage, `read_trace`'s gap code and
# `benchmark/stage_trace.py` go.


def _merge(intervals: list) -> list:
    out: list = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def idle_gaps(events) -> list:
    """The idle gaps of a traced window as `probe.summarize` cuts them:
    between the first and the last harness range, outside the union of
    device events (every device event not named `bench.*`), each as
    (start, end, the harness range at its middle), in time order."""
    dev, bench = [], []
    for ev in events:
        on_device = str(getattr(ev, "device_type", "")).endswith("CUDA")
        start, end = ev.time_range.start, ev.time_range.end
        if ev.name.startswith("bench."):
            if not on_device:
                bench.append((start, end, ev.name))
        elif on_device:
            dev.append((start, end))
    if not bench:
        return []
    bench.sort()
    starts = [r[0] for r in bench]
    first, last = bench[0][0], max(e for _s, e, _n in bench)
    edges = [first] + [x for pair in _merge(dev) for x in pair] + [last]
    return [(s, e, _range_at(bench, starts, (s + e) / 2))
            for s, e in zip(edges[0::2], edges[1::2]) if e > s]


def _overlaps(gaps: list, intervals: list) -> list:
    """For each gap (sorted, disjoint), the time `intervals` (sorted,
    disjoint) cover of it."""
    out = [0.0] * len(gaps)
    j = 0
    for i, (gs, ge, _n) in enumerate(gaps):
        while j < len(intervals) and intervals[j][1] <= gs:
            j += 1
        k = j
        while k < len(intervals) and intervals[k][0] < ge:
            out[i] += min(ge, intervals[k][1]) - max(gs, intervals[k][0])
            k += 1
    return out


def read_trace(events) -> dict:
    """From a torch.profiler event list of a traced window: the device's
    idle seconds, the device-side events named `pegasus.*` (a stage
    leaves none), the idle seconds each stage's host ranges cover, and
    the ten largest idle gaps, each named by the stage that covers most
    of it, or else by the harness range as `probe.summarize` names it.
    Times in seconds."""
    events = list(events)
    gaps = idle_gaps(events)
    by_stage: dict = {}
    device_stage_events = 0
    for ev in events:
        if not ev.name.startswith("pegasus."):
            continue
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            device_stage_events += 1
        else:
            by_stage.setdefault(ev.name, []).append(
                (ev.time_range.start, ev.time_range.end))
    cover = {name: _overlaps(gaps, _merge(r)) for name, r in by_stage.items()}
    named = []
    for i, (s, e, bench_name) in enumerate(gaps):
        best = max(cover, key=lambda n: cover[n][i], default=None)
        named.append((e - s, best if best is not None and cover[best][i] > 0
                      else bench_name))
    named.sort(reverse=True)
    return {
        "idle_s": sum(e - s for s, e, _n in gaps) / 1e6,
        "device_stage_events": device_stage_events,
        "idle_s_by_stage": {n: sum(c) / 1e6 for n, c in sorted(cover.items())},
        "host_s_by_stage": {n: sum(e - s for s, e in _merge(r)) / 1e6
                            for n, r in sorted(by_stage.items())},
        "idle_gaps": [[name, us / 1e6] for us, name in named[:10]],
    }
