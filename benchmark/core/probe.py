"""What a traced run reads from the program: the handler exec wall the
port's task profiler times, the scan kernel's launches and their
shapes, and a torch.profiler trace of the window. Everything here observes; none of it changes an answer.

The spans inside `SimCluster` are not read: their clock is the
simulated one (`_epoch + loop.now`), not the wall.
"""

from __future__ import annotations

import bisect
import contextlib
import time


class ExecWall:
    """Sums of the exec wall, by message type, that `utils/profiler.
    PROFILER` observes around every handler `runtime/sim` dispatches
    (perf_counter around the handler; its queue side is the simulated
    link delay and is not read). The profiler keeps windows of samples
    only, so its observe is wrapped to keep the sums as well."""

    def __init__(self) -> None:
        self.ms: dict = {}
        self.count: dict = {}
        self._was_enabled = False

    def __enter__(self):
        from pegasus_tpu_torch.utils.profiler import PROFILER

        observe = PROFILER.observe

        def summing(code, queue_ms, exec_ms):
            self.ms[code] = self.ms.get(code, 0.0) + exec_ms
            self.count[code] = self.count.get(code, 0) + 1
            observe(code, queue_ms, exec_ms)

        self._was_enabled = PROFILER.enabled
        PROFILER.observe = summing
        PROFILER.clear()
        PROFILER.enable()
        return self

    def __exit__(self, *exc) -> None:
        from pegasus_tpu_torch.utils.profiler import PROFILER

        del PROFILER.observe          # the class's method again
        if not self._was_enabled:
            PROFILER.disable()


class ScanLaunches:
    """The scan kernel's table launches (`ops/fused_scan._launch_table`)
    with the shape each one had: records, key width, filters, whether it
    read `now`, validated, and had a pidx column."""

    def __init__(self) -> None:
        self.shapes: list = []
        self._saved = None

    def __enter__(self):
        import torch

        from pegasus_tpu_torch.ops import fused_scan

        launch = fused_scan._launch_table

        def recording(blocks, pidxs, hash_filter, sort_filter,
                      validate_hash, partition_version, now):
            out = launch(blocks, pidxs, hash_filter, sort_filter,
                         validate_hash, partition_version, now)
            n = sum(int(b.keys.shape[0]) for b in blocks)
            if n:
                self.shapes.append({
                    "n": n, "k": int(blocks[0].keys.shape[1]),
                    "hash_filter": hash_filter.filter_type != 0,
                    "sort_filter": sort_filter.filter_type != 0,
                    "now": now is not None,
                    "validate": bool(validate_hash),
                    "pidx_column": any(isinstance(p, torch.Tensor)
                                       for p in pidxs)})
            return out

        self._saved = launch
        fused_scan._launch_table = recording
        return self

    def __exit__(self, *exc) -> None:
        from pegasus_tpu_torch.ops import fused_scan

        fused_scan._launch_table = self._saved


def scan_launch_counts() -> dict:
    from pegasus_tpu_torch.ops import fused_scan

    return dict(fused_scan.LAUNCHES)


def counters() -> dict:
    return {"scan_launches": scan_launch_counts()}


def delta(after: dict, before: dict) -> dict:
    return {group: {k: v - before[group].get(k, 0) for k, v in vals.items()}
            for group, vals in after.items()}


class DeviceTrace:
    """torch.profiler over the window, host and device activity, with
    the harness's own ranges (`span(name)`) around each call. After the
    window: `busy_s` (the union of device activity), `window_s`, kernel
    seconds by name, and the device's idle gaps named by the harness
    range the host was in."""

    def __init__(self, device) -> None:
        self.device = device
        self.on = device.type == "cuda"
        self._prof = None
        self.window_s = 0.0
        self.summary: dict = {}

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)

    def __exit__(self, *exc) -> None:
        if self.on:
            import torch

            torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self._t0
        if self.on:
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self.summary = summarize(self._prof.events())

    def busy_s(self):
        return self.summary.get("busy_s")


def summarize(events) -> dict:
    """busy_s, the device span and seconds by device op, and the idle
    gaps between device work, each named by the bench range around it."""
    dev, ranges = [], []
    for ev in events:
        kind = str(getattr(ev, "device_type", ""))
        start, end = ev.time_range.start, ev.time_range.end
        if ev.name.startswith("bench."):
            # the harness's ranges; on the device side they are the
            # profiler's annotations of the range, not device work
            if not kind.endswith("CUDA"):
                ranges.append((start, end, ev.name))
        elif kind.endswith("CUDA"):
            dev.append((start, end, ev.name))
    dev.sort()
    ranges.sort()
    by_name: dict = {}
    merged: list = []
    for start, end, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e6
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    busy_us = sum(e - s for s, e in merged)
    gaps = []
    starts = [r[0] for r in ranges]
    if ranges:
        first, last = ranges[0][0], max(e for _s, e, _n in ranges)
        edges = [first] + [x for pair in merged for x in pair] + [last]
        for s, e in zip(edges[0::2], edges[1::2]):
            if e > s:
                gaps.append((e - s, _range_at(ranges, starts, (s + e) / 2)))
    gaps.sort(reverse=True)
    return {"busy_s": busy_us / 1e6,
            "device_s_by_name": by_name,
            "device_ops": sorted(([n, s] for n, s in by_name.items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": [[name, us / 1e6] for us, name in gaps[:10]],
            "device_spans": len(dev)}


def _range_at(ranges: list, starts: list, t: float) -> str:
    """The bench range the host was in at `t` (the calls never overlap)."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and ranges[i][1] >= t:
        return ranges[i][2]
    return "between calls"
