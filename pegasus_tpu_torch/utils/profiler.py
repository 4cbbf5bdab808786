"""Per-task-code profiler toollet.

Parity: the rDSN profiler toollet (src/runtime/profiler.cpp:90-198) —
per-task-code counters installed on the task engine's join points:
queue delay (enqueue -> dispatch), execute latency, throughput. Here
the task codes are the cluster's message types and the join points are
the transports' dispatch seams (rpc/transport.py dispatcher thread,
runtime/sim.py delivery), which every RPC/timer-driven task crosses.

Like the reference's toollet it is a cross-cutting OPT-IN pack: off by
default (zero overhead beyond one branch per dispatch), switched on per
node via the `task-profiler` remote command (shell: remote_command
<node> task-profiler enable|disable|clear|dump).

Stages split a handler's exec wall: `PROFILER.stage("pegasus.<layer>.
<step>")` around a step of the scan path observes its wall under the
stage's name as one more code (queue 0), so the dump rows and anything
reading `observe` see the stages beside the message types. While a
torch.profiler recording runs, a stage also opens a host range of the
same name on the trace's timeline, beside the kernels and copies. The
range has the scope of an operator, not of a user annotation: a user
annotation (`record_function`) also leaves a device-side event spanning
the work launched inside it, which a reader of device time would count
as device work.

The port's copy of the JAX package's utils/profiler.py, its imports rewritten to
pegasus_tpu_torch (it imports nothing of that package); the stages are
the port's own.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from typing import Dict, List

from pegasus_tpu_torch.utils.metrics import Percentile


class _CodeStats:
    __slots__ = ("count", "queue_ms", "exec_ms", "started")

    def __init__(self) -> None:
        self.count = 0
        self.queue_ms = Percentile(window=1024)
        self.exec_ms = Percentile(window=1024)
        self.started = time.monotonic()


# the stage of a disabled profiler, shared: it does nothing
_NO_STAGE = contextlib.nullcontext()


def _torch_profiling() -> bool:
    """Whether a torch.profiler recording is running in this process
    (none can be where torch was never imported)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch._C._autograd._profiler_enabled()


class _Stage:
    """One timed step: perf_counter around it, observed under its name
    at exit; a host range of the trace while torch.profiler records.

    The range and the check for a recording use private torch APIs,
    `torch._C._profiler._RecordFunctionFast` and
    `torch._C._autograd._profiler_enabled` (torch 2.x); both are reached
    only while the profiler is on."""

    __slots__ = ("profiler", "name", "t0", "rf")

    def __init__(self, profiler: "TaskProfiler", name: str) -> None:
        self.profiler = profiler
        self.name = name

    def __enter__(self):
        self.rf = None
        if _torch_profiling():
            from torch._C._profiler import _RecordFunctionFast

            self.rf = _RecordFunctionFast(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return None

    def __exit__(self, *exc) -> bool:
        exec_ms = (time.perf_counter() - self.t0) * 1000.0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        # looked up on the instance: a wrapper installed there sees it
        self.profiler.observe(self.name, 0.0, exec_ms)
        return False


class TaskProfiler:
    """Process-wide per-code stats; one instance per process (the
    reference's profiler state is likewise per-node)."""

    def __init__(self) -> None:
        self.enabled = False
        self._stats: Dict[str, _CodeStats] = {}
        self._lock = threading.Lock()

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._stats.clear()

    def observe(self, code: str, queue_ms: float, exec_ms: float) -> None:
        with self._lock:
            st = self._stats.get(code)
            if st is None:
                st = self._stats[code] = _CodeStats()
            st.count += 1  # non-atomic RMW: many dispatchers, one lock
        st.queue_ms.set(queue_ms)
        st.exec_ms.set(exec_ms)

    def stage(self, name: str):
        """A context manager timing one step of a handler under `name`
        (`pegasus.<layer>.<step>`). Disabled: one attribute check and a
        shared no-op context, no clock read."""
        if not self.enabled:
            return _NO_STAGE
        return _Stage(self, name)

    def dump(self) -> List[dict]:
        """Per-code profile rows, busiest first (the reference's
        profiler data surface: THROUGHPUT + QUEUE + EXEC latencies per
        task code)."""
        now = time.monotonic()
        out = []
        with self._lock:
            items = list(self._stats.items())
        for code, st in items:
            window = max(now - st.started, 1e-9)
            q50, q99 = st.queue_ms.quantiles((50, 99))
            e50, e99 = st.exec_ms.quantiles((50, 99))
            out.append({
                "code": code,
                "count": st.count,
                "qps": round(st.count / window, 1),
                "queue_ms_p50": round(q50, 3),
                "queue_ms_p99": round(q99, 3),
                "exec_ms_p50": round(e50, 3),
                "exec_ms_p99": round(e99, 3),
            })
        return sorted(out, key=lambda d: -d["count"])

    def publish(self, registry=None) -> int:
        """Mirror the per-code profile onto the metrics spine: one
        "task" entity per code with count / qps / queue-p99 / exec-p99,
        so enabled-profiler stats appear in Prometheus exposition and
        the flight recorder's rings instead of living only behind the
        text `remote_command ... dump`. Idempotent per call; returns
        the number of codes published."""
        if registry is None:
            from pegasus_tpu_torch.utils.metrics import METRICS as registry
        rows = self.dump()
        for row in rows:
            ent = registry.entity("task", row["code"],
                                  {"code": row["code"]})
            c = ent.counter("task_dispatch_count")
            delta = row["count"] - c.value()
            if delta > 0:
                c.increment(delta)
            ent.gauge("task_qps").set(row["qps"])
            ent.gauge("task_queue_ms_p50").set(row["queue_ms_p50"])
            ent.gauge("task_queue_ms_p99").set(row["queue_ms_p99"])
            ent.gauge("task_exec_ms_p50").set(row["exec_ms_p50"])
            ent.gauge("task_exec_ms_p99").set(row["exec_ms_p99"])
        return len(rows)

    def control(self, args: List[str]):
        """The `task-profiler` command verb body."""
        verb = args[0] if args else "dump"
        if verb == "enable":
            self.enable()
            return "task profiler enabled"
        if verb == "disable":
            self.disable()
            return "task profiler disabled"
        if verb == "clear":
            self.clear()
            return "task profiler cleared"
        self.publish()  # a dump is also a publish: scrapes see it too
        return self.dump()


PROFILER = TaskProfiler()
