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

The port's copy of the JAX package's utils/profiler.py, its imports rewritten to
pegasus_tpu_torch (it imports nothing of that package).
"""

from __future__ import annotations

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
