"""Workload profiler: per-table shape stats + the cost-model drift gauge.

Two consumers motivated this layer (ROADMAP): scan pushdown needs
per-table SELECTIVITY (what fraction of evaluated rows survive the
masks — that is exactly what a server-side filter would save on the
wire), and the device-mesh item needs to know when the placement cost
model (ops/placement.py) is LYING (predicted vs measured kernel time).
Neither existed: the cluster knew where time went (traces) and when it
got sick (health rules), but not what the workload *looks like*.

Everything records onto ordinary metric entities, so the PR 12 flight
recorder rings the series for free and the PR 12 health engine can
rule on them:

- per-partition ``workload`` entity (id ``app.pidx``, table/partition
  attrs like the replica entity): op-mix counters (ring→rates), batch-
  size / value-size / scan-selectivity percentile windows, hot-hashkey
  share gauge fed by the existing HotkeyCollector.
- ONE process-wide ``("workload", "node")`` entity carrying
  ``cost_model_drift_ratio``: a warmup-discarding rolling MEDIAN of
  measured/predicted kernel time per workload class (stale classes
  age out), fed by the scan mask-evaluation sites. A
  default health rule fires when the ratio crosses threshold, so a
  mis-calibrated placement model raises a HealthEvent instead of
  silently mis-placing kernels. (Process-wide because the placement
  probe itself is per-process — the same known sim artifact as the
  node "storage" entity.)

Summaries ride config-sync to meta exactly like the CU/hotkey load
signals (stub.config_sync), surfacing as `shell workload <table>`, and
tools/collector.py folds the entities into a `_workload` stat row.

The port's copy of the JAX package's server/workload.py, its imports rewritten to
pegasus_tpu_torch (it imports nothing of that package).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from pegasus_tpu_torch.utils.fail_point import fail_point
from pegasus_tpu_torch.utils.metrics import METRICS

# predictions are estimates of STEADY-state kernel cost; the first few
# calls per workload class pay XLA compiles / lazy session setup that
# the model deliberately excludes, so they are discarded, not averaged
DRIFT_WARMUP = 3
# ratios fold through a short rolling MEDIAN, not a mean: one
# re-compile spike (a fresh batch shape) must not prop the gauge over
# the health threshold, while a genuinely mis-calibrated model shifts
# every sample and moves the median within half a window
DRIFT_WINDOW = 8
# a class with no kernel waves for this long stops contributing to the
# alerting gauge: a stale window must not pin `cost_model_drift` firing
# after traffic shifted away from the workload that drifted
DRIFT_STALE_S = 300.0


class CostModelDrift:
    """measured/predicted offload-time ratio per workload class.

    `note()` is called from the kernel dispatch sites with the
    cost-model prediction and the measured wall time; the fail point
    ``perf::kernel_time_scale`` scales the measured time (the planted
    mis-prediction the acceptance test drives across threshold). The
    published gauge is the WORST class's windowed median — one series
    for the health rule to watch.
    """

    def __init__(self) -> None:
        from collections import deque

        self._deque = deque
        self._lock = threading.Lock()
        # class -> {"window": deque[ratio], "n": int, "predicted_ms",
        #           "measured_ms"} (last sample, for reporting)
        self._classes: Dict[str, dict] = {}
        self._gauge = METRICS.entity("workload", "node").gauge(
            "cost_model_drift_ratio")

    @staticmethod
    def _median(window) -> float:
        s = sorted(window)
        return s[len(s) // 2]

    def note(self, workload: str, predicted_s: float,
             measured_s: float) -> None:
        import time as _time

        scale = fail_point("perf::kernel_time_scale")
        if scale is not None:
            measured_s *= float(scale)
        if predicted_s <= 0.0:
            return
        ratio = measured_s / predicted_s
        with self._lock:
            st = self._classes.setdefault(
                workload, {"window": self._deque(maxlen=DRIFT_WINDOW),
                           "n": 0, "predicted_ms": 0.0,
                           "measured_ms": 0.0, "at": 0.0})
            st["n"] += 1
            st["at"] = _time.monotonic()
            st["predicted_ms"] = predicted_s * 1000.0
            st["measured_ms"] = measured_s * 1000.0
            if st["n"] <= DRIFT_WARMUP:
                return  # compile/session warmup: not model error
            st["window"].append(ratio)
            self._publish(st["at"])

    def _publish(self, now: float) -> None:
        """caller holds self._lock: gauge = worst FRESH class."""
        fresh = [self._median(s["window"])
                 for s in self._classes.values()
                 if s["window"] and now - s["at"] <= DRIFT_STALE_S]
        self._gauge.set(round(max(fresh), 4) if fresh else 0.0)

    def refresh(self) -> None:
        """Periodic decay hook (the node health tick): a class whose
        kernel waves stopped ages out of the alerting gauge instead of
        pinning `cost_model_drift` at its last value forever."""
        import time as _time

        with self._lock:
            self._publish(_time.monotonic())

    def status(self) -> dict:
        with self._lock:
            return {
                "drift_ratio": self._gauge.value(),
                "classes": {
                    k: {"median": (round(self._median(s["window"]), 4)
                                   if s["window"] else None),
                        "samples": s["n"],
                        "last_predicted_ms": round(s["predicted_ms"], 3),
                        "last_measured_ms": round(s["measured_ms"], 3)}
                    for k, s in sorted(self._classes.items())},
            }

    def reset(self) -> None:
        """Test isolation."""
        with self._lock:
            self._classes.clear()
            self._gauge.set(0.0)


DRIFT = CostModelDrift()


# cheap sampling bound: percentile windows cost one lock round per
# set(); a 10k-op flush must not pay 10k value-size samples
_SAMPLE_CAP = 8


class WorkloadStats:
    """One partition's rolling shape stats. All writes are batched —
    at most one counter touch and a handful of percentile samples per
    served flush — so the profiler inherits the serving paths' own
    batching instead of adding per-row cost."""

    def __init__(self, app_id: int, pidx: int,
                 hotkey_collectors: Optional[dict] = None) -> None:
        self.app_id = app_id
        self.pidx = pidx
        self._hc = hotkey_collectors or {}
        ent = METRICS.entity(
            "workload", f"{app_id}.{pidx}",
            {"table": str(app_id), "partition": str(pidx)})
        self._read_ops = ent.counter("workload_read_ops")
        self._scan_ops = ent.counter("workload_scan_ops")
        self._write_ops = ent.counter("workload_write_ops")
        self._read_batch = ent.percentile("workload_read_batch")
        self._write_batch = ent.percentile("workload_write_batch")
        self._value_bytes = ent.percentile("workload_value_bytes")
        # percent of mask-evaluated rows that SURVIVED (scan pushdown's
        # win is exactly 100 minus this)
        self._selectivity = ent.percentile("workload_scan_selectivity")
        self._hot_share = ent.gauge("workload_hot_share")
        # pushdown scans (requests carrying a PushdownSpec the server
        # evaluated) vs plain scans: workload_scan_ops counts BOTH, this
        # counts the pushdown subset so `shell workload` can label the
        # mix. The pruned/aggregated counters are the metric twins of
        # the PerfContext fields of the same names (same kind, so
        # metrics_lint's conflict rule holds) — EXPLAIN reconciles a
        # pushdown scan's cost vector against these deltas
        self._pushdown_ops = ent.counter("workload_pushdown_ops")
        self._pushdown_pruned = ent.counter("pushdown_rows_pruned")
        self._rows_aggregated = ent.counter("rows_aggregated")

    # -- feed sites (serving paths) -------------------------------------

    def note_point(self, ops: int, keys: int,
                   value_sizes=()) -> None:
        self._read_ops.increment(ops)
        self._read_batch.set(float(keys))
        for v in value_sizes[:_SAMPLE_CAP]:
            self._value_bytes.set(float(v))

    def note_scan(self, reqs: int, rows_evaluated: int,
                  rows_survived: int) -> None:
        self._scan_ops.increment(reqs)
        if rows_evaluated > 0:
            self._selectivity.set(
                100.0 * rows_survived / rows_evaluated)

    def note_pushdown(self, reqs: int, rows_pruned: int,
                      rows_aggregated: int) -> None:
        """Pushdown leg of a scan flush (always paired with a
        note_scan for the same requests — pushdown scans ARE scans)."""
        self._pushdown_ops.increment(reqs)
        if rows_pruned > 0:
            self._pushdown_pruned.increment(rows_pruned)
        if rows_aggregated > 0:
            self._rows_aggregated.increment(rows_aggregated)

    def note_write(self, ops: int, rows: int, value_sizes=()) -> None:
        self._write_ops.increment(ops)
        self._write_batch.set(float(rows))
        for v in value_sizes[:_SAMPLE_CAP]:
            self._value_bytes.set(float(v))

    # -- read surfaces ---------------------------------------------------

    def _hot_hashkey_share(self) -> float:
        """Share (0..1) of fine-phase traffic owned by the detected-hot
        hashkey, from whichever HotkeyCollector finished a detection —
        0 when no detection has concluded."""
        best = 0.0
        for hc in self._hc.values():
            best = max(best, hc.hot_share())
        share = round(best, 4)
        self._hot_share.set(share)
        return share

    def summary(self) -> dict:
        """The compact digest riding config-sync (and the shell's
        --root fallback): op mix, batch/value/selectivity percentiles,
        hot-hashkey share."""
        rb = self._read_batch.quantiles((50.0, 99.0))
        wb = self._write_batch.quantiles((50.0, 99.0))
        vb = self._value_bytes.quantiles((50.0, 99.0))
        sel = self._selectivity.quantiles((50.0,))
        return {
            "read_ops": self._read_ops.value(),
            "scan_ops": self._scan_ops.value(),
            "pushdown_ops": self._pushdown_ops.value(),
            "write_ops": self._write_ops.value(),
            "read_batch_p50": rb[0], "read_batch_p99": rb[1],
            "write_batch_p50": wb[0], "write_batch_p99": wb[1],
            "value_bytes_p50": vb[0], "value_bytes_p99": vb[1],
            "scan_selectivity_p50": round(sel[0], 2),
            "hot_share": self._hot_hashkey_share(),
        }


def fold_summaries(rows) -> dict:
    """Roll per-partition summaries into one table row (meta's
    `workload` admin verb and the collector's `_workload` stat row
    share this): counters sum, percentiles take the worst partition
    (max — the honest aggregate, same rule the collector applies to
    latency percentiles), shares take the max."""
    out = {"partitions": 0, "read_ops": 0, "scan_ops": 0,
           "pushdown_ops": 0, "write_ops": 0, "read_batch_p99": 0.0,
           "write_batch_p99": 0.0, "value_bytes_p99": 0.0,
           "scan_selectivity_p50": 0.0, "hot_share": 0.0}
    for row in rows:
        out["partitions"] += 1
        for k in ("read_ops", "scan_ops", "pushdown_ops", "write_ops"):
            out[k] += int(row.get(k, 0))
        for k in ("read_batch_p99", "write_batch_p99",
                  "value_bytes_p99", "scan_selectivity_p50",
                  "hot_share"):
            out[k] = max(out[k], float(row.get(k, 0.0)))
    return out
