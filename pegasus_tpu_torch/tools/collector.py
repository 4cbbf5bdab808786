"""Info collector: cluster-wide stat aggregation + availability probing.

Parity: src/server/info_collector.h:48 (per-table stat aggregation
written back into a `stat` table via result_writer) and
src/server/available_detector.h:49 / collector/avail/detector.go (a
periodic set/get probe on a detect table producing an availability
percentage). The Go collector's metric scraping maps to the nodes'
remote "metrics" command (the /metrics JSON surface).

Runs over any deployment exposing the remote-command message and a
client factory: the in-process SimCluster (tests) or the multi-process
onebox (point it at the cluster dir).
"""

from __future__ import annotations

import itertools
import json
import time
from typing import Any, Callable, Dict, List, Optional

_RIDS = itertools.count(9_000_000)

STAT_TABLE = "stat"
DETECT_TABLE = "detect"


class InfoCollector:
    """`nodes`: replica node names; `send`/pump come from the transport;
    `client_factory(table_name)` returns a data client."""

    def __init__(self, net, name: str, nodes: List[str],
                 client_factory: Callable[[str], Any],
                 pump: Callable[[], None]) -> None:
        self.net = net
        self.name = name
        self.nodes = list(nodes)
        self.client_factory = client_factory
        self._pump = pump
        self._replies: Dict[int, dict] = {}
        self._stat_client = None
        self._detect_client = None
        # availability accounting (parity: available_detector partition
        # probe counters)
        self.probe_total = 0
        self.probe_failed = 0
        net.register(name, self._on_message)

    def _on_message(self, src: str, msg_type: str, payload) -> None:
        if msg_type == "remote_command_reply":
            self._replies[payload["rid"]] = payload

    def _command(self, node: str, verb: str,
                 args: Optional[list] = None,
                 rounds: int = 100) -> Optional[Any]:
        rid = next(_RIDS)
        self.net.send(self.name, node, "remote_command",
                      {"rid": rid, "cmd": verb, "args": args or []})
        for _ in range(rounds):
            if rid in self._replies:
                reply = self._replies.pop(rid)
                return reply["result"] if reply["err"] == 0 else None
            self._pump()
        return None

    # ---- stat aggregation (parity: info_collector.h:206-212) -----------

    def collect_round(self) -> Dict[str, dict]:
        """Scrape every node's replica metrics, aggregate per table
        (CU counters + read/write latency p50/p99 off the node
        percentile snapshots), and write one row per table into the
        stat table; node tail-kept slow-trace counts land in a
        `_traces` row so soak/scale runs can assert on them."""
        per_table: Dict[str, dict] = {}
        for node in self.nodes:
            snapshot = self._command(node, "metrics", ["replica"])
            if not snapshot:
                continue
            for entity in snapshot:
                table = entity.get("attributes", {}).get("table")
                if table is None:
                    continue
                agg = per_table.setdefault(table, {
                    "partitions": 0, "read_cu": 0, "write_cu": 0,
                    "abnormal_reads": 0,
                    "read_p50_ms": 0.0, "read_p99_ms": 0.0,
                    "write_p50_ms": 0.0, "write_p99_ms": 0.0,
                    "index_bloom_bytes": 0, "index_phash_bytes": 0})
                agg["partitions"] += 1
                metrics = entity.get("metrics", {})
                # resident index memory (round 15): per-partition
                # bloom-vs-phash gauge split summed per table — the
                # thousands-of-partitions elasticity scenario's
                # memory signal
                for key in ("index_bloom_bytes", "index_phash_bytes"):
                    agg[key] += int(
                        metrics.get(key, {}).get("value", 0))
                agg["read_cu"] += int(
                    metrics.get("recent_read_cu", {}).get("value", 0))
                agg["write_cu"] += int(
                    metrics.get("recent_write_cu", {}).get("value", 0))
                agg["abnormal_reads"] += int(
                    metrics.get("abnormal_read_count", {})
                    .get("value", 0))
                # per-table latency: the WORST partition's percentile
                # (percentiles over partitions cannot merge exactly;
                # max is the honest aggregate for an SLO check)
                for key, metric in (("read_p50_ms", "read_latency_ms"),
                                    ("write_p50_ms",
                                     "write_latency_ms")):
                    snap = metrics.get(metric)
                    if not snap:
                        continue
                    agg[key] = max(agg[key], snap.get("p50", 0.0))
                    p99_key = key.replace("p50", "p99")
                    agg[p99_key] = max(agg[p99_key],
                                       snap.get("p99", 0.0))
        node_traces = self.collect_traces()
        dup_rows = self.collect_dups()
        storage_rows = self.collect_storage()
        health_rows = self.collect_health()
        alert_rows = self.collect_alerts()
        workload_rows = self.collect_workload()
        tenant_rows = self.collect_tenants()
        if per_table:
            if self._stat_client is None:
                self._stat_client = self.client_factory(STAT_TABLE)
            ts = b"%d" % int(time.time())
            for table, agg in per_table.items():
                self._stat_client.set(
                    table.encode(), ts, json.dumps(agg).encode())
            if node_traces:
                self._stat_client.set(b"_traces", ts,
                                      json.dumps(node_traces).encode())
            if dup_rows:
                self._stat_client.set(b"_dups", ts,
                                      json.dumps(dup_rows).encode())
            if storage_rows:
                self._stat_client.set(b"_storage", ts,
                                      json.dumps(storage_rows).encode())
            if health_rows:
                self._stat_client.set(b"_health", ts,
                                      json.dumps(health_rows).encode())
            if alert_rows:
                self._stat_client.set(b"_alerts", ts,
                                      json.dumps(alert_rows).encode())
            if workload_rows:
                self._stat_client.set(
                    b"_workload", ts,
                    json.dumps(workload_rows).encode())
            if tenant_rows:
                self._stat_client.set(
                    b"_tenants", ts,
                    json.dumps(tenant_rows).encode())
        return per_table

    def collect_tenants(self) -> Dict[str, dict]:
        """Per-tenant QoS rows off every node's `qos.tenants` verb,
        folded cluster-wide: counters sum, the burn ratio keeps the
        worst node's value, brownout is true if ANY node holds the
        gate — one `_tenants` stat row per round, so a soak can assert
        'the compliant tenant was never shed' from table history."""
        out: Dict[str, dict] = {}
        for node in self.nodes:
            snap = self._command(node, "qos.tenants")
            if not snap:
                continue
            for name, st in snap.items():
                agg = out.setdefault(name, {
                    "weight": st.get("weight"),
                    "cu_budget": st.get("cu_budget"),
                    "cu_total": 0, "cu_ratio": 0.0,
                    "shed": 0, "overbudget": 0, "browned": False})
                # in-process sims share ONE registry across stubs, so
                # identical snapshots repeat per node: max (not sum)
                # keeps the fold honest in both deployments for the
                # monotonic counters too
                agg["cu_total"] = max(agg["cu_total"],
                                      int(st.get("cu_total") or 0))
                agg["cu_ratio"] = max(agg["cu_ratio"],
                                      float(st.get("cu_ratio") or 0.0))
                agg["shed"] = max(agg["shed"], int(st.get("shed") or 0))
                agg["overbudget"] = max(agg["overbudget"],
                                        int(st.get("overbudget") or 0))
                agg["browned"] = (agg["browned"]
                                  or bool(st.get("browned")))
        return out

    def collect_workload(self) -> Dict[str, dict]:
        """Per-table workload shape rows off the nodes' `workload`
        metric entities (op mix rates ride the flight recorder; this
        is the cumulative roll-up), plus the node cost-model drift
        ratio — one `_workload` stat row per round, so a soak can
        assert shape assumptions from table history alone.

        Entities DEDUPE by id with per-metric max across nodes before
        folding: every replica of a partition carries the same
        `app.pidx` workload entity (secondaries tick write applies
        too, and in-process sims share one registry outright), so a
        naive per-node sum would multiply op counts by ~replica_count
        and report replicas as partitions — disagreeing with the
        primary-only `shell workload` meta fold by 3-8x."""
        # (table, entity_id) -> per-metric maxima
        per_part: Dict[tuple, dict] = {}
        drift = 0.0
        for node in self.nodes:
            snapshot = self._command(node, "metrics", ["workload"])
            if not snapshot:
                continue
            for entity in snapshot:
                metrics = entity.get("metrics", {})
                if entity.get("id") == "node":
                    drift = max(drift, float(
                        metrics.get("cost_model_drift_ratio",
                                    {}).get("value", 0.0)))
                    continue
                table = entity.get("attributes", {}).get("table")
                if table is None:
                    continue
                row = per_part.setdefault(
                    (table, entity.get("id")), {
                        "read_ops": 0, "scan_ops": 0, "write_ops": 0,
                        "read_batch_p99": 0.0, "write_batch_p99": 0.0,
                        "value_bytes_p99": 0.0,
                        "scan_selectivity_p50": 0.0, "hot_share": 0.0})
                for key, metric in (("read_ops", "workload_read_ops"),
                                    ("scan_ops", "workload_scan_ops"),
                                    ("write_ops",
                                     "workload_write_ops")):
                    row[key] = max(row[key], int(
                        metrics.get(metric, {}).get("value", 0)))
                for key, metric, pkey in (
                        ("read_batch_p99", "workload_read_batch",
                         "p99"),
                        ("write_batch_p99", "workload_write_batch",
                         "p99"),
                        ("value_bytes_p99", "workload_value_bytes",
                         "p99"),
                        ("scan_selectivity_p50",
                         "workload_scan_selectivity", "p50")):
                    snap = metrics.get(metric)
                    if snap:
                        row[key] = max(row[key],
                                       float(snap.get(pkey, 0.0)))
                row["hot_share"] = max(row["hot_share"], float(
                    metrics.get("workload_hot_share",
                                {}).get("value", 0.0)))
        # ONE fold rule: the per-table rollup is workload.fold_summaries
        # — the same function meta's `shell workload` uses — so the
        # `_workload` stat row and the shell can never disagree on how
        # partitions aggregate
        from pegasus_tpu_torch.server.workload import fold_summaries

        by_table: Dict[str, list] = {}
        for (table, _eid), row in sorted(per_part.items()):
            by_table.setdefault(table, []).append(row)
        tables: Dict[str, dict] = {
            table: fold_summaries(rows)
            for table, rows in by_table.items()}
        if not tables:
            return {}
        # uniformly-typed persisted shape: table rows under "tables",
        # the node drift scalar beside them (a sentinel key mixed into
        # the table dict made `for t, row in rows.items()` consumers
        # trip over a float)
        return {"tables": tables, "drift_ratio": drift}

    def collect_health(self) -> Dict[str, dict]:
        """Per-node watchdog verdict off the `health.status` verb:
        status, firing rules, and the flight recorder's ring-memory
        cost — one `_health` stat row per round, so soaks/SLO checks
        can assert 'nothing fired' from table history alone."""
        out: Dict[str, dict] = {}
        for node in self.nodes:
            st = self._command(node, "health.status")
            if not st:
                continue
            out[node] = {
                "status": st.get("status", "?"),
                "firing": [f.get("rule") for f in st.get("firing", [])],
                "events_total": st.get("events_total", 0),
                "ring_bytes": st.get("ring_bytes", 0),
            }
        return out

    def collect_alerts(self) -> Dict[str, list]:
        """Recent typed health events per node (the `health.events`
        journal) — the `_alerts` stat row: severity, rule, firing/
        cleared, reason, compacted to the essentials."""
        out: Dict[str, list] = {}
        for node in self.nodes:
            events = self._command(node, "health.events", ["16"])
            if not events:
                continue
            out[node] = [{
                "rule": ev.get("rule"), "severity": ev.get("severity"),
                "firing": ev.get("firing"), "ts": ev.get("ts"),
                "entity": ev.get("entity"), "reason": ev.get("reason"),
            } for ev in events]
        return out

    def collect_storage(self) -> Dict[str, dict]:
        """Per-node point-read index health off the `storage` metric
        entity: perfect-hash usefulness (probes that skipped every
        block touch), located hits, and build failures (runs stamped
        "no phash" — a perf event worth alerting on if it trends), next
        to the bloom twin — one `_storage` stat row per round."""
        wanted = ("phash_useful_count", "phash_hit_count",
                  "phash_build_fail_count", "bloom_useful_count")
        out: Dict[str, dict] = {}
        for node in self.nodes:
            snapshot = self._command(node, "metrics", ["storage"])
            if not snapshot:
                continue
            for entity in snapshot:
                metrics = entity.get("metrics", {})
                row = {k: int(metrics.get(k, {}).get("value", 0))
                       for k in wanted if k in metrics}
                if row:
                    out[node] = row
        return out

    def collect_dups(self) -> Dict[str, dict]:
        """Per-table duplication lag rows off every node's `dup.stats`
        verb: worst lag (decrees + ms) across the table's sessions,
        shipped/error/skip totals — the geo-replication health a soak
        or an operator SLO check reads in one row per app."""
        out: Dict[str, dict] = {}
        for node in self.nodes:
            stats = self._command(node, "dup.stats")
            if not stats:
                continue
            for sess in stats.get("sessions", ()):
                app_id = str(sess.get("gpid", [0, 0])[0])
                agg = out.setdefault(app_id, {
                    "sessions": 0, "max_lag_decrees": 0,
                    "max_lag_ms": 0.0, "shipped_bytes": 0,
                    "error_count": 0, "skip_count": 0})
                agg["sessions"] += 1
                agg["max_lag_decrees"] = max(
                    agg["max_lag_decrees"], sess.get("lag_decrees", 0))
                agg["max_lag_ms"] = max(agg["max_lag_ms"],
                                        sess.get("lag_ms", 0.0))
                agg["shipped_bytes"] += sess.get("shipped_bytes", 0)
                agg["error_count"] += sess.get("error_count", 0)
                agg["skip_count"] += sess.get("skip_count", 0)
        return out

    def collect_traces(self) -> Dict[str, int]:
        """Tail-kept slow-trace count per node (the tracing entity's
        kept_trace_count) — how many slow requests each node pinned."""
        out: Dict[str, int] = {}
        for node in self.nodes:
            snapshot = self._command(node, "metrics", ["tracing"])
            if not snapshot:
                continue
            for entity in snapshot:
                if entity.get("id") != node:
                    continue
                out[node] = int(entity.get("metrics", {}).get(
                    "kept_trace_count", {}).get("value", 0))
        return out

    def table_history(self, app_id_str: str) -> List[dict]:
        if self._stat_client is None:
            self._stat_client = self.client_factory(STAT_TABLE)
        err, kvs = self._stat_client.multi_get(app_id_str.encode())
        if err != 0:
            return []
        return [json.loads(v) for _k, v in sorted(kvs.items())]

    # ---- availability (parity: available_detector.h:49) ----------------

    def probe_round(self, probes: int = 4) -> float:
        """Write+read probes against the detect table; returns the
        availability fraction so far."""
        if self._detect_client is None:
            self._detect_client = self.client_factory(DETECT_TABLE)
        c = self._detect_client
        for i in range(probes):
            self.probe_total += 1
            key = b"probe_%d" % (self.probe_total % 64)
            value = b"%d" % self.probe_total
            try:
                if c.set(key, b"s", value) != 0:
                    self.probe_failed += 1
                    continue
                err, got = c.get(key, b"s")
                if err != 0 or got != value:
                    self.probe_failed += 1
            except Exception:  # noqa: BLE001 - a probe failure IS the data
                self.probe_failed += 1
        return self.availability()

    def availability(self) -> float:
        if self.probe_total == 0:
            return 1.0
        return 1.0 - self.probe_failed / self.probe_total
