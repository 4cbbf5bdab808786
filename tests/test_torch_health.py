"""The port's flight recorder and health watchdog (utils/timeseries,
utils/health, meta/cluster_health) against the JAX package's, exact.

The cases of tests/test_health.py that need neither SimCluster nor the
shell: each runs on both packages with the same series and must give
equal rings, events and journals, and the port's must pass the JAX
case's own checks. Both packages' span rings, fail points, capture pins,
profilers and the flags the cases set are put back after every test.
"""

import dataclasses

import pytest

from pegasus_tpu.meta import cluster_health as jch
from pegasus_tpu.utils import health as jhealth
from pegasus_tpu.utils import timeseries as jts
from pegasus_tpu.utils import tracing as jtracing
from pegasus_tpu.utils.fail_point import FAIL_POINTS as JFAIL
from pegasus_tpu.utils.flags import FLAGS as JFLAGS
from pegasus_tpu.utils.metrics import MetricRegistry as JRegistry
from pegasus_tpu.utils.profiler import PROFILER as JPROFILER
from pegasus_tpu_torch.meta import cluster_health as tch
from pegasus_tpu_torch.utils import health as thealth
from pegasus_tpu_torch.utils import timeseries as tts
from pegasus_tpu_torch.utils import tracing as ttracing
from pegasus_tpu_torch.utils.fail_point import FAIL_POINTS as TFAIL
from pegasus_tpu_torch.utils.flags import FLAGS as TFLAGS
from pegasus_tpu_torch.utils.metrics import MetricRegistry as TRegistry
from pegasus_tpu_torch.utils.profiler import PROFILER as TPROFILER


@dataclasses.dataclass
class Pkg:
    name: str
    health: object
    ts: object
    cluster_health: object
    tracing: object
    FAIL_POINTS: object
    FLAGS: object
    Registry: type
    PROFILER: object


JAX = Pkg("jax", jhealth, jts, jch, jtracing, JFAIL, JFLAGS, JRegistry,
          JPROFILER)
PORT = Pkg("port", thealth, tts, tch, ttracing, TFAIL, TFLAGS, TRegistry,
           TPROFILER)

_FLAGS = [("pegasus.tracing", "sample_ratio"),
          ("pegasus.health", "recorder_enabled"),
          ("pegasus.health", "recorder_interval_s"),
          ("pegasus.health", "recorder_window_s"),
          ("pegasus.health", "recorder_byte_cap")]


@pytest.fixture(autouse=True)
def _isolation():
    """As tests/test_health.py's fixture, in both packages; the flags
    are put back to what they were."""
    saved = [[p.FLAGS.get(s, k) for s, k in _FLAGS] for p in (JAX, PORT)]
    for p in (JAX, PORT):
        p.tracing.reset()
        p.tracing.seed(7)
        p.FLAGS.set("pegasus.tracing", "sample_ratio", 0.0)
        p.FLAGS.set("pegasus.health", "recorder_enabled", True)
    yield
    for p, values in zip((JAX, PORT), saved):
        p.FAIL_POINTS.teardown()
        p.health.reset_capture()
        p.PROFILER.disable()
        p.PROFILER.clear()
        for (s, k), v in zip(_FLAGS, values):
            p.FLAGS.set(s, k, v)
        p.tracing.reset()


def both(case):
    """Run `case(pkg)` on the JAX package, then the port; what each
    returns must be equal."""
    out = [case(p) for p in (JAX, PORT)]
    assert out[0] == out[1]
    return out[1]


def rings(rec) -> list:
    return sorted((key, ring.kind, [tuple(pt) for pt in ring.points])
                  for key, ring in rec._series.items())


def events(evs) -> list:
    return [ev.to_dict() for ev in evs]


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _recorder(p, reg, clock):
    return p.ts.FlightRecorder("n0", clock=clock, registry=reg)


# ---- recorder ---------------------------------------------------------------


def test_recorder_counters_become_rates_gauges_sampled():
    def case(p):
        reg = p.Registry()
        clock = _Clock()
        ent = reg.entity("rpc", "n0")
        c = ent.counter("read_shed_count")
        g = ent.gauge("queue_depth")
        lat = ent.percentile("lat_ms")
        rec = _recorder(p, reg, clock)
        c.increment(10)
        g.set(3.0)
        for v in range(100):
            lat.set(float(v))
        rec.tick()  # first sight: cursors only, no rate points yet
        assert rec.series("rpc", "n0", "read_shed_count") is None
        clock.t += 10.0
        c.increment(50)
        rec.tick()
        ring = rec.series("rpc", "n0", "read_shed_count")
        assert ring.kind == "rate"
        assert ring.latest()[1] == pytest.approx(5.0)  # 50 over 10 s
        assert rec.series("rpc", "n0", "queue_depth").latest()[1] == 3.0
        p50 = rec.series("rpc", "n0", "lat_ms.p50")
        assert p50 is not None and p50.kind == "value"
        # volatile counters drain through the per-reader cursor
        v = ent.volatile_counter("qps")
        v.increment(30)
        clock.t += 10.0
        rec.tick()
        assert rec.series("rpc", "n0", "qps").latest()[1] == \
            pytest.approx(3.0)
        assert v.delta_since("other_reader") == 30
        return rings(rec)

    both(case)


def test_recorder_coalesces_below_interval_and_respects_master_switch():
    def case(p):
        reg = p.Registry()
        clock = _Clock()
        reg.entity("rpc", "n0").gauge("g").set(1.0)
        rec = _recorder(p, reg, clock)
        ticks = [rec.tick()]
        assert ticks[-1] is not None
        clock.t += 1.0  # below the cadence: coalesced
        ticks.append(rec.tick())
        assert ticks[-1] is None
        clock.t += 10.0
        p.FLAGS.set("pegasus.health", "recorder_enabled", False)
        ticks.append(rec.tick())
        assert ticks[-1] is None
        p.FLAGS.set("pegasus.health", "recorder_enabled", True)
        ticks.append(rec.tick())
        assert ticks[-1] is not None
        return ticks, rings(rec)

    both(case)


def test_recorder_window_trim_and_byte_cap():
    def case(p):
        reg = p.Registry()
        clock = _Clock()
        g = reg.entity("rpc", "n0").gauge("g")
        rec = _recorder(p, reg, clock)
        p.FLAGS.set("pegasus.health", "recorder_window_s", 100.0)
        for i in range(30):
            g.set(float(i + 1))
            rec.tick(force=True)
            clock.t += 10.0
        ring = rec.series("rpc", "n0", "g")
        assert len(ring.points) <= 11
        assert ring.points[0][0] >= clock.t - 110.0
        trimmed = rings(rec)
        # hard byte cap: overflow evicts oldest points, never grows
        p.FLAGS.set("pegasus.health", "recorder_window_s", 1e9)
        p.FLAGS.set("pegasus.health", "recorder_byte_cap", 600)
        for i in range(200):
            g.set(float(i))
            rec.tick(force=True)
            clock.t += 10.0
        assert rec.nbytes() <= 600 + 200
        assert rec.evicted_points > 0
        return trimmed, rings(rec), rec.nbytes(), rec.evicted_points

    both(case)


def test_recorder_ownership_predicate():
    def case(p):
        reg = p.Registry()
        reg.entity("rpc", "n0").gauge("g").set(1.0)
        reg.entity("rpc", "n1").gauge("g").set(2.0)
        rec = p.ts.FlightRecorder("n0", clock=_Clock(), registry=reg,
                                  owns=lambda e: e.entity_id == "n0")
        rec.tick()
        assert rec.series("rpc", "n0", "g") is not None
        assert rec.series("rpc", "n1", "g") is None
        return rings(rec)

    both(case)


# ---- rules engine -----------------------------------------------------------


def _engine_with_series(p, rule, points, clock, kind="rate"):
    """Engine over a hand-built ring (no registry round trip)."""
    reg = p.Registry()
    rec = p.ts.FlightRecorder("n0", clock=clock, registry=reg)
    ring = p.ts.SeriesRing(kind)
    for ts, v in points:
        ring.append(ts, v)
        rec._total_points += 1
    rec._series[(rule.entity_type, "n0", rule.metric)] = ring
    eng = p.health.HealthEngine("n0", rec, rules=[rule], clock=clock)
    return eng, ring


def test_threshold_rule_fires_and_clears_with_hysteresis():
    def case(p):
        clock = _Clock()
        rule = p.health.HealthRule("hot", "rpc", "m", kind="threshold",
                                   threshold=5.0, clear_hold=2)
        eng, ring = _engine_with_series(p, rule, [(999.0, 9.0)], clock)
        out = [events(eng.evaluate())]
        assert len(out[0]) == 1 and out[0][0]["firing"]
        assert out[0][0]["severity"] == "degraded" and out[0][0]["evidence"]
        assert eng.status()["status"] == "degraded"
        ring.append(1001.0, 0.0)
        out.append(events(eng.evaluate()))
        assert out[-1] == []  # one calm evaluation does not clear
        ring.append(1002.0, 0.0)
        out.append(events(eng.evaluate()))
        assert len(out[-1]) == 1 and not out[-1][0]["firing"]
        assert eng.status()["status"] == "ok"
        assert [d["firing"] for d in eng.journal] == [True, False]
        return out, list(eng.journal), eng.status()

    both(case)


def test_burn_rate_needs_sustained_violation_not_one_blip():
    def case(p):
        clock = _Clock()
        rule = p.health.HealthRule("burn", "rpc", "m", kind="burn_rate",
                                   threshold=1.0, window_s=30.0,
                                   min_points=2)
        eng, ring = _engine_with_series(
            p, rule, [(980.0, 50.0), (990.0, 0.0)], clock)
        out = [events(eng.evaluate())]
        assert out[-1] == []
        ring.append(992.0, 30.0)
        out.append(events(eng.evaluate()))
        assert out[-1] == []
        ring.append(995.0, 4.0)
        ring.append(999.0, 4.0)
        out.append(events(eng.evaluate()))
        assert len(out[-1]) == 1 and out[-1][0]["firing"]
        return out, list(eng.journal)

    both(case)


def test_zscore_rule_detects_spike_over_history():
    def case(p):
        clock = _Clock()
        pts = [(900.0 + i * 10, 10.0 + (i % 2)) for i in range(9)]
        pts.append((995.0, 60.0))  # the spike
        rule = p.health.HealthRule("spike", "rpc", "m", kind="zscore",
                                   threshold=4.0, window_s=120.0,
                                   min_points=5)
        eng, _ring = _engine_with_series(p, rule, pts, clock)
        out = events(eng.evaluate())
        assert len(out) == 1 and out[0]["firing"]
        assert "σ" in out[0]["reason"]
        return out, list(eng.journal)

    both(case)


def test_hold_delays_firing_until_consecutive_violations():
    def case(p):
        clock = _Clock()
        rule = p.health.HealthRule("flappy", "rpc", "m", kind="threshold",
                                   threshold=1.0, hold=3)
        eng, _ring = _engine_with_series(p, rule, [(999.0, 5.0)], clock)
        out = [events(eng.evaluate()) for _ in range(3)]
        assert out[0] == [] and out[1] == []
        assert len(out[2]) == 1 and out[2][0]["firing"]
        return out, list(eng.journal)

    both(case)


def test_firing_pins_capture_and_clear_restores_it():
    def case(p):
        clock = _Clock()
        p.FLAGS.set("pegasus.tracing", "sample_ratio", 0.01)
        rule = p.health.HealthRule("hot", "rpc", "m", kind="threshold",
                                   threshold=1.0, clear_hold=1)
        eng, ring = _engine_with_series(p, rule, [(999.0, 9.0)], clock)
        assert not p.PROFILER.enabled
        fired = events(eng.evaluate())
        pinned = p.FLAGS.get("pegasus.tracing", "sample_ratio")
        assert pinned == p.FLAGS.get("pegasus.health", "pin_sample_ratio")
        assert p.PROFILER.enabled
        ring.append(1001.0, 0.0)
        cleared = events(eng.evaluate())
        assert cleared and not cleared[0]["firing"]
        assert p.FLAGS.get("pegasus.tracing", "sample_ratio") == 0.01
        assert not p.PROFILER.enabled
        return fired, pinned, cleared, list(eng.journal)

    both(case)


def test_unpin_preserves_operator_ratio_change():
    def case(p):
        clock = _Clock()
        rule = p.health.HealthRule("hot", "rpc", "m", kind="threshold",
                                   threshold=1.0, clear_hold=1)
        eng, ring = _engine_with_series(p, rule, [(999.0, 9.0)], clock)
        eng.evaluate()  # fires -> pinned to pin_sample_ratio
        p.FLAGS.set("pegasus.tracing", "sample_ratio", 0.9)  # operator
        ring.append(1001.0, 0.0)
        evs = events(eng.evaluate())  # clears -> unpin
        assert evs and not evs[0]["firing"]
        assert p.FLAGS.get("pegasus.tracing", "sample_ratio") == 0.9
        return evs, list(eng.journal)

    both(case)


def test_cluster_health_stale_node_stops_asserting_tables():
    def case(p):
        class _Meta:
            t = 0.0

            def clock(self):
                return self.t

        meta = _Meta()
        ch = p.cluster_health.ClusterHealth(meta)
        ch.on_report("n0", {"health": {
            "status": "critical",
            "firing": [{"rule": "replica_quarantine",
                        "entity": ["replica", "3.1"],
                        "metric": "replica_quarantine_count",
                        "severity": "critical", "since": 0.0}],
            "events": []}})
        live = ch.status()
        assert live["tables"]["3"]["status"] == "critical"
        assert live["cluster"] == "critical"
        meta.t = p.cluster_health.STALE_S + 1.0
        stale = ch.status()
        assert stale["nodes"]["n0"]["status"] == "stale"
        assert "3" not in stale["tables"]
        assert stale["cluster"] == "ok"
        return live, stale

    both(case)


def test_engine_close_releases_outstanding_pins():
    def case(p):
        clock = _Clock()
        base = p.FLAGS.get("pegasus.tracing", "sample_ratio")
        rule = p.health.HealthRule("hot", "rpc", "m", kind="threshold",
                                   threshold=1.0)
        eng, _ring = _engine_with_series(p, rule, [(999.0, 9.0)], clock)
        evs = events(eng.evaluate())
        assert p.FLAGS.get("pegasus.tracing", "sample_ratio") != base
        eng.close()
        assert p.FLAGS.get("pegasus.tracing", "sample_ratio") == base
        return evs, list(eng.journal)

    both(case)


def test_drain_report_is_bounded_and_counts_drops():
    def case(p):
        clock = _Clock()
        cap = p.FLAGS.get("pegasus.health", "report_max_events")
        rule = p.health.HealthRule("hot", "rpc", "m", kind="threshold",
                                   threshold=1.0, clear_hold=1)
        eng, ring = _engine_with_series(p, rule, [(999.0, 9.0)], clock)
        for i in range(cap + 10):
            ring.append(1000.0 + i, 9.0 if i % 2 == 0 else 0.0)
            eng.evaluate()
        rep = eng.drain_report()
        assert len(rep["events"]) == cap
        assert rep["dropped"] > 0
        assert rep["events_total"] == len(eng.journal)
        rep2 = eng.drain_report()
        assert [e["seq"] for e in rep2["events"]] == \
            [e["seq"] for e in rep["events"]]
        eng.ack_report(max(e["seq"] for e in rep2["events"]))
        rep3 = eng.drain_report()
        assert rep3["events"] == []
        return rep, rep2, rep3, list(eng.journal)

    both(case)


def test_meta_journal_dedupes_reshipped_events():
    def case(p):
        class _Meta:
            t = 0.0

            def clock(self):
                return self.t

        ch = p.cluster_health.ClusterHealth(_Meta())
        block = {"health": {"status": "degraded", "firing": [], "events": [
            {"rule": "r", "entity": ["rpc", "n0"], "metric": "m",
             "severity": "degraded", "firing": True, "ts": 1.0,
             "reason": "x", "evidence": [], "seq": 1},
            {"rule": "r", "entity": ["rpc", "n0"], "metric": "m",
             "severity": "degraded", "firing": False, "ts": 2.0,
             "reason": "y", "evidence": [], "seq": 2}]}}
        block["health"]["seq_hw"] = 2
        acks = [ch.on_report("n0", block), ch.on_report("n0", block)]
        assert acks == [2, 2]
        assert len(ch.journal) == 2
        restarted = {"health": {"status": "degraded", "firing": [],
                                "seq_hw": 1, "events": [
            {"rule": "r2", "entity": ["rpc", "n0"], "metric": "m",
             "severity": "degraded", "firing": True, "ts": 9.0,
             "reason": "z", "evidence": [], "seq": 1}]}}
        acks.append(ch.on_report("n0", restarted))
        assert acks[-1] == 1
        assert len(ch.journal) == 3
        return acks, list(ch.journal), ch.status()

    both(case)


def test_parse_window_and_render_smoke():
    def case(p):
        windows = [p.health.parse_window(w) for w in ("90s", "5m", "2h",
                                                     "42")]
        assert windows == [90.0, 300.0, 7200.0, 42.0]
        text = p.health.render_timeline({
            "target": "node0", "window": [0.0, 60.0],
            "status": "degraded",
            "events": [{"ts": 30.0, "firing": True,
                        "severity": "degraded", "rule": "r",
                        "entity": ["rpc", "node0"], "metric": "m",
                        "reason": "m=2 > 1"}],
            "series": [{"entity": "rpc", "id": "node0", "metric": "m",
                        "kind": "rate",
                        "points": [[10.0, 0.0], [30.0, 2.0], [50.0, 1.0]]}],
            "traces": [{"trace": "ab", "name": "client_read",
                        "node": "node0", "total_ms": 42.0}]})
        assert "FIRING" in text and "client_read" in text and "|" in text
        return windows, text

    both(case)


def test_default_rules_match_jax():
    """The node's rule set: the same names, entities, metrics, kinds and
    thresholds."""
    both(lambda p: [dataclasses.asdict(r) for r in p.health.default_rules()])
