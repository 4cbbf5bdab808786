"""The node's observability layer: the port against the JAX package,
exact except for wall-time fields.

The same ops run on identical stores in both packages, with both wall
clocks frozen (the `Clock` discipline of test_torch_client.py) and
both process-wide registries reset first (METRICS, the span rings,
DRIFT, TENANTS). Checked against the JAX package:

- every op's PerfContext, field for field, except the wall-time fields
  (`measured_kernel_ms`, `predicted_kernel_ms`, `queue_wait_ms`,
  `mesh_wave_ms`) and `placement` (the port names its own routes);
- the slow log at threshold 0 (set through `update_app_envs`): the same
  entries, names, stage chains and perf keys;
- the spans at `sample_ratio = 1` with a seeded sampler: names,
  annotations (the stage names) and perf tags;
- the capacity-unit counters after the same reads and writes;
- the hotkey detected in the same Zipf stream;
- the tenancy statuses after tenanted point reads;
- the explain report's counters;
- the Prometheus text of the ("storage", "node") entity, timings left
  out.
"""

import time

import numpy as np
import pytest

from pegasus_tpu.base import value_schema as jvs
from pegasus_tpu.server import explain as jexplain
from pegasus_tpu.server import read_coordinator as jrc
from pegasus_tpu.server import tenancy as jtenancy
from pegasus_tpu.server import types as jtypes
from pegasus_tpu.server import write_service as jws
from pegasus_tpu.server.hotkey import HotkeyCollector as JHotkey
from pegasus_tpu.server.partition_server import PartitionServer as JServer
from pegasus_tpu.server.workload import DRIFT as JDRIFT
from pegasus_tpu.utils import metrics as jmetrics
from pegasus_tpu.utils import tracing as jtracing
from pegasus_tpu.utils.flags import FLAGS as JFLAGS
from pegasus_tpu_torch.base import value_schema as tvs
from pegasus_tpu_torch.base.key_schema import generate_key
from pegasus_tpu_torch.server import explain as texplain
from pegasus_tpu_torch.server import read_coordinator as trc
from pegasus_tpu_torch.server import tenancy as ttenancy
from pegasus_tpu_torch.server import types as ttypes
from pegasus_tpu_torch.server import write_service as tws
from pegasus_tpu_torch.server.hotkey import HotkeyCollector as THotkey
from pegasus_tpu_torch.server.partition_server import PartitionServer
from pegasus_tpu_torch.server.workload import DRIFT as TDRIFT
from pegasus_tpu_torch.utils import metrics as tmetrics
from pegasus_tpu_torch.utils import tracing as ttracing
from pegasus_tpu_torch.utils.flags import FLAGS as TFLAGS

T0 = 1_790_000_000.25   # unix seconds the frozen clock starts at
HASHKEYS = [b"user%03d" % i for i in range(40)]
SORTKEYS = [b"f%02d" % i for i in range(10)]
# the PerfContext fields that hold wall time
WALL_FIELDS = ("measured_kernel_ms", "predicted_kernel_ms",
               "queue_wait_ms", "mesh_wave_ms")
FLAG_NAMES = (("pegasus.storage", "block_codec"),
              ("pegasus.server", "bloom_bits_per_key"),
              ("pegasus.server", "phash_index"),
              ("pegasus.perfctx", "enabled"),
              ("pegasus.tracing", "sample_ratio"),
              ("pegasus.tracing", "slow_trace_ms"))


class Clock:
    """Stands in for a module's `time`: `time()` is frozen at `t`."""

    def __init__(self, t: float) -> None:
        self.t = t

    def time(self) -> float:
        return self.t

    def __getattr__(self, name):
        return getattr(time, name)


def zero_metrics(registry) -> None:
    """Every metric of every entity back to zero (entities and the
    module-level metric objects that hold them stay)."""
    for ent in registry.entities():
        for m in list(ent._metrics.values()):
            if isinstance(m, jmetrics.Percentile) or isinstance(
                    m, tmetrics.Percentile):
                with m._lock:
                    m._samples = []
                    m._idx = 0
                    m._version += 1
            elif hasattr(m, "_cursors"):
                m._value = 0
                m._cursors.clear()
            else:
                m._value = 0


def set_flags(values) -> None:
    for section, name, value in values:
        for reg in (JFLAGS, TFLAGS):
            reg.set(section, name, value, force=True)


@pytest.fixture
def clock(monkeypatch):
    """Both packages' frozen clocks and fresh process-wide state; flags
    restored afterwards."""
    clk = Clock(T0)
    for mod in (jvs, tvs, jws, tws):
        monkeypatch.setattr(mod, "time", clk)
    saved = [[(s, n, reg.get(s, n)) for s, n in FLAG_NAMES]
             for reg in (JFLAGS, TFLAGS)]
    for reg in (jmetrics.METRICS, tmetrics.METRICS):
        zero_metrics(reg)
    for tr in (jtracing, ttracing):
        tr.reset()
        tr.seed(7)
    for drift in (JDRIFT, TDRIFT):
        drift.reset()
    for ten in (jtenancy.TENANTS, ttenancy.TENANTS):
        ten.reset()
    yield clk
    for reg, values in zip((JFLAGS, TFLAGS), saved):
        for section, name, value in values:
            reg.set(section, name, value, force=True)
    for tr in (jtracing, ttracing):
        tr.reset()
    for drift in (JDRIFT, TDRIFT):
        drift.reset()
    for ten in (jtenancy.TENANTS, ttenancy.TENANTS):
        ten.reset()


def build_pair(root, clock, app_id, codec="dcz2", sidecars=True):
    """(JAX server, port server) holding the same records: an L1 run,
    an L0 table and a memtable, TTLs that expire once the clock moves
    on, and a few tombstones."""
    set_flags((("pegasus.storage", "block_codec", codec),
               ("pegasus.server", "bloom_bits_per_key",
                10 if sidecars else 0),
               ("pegasus.server", "phash_index", sidecars)))
    pair = (JServer(str(root / "j"), app_id=app_id),
            PartitionServer(str(root / "t"), app_id=app_id, device="cpu"))
    rng = np.random.default_rng(app_id)
    for i, hk in enumerate(HASHKEYS):
        for j, sk in enumerate(SORTKEYS):
            ttl = 100 if (i * 10 + j) % 7 == 0 else 0
            val = b"v%d-" % (i * 10 + j) + b"x" * int(rng.integers(0, 40))
            for s in pair:
                s.on_put(generate_key(hk, sk), val, ttl)
    for s in pair:
        s.manual_compact()
    for i in range(60):
        hk = HASHKEYS[int(rng.integers(0, len(HASHKEYS)))]
        sk = SORTKEYS[int(rng.integers(0, len(SORTKEYS)))]
        for s in pair:
            s.on_put(generate_key(hk, sk + b"a"), b"l0-%d" % i, 0)
    for s in pair:
        s.flush()
    for i in range(20):
        hk = HASHKEYS[int(rng.integers(0, len(HASHKEYS)))]
        for s in pair:
            s.on_put(generate_key(hk, b"mem%02d" % i), b"m%d" % i, 0)
    for i in range(5):
        key = generate_key(HASHKEYS[i * 3], SORTKEYS[i])
        for s in pair:
            s.on_remove(key)
    clock.t += 200  # the TTL rows have expired
    return pair


def strip(pc: dict) -> dict:
    return {k: v for k, v in pc.items()
            if k not in WALL_FIELDS and k != "placement"}


def slow_entries(server) -> list:
    """The slow log as comparable values: name, stage names, the extra
    keys and the perf vector without wall-time fields."""
    out = []
    for e in server.slow_log.dump():
        out.append((e["name"], [st["stage"] for st in e.get("stages", ())],
                    sorted(k for k in e if k not in ("total_ms", "stages")),
                    strip(e["perf"]) if "perf" in e else None))
    return out


def point_ops(types, rng, n=40):
    ops = []
    for i in range(n):
        hk = HASHKEYS[int(rng.integers(0, len(HASHKEYS)))]
        sks = [SORTKEYS[int(x)] for x in rng.integers(0, len(SORTKEYS), 3)]
        kind = i % 4
        if kind == 0:
            ops.append(("get", generate_key(hk, sks[0]), None))
        elif kind == 1:
            ops.append(("ttl", generate_key(hk, sks[1]), None))
        elif kind == 2:
            ops.append(("multi_get", types.MultiGetRequest(
                hash_key=hk, sort_keys=sks), None))
        else:
            ops.append(("batch_get", types.BatchGetRequest(
                keys=[types.FullKey(hk, sk) for sk in sks]), None))
    return ops


def scan_req(types, hk, batch=7, one_page=False):
    return types.GetScannerRequest(
        start_key=generate_key(hk, b""),
        stop_key=generate_key(hk + b"\xff", b""), batch_size=batch,
        one_page=one_page)


def run_reads(pair, seed):
    """The same read mix on both servers: a batched point flush, solo
    gets and ttls, multi_gets by sort key and by range, a scan paged to
    its end, a batch of scans."""
    for srv, types in zip(pair, (jtypes, ttypes)):
        rng = np.random.default_rng(seed)
        srv.on_point_read_batch(point_ops(types, rng))
        for i in range(6):
            hk = HASHKEYS[int(rng.integers(0, len(HASHKEYS)))]
            srv.on_get(generate_key(hk, SORTKEYS[i]))
            srv.on_ttl(generate_key(hk, SORTKEYS[i + 1]))
        srv.on_multi_get(types.MultiGetRequest(
            hash_key=HASHKEYS[3], sort_keys=SORTKEYS[:5]))
        srv.on_multi_get(types.MultiGetRequest(hash_key=HASHKEYS[4]))
        resp = srv.on_get_scanner(scan_req(types, HASHKEYS[5]))
        while resp.context_id >= 0:
            resp = srv.on_scan(resp.context_id)
        srv.on_get_scanner_batch(
            [scan_req(types, HASHKEYS[i], one_page=True)
             for i in (6, 7, 8, 6)])


@pytest.mark.parametrize("codec,sidecars", [("none", False),
                                            ("dcz2", True)])
def test_perf_context_and_slow_log_match_jax(tmp_path, clock, codec,
                                             sidecars):
    pair = build_pair(tmp_path, clock, 9301, codec, sidecars)
    try:
        for s in pair:
            s.update_app_envs({"replica.slow_query_threshold_ms": "0"})
            s.slow_log.dump(clear=True)
        run_reads(pair, seed=1)
        jlog, tlog = (slow_entries(s) for s in pair)
        assert len(tlog) == len(jlog) > 10
        assert tlog == jlog
        # each batched flush's vector: its rows_evaluated equals the
        # rows the plan sent to masks
        names = [e[0] for e in tlog]
        assert "scan_batch.9301.0" in names
        assert "point_get_batch.9301.0" in names
    finally:
        for s in pair:
            s.close()


def test_spans_match_jax(tmp_path, clock):
    pair = build_pair(tmp_path, clock, 9303, "dcz2", True)
    set_flags((("pegasus.tracing", "sample_ratio", 1.0),
               ("pegasus.tracing", "slow_trace_ms", 1e9)))
    try:
        dumps = []
        for srv, tr, types in zip(pair, (jtracing, ttracing),
                                  (jtypes, ttypes)):
            tr.reset()
            tr.seed(11)
            ring = tr.ring_for("node-a")
            rng = np.random.default_rng(3)
            ops = [("point", point_ops(types, rng, 12)),
                   ("scan", [scan_req(types, HASHKEYS[i], one_page=True)
                             for i in (1, 2, 3)]),
                   ("get", generate_key(HASHKEYS[9], SORTKEYS[2]))]
            for name, args in ops:
                assert tr.maybe_sample()
                span = ring.start(f"rpc.{name}")
                with tr.activate(span):
                    if name == "point":
                        srv.on_point_read_batch(args)
                    elif name == "scan":
                        srv.on_get_scanner_batch(args)
                    else:
                        srv.on_get(args)
                span.finish()
            dumps.append([
                (d["name"], [a[0] for a in d["ann"]],
                 strip(d["tags"]["perf"]) if "perf" in d["tags"] else None)
                for d in ring.dump()])
        assert dumps[1] == dumps[0]
        stages = {a for _n, ann, _p in dumps[1] for a in ann}
        assert {"plan", "bloom", "phash_probe", "block_probe", "decode",
                "finish"} <= stages
        assert all(p is not None for _n, _a, p in dumps[1])
    finally:
        for s in pair:
            s.close()


def test_capacity_units_match_jax(tmp_path, clock):
    pair = build_pair(tmp_path, clock, 9304, "dcz2", True)
    try:
        run_reads(pair, seed=4)
        for srv, types in zip(pair, (jtypes, ttypes)):
            srv.on_multi_put(types.MultiPutRequest(
                hash_key=b"w", kvs=[types.KeyValue(b"a", b"1" * 5000),
                                    types.KeyValue(b"b", b"2")]))
            srv.on_incr(types.IncrRequest(key=generate_key(b"w", b"c"),
                                          increment=3))
            srv.on_multi_remove(types.MultiRemoveRequest(
                hash_key=b"w", sort_keys=[b"a"]))
        cus = [(s.cu.read_cu, s.cu.write_cu) for s in pair]
        assert cus[1] == cus[0]
        assert cus[1][0] > 0 and cus[1][1] > 0
    finally:
        for s in pair:
            s.close()


def test_hotkey_detection_matches_jax():
    rng = np.random.default_rng(5)
    keys = [b"hk%04d" % i for i in range(500)]
    p = 1.0 / np.arange(1, len(keys) + 1) ** 1.3
    stream = rng.choice(len(keys), size=6000, p=p / p.sum())
    results = []
    for cls in (JHotkey, THotkey):
        hc = cls()
        hc.start()
        states = []
        for off in range(0, len(stream), 200):
            hc.capture([keys[i] for i in stream[off:off + 200]])
            states.append(hc.state.value)
        results.append((states, hc.hot_hash_key(), round(hc.hot_share(),
                                                         12)))
    assert results[1] == results[0]
    assert results[1][1] == keys[0]


def test_server_hotkey_capture_matches_jax(tmp_path, clock):
    pair = build_pair(tmp_path, clock, 9305, "none", False)
    try:
        for s in pair:
            s.hotkey_collectors["read"].start()
        rng = np.random.default_rng(6)
        picks = rng.choice(len(HASHKEYS), size=3000,
                           p=np.r_[[0.6], np.full(len(HASHKEYS) - 1,
                                                  0.4 / (len(HASHKEYS) - 1))])
        for srv in pair:
            for i in picks:
                srv.on_get(generate_key(HASHKEYS[int(i)], SORTKEYS[0]))
        got = [(s.hotkey_collectors["read"].state.value,
                s.hotkey_collectors["read"].hot_hash_key(),
                s.workload.summary()) for s in pair]
        assert got[1] == got[0]
        assert got[1][1] == HASHKEYS[0]
    finally:
        for s in pair:
            s.close()


def test_tenancy_statuses_match_jax(tmp_path, clock):
    pair = build_pair(tmp_path, clock, 9306, "dcz2", True)
    try:
        snaps = []
        for srv, ten, rc, types in zip(
                pair, (jtenancy, ttenancy), (jrc, trc), (jtypes, ttypes)):
            ten.TENANTS.set_clock(lambda: 1000.0)
            ten.TENANTS.configure_from_envs(
                {"qos.tenants": "gold:4:100,free:1:5,Bad Name:2"})
            rng = np.random.default_rng(8)
            rc.point_read_multi([(srv, point_ops(types, rng, 20))],
                                tenants=["gold"])
            rc.point_read_multi([(srv, point_ops(types, rng, 20))],
                                tenants=["free"])
            rc.point_read_multi([(srv, point_ops(types, rng, 5))],
                                tenants=["nobody"])
            snaps.append((ten.TENANTS.snapshot(),
                          ten.TENANTS.admit("free"),
                          ten.TENANTS.admit("gold"),
                          ten.TENANTS.weight("gold")))
        assert snaps[1] == snaps[0]
        assert snaps[1][0]["free"]["cu_total"] > 0
    finally:
        for s in pair:
            s.close()


@pytest.mark.parametrize("spec", [
    {"op": "get", "hash_key": "user007", "sort_key": "f03"},
    {"op": "multi_get", "hash_key": "user008",
     "sort_keys": ["f01", "f02", "nope"]},
    {"op": "scan", "hash_key": "user009", "batch_size": 5},
    {"op": "scan", "hash_key": "user010", "filter": "v", "agg": "count"},
])
def test_explain_matches_jax(tmp_path, clock, spec):
    pair = build_pair(tmp_path, clock, 9307, "dcz2", True)
    try:
        reports = []
        for srv, ex in zip(pair, (jexplain, texplain)):
            op, args, ph = ex.op_from_spec(spec)
            rep = ex.explain_op(srv, op, args, ph)
            reports.append((rep["op"], rep["gpid"],
                            [st["stage"] for st in rep["stages"]],
                            strip(rep["perf"]), rep["result"],
                            rep["drift"]))
            text = ex.render_report(rep)
            assert text.startswith(f"EXPLAIN {op}")
        assert reports[1] == reports[0]
    finally:
        for s in pair:
            s.close()


def _prometheus_without_timings(metrics_mod) -> dict:
    text = metrics_mod.to_prometheus(
        metrics_mod.METRICS.snapshot(entity_type="storage"))
    out = {}
    for line in text.splitlines():
        if line.startswith("#") or 'id="node"' not in line:
            continue
        name = line.split("{", 1)[0]
        if name.endswith(("_ms", "_per_s", "_mbps", "_depth")):
            continue  # timings and queue depths
        out[name] = line
    return out


def test_storage_node_prometheus_matches_jax(tmp_path, clock):
    pair = build_pair(tmp_path, clock, 9308, "dcz2", True)
    try:
        run_reads(pair, seed=9)
        for s in pair:
            s.manual_compact()
        run_reads(pair, seed=10)
        jtext = _prometheus_without_timings(jmetrics)
        ttext = _prometheus_without_timings(tmetrics)
        # every series the port exports equals the JAX package's, and
        # every series the JAX package moved, the port exports
        assert ttext
        for name, line in ttext.items():
            assert jtext.get(name) == line
        moved = {n for n, line in jtext.items()
                 if float(line.rsplit(" ", 1)[1]) != 0}
        assert moved <= set(ttext)
        assert "pegasus_block_cache_hit" in moved
    finally:
        for s in pair:
            s.close()
