"""The resident image's serving (parallel/mesh_resident.py): the port's
MESH_SERVING against the JAX package's, exact.

The same seeded 8-partition tables (rows written under the none, dcz
and dcz2 codecs, empty-hashkey rows, then compacted) are built in both
packages on frozen clocks, with both packages' MESH_SERVINGs attached
(tests/test_partition_mesh_serving.py's cases):

- scan waves: every partition's drained rows through the resident round
  equal the host arm's and the JAX package's, at each codec, with an
  unflushed overlay on top; the round really served (wave dispatches);
- pushdown aggregates: count, sum, top_k and sample over every
  partition equal the host arm's and the JAX package's wire results,
  with one round per (predicate, `now`) shared by all 8 siblings; a
  later round at another `now` leaves the first round's cached counts
  and totals equal to the JAX package's;
- the incremental refresh: after one partition's flush and compaction
  only that partition restages, and no wave serves a stale image;
- declines: a paging budget below the resident range and an overlay
  keep the host arm (and its answers); a disabled `[pegasus.mesh]
  serving_enabled` declines; a declined wave's answer is the host
  arm's;
- attach raises for a table whose partitions sit on two devices;
- explain reports the resident ride (`placement` "mesh");
- the placement gate's shape under the constants measured on the card;
  audited host waves carry a nonzero `predicted_kernel_ms` and DRIFT
  gets `ttl` and `rules` samples, the resident rounds `mesh` ones.

The JAX package's watchdog, tunnel and metrics-lint tests have no
counterpart: the port carries none of those constructs. Both packages'
MESH_SERVING, flags, DRIFT and METRICS are reset and restored around
every test.
"""

import numpy as np
import pytest
import torch
from torch_mesh_helpers import T0, set_flags
from torch_mesh_helpers import mesh_guard as guard

from pegasus_tpu.client import PegasusClient as JClient
from pegasus_tpu.client import Table as JTable
from pegasus_tpu.ops import placement as jplacement
from pegasus_tpu.ops.pushdown import PushdownSpec as JPushdown
from pegasus_tpu.parallel.mesh_resident import MESH_SERVING as JMESH
from pegasus_tpu.server import types as jtypes
from pegasus_tpu_torch.client import PegasusClient, Table
from pegasus_tpu_torch.ops import placement
from pegasus_tpu_torch.ops.predicates import FT_MATCH_ANYWHERE, FT_MATCH_PREFIX
from pegasus_tpu_torch.ops.pushdown import PushdownSpec
from pegasus_tpu_torch.parallel.mesh_resident import MESH_SERVING
from pegasus_tpu_torch.server import types as ttypes
from pegasus_tpu_torch.server.partition_server import PartitionServer
from pegasus_tpu_torch.server.workload import DRIFT as TDRIFT
from pegasus_tpu_torch.utils import perf_context as perf

N_PARTS = 8
APP_ID = 9110
FLAG_NAMES = (("pegasus.storage", "block_codec"),
              ("pegasus.mesh", "serving_enabled"),
              ("pegasus.server", "rocksdb_max_iteration_count"))


@pytest.fixture
def mesh_guard(monkeypatch):
    """Frozen clocks in both packages; both MESH_SERVINGs detached, both
    DRIFTs and METRICS zeroed, before and after; flags restored."""
    with guard(monkeypatch, FLAG_NAMES) as clk:
        yield clk


def force_mesh_pays(monkeypatch):
    """Tiny fixtures never amortize a round: the identity tests pin both
    gates open so every wave takes the resident path (the gate has its
    own test, and chip_smoke.py phase 10 runs the measured one)."""
    for mod in (jplacement, placement):
        monkeypatch.setattr(mod, "mesh_wave_pays", lambda *_a: True)


def drain(s, req):
    rows = []
    resp = s.on_get_scanner(req)
    while True:
        assert resp.error == 0
        rows.extend((kv.key, kv.value) for kv in resp.kvs)
        if resp.context_id == jtypes.SCAN_CONTEXT_ID_COMPLETED:
            return rows, resp.agg
        resp = s.on_scan(resp.context_id)


def vf_req(types, pd_cls, pat, agg="", k=0, seed=0, **kw):
    pd = pd_cls(value_filter_type=FT_MATCH_ANYWHERE,
                value_filter_pattern=pat, aggregate=agg, k=k, seed=seed)
    return types.GetScannerRequest(pushdown=pd, **kw)


REQS = (
    ("plain", lambda t, pd: t.GetScannerRequest(batch_size=171)),
    ("value-filter", lambda t, pd: vf_req(t, pd, b"blue", batch_size=64)),
    ("hash-prefix", lambda t, pd: t.GetScannerRequest(
        hash_key_filter_type=FT_MATCH_PREFIX,
        hash_key_filter_pattern=b"hk0", batch_size=97)),
)
PKGS = ((jtypes, JPushdown), (ttypes, PushdownSpec))


def build_pair(tmp_path, rows=240, compact_codec=None):
    """The JAX and the port table with the same history: rows written
    under three SST codecs plus empty-hashkey rows, flushed; compacted
    under `compact_codec` when given."""
    tables = (JTable(str(tmp_path / "j"), app_id=APP_ID,
                     partition_count=N_PARTS),
              Table(str(tmp_path / "t"), app_id=APP_ID,
                    partition_count=N_PARTS, device="cpu"))
    clients = (JClient(tables[0]), PegasusClient(tables[1]))
    i = 0
    for codec in ("none", "dcz", "dcz2"):
        set_flags("pegasus.storage", "block_codec", codec)
        for _ in range(rows // 3):
            v = b"blue-%04d" % i if i % 5 == 0 else b"red-%04d" % i
            for c in clients:
                assert c.set(b"hk%02d" % (i % 13), b"s%05d" % i, v) == 0
            i += 1
        for c in clients:
            assert c.set(b"", b"osk%02d" % (i % 7), b"blue-ovf-%d" % i) == 0
        i += 1
        for t in tables:
            t.flush_all()
    if compact_codec is not None:
        set_flags("pegasus.storage", "block_codec", compact_codec)
        for t in tables:
            for s in t.partitions.values():
                s.engine.flush()
                s.engine.manual_compact()
    return tables, clients


def all_rows(table, pkg, make):
    return {p: drain(s, make(*pkg))[0]
            for p, s in sorted(table.partitions.items())}


def clear_mask_caches(table):
    """Static masks are cached per (block, filter): clear them so each arm
    evaluates real waves instead of replaying the other arm's masks."""
    for s in table.partitions.values():
        with s._mask_lock:
            s._mask_cache.clear()


def attach_all(tables):
    for mesh, t in zip((JMESH, MESH_SERVING), tables):
        for s in t.partitions.values():
            mesh.attach(s)


def close(tables):
    for t in tables:
        t.close()


@pytest.mark.parametrize("codec", ["none", "dcz", "dcz2"])
def test_wave_identity_mixed_codecs(tmp_path, mesh_guard, monkeypatch,
                                    codec):
    tables, _c = build_pair(tmp_path, compact_codec=codec)
    try:
        host = {name: all_rows(tables[1], PKGS[1], f) for name, f in REQS}
        assert host == {name: all_rows(tables[0], PKGS[0], f)
                        for name, f in REQS}
        assert any(host["value-filter"].values()), "degenerate fixture"
        assert any(host["hash-prefix"].values()), "degenerate fixture"
        for t in tables:
            clear_mask_caches(t)
        force_mesh_pays(monkeypatch)
        attach_all(tables)
        for name, f in REQS:
            assert all_rows(tables[1], PKGS[1], f) == host[name], name
            assert all_rows(tables[0], PKGS[0], f) == host[name], name
        st = MESH_SERVING.status()
        assert MESH_SERVING.wave_dispatches > 0
        assert MESH_SERVING.wave_dispatches == JMESH.wave_dispatches
        assert st["mesh_dispatch_count"] == MESH_SERVING.wave_dispatches
        assert st["mesh_verdict_share"] > 0.0
        assert st["platform"] == "cpu" and st["devices"] == 1
        # every resident round is one drift sample under "mesh"
        assert TDRIFT.status()["classes"]["mesh"]["samples"] == \
            MESH_SERVING.wave_dispatches
    finally:
        close(tables)


def test_wave_identity_with_overlay(tmp_path, mesh_guard, monkeypatch):
    """An unflushed overlay merges on top of whichever arm serves the
    base."""
    tables, clients = build_pair(tmp_path, compact_codec="dcz2")
    try:
        force_mesh_pays(monkeypatch)
        attach_all(tables)
        make = REQS[1][1]
        base = all_rows(tables[1], PKGS[1], make)
        assert MESH_SERVING.wave_dispatches > 0
        for c in clients:
            assert c.set(b"hk00", b"s00000", b"red-shadowed") == 0
            assert c.set(b"hknew", b"s0", b"blue-overlay-only") == 0
        for t in tables:
            clear_mask_caches(t)
        with_overlay = all_rows(tables[1], PKGS[1], make)
        assert with_overlay != base
        assert with_overlay == all_rows(tables[0], PKGS[0], make)
        MESH_SERVING.reset()
        clear_mask_caches(tables[1])
        assert all_rows(tables[1], PKGS[1], make) == with_overlay
    finally:
        close(tables)


def agg_wires(table, pkg, kind, k=3, seed=9):
    types, pd_cls = pkg
    return {p: drain(s, vf_req(types, pd_cls, b"blue", agg=kind, k=k,
                               seed=seed))[1]
            for p, s in sorted(table.partitions.items())}


def test_aggregates_mesh_vs_host_single_dispatch(tmp_path, mesh_guard):
    tables, _c = build_pair(tmp_path, compact_codec="dcz2")
    kinds = ("count", "sum", "top_k", "sample")
    try:
        host = {kind: agg_wires(tables[1], PKGS[1], kind) for kind in kinds}
        assert sum(w["count"] for w in host["count"].values()) > 0
        attach_all(tables)
        # the measured gate, not a pinned one: one round over 8
        # partitions beats 8 host waves on the CPU
        for kind in kinds:
            assert agg_wires(tables[1], PKGS[1], kind) == host[kind], kind
            assert agg_wires(tables[0], PKGS[0], kind) == host[kind], kind
        # all 32 (kind, partition) folds share TWO rounds on the frozen
        # clock: one per with_sum flavour (count, top_k and sample reuse
        # one cached round)
        assert MESH_SERVING.agg_dispatches == 2 == JMESH.agg_dispatches
        assert MESH_SERVING.status()["mesh_dispatch_count"] == 2
    finally:
        close(tables)


def test_aggregate_cache_survives_a_later_round(tmp_path, mesh_guard):
    """Two aggregate rounds at different `now`: each round's results come
    home in a host buffer of its own, so the first round's cached counts
    and totals still equal the JAX package's after the second."""
    clk = mesh_guard
    tables, clients = build_pair(tmp_path, rows=120)
    try:
        # rows that run out between the two rounds
        for i in range(40):
            for c in clients:
                assert c.set(b"hk%02d" % (i % 13), b"t%04d" % i,
                             b"blue-ttl-%d" % i, ttl_seconds=30) == 0
        for t in tables:
            for s in t.partitions.values():
                s.engine.flush()
                s.engine.manual_compact()
        attach_all(tables)
        kinds = ("count", "sum")
        first = {kind: agg_wires(tables[1], PKGS[1], kind) for kind in kinds}
        assert first == {kind: agg_wires(tables[0], PKGS[0], kind)
                         for kind in kinds}
        cached = dict(MESH_SERVING._agg_cache)
        assert len(cached) == 2
        kept = {k: (v["counts"].copy(), list(v["totals"]))
                for k, v in cached.items()}
        clk.t += 60
        second = {kind: agg_wires(tables[1], PKGS[1], kind)
                  for kind in kinds}
        assert second == {kind: agg_wires(tables[0], PKGS[0], kind)
                          for kind in kinds}
        assert second["count"] != first["count"], "degenerate fixture"
        assert MESH_SERVING.agg_dispatches == 4 == JMESH.agg_dispatches
        # both caches key on (..., now, with_sum) last
        jax_first = {k[-2:]: v for k, v in JMESH._agg_cache.items()}
        for k, v in cached.items():
            np.testing.assert_array_equal(v["counts"], kept[k][0])
            assert v["totals"] == kept[k][1]
            j = jax_first[k[-2:]]
            np.testing.assert_array_equal(v["counts"], np.asarray(j["counts"]))
            assert v["totals"] == j["totals"]
    finally:
        close(tables)


def test_incremental_refresh_no_stale_image(tmp_path, mesh_guard,
                                            monkeypatch):
    tables, clients = build_pair(tmp_path, rows=120, compact_codec="dcz")
    try:
        force_mesh_pays(monkeypatch)
        attach_all(tables)
        make = REQS[0][1]
        before = all_rows(tables[1], PKGS[1], make)
        assert MESH_SERVING.wave_dispatches > 0
        sb0, stk0 = MESH_SERVING.slab_builds, MESH_SERVING.stack_builds
        assert sb0 >= N_PARTS
        for t, c in zip(tables, clients):
            target = t.resolve(b"hot-hk")
            for j in range(40):
                assert c.set(b"hot-hk", b"z%03d" % j,
                             b"blue-hot-%d" % j) == 0
            target.engine.flush()
            target.engine.manual_compact()
            clear_mask_caches(t)
        w0 = MESH_SERVING.wave_dispatches
        after = all_rows(tables[1], PKGS[1], make)
        assert after == all_rows(tables[0], PKGS[0], make)
        assert MESH_SERVING.wave_dispatches > w0
        pidx = tables[1].resolve(b"hot-hk").pidx
        grew = {p for p in after if len(after[p]) != len(before[p])}
        assert grew == {pidx}, "stale (or over-fresh) resident image"
        got = {v for _k, v in after[pidx]}
        assert all(b"blue-hot-%d" % j in got for j in range(40))
        # incremental: only the published partition restaged
        assert MESH_SERVING.slab_builds == sb0 + 1
        assert MESH_SERVING.stack_builds == stk0 + 1
        tables[1].resolve(b"hot-hk").engine.manual_compact()
        clear_mask_caches(tables[1])
        assert all_rows(tables[1], PKGS[1], make) == after
        assert MESH_SERVING.slab_builds <= sb0 + 2
    finally:
        close(tables)


def test_aggregate_declines_paged_and_overlay(tmp_path, mesh_guard):
    """The resident aggregate answers only what the host arm serves in ONE
    page over pure sorted runs."""
    tables, clients = build_pair(tmp_path, compact_codec="dcz2")
    try:
        host = agg_wires(tables[1], PKGS[1], "count")
        attach_all(tables)
        set_flags("pegasus.server", "rocksdb_max_iteration_count", 10)
        assert agg_wires(tables[1], PKGS[1], "count") == host
        assert MESH_SERVING.agg_dispatches == 0
        set_flags("pegasus.server", "rocksdb_max_iteration_count", 0)
        for c in clients:
            assert c.set(b"hk01", b"blue-snew", b"blue-overlay") == 0
        targets = [t.resolve(b"hk01") for t in tables]
        wires = [drain(s, vf_req(*pkg, b"blue", agg="count"))[1]
                 for s, pkg in zip(targets, PKGS)]
        assert wires[1] == wires[0]
        assert wires[1]["count"] == host[targets[1].pidx]["count"] + 1
        assert MESH_SERVING.agg_dispatches == 0
    finally:
        close(tables)


def test_disabled_flag_declines_with_host_answers(tmp_path, mesh_guard,
                                                  monkeypatch):
    """`[pegasus.mesh] serving_enabled = false` declines every round, and
    a declined wave or aggregate answers what the host arm answers."""
    tables, _c = build_pair(tmp_path, rows=120, compact_codec="none")
    try:
        host_rows = all_rows(tables[1], PKGS[1], REQS[1][1])
        host_agg = agg_wires(tables[1], PKGS[1], "sum")
        clear_mask_caches(tables[1])
        force_mesh_pays(monkeypatch)
        attach_all(tables)
        set_flags("pegasus.mesh", "serving_enabled", False)
        assert not MESH_SERVING.enabled
        assert all_rows(tables[1], PKGS[1], REQS[1][1]) == host_rows
        assert agg_wires(tables[1], PKGS[1], "sum") == host_agg
        assert MESH_SERVING.status()["disabled"]
        assert MESH_SERVING.wave_dispatches == 0
        assert MESH_SERVING.agg_dispatches == 0
        # the gate's own decline leaves the host arm's answers too
        set_flags("pegasus.mesh", "serving_enabled", True)
        monkeypatch.setattr(placement, "mesh_wave_pays", lambda *_a: False)
        clear_mask_caches(tables[1])
        assert all_rows(tables[1], PKGS[1], REQS[1][1]) == host_rows
        assert agg_wires(tables[1], PKGS[1], "sum") == host_agg
        assert MESH_SERVING.wave_dispatches == 0
        assert MESH_SERVING.host_waves > 0
    finally:
        close(tables)


def test_attach_across_devices_raises(tmp_path, mesh_guard):
    """One table's image lives on one device: a partition on another
    device than its attached siblings raises at attach."""
    a = PartitionServer(str(tmp_path / "a"), app_id=APP_ID, pidx=0,
                        partition_count=2, device="cpu")
    b = PartitionServer(str(tmp_path / "b"), app_id=APP_ID, pidx=1,
                        partition_count=2, device="cpu")
    try:
        MESH_SERVING.attach(a)
        b.device = torch.device("cuda", 0)  # as a server on the card
        with pytest.raises(ValueError, match="one device"):
            MESH_SERVING.attach(b)
        assert list(MESH_SERVING._tables[APP_ID].servers) == [0]
    finally:
        a.close()
        b.close()


def test_explain_reports_mesh_ride(tmp_path, mesh_guard, monkeypatch):
    from pegasus_tpu_torch.server import explain as explain_mod

    tables, _c = build_pair(tmp_path, rows=120, compact_codec="none")
    try:
        force_mesh_pays(monkeypatch)
        attach_all(tables)
        clear_mask_caches(tables[1])
        s = tables[1].partitions[0]
        spec = explain_mod.spec_from_words(
            ["scan", "filter=blue", "batch_size=1000"])
        op, args, ph = explain_mod.op_from_spec(spec)
        report = explain_mod.explain_op(s, op, args, partition_hash=ph)
        assert report["perf"]["placement"] == "mesh"
        assert report["perf"]["mesh_partitions"] >= 1
        assert report["perf"]["mesh_wave_ms"] > 0.0
        assert report["perf"]["predicted_kernel_ms"] > 0.0
        assert "mesh: partitions=" in explain_mod.render_report(report)
        spec = explain_mod.spec_from_words(["scan", "filter=blue",
                                            "agg=count"])
        op, args, ph = explain_mod.op_from_spec(spec)
        report = explain_mod.explain_op(s, op, args, partition_hash=ph)
        assert report["perf"]["placement"] == "mesh"
        assert report["perf"]["rows_aggregated"] == \
            report["result"]["agg"]["count"]
    finally:
        close(tables)


def test_host_waves_audited_with_prediction(tmp_path, mesh_guard):
    """A host wave carries the placement model's prediction on its
    PerfContext and is one DRIFT sample: `ttl` without a key filter,
    `rules` with one (ROADMAP's PerfContext divergence, closed)."""
    tables, _c = build_pair(tmp_path, rows=120, compact_codec="none")
    try:
        s = tables[1].partitions[0]
        for make in (REQS[0][1], REQS[2][1]):
            pc = perf.start("scan_page")
            with perf.activate(pc):
                drain(s, make(*PKGS[1]))
            assert pc.placement == "host-XLA"
            assert pc.predicted_kernel_ms > 0.0
            assert pc.measured_kernel_ms > 0.0
        classes = TDRIFT.status()["classes"]
        assert classes["ttl"]["samples"] > 0
        assert classes["rules"]["samples"] > 0
    finally:
        close(tables)


def test_mesh_cost_gate_and_verdict(monkeypatch):
    """The gate's shape under the constants measured on the card: with a
    card, a one-table wave of a few blocks stays on the stacked path (one
    launch against the resident round's floor), while a whole 64-partition
    image of 2^20 rows, 64 launches on the stacked path, pays. Without a
    card the round's floor is the host's dispatch floor (the CPU tests'
    gate). The JAX package's ICI terms are gone: see PERF.md."""
    monkeypatch.setattr(placement, "_PROBE_RTT", 3e-5)
    monkeypatch.setattr(placement, "_PROBE_DEVICE", torch.device("cuda", 0))
    assert not placement.mesh_wave_pays(1, 4 * 1024 * 41)
    assert placement.mesh_wave_pays(64, (1 << 20) * 41)
    assert placement.mesh_round_fixed_s() == placement.ROUND_FIXED_S_EST
    assert placement.placement_verdict("mesh") == "mesh"
    assert placement.placement_verdict("ttl") == "device"
    assert placement.placement_verdict("ttl", torch.device("cpu")) == \
        "host-XLA"
    assert placement.predict_kernel_seconds("mesh", 1 << 20) > 0.0
    monkeypatch.setattr(placement, "_PROBE_RTT", None)
    monkeypatch.setattr(placement, "_PROBE_DEVICE", None)
    assert placement.mesh_round_fixed_s() == placement.HOST_DISPATCH_S_EST
    assert placement.mesh_wave_pays(8, 1 << 16)
    assert placement.placement_verdict("rules") == "host-XLA"
    bd = placement.offload_breakdown("rules", 1 << 20)
    assert not bd["accelerator_present"] and bd["placement"] == "host-XLA"
    assert "routed" not in bd and "offload_pays" not in bd
    assert bd["compact"]["workload"] == "mesh_compact"
    assert np.isfinite(bd["compact"]["mesh_batch_s_est"])
