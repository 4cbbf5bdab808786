"""The task profiler's stages inside the port's scan handler
(`utils/profiler.PROFILER.stage`), the scan path's counters, and the
benchmark's stage readers, on the CPU.

A stage times one step of the client_scan_multi handler under a code
`pegasus.<layer>.<step>` beside the message types; off, it is a shared
no-op. The cluster cases serve YCSB-E tables of the benchmark's
configuration at a small size through `ClusterClient.scan_multi`: a
compacted table under an insert overlay (the batched path) and a table
bulk-loaded into L0 runs (the merge path).
"""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.core import harness, probe, stages
from benchmark.core.gen import Dataset
from benchmark.core.system import System, set_store_flags
from benchmark.reference.kv import encode_key, hashkey, sortkey
from pegasus_tpu_torch.ops import record_block
from pegasus_tpu_torch.server import page
from pegasus_tpu_torch.server.types import GetScannerRequest
from pegasus_tpu_torch.utils.profiler import _NO_STAGE, PROFILER
from torch_mesh_helpers import restore_process_state

CONFIG = os.path.join(harness.REPO, "benchmark", "configs",
                      "ycsb-e-64p.json")
SMALL = {"hashkeys": 400, "partitions": 8}
SEED = 3_141_592_653_589

BATCHED_LEAVES = {"pegasus.stub.gate", "pegasus.scan.plan",
                  "pegasus.scan.mask_eval", "pegasus.scan.prepare",
                  "pegasus.scan.pack", "pegasus.scan.overlay",
                  "pegasus.scan.assemble", "pegasus.stub.reply"}
MERGE_LEAVES = {"pegasus.stub.gate", "pegasus.scan.plan",
                "pegasus.scan.mask_eval", "pegasus.scan.prepare",
                "pegasus.merge.read", "pegasus.merge.validate",
                "pegasus.merge.rows", "pegasus.stub.reply"}


class Observed:
    """The codes PROFILER.observe sees while installed, in order."""

    def __init__(self) -> None:
        self.codes: list = []

    def __enter__(self):
        observe = PROFILER.observe

        def recording(code, queue_ms, exec_ms):
            self.codes.append(code)
            observe(code, queue_ms, exec_ms)

        PROFILER.observe = recording
        return self

    def __exit__(self, *exc) -> None:
        del PROFILER.observe


@pytest.fixture
def profiler_state():
    was = PROFILER.enabled
    PROFILER.disable()
    PROFILER.clear()
    yield
    PROFILER.enabled = was
    PROFILER.clear()


# ---- the primitive --------------------------------------------------------


def test_a_disabled_stage_observes_nothing_and_opens_no_range(
        profiler_state):
    assert PROFILER.stage("pegasus.scan.plan") is _NO_STAGE
    assert PROFILER.stage("pegasus.scan.pack") is _NO_STAGE
    from torch.profiler import ProfilerActivity, profile

    with Observed() as seen, profile(
            activities=[ProfilerActivity.CPU]) as prof:
        with PROFILER.stage("pegasus.test.off"):
            torch.ones(4).sum()
    assert seen.codes == []
    assert not [ev for ev in prof.events()
                if ev.name.startswith("pegasus.")]
    assert PROFILER.dump() == []


def test_an_enabled_stage_is_observed_and_a_host_range_of_the_trace(
        profiler_state):
    from torch.profiler import ProfilerActivity, profile

    PROFILER.enable()
    with Observed() as seen:
        with PROFILER.stage("pegasus.test.untraced"):
            pass
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with PROFILER.stage("pegasus.test.traced"):
                torch.ones(4).sum()
    assert seen.codes == ["pegasus.test.untraced", "pegasus.test.traced"]
    ranges = [ev for ev in prof.events() if ev.name.startswith("pegasus.")]
    assert [ev.name for ev in ranges] == ["pegasus.test.traced"]
    # the scope of an operator, not a user annotation: no device-side
    # event spans the work launched inside it
    assert not ranges[0].is_user_annotation
    rows = {row["code"]: row for row in PROFILER.control(["dump"])}
    assert rows["pegasus.test.traced"]["count"] == 1
    assert rows["pegasus.test.untraced"]["queue_ms_p99"] == 0.0


def test_a_stage_that_raises_is_still_observed(profiler_state):
    PROFILER.enable()
    with Observed() as seen, pytest.raises(KeyError):
        with PROFILER.stage("pegasus.test.raises"):
            raise KeyError("x")
    assert seen.codes == ["pegasus.test.raises"]


def test_the_prefresher_records_under_its_own_stage(profiler_state,
                                                    isolated, tmp_path):
    from pegasus_tpu_torch.server.partition_server import PartitionServer
    from pegasus_tpu_torch.server.scan_coordinator import MaskPrefresher

    srv = PartitionServer(str(tmp_path / "p"), device="cpu")
    try:
        PROFILER.enable()
        with Observed() as seen:
            MaskPrefresher([srv]).refresh_once()
        assert seen.codes == ["pegasus.prefresh.pass"]
    finally:
        srv.close()


# ---- the counters ---------------------------------------------------------


def test_record_block_copies_to_a_device_are_counted():
    keys = [encode_key(hashkey(h), sortkey(f)) for h in range(5)
            for f in range(3)]
    before = dict(record_block.H2D)
    record_block.build_record_block(keys, [0] * len(keys))
    assert record_block.H2D == before  # a block on the host copies nothing
    blk = record_block.build_record_block(keys, [0] * len(keys),
                                          device="meta")
    tensors = [blk.keys, blk.key_len, blk.hashkey_len, blk.expire_ts,
               blk.valid, blk.hash_lo]
    assert record_block.H2D["copies"] - before["copies"] == len(tensors)
    assert record_block.H2D["bytes"] - before["bytes"] == sum(
        t.numel() * t.element_size() for t in tensors)
    mid = dict(record_block.H2D)
    cols = record_block.block_from_columns(
        np.zeros((7, 32), np.uint8), np.full(7, 12, np.int32),
        np.zeros(7, np.int64), capacity=16, device="meta")
    assert cols.hash_lo is None
    assert record_block.H2D["copies"] - mid["copies"] == 5
    assert record_block.H2D["bytes"] - mid["bytes"] == 16 * (32 + 4 * 3 + 1)


# ---- the stages on a served table -----------------------------------------


@pytest.fixture
def isolated():
    """The cluster's metric entities, span rings, clocks and the store
    flags it sets are put back after the test."""
    with restore_process_state():
        yield


def served_table(tmp_path, state: str):
    config = dict(json.load(open(CONFIG)), **SMALL)
    set_store_flags(config["store"])
    data = Dataset(config, SEED)
    system = System(config, torch.device("cpu"), str(tmp_path), SEED)
    system.data = data
    harness.load_table(system, data, state)
    return system, data, system.open_client()


def scan_groups(data, starts, limit: int) -> dict:
    groups: dict = {}
    for h in starts:
        groups.setdefault(data.partition_of(h), []).append(GetScannerRequest(
            start_key=encode_key(hashkey(h), b""), batch_size=limit,
            validate_partition_hash=True, one_page=True))
    return groups


def answers(result: dict) -> dict:
    """Every page's rows, byte for byte, with its error and context."""
    return {p: [(r.error, r.context_id,
                 [(kv.key, kv.value, kv.expire_ts_seconds) for kv in r.kvs])
                for r in resps] for p, resps in result.items()}


def staged_call(client, groups):
    """One scan_multi call with the profiler on, its exec sums kept by the
    harness's own probe."""
    with probe.ExecWall() as wall:
        result = client.scan_multi(groups)
    return result, wall


@pytest.mark.parametrize("state", ["compacted", "bulk_l0"])
def test_the_handler_is_split_into_its_leaf_stages(profiler_state,
                                                   isolated, tmp_path,
                                                   state):
    system, data, client = served_table(tmp_path, state)
    try:
        starts = list(range(0, data.hashkeys, 13))
        if state == "compacted":
            # an overlay: new values over some records the scans read
            for h in starts[::3]:
                assert client.multi_set(hashkey(h), {
                    sortkey(f): b"overlay-%d" % h
                    for f in range(data.fields)}) == 0
        groups = scan_groups(data, starts, 40)
        off = answers(client.scan_multi(groups))
        rows0 = page.SERVE_STATS["overlay_rows"]
        result, wall = staged_call(client, groups)
        rows = page.SERVE_STATS["overlay_rows"] - rows0
        assert answers(result) == off
        assert answers(client.scan_multi(groups)) == off
        assert not PROFILER.enabled
        leaves = {c for c in wall.ms if c.startswith(stages.LEAF_PREFIXES)}
        want = BATCHED_LEAVES if state == "compacted" else MERGE_LEAVES
        assert leaves == want
        assert wall.count["client_scan_multi"] == 1
        assert sum(wall.ms[c] for c in leaves) <= \
            wall.ms["client_scan_multi"]
        if state == "compacted":
            shadowed = sum(kv[1].startswith(b"overlay-")
                           for resps in answers(result).values()
                           for _e, _c, kvs in resps for kv in kvs)
            assert shadowed > 0 and rows == shadowed
        else:
            assert rows == 0
    finally:
        system.close()


def test_the_bulk_loaded_table_scans_through_the_columnar_overlay_path(
        isolated, tmp_path):
    """Each partition of the bulk-loaded table holds one L0 table: its
    forward scans take the columnar scan under the memtable (counted by
    the partition's `scan_path_*_count` metrics), never the heap merge; a
    reverse ranged read takes the heap merge."""
    system, data, client = served_table(tmp_path, "bulk_l0")

    def paths() -> dict:
        out: dict = {}
        for srv in system.servers():
            for k, v in srv.scan_paths.items():
                out[k] = out.get(k, 0) + v
        return out

    try:
        groups = scan_groups(data, list(range(0, data.hashkeys, 7)), 40)
        before = paths()
        client.scan_multi(groups)
        moved = {k: v - before[k] for k, v in paths().items()}
        assert moved["columnar_overlay"] > 0
        assert moved["merge"] == 0 and moved["columnar"] == 0
        before = paths()
        err, kvs = client.multi_get(hashkey(5), reverse=True)
        assert err == 0 and len(kvs) > 0
        moved = {k: v - before[k] for k, v in paths().items()}
        assert moved == {"columnar": 0, "columnar_overlay": 0, "merge": 1}
    finally:
        system.close()


def test_a_ranged_read_in_the_window_silences_the_stage_readers(
        profiler_state, isolated, tmp_path):
    """A ranged multi_get enters the merge path's stages from another
    handler (client_read): the stages can no longer be laid on
    client_scan_multi's wall, so every stage reader reads nothing."""
    system, data, client = served_table(tmp_path, "bulk_l0")
    try:
        groups = scan_groups(data, list(range(0, data.hashkeys, 37)), 40)
        client.scan_multi(groups)
        _result, alone = staged_call(client, groups)
        with probe.ExecWall() as mixed:
            client.scan_multi(groups)
            err, kvs = client.multi_get(hashkey(5))
        assert err == 0 and len(kvs) > 0
        assert mixed.count["client_read"] == 1
        # the ranged read's own pass through the merge path
        assert mixed.count["pegasus.merge.read"] > \
            alone.count["pegasus.merge.read"]
        assert all(read(a_run(alone.ms, alone.count)) is not None
                   for read in map(harness.reader, NEW_READERS))
        assert [harness.reader(name)(a_run(mixed.ms, mixed.count))
                for name in NEW_READERS] == [None] * len(NEW_READERS)
    finally:
        system.close()


# ---- the readers ----------------------------------------------------------

NEW_READERS = ("plan_ms_per_call.scan", "pack_ms_per_call.scan",
               "overlay_ms_per_call.scan", "merge_read_ms_per_call.scan",
               "merge_validate_ms_per_call.scan",
               "merge_rows_ms_per_call.scan", "stub_untraced_pct.scan",
               "mask_eval_ms_per_call.scan", "gate_reply_ms_per_call.scan")


def a_run(exec_ms: dict, exec_count: dict):
    run = harness.Run()
    run.exec_ms, run.exec_count = exec_ms, exec_count
    return run


@pytest.mark.parametrize("name", NEW_READERS)
def test_a_new_reader_is_silent_without_the_stages(name):
    read = harness.reader(name)
    assert read(harness.Run()) is None
    # the parent's program: the handler timed, no stage inside it
    assert read(a_run({"client_scan_multi": 40.0},
                      {"client_scan_multi": 2})) is None
    # the prefresher's stage alone is not the handler's
    assert read(a_run({"client_scan_multi": 40.0,
                       "pegasus.prefresh.pass": 3.0},
                      {"client_scan_multi": 2})) is None
    # stages beside another read handler, which enters them too
    for other in stages.OTHER_READS:
        assert read(a_run({"client_scan_multi": 40.0, other: 9.0,
                           "pegasus.scan.plan": 4.0,
                           "pegasus.merge.read": 20.0},
                          {"client_scan_multi": 2, other: 1})) is None


def test_the_readers_add_up_to_the_handler():
    ms = {"client_scan_multi": 100.0, "client_write": 7.0,
          "pegasus.stub.gate": 1.0, "pegasus.scan.plan": 10.0,
          "pegasus.scan.mask_eval": 2.0, "pegasus.scan.prepare": 5.0,
          "pegasus.scan.pack": 20.0, "pegasus.scan.assemble": 15.0,
          "pegasus.scan.overlay": 30.0, "pegasus.merge.read": 4.0,
          "pegasus.merge.validate": 3.0, "pegasus.merge.rows": 2.0,
          "pegasus.stub.reply": 0.5, "pegasus.prefresh.pass": 50.0}
    run = a_run(ms, {"client_scan_multi": 4})
    got = {name: harness.reader(name)(run) for name in NEW_READERS}
    assert got["plan_ms_per_call.scan"] == 2.5
    assert got["pack_ms_per_call.scan"] == 10.0
    assert got["overlay_ms_per_call.scan"] == 7.5
    assert got["merge_read_ms_per_call.scan"] == 1.0
    assert got["merge_validate_ms_per_call.scan"] == 0.75
    assert got["merge_rows_ms_per_call.scan"] == 0.5
    assert got["stub_untraced_pct.scan"] == pytest.approx(7.5)
    assert got["mask_eval_ms_per_call.scan"] == 0.5
    assert got["gate_reply_ms_per_call.scan"] == 0.375
    # every leaf is in one time metric: with the untraced share they
    # add up to the handler's wall a message
    times = sum(v for name, v in got.items() if name.endswith("_call.scan"))
    assert times + 25.0 * got["stub_untraced_pct.scan"] / 100 == \
        pytest.approx(25.0)
    # a stage the window never entered reads 0 beside the others
    del ms["pegasus.scan.overlay"]
    assert harness.reader("overlay_ms_per_call.scan")(run) == 0.0


def test_the_new_metrics_are_declared_with_readers():
    spec = harness.load_spec()
    declared = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW_READERS:
        assert declared[name]["moves"] == "scans_per_s"
        assert declared[name]["source"] == "program_span"
        assert callable(harness.reader(name))


# ---- the device trace, read by stage --------------------------------------


def ev(name, start, end, device="CPU"):
    return SimpleNamespace(name=name, device_type=f"DeviceType.{device}",
                           time_range=SimpleNamespace(start=start, end=end))


def test_stage_ranges_leave_the_device_time_alone():
    base = [ev("bench.scan", 0, 1000), ev("bench.scan", 1100, 2000),
            ev("kernel_a", 100, 150, "CUDA"), ev("Memcpy HtoD", 400, 420,
                                                  "CUDA"),
            ev("kernel_a", 1500, 1560, "CUDA")]
    staged_events = base + [ev("pegasus.scan.plan", 10, 90),
                            ev("pegasus.scan.pack", 160, 900),
                            ev("pegasus.merge.rows", 1200, 1490)]
    plain, staged = probe.summarize(base), probe.summarize(staged_events)
    assert staged["busy_s"] == plain["busy_s"]
    assert staged["device_s_by_name"] == plain["device_s_by_name"]
    read = stages.read_trace(staged_events)
    assert read["idle_s"] == pytest.approx(2000e-6 - plain["busy_s"])
    assert read["device_stage_events"] == 0


@pytest.mark.parametrize("stage_on_device", [False, True])
def test_the_gaps_are_cut_as_the_harness_cuts_them(stage_on_device):
    """stages.idle_gaps repeats probe.summarize's cut of the idle gaps,
    which keeps no gap's bounds: every gap, its length and its name the
    same, a device-side event of any name counted as device work."""
    events = [ev("bench.scan", 0, 1000), ev("bench.insert", 1000, 1400),
              ev("bench.scan", 1450, 3000),
              ev("k", 100, 150, "CUDA"), ev("Memcpy HtoD", 140, 180, "CUDA"),
              ev("bench.scan", 500, 900, "CUDA"),
              ev("k", 1390, 1460, "CUDA"), ev("k", 2000, 2100, "CUDA"),
              ev("pegasus.scan.pack", 300, 700,
                 "CUDA" if stage_on_device else "CPU")]
    want = probe.summarize(events)
    gaps = stages.idle_gaps(events)
    assert len(gaps) == 4 + stage_on_device
    assert sorted(((e - s) / 1e6, n) for s, e, n in gaps)[::-1][:10] == [
        (s, n) for n, s in want["idle_gaps"]]
    assert sum(e - s for s, e, _n in gaps) / 1e6 == pytest.approx(
        3000e-6 - want["busy_s"])
    assert stages.read_trace(events)["device_stage_events"] == \
        stage_on_device


def test_the_stage_trace_script_puts_the_harness_summary_back():
    from benchmark import stage_trace

    summarize = probe.summarize
    events = [ev("bench.scan", 0, 1000), ev("k", 100, 150, "CUDA"),
              ev("pegasus.scan.plan", 150, 900)]
    with stage_trace.reading_stages({}) as report:
        assert probe.summarize(events) == summarize(events)
    assert probe.summarize is summarize
    assert report["idle_gaps"][0] == ["pegasus.scan.plan", 850e-6]
    with pytest.raises(RuntimeError):
        with stage_trace.reading_stages({}):
            raise RuntimeError("the run failed")
    assert probe.summarize is summarize


def test_a_gap_is_named_by_the_stage_that_covers_most_of_it():
    events = [ev("bench.scan", 0, 1000), ev("bench.insert", 1000, 1400),
              ev("k", 100, 150, "CUDA"), ev("k", 600, 700, "CUDA"),
              ev("k", 1390, 1400, "CUDA"),
              # gap 150-600: pack covers 300 of it, plan 100
              ev("pegasus.scan.plan", 150, 250),
              ev("pegasus.scan.pack", 290, 440),
              ev("pegasus.scan.pack", 450, 600),
              # gap 700-1390: no stage; the harness range at its middle
              # gap 0-100: rows covers 40
              ev("pegasus.merge.rows", 20, 60)]
    read = stages.read_trace(events)
    assert read["idle_gaps"] == [["bench.insert", 690e-6],
                                 ["pegasus.scan.pack", 450e-6],
                                 ["pegasus.merge.rows", 100e-6]]
    assert read["idle_s_by_stage"] == pytest.approx(
        {"pegasus.merge.rows": 40e-6, "pegasus.scan.pack": 300e-6,
         "pegasus.scan.plan": 100e-6})
    assert read["idle_s"] == pytest.approx(1240e-6)
    assert read["device_stage_events"] == 0
    # the harness's own naming of the same trace is unchanged
    assert [n for n, _s in probe.summarize(events)["idle_gaps"]] == [
        "bench.insert", "bench.scan", "bench.scan"]
