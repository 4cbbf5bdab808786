"""The compaction cell end to end against the port on the CPU, at a small
store: it proves correct, every fault planted under its timed path and
the control come out not correct, a traffic file that names a runner is
run by it, the scan cells still run and report as they did, and the
filter's bytes are those of the yardstick they were frozen from."""

import json
import os
import shutil
import time

import pytest
import torch

from benchmark.core import harness
from benchmark.roofline.compaction import filter_bytes

REPO = harness.REPO
CELL = "ttl-compact-8p.ttl"
SMALL = {"store_gb": 0.005}    # 34,480 records in 8 partitions
RUNNER = harness.runner("compaction")


def run(seed=2_718_281_828_459, seconds=0.3, trace=0, cell=CELL,
        repo=REPO, overrides=None, **kw):
    args = harness.parse(["--workload", cell, "--seed", str(seed),
                          "--seconds", str(seconds), "--trace", str(trace)])
    return harness.run_cell(args, time.perf_counter(), torch.device("cpu"),
                            overrides=SMALL if overrides is None
                            else overrides, repo=repo, **kw)


@pytest.mark.parametrize("trace", (0, 1))
def test_the_compaction_cell_is_correct_on_the_port(trace):
    out = run(trace=trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 8 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert list(out["checks"]) == ["expired_kept", "live_lost",
                                   "rows_unexpected", "rows_misordered",
                                   "passes_failed"]
    parts = harness.cell_parts(harness.load_spec(), CELL)
    group = parts["per_layer" if trace else "end_to_end"]
    # the device metrics stay silent on the CPU
    want = {m["name"] for m in group if m["source"] != "device_trace"}
    assert set(out["metrics"]) == want, out["metrics"]
    if not trace:
        assert out["metrics"]["compact_gbps"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(RUNNER.FAULTS))
def test_a_planted_compaction_fault_is_not_correct(fault):
    out = run(plant=RUNNER.FAULTS[fault])
    assert not out["correct"], out["checks"]


def test_rows_out_of_key_order_are_not_correct():
    """Two rows of one block swapped keep every row once and unchanged:
    only the order check sees them."""
    out = run(plant=RUNNER.plant_swap_two_rows)
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert checks == {"expired_kept": 0, "live_lost": 0,
                      "rows_unexpected": 0, "rows_misordered": 1,
                      "passes_failed": 0}


@pytest.mark.parametrize("keys,key_len,want", (
    ([b"ab", b"ac", b"b"], [2, 2, 1], 0),
    ([b"ac", b"ab", b"b"], [2, 2, 1], 1),
    ([b"a", b"a", b"b"], [1, 1, 1], 1),
    # a key sorts before every longer key it begins, also one that goes
    # on with a zero byte
    ([b"a", b"a\0", b"a\1"], [1, 2, 2], 0),
    ([b"a\0", b"a", b"b"], [2, 1, 1], 1),
))
def test_the_order_check_compares_keys_as_bytes(keys, key_len, want):
    import numpy as np

    from benchmark.reference.compaction import misordered

    rows = np.zeros((len(keys), 4), dtype=np.uint8)
    for i, k in enumerate(keys):
        rows[i, :len(k)] = np.frombuffer(k, dtype=np.uint8)
    assert misordered(rows, np.array(key_len)) == want


def test_the_compaction_control_is_not_correct():
    out = run(plant=RUNNER.plant_control)
    assert not out["correct"], out["checks"]
    assert out["checks"]["expired_kept"]["value"] > 0


def test_the_same_seed_stages_the_same_records():
    from benchmark.reference.compaction import TtlTable

    config = dict(harness.cell_parts(harness.load_spec(), CELL)["config"],
                  **SMALL)
    a, b = TtlTable(config, 5), TtlTable(config, 5)
    c = TtlTable(config, 6)
    for p in (0, 7):
        ra, rb, rc = a.partition(p), b.partition(p), c.partition(p)
        assert (ra.values == rb.values).all()
        assert (ra.expired == rb.expired).all()
        # another seed: other values and rows, the same sizes
        assert not (ra.values == rc.values).all()
        assert ra.keys.shape == rc.keys.shape
        assert ra.expired.sum() == rc.expired.sum()


def test_a_traffic_file_that_names_a_runner_is_run_by_it(tmp_path):
    """A traffic file, a runner and a cell added beside the others, with
    no file of the harness edited."""
    for sub in ("configs", "traffic", "metrics", "runners"):
        shutil.copytree(os.path.join(REPO, "benchmark", sub),
                        tmp_path / "benchmark" / sub)
    (tmp_path / "benchmark" / "traffic" / "echo.json").write_text(
        json.dumps({"runner": "echo"}))
    (tmp_path / "benchmark" / "runners" / "echo.py").write_text(
        "def run_cell(args, t_start, device, parts, overrides, plant,\n"
        "             repo):\n"
        "    return {'runner': 'echo', 'cell': parts['cell']['name'],\n"
        "            'repo': repo, 'overrides': overrides}\n")
    spec = harness.load_spec()
    spec["workloads"].append({"name": "ttl-compact-8p.echo",
                              "config": "ttl-compact-8p",
                              "traffic": "echo", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    out = run(cell="ttl-compact-8p.echo", repo=str(tmp_path))
    assert out == {"runner": "echo", "cell": "ttl-compact-8p.echo",
                   "repo": str(tmp_path), "overrides": SMALL}


@pytest.mark.parametrize("cell", ("ycsb-e-64p.scan", "ycsb-e-64p.l0"))
def test_the_scan_cells_report_as_before_the_runners(cell):
    """The scan cells' traffic names no runner: they run the harness's
    own path, with the result keys and checks they had, and never read
    the compaction cell's metrics."""
    parts = harness.cell_parts(harness.load_spec(), cell)
    assert "runner" not in parts["traffic"]
    names = {m["name"] for m in parts["end_to_end"] + parts["per_layer"]}
    assert not names & {"compact_gbps", "compaction_filter_roofline"}
    out = run(cell=cell, seconds=0.5, overrides={"hashkeys": 1500})
    assert out["correct"], out["checks"]
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert list(out["checks"]) == ["inserts_unseen", "pages_wrong",
                                   "expired_served", "unanswered",
                                   "runs_changed"]
    assert set(out["metrics"]) == {"scans_per_s", "setup_s"}


# the shapes phase 7 launches (chip_smoke.run_compaction): passes a and b
# through the bulk path (TTL only, a chunk of 2^18 rows and a remainder,
# hash_lo and a pidx column, packed), pass c with config #4's pattern
# rules; phase 3's merge batch and its chunk validating by the key hash;
# the resident round's slot gate
PHASE7_SHAPES = (
    dict(rows=1 << 18, k=32, keys=False, hash_lo=True, pidx_col=True,
         pack=True, want_ets=False),
    dict(rows=169_250, k=32, keys=False, hash_lo=True, pidx_col=True,
         pack=True, want_ets=False),
    dict(rows=1 << 18, k=32, keys=True, hash_lo=True, pidx_col=True,
         pack=True, want_ets=False),
    dict(rows=16 * 1024, k=32, keys=False, hash_lo=True, pidx_col=False,
         pack=False, want_ets=True),
    dict(rows=1 << 18, k=32, keys=True, hash_lo=False, pidx_col=True,
         pack=True, want_ets=False),
    dict(rows=1 << 20, k=32, keys=False, hash_lo=True, pidx_col=False,
         pack=True, want_ets=True, slots=64),
)


@pytest.mark.parametrize("shape", PHASE7_SHAPES)
def test_the_filter_bytes_are_chip_smokes(shape):
    import chip_smoke

    bound_ms, by = chip_smoke.compaction_bound(**shape, ops=0)
    assert by == "bytes"
    assert filter_bytes(**shape) / chip_smoke.HBM_BYTES_PER_S * 1e3 \
        == bound_ms


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's compaction kernel)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_the_compaction_cell_is_correct_on_the_card(card):
    args = harness.parse(["--workload", CELL, "--seed", "9000000001",
                          "--seconds", "1", "--trace", "1"])
    out = harness.run_cell(args, time.perf_counter(), card,
                           overrides=SMALL)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["metrics"]["compaction_launches_per_gb"]["value"] > 0


@pytest.mark.parametrize("rules", (False, True))
def test_the_filter_launches_record_the_bulk_paths_shape(monkeypatch,
                                                          rules):
    """A launch as compaction_eval_submit makes it (a chunk of 2^18 rows,
    K = 32, a pidx column, hash_lo, packed, no ets2) is recorded with the
    shape of phase 7's pass a (TTL only) or c (config #4's rules)."""
    import functools

    import chip_smoke
    from pegasus_tpu_torch.ops import fused_compaction
    from pegasus_tpu_torch.ops.compaction_rules import parse_rules

    real = fused_compaction.compaction_filter

    @functools.wraps(real)
    def stand_in(*a, **kw):
        return None, None

    monkeypatch.setattr(fused_compaction, "compaction_filter", stand_in)
    rows = 1 << 18
    cols = [torch.zeros((rows, 32), dtype=torch.uint8)] + [
        torch.zeros(rows, dtype=torch.int32) for _ in range(2)]
    ops = tuple(parse_rules(chip_smoke.CONFIG4_RULES)) if rules else ()
    with RUNNER.FilterLaunches() as launches:
        fused_compaction.compaction_filter(
            cols[0], cols[1], cols[2], torch.ones(rows, dtype=torch.bool),
            cols[2], cols[1], ops, 5000, 0, 7, validate_hash=True,
            expire=True, want_ets=False, pack=True)
    assert fused_compaction.compaction_filter is stand_in
    assert launches.shapes == [PHASE7_SHAPES[2 if rules else 0]
                               | {"slots": 0}]
