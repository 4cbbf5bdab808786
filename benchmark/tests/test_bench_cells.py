"""The harness end to end against the port on the CPU, at a tiny size:
every cell proves correct, every fault a cell can have and the control
come out not correct, a cell added as data is found by name, and a run
fails where it must."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark.core import faults, harness

REPO = harness.REPO
SMALL = {"hashkeys": 1500}     # 1,500 records of 10 fields
CELLS = ("ycsb-e-64p.scan", "ycsb-e-64p.l0")


def run(cell, repo=REPO, seed=2_718_281_828_459, seconds=0.5, trace=0,
        **kw):
    args = harness.parse(["--workload", cell, "--seed", str(seed),
                          "--seconds", str(seconds), "--trace", str(trace)])
    return harness.run_cell(args, time.perf_counter(), torch.device("cpu"),
                            overrides=SMALL, repo=repo, **kw)


def test_the_cells_are_named():
    spec = harness.load_spec()
    assert tuple(w["name"] for w in spec["workloads"]) \
        == CELLS + ("ttl-compact-8p.ttl",)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", (0, 1))
def test_cell_is_correct_on_the_port(cell, trace):
    out = run(cell, trace=trace)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    parts = harness.cell_parts(harness.load_spec(), cell)
    group = parts["per_layer" if trace else "end_to_end"]
    # the device metrics stay silent on the CPU
    want = {m["name"] for m in group if m["source"] != "device_trace"}
    assert want <= set(out["metrics"]), (want, out["metrics"])


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_planted_fault_is_not_correct(cell, fault):
    out = run(cell, plant=faults.FAULTS[fault])
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    out = run(cell, make_system=faults.ControlSystem)
    assert not out["correct"], out["checks"]


def copy_cells(root):
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(REPO, "benchmark", sub),
                        root / "benchmark" / sub)


def test_a_cell_added_as_data_is_found_by_name(tmp_path):
    """A configuration file, a traffic file and a metric reader added
    beside the others, with no file of the harness edited."""
    copy_cells(tmp_path)
    spec = harness.load_spec()
    config = json.load(open(os.path.join(
        REPO, "benchmark", "configs", "ycsb-e-64p.json")))
    config.update(name="ycsb-e-8p", partitions=8)
    (tmp_path / "benchmark" / "configs" / "ycsb-e-8p.json").write_text(
        json.dumps(config))
    (tmp_path / "benchmark" / "traffic" / "half.json").write_text(
        json.dumps({"table_state": "compacted",
                    "mix": {"scan": 0.5, "insert": 0.5}, "batch": 8,
                    "scan_records": [1, 10], "operationcount": 100,
                    "warmup_calls": 2}))
    (tmp_path / "benchmark" / "metrics" / "calls_per_s.py").write_text(
        "def read(run):\n"
        "    return sum(len(w) for w in run.walls.values()) / run.window_s\n")
    spec["configs"].append({"name": "ycsb-e-8p", "source": "test",
                            "file": "benchmark/configs/ycsb-e-8p.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "ycsb-e-8p.half",
                              "config": "ycsb-e-8p", "traffic": "half",
                              "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "calls_per_s", "unit": "calls/s",
                               "better": "higher", "bound": 0.1,
                               "source": "host_clock",
                               "workloads": ["ycsb-e-8p.half"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    parts = harness.cell_parts(spec, "ycsb-e-8p.half", str(tmp_path))
    assert parts["config"]["partitions"] == 8
    assert parts["traffic"]["mix"]["insert"] == 0.5
    assert sorted(m["name"] for m in parts["end_to_end"]) == ["calls_per_s",
                                                         "setup_s"]
    out = run("ycsb-e-8p.half", str(tmp_path))
    assert out["correct"], out["checks"]
    assert out["metrics"]["calls_per_s"]["value"] > 0
    assert set(out["metrics"]) == {"calls_per_s", "setup_s"}


def test_a_jax_module_loaded_by_a_reader_fails_the_run(tmp_path):
    """The check of sys.modules comes after every metric reader ran."""
    copy_cells(tmp_path)
    (tmp_path / "benchmark" / "metrics" / "stub_jax.py").write_text(
        "import sys\nimport types\n\n"
        "sys.modules['jax'] = types.ModuleType('jax')\n\n\n"
        "def read(run):\n    return 1.0\n")
    spec = harness.load_spec()
    spec["end_to_end"].append({"name": "stub_jax", "unit": "x",
                               "better": "higher", "bound": 0.1,
                               "source": "host_clock"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    try:
        with pytest.raises(harness.ForbiddenModules) as e:
            run("ycsb-e-64p.scan", str(tmp_path), seconds=0.2)
        assert e.value.names == ["jax"]
    finally:
        sys.modules.pop("jax", None)


def test_no_module_of_the_jax_package_is_loaded():
    run("ycsb-e-64p.scan", seconds=0.2)
    assert harness.forbidden_loaded() == []


def cli(cwd, extra_env=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(extra_env or {}))
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ycsb-e-64p.scan",
         "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_the_command_refuses_a_host_without_the_card():
    out = cli(REPO)
    assert out.returncode != 0 and out.stdout == ""


def test_the_command_fails_with_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(card, cell):
    args = harness.parse(["--workload", cell, "--seed", "9000000001",
                          "--seconds", "1", "--trace", "1"])
    out = harness.run_cell(args, time.perf_counter(), card,
                           overrides=SMALL)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"

