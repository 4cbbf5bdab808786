"""One run of one cell: set up the system, warm it, measure a window,
judge every answer against the plain reference, print one JSON line.

Everything that belongs to a cell is found by name from BENCHMARK.json:
the configuration file its entry names, `traffic/<traffic>.json`, and
one reader `metrics/<metric>.py` per metric. Diagnostics go to standard
error; the judged numbers, each beside its limit, are its last lines.
The last line of standard output is the result.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)
SPEC_FILE = os.path.join(REPO, "BENCHMARK.json")
CACHE_DIR = os.path.join(BENCH_DIR, ".cache")

# top-level module names that no run may load: the JAX stack and the
# JAX package (the port, pegasus_tpu_torch, is another name)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "pegasus_tpu")

PEGASUS_EPOCH = 1451606400   # 2016-01-01 00:00:00 UTC, seconds


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


# ---- what BENCHMARK.json names ------------------------------------------


def load_spec(path: str = SPEC_FILE) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_parts(spec: dict, workload: str, repo: str = REPO) -> dict:
    """The cell, its configuration, its traffic and its metrics, from
    the files under `repo` that BENCHMARK.json names."""
    bench_dir = os.path.join(repo, "benchmark")
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    entry = configs[cell["config"]]
    with open(os.path.join(repo, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic",
                           f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)

    def mine(metric: dict) -> bool:
        return workload in metric.get("workloads", [workload])

    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": [m for m in spec["end_to_end"] if mine(m)],
            "per_layer": [m for m in spec["per_layer"] if mine(m)]}


def reader(name: str, bench_dir: str = BENCH_DIR):
    """The `read(run)` of metrics/<name>.py."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def runner(name: str, bench_dir: str = BENCH_DIR):
    """The module runners/<name>.py: a cell whose traffic file names a
    runner is run by its `run_cell`."""
    path = os.path.join(bench_dir, "runners", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_runner_{name.replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


# ---- the run ------------------------------------------------------------


class Run:
    """What the metric readers read: the window's calls, the program's
    counters over it and, in a traced run, the task profiler's exec
    wall, the scan launches' shapes and the device trace."""

    def __init__(self) -> None:
        self.setup_s = 0.0
        self.window_s = 0.0
        self.walls: dict = {}
        self.done: dict = {}
        self.counters: dict = {}
        self.exec_ms: dict = {}
        self.exec_count: dict = {}
        self.launch_shapes: list = []
        self.trace: dict = {}
        self.trace_window_s = 0.0


def set_cache_dirs() -> None:
    """Build caches inside the checkout, at fixed paths. (The port
    builds its own libraries into pegasus_tpu_torch/_build/.)"""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE_DIR,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE_DIR, "triton")


def load_table(system, data, state: str) -> dict:
    """The configuration's records into the system, in the table state
    the traffic names; seconds by step."""
    from benchmark.reference.kv import (
        encode_key,
        hashkey,
        record_value,
        sortkey,
    )

    split = {}
    t0 = time.perf_counter()
    dead_ts = max(1, int(time.time()) - PEGASUS_EPOCH - 100)
    fields, width = data.fields, data.value_bytes
    sks = [sortkey(f) for f in range(fields)]
    expired = data.expired.tolist()
    if state == "compacted":
        puts = {p: [] for p in range(data.partitions)}
        for h in range(data.hashkeys):
            lst = puts[int(data.route[h])]
            hk, row = hashkey(h), expired[h]
            for f in range(fields):
                lst.append((encode_key(hk, sks[f]),
                            record_value(h * fields + f, width),
                            dead_ts if row[f] else 0))
        split["layout_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        acked = system.load_writes(puts)
        del puts
        if acked != data.records:
            raise RuntimeError(f"{acked} of {data.records} puts acked")
        split["load_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        system.compact()
        split["compaction_s"] = time.perf_counter() - t0
    elif state == "bulk_l0":
        records = []
        for h in range(data.hashkeys):
            hk, row = hashkey(h), expired[h]
            for f in range(fields):
                records.append((hk, sks[f],
                                record_value(h * fields + f, width),
                                dead_ts if row[f] else 0))
        split["layout_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        staged = system.bulk_load(records, os.path.join(system.data_dir,
                                                        "bulk_root"))
        del records
        if staged != data.records:
            raise RuntimeError(f"{staged} of {data.records} staged")
        split["load_s"] = time.perf_counter() - t0
        split["compaction_s"] = 0.0
    else:
        raise ValueError(f"unknown table state {state!r}")
    return split


def run_cell(args, t_start: float, device, overrides=None,
             plant=None, make_system=None, repo: str = REPO) -> dict:
    """One run; the result's dict (with "checks" last). `overrides`
    replace configuration keys (the tests' small sizes); `plant(system,
    loop)` breaks the timed path before the window, and `make_system`
    puts another system in the program's place (core/faults.py); `repo`
    is where BENCHMARK.json and the cell's files are. A cell whose
    traffic file names a `runner` is run by runners/<runner>.py."""
    parts = cell_parts(load_spec(os.path.join(repo, "BENCHMARK.json")),
                       args.workload, repo)
    if "runner" in parts["traffic"]:
        return runner(parts["traffic"]["runner"],
                      os.path.join(repo, "benchmark")).run_cell(
            args, t_start, device, parts, overrides, plant, repo)
    config = dict(parts["config"], **(overrides or {}))
    traffic = parts["traffic"]
    from benchmark.core import probe
    from benchmark.core.loop import Loop
    from benchmark.core.gen import Dataset, Requests
    from benchmark.core.system import System, build_kernels, set_store_flags
    from benchmark.reference.judge import checks_for, judge
    from benchmark.reference.kv import Table

    import pegasus_tpu_torch.client.cluster_client  # noqa: F401
    import pegasus_tpu_torch.tools.cluster  # noqa: F401

    split = {"imports_s": time.perf_counter() - t_start}
    split["build_s"] = build_kernels(device)
    set_store_flags(config["store"])
    data_dir = tempfile.mkdtemp(prefix="pegasus-bench-")
    system = None
    try:
        data = Dataset(config, args.seed)
        system = (make_system or System)(config, device, data_dir,
                                         args.seed)
        system.data = data
        split.update(load_table(system, data, traffic["table_state"]))
        t0 = time.perf_counter()
        client = system.open_client()
        loop = Loop(client, Requests(traffic, data, args.seed), data)
        if plant is not None:
            plant(system, loop)
        for _ in range(int(traffic["warmup_calls"])):
            loop.step()
        sync(device)
        split["warmup_s"] = time.perf_counter() - t0
        state0 = system.lsm_state()
        gc.collect()
        run = Run()
        run.setup_s = time.perf_counter() - t_start
        log("setup split: " + json.dumps(split))
        loop.reset_window()
        before = probe.counters()
        with TraceHooks(device, args.trace) as hooks:
            t0 = time.perf_counter()
            end = t0 + args.seconds
            while time.perf_counter() < end:
                loop.step(hooks.span)
            sync(device)
            run.window_s = time.perf_counter() - t0
        run.counters = probe.delta(probe.counters(), before)
        hooks.fill(run)
        run.walls, run.done = loop.walls, loop.done
        log("requests sent in each half of the window: "
            + json.dumps(halves(loop.ends, t0 + run.window_s / 2)))
        state1 = system.lsm_state()
        log(f"table state at the window's start {json.dumps(state0)}, "
            f"at its end {json.dumps(state1)}")
        peak = memory_peak(device)
        device_info = describe(device, peak)
        attempted, failed = loop.attempted, loop.failed
        raw_log = loop.finish_log()
        kinds = sorted(traffic["mix"])
        system.close()
        system = None
        # the plain reference, after the program's state is freed
        t0 = time.perf_counter()
        table = Table(data.hashkeys, data.fields, data.expired,
                      data.partitions, data.value_bytes)
        faults = judge(table, raw_log)
        faults["runs_changed"] = int(
            (state0["l0_runs"], state0["l1_runs"])
            != (state1["l0_runs"], state1["l1_runs"]))
        log(f"reference judged {len(raw_log)} requests in "
            f"{time.perf_counter() - t0} s")
    finally:
        if system is not None:
            system.close()
        shutil.rmtree(data_dir, ignore_errors=True)

    checks = {name: {"value": faults[name], "limit": 0}
              for name in checks_for(kinds) + ["runs_changed"]}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    group = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in parts[group]:
        value = reader(m["name"], os.path.join(repo, "benchmark"))(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if args.trace:
        device_info["busy_s"] = run.trace.get("busy_s", 0.0)
        device_info["window_s"] = run.trace_window_s
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_info}
    if args.trace and run.trace:
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["checks"] = checks
    # last, once every reader has run: nothing of the JAX stack loaded
    bad = forbidden_loaded()
    if bad:
        raise ForbiddenModules(bad)
    return out


def halves(ends: list, middle: float) -> dict:
    """kind -> [requests whose call ended in the window's first half,
    in its second]: whether the rate holds over the window."""
    out: dict = {}
    for t, kind, n in ends:
        out.setdefault(kind, [0, 0])[t > middle] += n
    return out


class ForbiddenModules(RuntimeError):
    def __init__(self, names) -> None:
        super().__init__("loaded in the measuring process: "
                         + ", ".join(names))
        self.names = names


class TraceHooks:
    """In a traced run: the task profiler's exec sums, the scan
    launches' shapes and the device trace, around the window."""

    def __init__(self, device, on: int) -> None:
        from benchmark.core import probe

        self.on = bool(on)
        self.parts = ([probe.ExecWall(), probe.ScanLaunches(),
                       probe.DeviceTrace(device)] if self.on else [])

    def __enter__(self):
        for p in self.parts:
            p.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        for p in reversed(self.parts):
            p.__exit__(*exc)

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return self.parts[2].span(name)

    def fill(self, run: Run) -> None:
        if not self.on:
            return
        wall, launches, trace = self.parts
        run.exec_ms, run.exec_count = wall.ms, wall.count
        run.launch_shapes = launches.shapes
        run.trace = trace.summary
        run.trace_window_s = trace.window_s


def sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    if device.type != "cuda":
        return 0
    import torch

    return int(torch.cuda.max_memory_allocated(device))


def describe(device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": peak}


def print_result(out: dict) -> None:
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(out), flush=True)


def main(argv=None, t_start: float = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    set_cache_dirs()
    try:
        parts = cell_parts(load_spec(), args.workload)
    except (KeyError, OSError, ValueError) as e:
        log(f"benchmark: {e}")
        return 2
    import torch

    need = int(parts["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"benchmark: the cell needs {need} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    try:
        out = run_cell(args, t_start, torch.device("cuda", 0))
    except ForbiddenModules as e:
        log(f"benchmark: {e}")
        return 4
    print_result(out)
    return 0
