"""One run of one cell read by the task profiler's stages.

    python3 benchmark/stage_trace.py --workload <cell> --seed <n> \\
        --seconds <s> [--profiler-only]

from the root of a checkout on a machine with the cell's CUDA devices.
By default the run is run.py's `--trace 1` run, and the device trace is
also read by stage (`core/stages.read_trace`): the device's idle seconds
each stage's host ranges cover, and the largest idle gaps named by the
stage that covers most of each. With `--profiler-only` the window is
untraced, as run.py's `--trace 0`, with the task profiler on from the
start: what the stages cost while they are on; its stage line holds
the profiler's dump rows (every code's count over the process). The
result's JSON line is printed as run.py prints it, then a line
{"stages": ...}.
"""

import argparse
import contextlib
import json
import os
import sys
import time

T_START = time.perf_counter()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark.core import harness, probe, stages  # noqa: E402


@contextlib.contextmanager
def reading_stages(report: dict):
    """While open, every trace the harness summarizes is also read by
    stage into `report`; `probe.summarize` is put back after."""
    summarize = probe.summarize

    def by_stage(events):
        events = list(events)
        report.update(stages.read_trace(events))
        return summarize(events)

    probe.summarize = by_stage
    try:
        yield report
    finally:
        probe.summarize = summarize


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--profiler-only", action="store_true")
    opts = ap.parse_args(argv)
    harness.set_cache_dirs()
    import torch

    from pegasus_tpu_torch.utils.profiler import PROFILER

    report: dict = {}
    args = harness.parse([
        "--workload", opts.workload, "--seed", str(opts.seed),
        "--seconds", str(opts.seconds),
        "--trace", "0" if opts.profiler_only else "1"])
    if opts.profiler_only:
        PROFILER.enable()
        out = harness.run_cell(args, T_START, torch.device("cuda", 0))
        report["dump"] = PROFILER.dump()
    else:
        with reading_stages(report):
            out = harness.run_cell(args, T_START, torch.device("cuda", 0))
    harness.print_result(out)
    print(json.dumps({"stages": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
