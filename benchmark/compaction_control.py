"""Run a compaction cell with a fault planted under its timed path, or
with the control in the program's place, and print the result: `correct`
has to come out false. Not part of a benchmark run.

    python3 benchmark/compaction_control.py --workload <cell> --seed <n> \\
        --seconds <s> --fault <control or a fault of runners/compaction.py>

The control is the plain reference compaction (reference/compaction.
survivors) judging TTLs an hour late: records expired 100 s before the
pass are kept (the configuration's TTL guarantee broken). The faults are
runners/compaction.FAULTS, planted in the port after the warm-up.
"""

import argparse
import os
import sys
import time

T_START = time.perf_counter()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark.core import harness  # noqa: E402

RUNNER = harness.runner("compaction")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", required=True,
                    choices=["control"] + sorted(RUNNER.FAULTS))
    a = ap.parse_args(argv)
    harness.set_cache_dirs()
    import torch

    args = harness.parse(["--workload", a.workload, "--seed", str(a.seed),
                          "--seconds", str(a.seconds), "--trace", "0"])
    plant = (RUNNER.plant_control if a.fault == "control"
             else RUNNER.FAULTS[a.fault])
    out = harness.run_cell(args, T_START, torch.device("cuda", 0),
                           plant=plant)
    harness.print_result(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
