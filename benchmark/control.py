"""Run one cell with a fault planted under the timed path, or with the
control in the program's place, and print the result: `correct` has to
come out false. Not part of a benchmark run.

    python3 benchmark/control.py --workload <cell> --seed <n> \\
        --seconds <s> --fault <control or a fault of core/faults.py>

The control is the plain reference serving the records written already
expired as live (one guarantee of the configuration broken); the
faults are those of core/faults.py, planted in the port's client.
"""

import argparse
import os
import sys
import time

T_START = time.perf_counter()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark.core import faults, harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", required=True,
                    choices=["control"] + sorted(faults.FAULTS))
    a = ap.parse_args(argv)
    harness.set_cache_dirs()
    import torch

    args = harness.parse(["--workload", a.workload, "--seed", str(a.seed),
                          "--seconds", str(a.seconds), "--trace", "0"])
    if a.fault == "control":
        out = harness.run_cell(args, T_START, torch.device("cuda", 0),
                               make_system=faults.ControlSystem)
    else:
        out = harness.run_cell(args, T_START, torch.device("cuda", 0),
                               plant=faults.FAULTS[a.fault])
    harness.print_result(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
