"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout on a machine with the CUDA devices the cell
asks for. The last line of standard output is the result's JSON object.
"""

import os
import sys
import time

T_START = time.perf_counter()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark.core.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
