"""A/B of chip_smoke.py's phase 5 (the batched YCSB-E scan path) between
this checkout and another one, on one card, with a host-speed probe.

    python3 ab_batched.py OTHER_DIR [--order ABBAAB]

Each letter of `--order` is one run in a fresh process: A is OTHER_DIR's
`chip_smoke.run_batched`, B this checkout's, both at their default size
on the card (`--device cpu --records 40000 --ops 2000` for a quick
check on the CPU).
A run reports the flush wall (the sum of its `scan_multi` calls: the
server time of phase 5 without its inserts, plus the steady state's few
flushes), scans/s over it, and a probe: one fixed pure-Python workload,
timed before every 64th flush and summed. Phase 5 is host-bound, so
where two runs differ in scans/s and their probes differ alike, the
host's speed moved, not the code. Prints one JSON object per run and a
summary as the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


PROBE_EVERY = 64  # flushes


def probe() -> float:
    """Seconds of a fixed pure-Python workload (byte formatting, dict and
    integer work, as the scan path's host code does)."""
    t = time.perf_counter()
    acc = {}
    for i in range(30_000):
        k = b"user%08d" % i
        acc[k[-3:]] = (acc.get(k[-3:], 0) * 31 + len(k) + i) & 0xFFFFFFFF
    return time.perf_counter() - t


def child(tree: str, device: str, records: int, ops: int) -> dict:
    sys.path.insert(0, tree)
    import torch

    import chip_smoke
    from pegasus_tpu_torch.server import scan_coordinator

    orig = scan_coordinator.scan_multi
    st = {"wall": 0.0, "scans": 0, "flushes": 0, "probe": 0.0}

    def timed(batches, *a, **k):
        if st["flushes"] % PROBE_EVERY == 0:
            st["probe"] += probe()
        st["flushes"] += 1
        st["scans"] += sum(len(reqs) for _s, reqs in batches)
        t = time.perf_counter()
        try:
            return orig(batches, *a, **k)
        finally:
            st["wall"] += time.perf_counter() - t

    scan_coordinator.scan_multi = timed
    # the store flags chip_smoke.py's main pins for phase 5
    with chip_smoke.store_flags(chip_smoke.NONE_STORE):
        chip_smoke.run_batched(torch.device(device),
                               records or chip_smoke.BATCHED_RECORDS,
                               n_ops=ops or chip_smoke.BATCHED_OPS)
    return {"flush_wall_s": st["wall"], "scans": st["scans"],
            "flushes": st["flushes"], "scans_per_s": st["scans"] / st["wall"],
            "probe_s": st["probe"]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("other", help="the other checkout (run A)")
    parser.add_argument("--order", default="ABBAAB")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--records", type=int, default=0)
    parser.add_argument("--ops", type=int, default=0)
    parser.add_argument("--child", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        print(json.dumps(child(os.path.abspath(args.other), args.device,
                               args.records, args.ops)))
        return 0
    trees = {"A": os.path.abspath(args.other), "B": HERE}
    runs = []
    for run in args.order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), trees[run],
             "--child", "--device", args.device, "--records",
             str(args.records), "--ops", str(args.ops)],
            cwd=trees[run], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        out["run"] = run
        runs.append(out)
        print(json.dumps(out), flush=True)
    print(json.dumps({run: {
        "scans_per_s": [r["scans_per_s"] for r in runs if r["run"] == run],
        "probe_s": [r["probe_s"] for r in runs if r["run"] == run]}
        for run in "AB"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
