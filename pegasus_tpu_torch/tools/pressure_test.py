"""Pressure tier: sustained mixed load with online data verification.

Parity: src/test/pressure_test/ (sustained load generator with per-case
qps control) + src/test/kill_test/data_verifier.cpp (every acked write
must stay readable with its exact value) — run for MINUTES against the
multi-process onebox, not seconds, reporting ops/s over time.

Workload mix per loop iteration (YCSB-A-flavoured, configurable):
    set / get / del / multi_get / scan over a growing sequenced keyspace
with continuous verification: reads check the exact last-acked value,
scans check ordering + membership of the sampled hashkey. Any
divergence is a consistency VIOLATION and fails the run.

CLI:
    python -m pegasus_tpu_torch.tools.pressure_test --dir D --duration 300 \
        [--qps 0 (unthrottled)] [--report-every 10]

Output: one JSON line per report interval
    {"t": s, "ops": n, "ops_per_s": r, "violations": 0, ...}
and a final summary line. Exit code 1 on any violation.

The CI smoke (tests/test_pressure.py) runs the same loop for a few
seconds in-process; this module is the minutes-long operator tier.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from typing import Dict, List

from pegasus_tpu_torch.utils.errors import PegasusError


class PressureWorkload:
    """One client's mixed-op loop with online verification.

    Keeps an acked-model: hashkey -> {sortkey: value} mirroring every
    acknowledged mutation; every read verifies against it. The model IS
    the verifier (data_verifier.cpp's expectation table)."""

    def __init__(self, client, seed: int = 0,
                 mix=(("set", 40), ("get", 35), ("multi_get", 10),
                     ("scan", 10), ("del", 5))) -> None:
        self.client = client
        self.rng = random.Random(seed)
        self.model: Dict[bytes, Dict[bytes, bytes]] = {}
        # O(1) random sampling over a growing/shrinking keyspace:
        # parallel list + index map, swap-remove on delete (list(model)
        # per op would make the LOAD GENERATOR quadratic over a long
        # run and read as a server throughput regression)
        self._hk_list: List[bytes] = []
        self._hk_idx: Dict[bytes, int] = {}
        self.seq = 0
        self.ops = 0
        self.rejected = 0
        self.violations: List[str] = []
        self._ops, weights = zip(*mix)
        self._weights = list(weights)

    # ---- model maintenance --------------------------------------------

    def _track(self, hk: bytes) -> None:
        if hk not in self._hk_idx:
            self._hk_idx[hk] = len(self._hk_list)
            self._hk_list.append(hk)

    def _untrack(self, hk: bytes) -> None:
        i = self._hk_idx.pop(hk, None)
        if i is None:
            return
        last = self._hk_list.pop()
        if last != hk:
            self._hk_list[i] = last
            self._hk_idx[last] = i

    def _adopt(self, hk: bytes, sk: bytes) -> None:
        """A write/delete raised (e.g. timeout): the outcome is
        AMBIGUOUS — it may have committed. Re-read and adopt the
        store's answer as the expectation, so a committed-but-unacked
        mutation is not later reported as a false corruption
        (kill_test's verifier sidesteps this by never overwriting;
        this mixed workload overwrites constantly)."""
        self.rejected += 1
        try:
            err, got = self.client.get(hk, sk)
        except PegasusError:
            # still unreachable: stop verifying this sort key
            sks = self.model.get(hk)
            if sks is not None:
                sks.pop(sk, None)
                if not sks:
                    self.model.pop(hk, None)
                    self._untrack(hk)
            return
        if err == 0:
            self.model.setdefault(hk, {})[sk] = got
            self._track(hk)
        else:
            sks = self.model.get(hk)
            if sks is not None:
                sks.pop(sk, None)
                if not sks:
                    self.model.pop(hk, None)
                    self._untrack(hk)

    # ---- op implementations -------------------------------------------

    def _hk(self, existing: bool) -> bytes:
        if existing and self._hk_list:
            return self._hk_list[self.rng.randrange(len(self._hk_list))]
        self.seq += 1
        return b"pt%07d" % self.seq

    def _op_set(self) -> None:
        hk = self._hk(self.rng.random() < 0.5)
        sk = b"s%02d" % self.rng.randrange(8)
        value = b"v%d.%d" % (self.seq, self.rng.randrange(1 << 20))
        try:
            if self.client.set(hk, sk, value) == 0:
                self.model.setdefault(hk, {})[sk] = value
                self._track(hk)
            else:
                self.rejected += 1
        except PegasusError:
            self._adopt(hk, sk)

    def _op_del(self) -> None:
        if not self.model:
            return
        hk = self._hk(True)
        sks = self.model.get(hk)
        if not sks:
            return
        sk = next(iter(sks))
        try:
            if self.client.delete(hk, sk) == 0:
                sks.pop(sk, None)
                if not sks:
                    self.model.pop(hk, None)
                    self._untrack(hk)
            else:
                self.rejected += 1
        except PegasusError:
            self._adopt(hk, sk)

    def _op_get(self) -> None:
        if not self.model:
            return
        hk = self._hk(True)
        sks = self.model.get(hk)
        if not sks:
            return
        sk = self.rng.choice(list(sks))
        want = sks[sk]
        try:
            err, got = self.client.get(hk, sk)
        except PegasusError:
            self.rejected += 1
            return
        if err != 0 or got != want:
            self.violations.append(
                f"get {hk!r}/{sk!r}: want {want!r}, got err={err} "
                f"{got!r}")

    def _op_multi_get(self) -> None:
        if not self.model:
            return
        hk = self._hk(True)
        want = self.model.get(hk)
        if not want:
            return
        try:
            err, got = self.client.multi_get(hk)
        except PegasusError:
            self.rejected += 1
            return
        if err != 0 or got != want:
            self.violations.append(
                f"multi_get {hk!r}: want {len(want)} kvs, got err={err} "
                f"{len(got)} kvs")

    def _op_scan(self) -> None:
        if not self.model:
            return
        hk = self._hk(True)
        want = self.model.get(hk)
        if not want:
            return
        try:
            scanner = self.client.get_scanner(hk)
            got = {sk: v for _hk, sk, v in scanner}
        except (PegasusError, RuntimeError):
            self.rejected += 1
            return
        if got != want:
            self.violations.append(
                f"scan {hk!r}: want {len(want)} rows, got {len(got)}")

    # ---- loop ----------------------------------------------------------

    def step(self) -> None:
        op = self.rng.choices(self._ops, weights=self._weights)[0]
        getattr(self, f"_op_{op}")()
        self.ops += 1


def run(client, duration_s: float, qps: float = 0.0,
        report_every: float = 10.0, seed: int = 0,
        out=sys.stdout) -> dict:
    """Drive the workload for `duration_s`; returns the summary dict."""
    w = PressureWorkload(client, seed=seed)
    t0 = time.monotonic()
    next_report = t0 + report_every
    last_ops = 0
    last_t = t0
    series = []
    while True:
        now = time.monotonic()
        if now - t0 >= duration_s:
            break
        w.step()
        if qps > 0:
            # crude rate limit: sleep off any lead over the target rate
            lead = w.ops / qps - (now - t0)
            if lead > 0.002:
                time.sleep(lead)
        if now >= next_report:
            rate = (w.ops - last_ops) / max(now - last_t, 1e-9)
            rec = {"t": round(now - t0, 1), "ops": w.ops,
                   "ops_per_s": round(rate, 1),
                   "rejected": w.rejected,
                   "violations": len(w.violations),
                   "keys": len(w.model)}
            print(json.dumps(rec), file=out, flush=True)
            series.append(rec)
            last_ops, last_t = w.ops, now
            next_report = now + report_every
    elapsed = time.monotonic() - t0
    summary = {
        "summary": True,
        "duration_s": round(elapsed, 1),
        "ops": w.ops,
        "ops_per_s": round(w.ops / max(elapsed, 1e-9), 1),
        "rejected": w.rejected,
        "violations": len(w.violations),
        "violation_samples": w.violations[:5],
        "keys": len(w.model),
        "series": series,
    }
    print(json.dumps(summary), file=out, flush=True)
    return summary


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default=None,
                    help="onebox directory (tools/onebox_cluster)")
    ap.add_argument("--app", default="pressure")
    ap.add_argument("--duration", type=float, default=300.0)
    ap.add_argument("--qps", type=float, default=0.0,
                    help="target ops/s (0 = unthrottled)")
    ap.add_argument("--report-every", type=float, default=10.0)
    ap.add_argument("--partitions", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from pegasus_tpu_torch.tools import onebox_cluster as ob

    d = args.dir or ob.DEFAULT_DIR
    admin = ob.OneboxAdmin(d)
    try:
        admin.create_table(args.app, partition_count=args.partitions)
    except PegasusError:
        pass  # already exists: keep pressing the same table
    admin.close()
    client = ob.connect(args.app, d)
    summary = run(client, args.duration, qps=args.qps,
                  report_every=args.report_every, seed=args.seed)
    sys.exit(1 if summary["violations"] else 0)


if __name__ == "__main__":
    main()
