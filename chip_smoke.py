#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pegasus_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles csrc/scan_predicate.cu with nvcc for sm_90a;
3. kernel vs plain: the scan-predicate kernel against its plain torch
   version on seeded random blocks at the serving shapes (B = 1024 and a
   16 x 1024 stack, K in {32, 64, 256}), every hash x sort filter type,
   empty and over-long patterns, malformed rows, validation off / scalar
   pidx / per-record pidx, with and without `now`; bit-identical status
   bytes required; times both on the card;
4. the slice: one PartitionServer on the card as partition 0 of a
   64-partition YCSB-E table, loaded in bench.py's layout, compacted,
   then serving YCSB-E traffic (95% scans / 5% inserts, zipfian start
   keys, scan length uniform in 1..100) plus gets and multi_gets; every
   response is checked against a host oracle, and both predicate modes
   (columnar static masks, merge path with `now`) must launch the kernel.

The line before the last lists the kernels as JSON; the last line is
{"ok": true, "device": {...}}. `--records N` cuts the load (default
1,000,000 records of partition 0) and says so in its output.
"""

from __future__ import annotations

import argparse
import bisect
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
SCALAR_OPS_PER_S = 67e12    # H100 SXM non-tensor peak (float32 rate)

PARTITION_COUNT = 64
PIDX = 0
FULL_RECORDS = 1_000_000
SCAN_OPS = 2000    # scans of the first columnar phase
MIXED_OPS = 2000   # operations of the YCSB-E mix (95% scans, 5% inserts)
SORT_KEYS = [b"s%02d" % i for i in range(10)]


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---- seeded blocks for the kernel-vs-plain comparison ------------------

ALPHABET = np.frombuffer(b"abcd", dtype=np.uint8)


def random_block_columns(rng, b: int, k: int):
    """numpy columns (keys uint8[b, k], key_len int32, expire_ts uint32,
    hash_lo uint32) of a block that exercises every predicate edge:
    empty and non-empty hashkeys over a 4-letter alphabet, ~3% padding
    rows, ~3% rows shorter than the 2-byte header (invalid), ~6% rows
    whose header claims more hashkey bytes than the row holds (up to 40
    past it), expire_ts of 0, past, future and >= 2^31."""
    from pegasus_tpu_torch.ops.record_block import hash_lo_column

    keys = np.zeros((b, k), dtype=np.uint8)
    key_len = np.zeros(b, dtype=np.int32)
    kind = rng.random(b)
    for i in range(b):
        if kind[i] < 0.03:
            continue  # padding row
        if kind[i] < 0.06:
            key_len[i] = int(rng.integers(0, 2))  # a zero byte or none
            continue
        n = int(rng.integers(2, k + 1))
        body = rng.choice(ALPHABET, n - 2)
        hkl = int(rng.integers(0, n - 1)) if rng.random() < 0.9 else 0
        if kind[i] < 0.12:
            hkl = n - 2 + int(rng.integers(1, 41))  # malformed header
        keys[i, 0], keys[i, 1] = hkl >> 8, hkl & 0xFF
        keys[i, 2:n] = body
        key_len[i] = n
    ets = rng.choice(np.array([0, 0, 100, 299_999_999, 300_000_000,
                               300_000_001, 0x7FFFFFFF, 0x80000000,
                               0x80000010, 0xFFFFFFF0], dtype=np.uint32), b)
    return keys, key_len, ets, hash_lo_column(keys, key_len)


def random_pattern(rng, n: int) -> bytes:
    return rng.choice(ALPHABET, n).tobytes()


def predicate_cases(rng, k: int):
    """(hash_ft, hash_pat, sort_ft, sort_pat) over every pair of filter
    types, each with a short pattern, an empty one and one longer than
    any region of a row of width k."""
    for hft in range(4):
        for sft in range(4):
            for variant in ("short", "empty", "long"):
                if variant == "short":
                    hp = random_pattern(rng, int(rng.integers(1, 3)))
                    sp = random_pattern(rng, int(rng.integers(1, 3)))
                elif variant == "empty":
                    hp = sp = b""
                else:
                    hp = random_pattern(rng, k + 8)
                    sp = random_pattern(rng, k - 1)
                yield hft, hp, sft, sp


# ---- phase 3 -----------------------------------------------------------


def _cuda_ms(fn, iters: int) -> float:
    """Milliseconds per call between CUDA events around `iters` calls: the
    time a caller pays, host-side launch overhead included."""
    import torch

    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _device_ms(fn, iters: int, kernel: str = ""):
    """Device milliseconds per call from torch.profiler's CUDA trace: the
    kernels' own time, without the host gaps between launches. `kernel`
    keeps only kernels whose name holds it (all kernels when empty).
    None when the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        if kernel in ev.key:
            total_us += getattr(ev, "self_device_time_total", 0.0)
    return total_us / iters / 1e3 if total_us > 0 else None


def kernel_bound(b: int, k: int, per_record_pidx: bool, ops_per_row: int):
    """(bound_ms, bound_by): each input byte read once, each status byte
    written once, over HBM; the integer work over the non-tensor peak.
    Per record: the key row, key_len, hashkey_len, expire_ts and hash_lo
    at 4 B each, valid at 1 B, a per-record pidx at 4 B when given."""
    col_bytes = 4 + 4 + 4 + 4 + 1 + (4 if per_record_pidx else 0)
    nbytes = b * (k + col_bytes + 1)
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = b * ops_per_row / SCALAR_OPS_PER_S * 1e3
    return (mem_ms, "bytes") if mem_ms >= ops_ms else (ops_ms, "operations")


def kernel_vs_plain(device, shapes, time_it: bool = True) -> dict:
    """Phase 3: hold the kernel against the plain version on the card.
    Returns the comparison counts, the largest status difference and
    the timings at the serving shapes."""
    import torch

    from pegasus_tpu_torch.ops import fused_scan
    from pegasus_tpu_torch.ops.predicates import FilterSpec
    from pegasus_tpu_torch.ops.record_block import _to_block

    rng = np.random.default_rng(20261016)
    pv = 7
    compared = 0
    max_err = 0
    for b, k, stack in shapes:
        keys, key_len, ets, hash_lo = random_block_columns(rng, b * stack, k)
        hkl = (keys[:, 0].astype(np.int32) << 8) | keys[:, 1]
        hkl = np.where(key_len >= 2, hkl, 0)
        block = _to_block(keys, key_len, hkl, ets, key_len >= 2, hash_lo,
                          device)
        owned = rng.random(b * stack) < 0.5
        pidx_col = torch.from_numpy(np.where(
            owned, hash_lo & pv, rng.integers(0, pv + 1, b * stack)
        ).astype(np.int32)).to(device)
        pidx_modes = [(False, 0), (True, int(rng.integers(0, pv + 1))),
                      (True, pidx_col)]
        for hft, hp, sft, sp in predicate_cases(rng, k):
            hf = FilterSpec.make(hft, hp, device)
            sf = FilterSpec.make(sft, sp, device)
            for validate, pidx in pidx_modes:
                for now in (None, 300_000_000, 0x80000010):
                    got = fused_scan.scan_status(block, hf, sf, validate,
                                                 pidx, pv, now)
                    want = fused_scan.scan_status_plain(
                        block, hf, sf, validate, pidx, pv, now)
                    err = int((got.int() - want.int()).abs().max())
                    max_err = max(max_err, err)
                    if err:
                        fail(f"kernel != plain: B={b}x{stack} K={k} "
                             f"hft={hft} hp={hp!r} sft={sft} sp={sp!r} "
                             f"validate={validate} now={now}")
                    compared += 1
    if device.type == "cuda":
        torch.cuda.synchronize()
    out = {"compared": compared, "max_abs_err": max_err, "timings": []}
    if not time_it:
        return out
    none = FilterSpec.none(device)
    for b, stack, per_record in ((1024, 1, False), (1024, 16, True)):
        n = b * stack
        keys, key_len, ets, hash_lo = random_block_columns(rng, n, 32)
        hkl = (keys[:, 0].astype(np.int32) << 8) | keys[:, 1]
        block = _to_block(keys, key_len, np.where(key_len >= 2, hkl, 0),
                          ets, key_len >= 2, hash_lo, device)
        pidx = (torch.from_numpy((hash_lo & pv).astype(np.int32)).to(device)
                if per_record else 0)
        now = None if per_record else 300_000_000

        def kernel():
            fused_scan._launch(block, none, none, True, pidx, pv, now)

        def plain():
            fused_scan.scan_status_plain(block, none, none, True, pidx, pv,
                                         now)

        bound_ms, bound_by = kernel_bound(n, 32, per_record, 12)
        out["timings"].append({
            "shape": f"B={n} K=32 " + ("stacked static, per-record pidx"
                                       if per_record else
                                       "merge batch with now"),
            "ms": _device_ms(kernel, 200, "scan_predicate_kernel"),
            "plain_ms": _device_ms(plain, 50),
            "call_ms": _cuda_ms(kernel, 200),
            "plain_call_ms": _cuda_ms(plain, 50),
            "bound_ms": bound_ms, "bound_by": bound_by})
        if None in (out["timings"][-1]["ms"], out["timings"][-1]["plain_ms"]):
            fail("torch.profiler recorded no device time")
    return out


# ---- phase 4: the slice ------------------------------------------------


def _user_keys(lo: int, hi: int) -> np.ndarray:
    """uint8[n, 12] rows b"user%08d" for h in [lo, hi)."""
    h = np.arange(lo, hi, dtype=np.int64)
    rows = np.empty((h.size, 12), dtype=np.uint8)
    rows[:, :4] = np.frombuffer(b"user", dtype=np.uint8)
    for d in range(8):
        rows[:, 11 - d] = ord("0") + (h // 10 ** d) % 10
    return rows


def partition_hashkeys(count: int, start: int = 0, pidx: int = PIDX):
    """The first `count` hashkeys user%08d, from h = start, that route to
    `pidx` (crc64(hashkey) % PARTITION_COUNT, bench.py's routing)."""
    from pegasus_tpu_torch.base.crc import crc64_batch

    out: list = []
    lo = start
    chunk = 1 << 20
    while len(out) < count:
        rows = _user_keys(lo, lo + chunk)
        lens = np.full(rows.shape[0], 12, dtype=np.int64)
        route = crc64_batch(rows, lens) % np.uint64(PARTITION_COUNT)
        for i in np.flatnonzero(route == np.uint64(pidx)):
            out.append(rows[i].tobytes())
            if len(out) == count:
                break
        lo += chunk
    return out


class Oracle:
    """What the partition must serve: owned, unexpired records in key
    order, with the scan rules applied on the host.

    A one-page scan is answered exactly, iteration budget included
    (range_read_limiter.h: a ranged read stops once it has examined
    `rocksdb_max_iteration_count` records). Which records count depends
    on the path: with an overlay (memtable or L0) the merge path examines
    stored records one by one, those the partition does not serve
    included; on a pure-L1 store the columnar path charges whole windows
    of LOOKAHEAD SST blocks up front and stops after the first block
    that leaves the budget spent. The block layout is taken from the
    store's run metadata after each compaction and checked against the
    oracle's own keys."""

    def __init__(self, budget: int, lookahead: int) -> None:
        self.budget = budget
        self.lookahead = lookahead
        self.keys: list = []
        self.values: dict = {}
        self.hidden: list = []    # stored, never served (foreign hash)
        self.overlay = True       # no compaction yet
        self.block_starts: list = []

    def put(self, key: bytes, value: bytes) -> None:
        if key not in self.values:
            bisect.insort(self.keys, key)
        self.values[key] = value
        self.overlay = True

    def hide(self, key: bytes) -> None:
        bisect.insort(self.hidden, key)
        self.overlay = True

    def compacted(self, runs) -> None:
        """After a manual compaction: the hidden records and the expired
        ones are gone, and the L1 blocks hold exactly the served keys."""
        metas = [bm for run in runs for bm in run.blocks]
        starts = np.cumsum([0] + [bm.count for bm in metas]).tolist()
        if starts[-1] != len(self.keys) or any(
                self.keys[i] != bm.first_key
                for i, bm in zip(starts, metas)):
            fail(f"compacted store holds {starts[-1]} records in "
                 f"{len(metas)} blocks; the oracle has {len(self.keys)}")
        self.block_starts = starts
        self.hidden = []
        self.overlay = False

    def _passes(self, key: bytes, filters) -> bool:
        from pegasus_tpu_torch.base.key_schema import restore_key
        from pegasus_tpu_torch.ops.predicates import host_match_filter

        hft, hp, sft, sp = filters
        hk, sk = restore_key(key)
        return (host_match_filter(hk, hft, hp)
                and host_match_filter(sk, sft, sp))

    def scan(self, start: bytes, limit: int, filters) -> list:
        """Up to `limit` records from `start` that pass the filters, with
        no iteration budget (what a client paging to the end sees)."""
        out = []
        for i in range(bisect.bisect_left(self.keys, start), len(self.keys)):
            if len(out) == limit:
                break
            if self._passes(self.keys[i], filters):
                out.append((self.keys[i], self.values[self.keys[i]]))
        return out

    def page(self, start: bytes, limit: int, filters) -> list:
        """Exactly what one page of a scan from `start` returns."""
        keys = self.keys
        i = bisect.bisect_left(keys, start)
        out: list = []

        def take(idx: int) -> bool:
            if self._passes(keys[idx], filters):
                out.append((keys[idx], self.values[keys[idx]]))
            return len(out) == limit

        if self.overlay:
            h = bisect.bisect_left(self.hidden, start)
            examined = 0
            while examined < self.budget and (i < len(keys)
                                              or h < len(self.hidden)):
                examined += 1
                if h < len(self.hidden) and (i == len(keys)
                                             or self.hidden[h] < keys[i]):
                    h += 1
                    continue
                i += 1
                if take(i - 1):
                    break
            return out
        starts = self.block_starts
        j = bisect.bisect_right(starts, i) - 1
        charged = 0
        while j < len(starts) - 1:
            window = range(j, min(j + self.lookahead, len(starts) - 1))
            charged += sum(starts[w + 1] - max(i, starts[w]) for w in window)
            for w in window:
                for idx in range(max(i, starts[w]), starts[w + 1]):
                    if take(idx):
                        return out
                if charged >= self.budget:
                    return out
            j = window[-1] + 1
        return out


def check_page(resp, oracle: Oracle, start: bytes, limit: int,
               filters=(0, b"", 0, b"")) -> bool:
    """A one-page scan must return exactly the oracle's page. Returns
    whether the page was full."""
    if resp.error != 0:
        fail(f"scan error {resp.error}")
    got = [(kv.key, kv.value) for kv in resp.kvs]
    want = oracle.page(start, limit, filters)
    if got != want:
        fail(f"scan from {start!r} limit {limit} filters {filters} "
             f"({'merge' if oracle.overlay else 'columnar'} path): "
             f"got {len(got)} records {got[:3]}..., want {len(want)} "
             f"{want[:3]}...")
    return len(got) == limit


class GcPauses:
    """The interpreter's garbage-collection pauses, from gc.callbacks."""

    def __init__(self) -> None:
        self.count = 0
        self.total_s = 0.0
        self.longest_s = 0.0
        self._t0 = 0.0
        gc.callbacks.append(self._callback)

    def _callback(self, phase: str, _info) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
            return
        pause = time.perf_counter() - self._t0
        self.count += 1
        self.total_s += pause
        self.longest_s = max(self.longest_s, pause)

    def reset(self) -> None:
        self.count, self.total_s, self.longest_s = 0, 0.0, 0.0

    def close(self) -> None:
        gc.callbacks.remove(self._callback)


def zipf_ranks(rng, n_items: int, size: int, theta: float = 0.99):
    """YCSB's bounded zipfian (constant 0.99) over n_items ranks."""
    cdf = np.cumsum(1.0 / np.arange(1, n_items + 1) ** theta)
    return np.searchsorted(cdf / cdf[-1], rng.random(size))


def percentiles(lat_s: list) -> str:
    a = np.asarray(lat_s) * 1e3
    return (f"p50 {np.percentile(a, 50)} ms, "
            f"p99 {np.percentile(a, 99)} ms")


def run_slice(device, n_records: int, seed: int = 7,
              card: str = "") -> dict:
    """Phase 4. Returns the kernel launches by mode."""
    from pegasus_tpu_torch.base.key_schema import (
        generate_key,
        key_hash_parts,
    )
    from pegasus_tpu_torch.base.value_schema import epoch_now
    from pegasus_tpu_torch.ops import fused_scan
    from pegasus_tpu_torch.utils.flags import FLAGS
    from pegasus_tpu_torch.ops.predicates import (
        FT_MATCH_ANYWHERE,
        FT_MATCH_POSTFIX,
        FT_MATCH_PREFIX,
    )
    from pegasus_tpu_torch.server.partition_server import (
        LOOKAHEAD,
        PartitionServer,
    )
    from pegasus_tpu_torch.server.types import (
        GetScannerRequest,
        KeyValue,
        MultiGetRequest,
        MultiPutRequest,
    )

    rng = np.random.default_rng(seed)
    n_hashkeys = max(1, n_records // 10)
    # fresh hashkeys for the inserts: the next ones routing here
    hashkeys = partition_hashkeys(n_hashkeys + MIXED_OPS)
    insert_pool = hashkeys[n_hashkeys:]
    hashkeys = hashkeys[:n_hashkeys]
    # records a split left behind: their hash routes to partition 32
    foreign = partition_hashkeys(max(1, n_hashkeys // 100), pidx=32)
    oracle = Oracle(FLAGS.get("pegasus.server",
                              "rocksdb_max_iteration_count"), LOOKAHEAD)
    gc_pauses = GcPauses()
    data_dir = tempfile.mkdtemp(prefix="pegasus_torch_smoke_")
    fused_scan.LAUNCHES.update(static=0, now=0)
    try:
        server = PartitionServer(data_dir, pidx=PIDX,
                                 partition_count=PARTITION_COUNT,
                                 device=device)
        # load: 10 records per hashkey, bench.py's keys and values; ~10%
        # written with a 1-second TTL, so they are expired by compaction
        t0 = time.perf_counter()
        expired_keys = []
        written = 0
        for h, hk in enumerate(hashkeys):
            hnum = int(hk[4:])
            live, short = [], []
            for s, sk in enumerate(SORT_KEYS):
                if written >= n_records:
                    break
                kv = KeyValue(sk, b"field0=%064d" % (hnum * 10 + s))
                (short if rng.random() < 0.10 else live).append(kv)
                written += 1
            for kvs, ttl in ((live, 0), (short, 1)):
                if kvs and server.on_multi_put(
                        MultiPutRequest(hk, kvs, ttl),
                        partition_hash=key_hash_parts(hk)) != 0:
                    fail("multi_put refused")
            for kv in live:
                oracle.put(generate_key(hk, kv.key), kv.value)
            expired_keys += [generate_key(hk, kv.key) for kv in short]
            if (h + 1) % 25_000 == 0:
                server.flush()
        for hk in foreign:
            server.on_put(generate_key(hk, b"s00"), b"stale")
            oracle.hide(generate_key(hk, b"s00"))
        load_s = time.perf_counter() - t0
        log(f"slice: loaded {written} records ({len(expired_keys)} with "
            f"a 1 s TTL, {len(foreign)} split leftovers) in {load_s:.1f} s")
        # every short-TTL record must be expired before compaction
        deadline = epoch_now() + 2
        while epoch_now() < deadline:
            time.sleep(0.1)
        t0 = time.perf_counter()
        server.manual_compact()
        runs = server.engine.lsm.l1_runs
        n_blocks = sum(len(r.blocks) for r in runs)
        kept = sum(r.total_count for r in runs)
        log(f"slice: flush + manual_compact in "
            f"{time.perf_counter() - t0:.1f} s -> {kept} records in "
            f"{n_blocks} SST blocks")
        oracle.compacted(runs)
        for key in expired_keys[:200]:
            if server.on_get(key)[0] == 0:
                fail(f"expired record {key!r} still served")

        filters = [(0, b"", 0, b"")] * 17 + [
            (0, b"", FT_MATCH_POSTFIX, b"5"),
            (0, b"", FT_MATCH_ANYWHERE, b"s0"),
            (FT_MATCH_PREFIX, b"user00", FT_MATCH_PREFIX, b"s0")]

        def scan_op(hk: bytes, limit: int, f):
            """(page was full, seconds in the server, CPU seconds of this
            process meanwhile, whether a GC pause fell inside)."""
            start = generate_key(hk, b"")
            req = GetScannerRequest(
                start_key=start, batch_size=limit,
                validate_partition_hash=True, one_page=True,
                hash_key_filter_type=f[0], hash_key_filter_pattern=f[1],
                sort_key_filter_type=f[2], sort_key_filter_pattern=f[3])
            g = gc_pauses.count
            c, t = time.process_time(), time.perf_counter()
            resp = server.on_get_scanner(req)
            seconds = time.perf_counter() - t
            cpu = time.process_time() - c
            return (check_page(resp, oracle, start, limit, f), seconds, cpu,
                    gc_pauses.count != g)

        def scan_phase(name: str, n_ops: int, insert_frac: float):
            ranks = zipf_ranks(rng, n_hashkeys, n_ops)
            order = rng.permutation(n_hashkeys)  # scrambled zipfian
            lens = rng.integers(1, 101, n_ops)
            fsel = rng.integers(0, len(filters), n_ops)
            ins = rng.random(n_ops) < insert_frac
            lat, full, inserts, insert_s, cpu_s = [], 0, 0, 0.0, 0.0
            gc_lat = []
            gc_pauses.reset()
            for op in range(n_ops):
                if ins[op]:
                    hk = insert_pool.pop()
                    key = generate_key(hk, b"s00")
                    t = time.perf_counter()
                    if server.on_put(key, b"inserted") != 0:
                        fail("insert refused")
                    insert_s += time.perf_counter() - t
                    oracle.put(key, b"inserted")
                    inserts += 1
                    continue
                page_full, seconds, cpu, in_gc = scan_op(
                    hashkeys[order[ranks[op]]], int(lens[op]),
                    filters[fsel[op]])
                full += page_full
                lat.append(seconds)
                cpu_s += cpu
                if in_gc:
                    gc_lat.append(seconds)
            # one client, requests back to back: the rate is the server's
            # time alone (the oracle's checks run between requests). The
            # process's CPU time (all threads) beside the scans' wall time
            # tells host stalls (off-CPU) from work; the GC pauses of the
            # phase (oracle checks included) and the scans they fell in
            # tell the interpreter's pauses from the server's work.
            log(f"slice[{name}] on {card}: {len(lat)} scans, {inserts} "
                f"inserts, {full} full pages; "
                f"{len(lat) / (sum(lat) + insert_s)} scans/s, "
                f"{percentiles(lat)}, CPU {cpu_s} s of {sum(lat)} s wall; "
                f"gc {gc_pauses.count} pauses, {gc_pauses.total_s} s, "
                f"longest {gc_pauses.longest_s} s, inside {len(gc_lat)} "
                f"scans taking {sum(gc_lat)} s; "
                f"launches {fused_scan.LAUNCHES}")

        # columnar path: the compacted store, static masks
        scan_phase("columnar", SCAN_OPS, 0.0)
        on_card = device.type == "cuda"
        if on_card and fused_scan.LAUNCHES["static"] == 0:
            fail("columnar scans launched no static-mask kernel")
        # YCSB-E mix: the inserts build an overlay -> merge path with now
        scan_phase("ycsb-e", MIXED_OPS, 0.05)
        for hk in foreign[:5]:  # split leftovers in the overlay
            server.on_put(generate_key(hk, b"s01"), b"stale")
            oracle.hide(generate_key(hk, b"s01"))
        scan_phase("merge", MIXED_OPS // 4, 0.0)
        if on_card and fused_scan.LAUNCHES["now"] == 0:
            fail("merge-path scans launched no kernel with now")

        # point reads
        for h in rng.integers(0, n_hashkeys, 200):
            hk = hashkeys[h]
            sk = SORT_KEYS[int(rng.integers(0, 10))]
            key = generate_key(hk, sk)
            err, val = server.on_get(key)
            want = oracle.values.get(key)
            if (err == 0) != (want is not None) or (err == 0
                                                    and val != want):
                fail(f"get {key!r}: {err} {val!r}, want {want!r}")
            resp = server.on_multi_get(MultiGetRequest(hk, SORT_KEYS[:5]))
            got = [(kv.key, kv.value) for kv in resp.kvs]
            want_kvs = [(sk, oracle.values[generate_key(hk, sk)])
                        for sk in SORT_KEYS[:5]
                        if generate_key(hk, sk) in oracle.values]
            if resp.error != 0 or got != want_kvs:
                fail(f"multi_get {hk!r}: {got} want {want_kvs}")
            resp = server.on_multi_get(MultiGetRequest(
                hk, sort_key_filter_type=FT_MATCH_POSTFIX,
                sort_key_filter_pattern=b"3"))
            got = [(kv.key, kv.value) for kv in resp.kvs]
            want_kvs = [(sk, oracle.values[generate_key(hk, sk)])
                        for sk in SORT_KEYS if sk.endswith(b"3")
                        and generate_key(hk, sk) in oracle.values]
            if resp.error != 0 or got != want_kvs:
                fail(f"range multi_get {hk!r}: {got} want {want_kvs}")
        log("slice: 200 gets and 400 multi_gets match the oracle")

        # paged scans: the pages of a filtered range, concatenated, equal
        # the oracle's unbudgeted scan: all of it when the scanner ran to
        # the end, else its first 2000 records or more
        for f in filters[-3:]:
            lo = hashkeys[int(rng.integers(0, n_hashkeys))]
            start = generate_key(lo, b"")
            req = GetScannerRequest(
                start_key=start, batch_size=37,
                validate_partition_hash=True,
                hash_key_filter_type=f[0], hash_key_filter_pattern=f[1],
                sort_key_filter_type=f[2], sort_key_filter_pattern=f[3])
            resp = server.on_get_scanner(req)
            got = [(kv.key, kv.value) for kv in resp.kvs]
            while resp.context_id >= 0 and len(got) < 2000:
                resp = server.on_scan(resp.context_id)
                got += [(kv.key, kv.value) for kv in resp.kvs]
            if resp.context_id >= 0:
                server.on_clear_scanner(resp.context_id)
                want = oracle.scan(start, len(got), f)
            else:
                want = oracle.scan(start, len(oracle.keys), f)
            if got != want:
                fail(f"paged scan with {f}: {len(got)} records, the oracle "
                     f"{len(want)}")
        log("slice: paged filtered scans match the oracle")

        # fold the overlay back in: the split leftovers drop
        server.manual_compact()
        if server.engine.lsm.sorted_runs() is None:
            fail("store not pure L1 after manual_compact")
        oracle.compacted(server.engine.lsm.l1_runs)
        scan_phase("columnar-2", SCAN_OPS // 4, 0.0)
        server.close()
    finally:
        gc_pauses.close()
        shutil.rmtree(data_dir, ignore_errors=True)
    return dict(fused_scan.LAUNCHES)


# ---- main --------------------------------------------------------------


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--records", type=int, default=FULL_RECORDS,
                        help="records of partition 0 to load (a cut below "
                        f"{FULL_RECORDS:,} is printed)")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "pegasus_tpu_torch")):
        fail("run from a checkout: pegasus_tpu_torch/ is missing")
    sys.path.insert(0, here)
    from pegasus_tpu_torch.ops import fused_scan

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    device = torch.device("cuda", torch.cuda.current_device())
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2. build
    build_s, build_log = fused_scan.build(force=True)
    log(f"build: csrc/scan_predicate.cu -> sm_90a in {build_s:.2f} s")
    print(build_log.strip(), file=sys.stderr, flush=True)

    # 3. kernel vs plain
    shapes = [(1024, k, 1) for k in (32, 64, 256)] + \
             [(1024, k, 16) for k in (32, 64, 256)]
    t0 = time.perf_counter()
    cmp = kernel_vs_plain(device, shapes)
    log(f"kernel vs plain: {cmp['compared']} cases bit-identical "
        f"(max |diff| {cmp['max_abs_err']}) in "
        f"{time.perf_counter() - t0:.1f} s")
    for t in cmp["timings"]:
        log(f"scan_predicate {t['shape']} on {card}: device time kernel "
            f"{t['ms'] * 1e3} us, plain {t['plain_ms'] * 1e3} us "
            f"(profiler); per call with launch overhead kernel "
            f"{t['call_ms'] * 1e3} us, plain {t['plain_call_ms'] * 1e3} us "
            f"(CUDA events); bound {t['bound_ms'] * 1e3} us "
            f"({t['bound_by']})")

    # 4. the slice
    if args.records != FULL_RECORDS:
        log(f"slice: CUT to {args.records} records of partition {PIDX} "
            f"(the configuration loads {FULL_RECORDS})")
    t0 = time.perf_counter()
    launches = run_slice(device, args.records, card=card)
    torch.cuda.synchronize()
    log(f"slice: done in {time.perf_counter() - t0:.1f} s; kernel launches "
        f"static {launches['static']}, now {launches['now']}")

    # 5. summary
    t = cmp["timings"][0]
    log(json.dumps({"kernels": [{
        "name": "scan_predicate", "route": "cuda",
        "source": "pegasus_tpu_torch/csrc/scan_predicate.cu",
        "replaces": "pegasus_tpu/ops/pallas_scan.py:43",
        "launches": launches["static"] + launches["now"],
        "max_abs_err": cmp["max_abs_err"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "call_ms": t["call_ms"], "shape": t["shape"]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
