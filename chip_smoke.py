#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pegasus_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles csrc/scan_predicate.cu with nvcc for sm_90a;
3. kernel vs plain: the scan-predicate kernel's table launch against
   its plain torch version on seeded random blocks: tables of 1, 3, 8
   and 16 blocks (counts not a multiple of the tile or of 8, an empty
   block, scalar and per-record pidx), K in {32, 64, 256}, every hash x
   sort filter type with short, empty and over-long patterns, malformed
   rows, validation off and on, the packed static mask and the status
   bytes with `now` (below and above 2^31); bit-identical output
   required. Then times at the serving shapes and two large ones, and
   one columnar cold window through stacked_block_eval, which must issue
   exactly one kernel and one copy on the device;
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
EXPIRE_TS = np.array([0, 0, 100, 299_999_999, 300_000_000, 300_000_001,
                      0x7FFFFFFF, 0x80000000, 0x80000010, 0xFFFFFFF0],
                     dtype=np.uint32)


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
    ets = rng.choice(EXPIRE_TS, b)
    return keys, key_len, ets, hash_lo_column(keys, key_len)


def serving_block_columns(rng, b: int, k: int, pidx: int, pv: int):
    """The same columns in bulk, shaped like a compacted partition's
    blocks: keys of k/2..k bytes over the alphabet with a hashkey of
    0..len-2 bytes, and 97% of the records owned by `pidx` under the
    mask `pv` (compaction drops the others)."""
    key_len = rng.integers(k // 2, k + 1, b).astype(np.int32)
    hkl = (rng.random(b) * (key_len - 1)).astype(np.int32)
    keys = rng.choice(ALPHABET, (b, k))
    keys[np.arange(k)[None, :] >= key_len[:, None]] = 0
    keys[:, 0], keys[:, 1] = hkl >> 8, hkl & 0xFF
    hash_lo = rng.integers(0, 1 << 32, b, dtype=np.uint64)
    owned = rng.random(b) < 0.97
    hash_lo = np.where(owned, (hash_lo & ~np.uint64(pv)) | np.uint64(pidx),
                       hash_lo).astype(np.uint32)
    return keys, key_len, rng.choice(EXPIRE_TS, b), hash_lo


def device_block(cols, device):
    """A RecordBlock on `device` from (keys, key_len, expire_ts, hash_lo)
    columns, hashkey_len decoded from the header as SST blocks do."""
    from pegasus_tpu_torch.ops.record_block import _to_block

    keys, key_len, ets, hash_lo = cols
    hkl = (keys[:, 0].astype(np.int32) << 8) | keys[:, 1]
    return _to_block(keys, key_len, np.where(key_len >= 2, hkl, 0), ets,
                     key_len >= 2, hash_lo, device)


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

# records of the 16 blocks of a checked table: serving blocks of 1024
# and counts that are not a multiple of the 256-record tile or of 8,
# one empty block among them
CHECK_COUNTS = (1024, 1000, 257, 0, 33, 1023, 8, 700, 513, 1, 129, 1024,
                77, 600, 255, 1024)
# the tables checked: slices of those 16 blocks
CHECK_TABLES = ((0, 1), (1, 4), (4, 12), (0, 16))
NOWS = (None, 300_000_000, 0x80000010)


def _cuda_ms(fn, iters: int, before=None) -> float:
    """Milliseconds per call between CUDA events: the time a caller pays,
    host-side launch overhead included. Without `before`, events bracket
    `iters` back-to-back calls; with it (an L2 flush), each call is
    bracketed alone after its `before()`."""
    import torch

    for _ in range(3):
        fn()
    if before is None:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters
    pairs = []
    for _ in range(iters):
        before()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def _device_ms(fn, iters: int, kernel: str = "", before=None):
    """Device milliseconds per call from torch.profiler's CUDA trace: the
    kernels' own time, without the host gaps between launches. `kernel`
    keeps only kernels whose name holds it (all kernels when empty); the
    device-to-device copies of `before` (the L2 flush) never count.
    None when the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        if kernel in ev.key and not ev.key.startswith("Memcpy DtoD"):
            total_us += getattr(ev, "self_device_time_total", 0.0)
    return total_us / iters / 1e3 if total_us > 0 else None


def _device_ops(fn, calls: int = 20) -> dict:
    """What the device ran per call of `fn`, from torch.profiler over
    `calls` calls (a profile can miss the first kernel after it starts,
    so one call alone is not counted): {"kernels": per call, "copies":
    per call, "names": {name: count over the calls}}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {"kernels": 0, "copies": 0, "names": {}}
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        out["names"][ev.key] = ev.count
        out["copies" if ev.key.startswith(("Memcpy", "Memset"))
            else "kernels"] += ev.count
    out["kernels"] /= calls
    out["copies"] /= calls
    return out


def kernel_bound(n: int, k: int, *, hash_filter: bool, sort_filter: bool,
                 now: bool, validate: bool, pidx_column: bool,
                 ops: float):
    """(bound_ms, bound_by) of one table launch over `n` records of key
    width `k`: each input byte the call needs read once, each output byte
    written once, over HBM; `ops` integer operations over the non-tensor
    peak. Per record: valid 1 B; hash_lo 4 B (and the pidx column 4 B)
    with validation; expire_ts 4 B with `now`; the key row k B and
    hashkey_len 4 B with any filter, key_len 4 B with a sortkey filter.
    Output: a status byte with `now`, a packed keep bit without."""
    per = 1
    if validate:
        per += 4 + (4 if pidx_column else 0)
    if now:
        per += 4
    if hash_filter or sort_filter:
        per += k + 4
    if sort_filter:
        per += 4
    nbytes = n * per + (n if now else -(-n // 8))
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    return (mem_ms, "bytes") if mem_ms >= ops_ms else (ops_ms, "operations")


def match_ops(cols, filters, validate: bool, pidx: int, pv: int,
              now) -> float:
    """Integer operations these inputs need: about 8 a record for the
    status, and for each record that reaches the filters, one compare per
    pattern byte (PREFIX, POSTFIX) or per candidate start (ANYWHERE) of
    each active filter."""
    keys, key_len, ets, hash_lo = cols
    hkl = np.where(key_len >= 2, (keys[:, 0].astype(np.int64) << 8)
                   | keys[:, 1], 0)
    reach = key_len >= 2
    if now is not None:
        reach &= ~((ets > 0) & (ets <= now))
    if validate:
        reach &= (hash_lo & (pv & 0xFFFFFFFF)) == pidx
    ops = 8.0 * keys.shape[0]
    k = keys.shape[1]
    regions = ((2, hkl), (2 + hkl, key_len - 2 - hkl))
    for (ftype, pat), (start, length) in zip(filters, regions):
        plen = len(pat)
        if ftype == 0 or plen == 0:
            continue
        start = np.broadcast_to(start, key_len.shape)
        fits = reach & (length >= plen)
        if ftype == 1:
            starts = (np.minimum(start + length - plen, k - 1)
                      - np.maximum(start, 0) + 1)
            ops += float(np.clip(starts, 0, None)[fits].sum())
        else:
            ops += float(plen * fits.sum())
    return ops


def check_tables(device, widths=(32, 64, 256),
                 counts=CHECK_COUNTS) -> dict:
    """Phase 3, correctness: the table launch against the plain version,
    bit for bit. Per key width, 16 seeded blocks (`counts`) go in
    tables of 1, 3, 8 and 16 blocks, each block with a scalar pidx or a
    per-record pidx column, through every filter case, validation off
    and on, without `now` (the packed static mask) and with it (status
    bytes, `now` below and above 2^31). Returns the count of tables
    compared and the largest byte difference (0: identical)."""
    import torch

    from pegasus_tpu_torch.ops import fused_scan
    from pegasus_tpu_torch.ops.predicates import FilterSpec, pack_mask

    rng = np.random.default_rng(20261016)
    pv = 7
    compared = 0
    max_err = 0
    for k in widths:
        blocks, pidxs = [], []
        for i, count in enumerate(counts):
            cols = random_block_columns(rng, count, k)
            blocks.append(device_block(cols, device))
            if i % 2:
                owned = rng.random(count) < 0.5
                col = np.where(owned, cols[3] & pv,
                               rng.integers(0, pv + 1, count))
                pidxs.append(torch.from_numpy(col.astype(np.int32)).to(
                    device))
            else:
                pidxs.append(int(rng.integers(0, pv + 1)))
        for hft, hp, sft, sp in predicate_cases(rng, k):
            hf = FilterSpec.make(hft, hp, device)
            sf = FilterSpec.make(sft, sp, device)
            for validate in (False, True):
                for now in NOWS:
                    plain = []
                    for block, pidx in zip(blocks, pidxs):
                        status = fused_scan.scan_status_plain(
                            block, hf, sf, validate, pidx, pv, now)
                        plain.append(status if now is not None else
                                     pack_mask(status
                                               == fused_scan.STATUS_KEEP))
                    for lo, hi in CHECK_TABLES:
                        got = fused_scan.scan_table(
                            blocks[lo:hi], pidxs[lo:hi], hf, sf, validate,
                            pv, now)
                        want = torch.cat(plain[lo:hi])
                        if got.shape != want.shape:
                            fail(f"table {lo}:{hi} K={k}: {got.shape} "
                                 f"bytes, plain {want.shape}")
                        err = int((got.int() - want.int()).abs().max())
                        max_err = max(max_err, err)
                        if err:
                            fail(f"kernel != plain: table {lo}:{hi} K={k} "
                                 f"hft={hft} hp={hp!r} sft={sft} sp={sp!r} "
                                 f"validate={validate} now={now}")
                        compared += 1
    if device.type == "cuda":
        torch.cuda.synchronize()
    return {"compared": compared, "max_abs_err": max_err}


# the timed shapes: (name, blocks, records per block, K, now, hashkey
# filter, sortkey filter, L2 flushed before each launch by writing
# FLUSH_BYTES)
TIMED_SHAPES = (
    ("merge batch", 1, 1024, 32, True, (0, b""), (0, b""), False),
    ("merge batch, sortkey PREFIX 3 B", 1, 1024, 32, True, (0, b""),
     (2, b"abc"), False),
    ("cold window", 8, 1024, 32, False, (0, b""), (0, b""), False),
    ("cold window, hashkey PREFIX + sortkey ANYWHERE", 8, 1024, 32, False,
     (2, b"ab"), (1, b"cd"), False),
    ("large K=32, sortkey PREFIX 3 B", 1, 1 << 20, 32, False, (0, b""),
     (2, b"abc"), True),
    ("large K=256, sortkey ANYWHERE 4 B", 1, 1 << 18, 256, False, (0, b""),
     (1, b"abcd"), True),
)
LARGE_SHAPE = 4  # the shape reported in the kernels line
FLUSH_BYTES = 256 << 20


def time_tables(device) -> list:
    """Phase 3, times: each TIMED_SHAPES entry with validation on and a
    scalar pidx, as the server launches it. Per shape: the kernel's
    device time (torch.profiler), its per-call time with the host
    included (CUDA events), the plain version's two times, the bound.
    A flushed shape's kernel is also timed after a flush that only reads
    FLUSH_BYTES, which leaves no dirty lines in L2 to write back."""
    import torch

    from pegasus_tpu_torch.ops import fused_scan
    from pegasus_tpu_torch.ops.predicates import FilterSpec

    rng = np.random.default_rng(20261017)
    pv, pidx, now_s = 63, 0, 300_000_000
    src = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)

    def flush():
        dst.copy_(src)

    def read_flush():
        src.view(torch.int32).sum()

    out = []
    for (name, n_blocks, n, k, with_now, hfk, sfk, flushed) in TIMED_SHAPES:
        now = now_s if with_now else None
        cols = [serving_block_columns(rng, n, k, pidx, pv)
                for _ in range(n_blocks)]
        blocks = [device_block(c, device) for c in cols]
        hf = FilterSpec.make(*hfk, device)
        sf = FilterSpec.make(*sfk, device)
        pidxs = [pidx] * n_blocks

        def kernel():
            fused_scan.scan_table(blocks, pidxs, hf, sf, True, pv, now)

        def plain():
            fused_scan.scan_table_plain(blocks, pidxs, hf, sf, True, pv,
                                        now)

        before = flush if flushed else None
        iters, plain_iters = (50, 10) if flushed else (200, 50)
        ops = sum(match_ops(c, (hfk, sfk), True, pidx, pv, now)
                  for c in cols)
        bound_ms, bound_by = kernel_bound(
            n_blocks * n, k, hash_filter=bool(hfk[0] and hfk[1]),
            sort_filter=bool(sfk[0] and sfk[1]), now=with_now,
            validate=True, pidx_column=False, ops=ops)
        row = {"shape": f"{name}: {n_blocks} x {n} records, K={k}, "
                        + ("now" if with_now else "static")
                        + ", validation"
                        + (", L2 flushed" if flushed else ""),
               "ms": _device_ms(kernel, iters, "scan_table_kernel", before),
               "call_ms": _cuda_ms(kernel, iters, before),
               "plain_ms": _device_ms(plain, plain_iters, "", before),
               "plain_call_ms": _cuda_ms(plain, plain_iters, before),
               "bound_ms": bound_ms, "bound_by": bound_by}
        if flushed:
            row["ms_read_flushed"] = _device_ms(kernel, iters,
                                                "scan_table_kernel",
                                                read_flush)
        if None in (row["ms"], row["plain_ms"],
                    row.get("ms_read_flushed", 0)):
            fail(f"torch.profiler recorded no device time for {name}")
        row["share"] = bound_ms / row["ms"]
        out.append(row)
        del blocks, cols
    return out


def time_window(device, n_blocks: int = 8, reps: int = 200) -> dict:
    """Phase 3, the columnar path's cold window: one stacked_block_eval
    over `n_blocks` resident blocks of 1024 records (K = 32, validation,
    no filter), from the call to the host masks, on the host clock; and
    what one such call issues on the device."""
    import torch

    from pegasus_tpu_torch.ops.record_block import block_from_columns
    from pegasus_tpu_torch.server.scan_coordinator import stacked_block_eval

    rng = np.random.default_rng(20261018)
    pv, pidx = 63, 0
    blocks = []
    for i in range(n_blocks):
        keys, key_len, ets, hash_lo = serving_block_columns(
            rng, 1024, 32, pidx, pv)
        blocks.append((i, block_from_columns(keys, key_len, ets,
                                             hash_lo=hash_lo,
                                             capacity=1024, device=device),
                       pidx))

    def window():
        return list(stacked_block_eval(blocks, True, pv))

    for _ in range(5):
        window()
    seconds = []
    for _ in range(reps):
        t = time.perf_counter()
        masks = window()
        seconds.append(time.perf_counter() - t)
    if len(masks) != n_blocks or any(m.shape != (1024,) for _t, m in masks):
        fail("stacked_block_eval returned the wrong masks")
    ops = _device_ops(window)
    return {"blocks": n_blocks, "median_us": float(np.median(seconds)) * 1e6,
            "mean_us": float(np.mean(seconds)) * 1e6, **ops}


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
    t_start = time.perf_counter()

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

    # 3. kernel vs plain, then times
    t0 = time.perf_counter()
    cmp = check_tables(device)
    log(f"kernel vs plain: {cmp['compared']} tables bit-identical "
        f"(max |diff| {cmp['max_abs_err']}) in "
        f"{time.perf_counter() - t0:.1f} s")
    timings = time_tables(device)
    for t in timings:
        log(f"scan_predicate {t['shape']} on {card}: device time kernel "
            f"{t['ms'] * 1e3} us, plain {t['plain_ms'] * 1e3} us "
            f"(profiler); per call with the host kernel "
            f"{t['call_ms'] * 1e3} us, plain {t['plain_call_ms'] * 1e3} us "
            f"(CUDA events); bound {t['bound_ms'] * 1e3} us "
            f"({t['bound_by']}), {100 * t['share']}% of it"
            + (f"; kernel after a read-only flush {t['ms_read_flushed'] * 1e3}"
               " us" if "ms_read_flushed" in t else ""))
    win = time_window(device)
    log(f"stacked_block_eval over {win['blocks']} resident blocks of 1024 "
        f"on {card}: median {win['median_us']} us, mean {win['mean_us']} "
        f"us (host clock, call to host masks); device ops per call: "
        f"{win['kernels']} kernels, {win['copies']} copies (over 20 calls: "
        f"{win['names']})")
    if round(win["kernels"]) != 1 or round(win["copies"]) != 1:
        fail("a cold window must issue one kernel and one copy")

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
    log(f"chip_smoke: phases 1-4 in {time.perf_counter() - t_start:.1f} s")
    t = timings[LARGE_SHAPE]
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
