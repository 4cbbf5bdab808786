#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pegasus_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles csrc/scan_predicate.cu, csrc/compaction_filter.cu
   and csrc/mesh_step.cu with nvcc for sm_90a and native/packer.cpp with
   g++, all started together;
3. kernel vs plain: the scan-predicate kernel's table launch against
   its plain torch version on seeded random blocks: tables of 1, 3, 8
   and 16 blocks (counts not a multiple of the tile or of 8, an empty
   block, scalar and per-record pidx), K in {32, 64, 256}, every hash x
   sort filter type with short, empty and over-long patterns, malformed
   rows, validation off and on, the packed static mask and the status
   bytes with `now` (below and above 2^31); bit-identical output
   required. Then times at the serving shapes and two large ones, and
   one columnar cold window through stacked_block_eval, which must issue
   exactly one kernel and one copy on the device. Then the kernel's
   flavour axis (scan_table_multi) against its plain version on the
   same tables for 2, 5, 16 and 64 flavours of every filter type pair,
   and its times at a cold window and a large shape;
4. the slice: one PartitionServer on the card as partition 0 of a
   64-partition YCSB-E table, loaded in bench.py's layout, compacted,
   then serving YCSB-E traffic (95% scans / 5% inserts, zipfian start
   keys, scan length uniform in 1..100) plus gets and multi_gets; every
   response is checked against a host oracle, and both predicate modes
   (columnar static masks, merge path with `now`) must launch the kernel;
5. the batched path: one node's share of the same table (partitions
   0..7, 125,000 records each) serving YCSB-E through
   scan_coordinator.scan_multi in flushes of 32 scans, 3 in 20 of them
   with a sortkey POSTFIX filter, every page checked against an oracle
   of the batched plan; the static and the flavour-axis kernel must
   launch, and a CUDA trace of the traffic gives the device's busy
   share; then 1 in 50 records is rewritten with a TTL, and after a
   compaction and MaskPrefresher passes a flush of unfiltered scans must
   launch nothing, both while those records live and once they expired,
   with the expired records it planned counted as the oracle counts
   them. Between the traffic and the TTL rewrite, the observability
   layer is switched off and on, A B B A, over the same 60 seeded
   flushes: off is `[pegasus.perfctx] enabled` false and
   `[pegasus.tracing] sample_ratio` 0, on is PerfContexts, sample_ratio
   1 with a span a flush, and the slow log at 0 ms; scans/s is printed
   for each pass, and in every on pass each flush's states must leave
   one slow-log entry with its PerfContext (rows_evaluated equal to the
   rows the plan sent to masks) and the flush's span the JAX package's
   stage names;
6. the point-get path: BASELINE config #1 (onebox, one table of 4
   partitions, YCSB-C, 1,000,000 records) at the JAX package's default
   store flags (dcz2 blocks, bloom filters, perfect-hash indexes, the
   row cache), compacted into dcz2 L1 runs under 4 interleaved L0
   flushes, serving bench.py's get and miss streams through
   read_coordinator.point_read_multi in flushes of 32 and YCSB-E scans
   (some filtered, some with a pushdown count) through scan_multi, every
   answer checked against a host oracle; no planned block of a clean
   encoded run may have its mask computed on the device;
7. bulk manual compaction: BASELINE config #3 (TTL expiry, half the
   records expired) at `block_codec = none` (a), the same at dcz2 with
   sidecars (b), and config #4 (user rules: hashkey PREFIX, hashkey
   ANYWHERE with sortkey PREFIX, 5% expired) at dcz2 (c), each over a
   fresh 0.5 GB store (a printed cut of the configuration's 10 GB) of 8
   partitions in bench.py's compaction layout plus an untimed warm one,
   all 8 compacted at once through StorageEngine(device="cuda")
   .manual_compact on a thread pool, GB/s = store bytes before / wall
   seconds; every partition's survivors must equal a host oracle of the
   generator and the ruleset, every partition's first chunk must mask the
   same through the kernel and its plain version, and the kernel must
   launch in (a) and (c) and never in (b), whose masks come from the
   encoded columns on the host, as the JAX package routes them. Pass (c)
   runs under a CUDA trace that gives the device's busy share;
8. the in-process client: (a) BASELINE config #5 in the shape of
   bench.py's measure_geo: a raw and an index Table of 8 partitions,
   20,000 points through GeoClient.set, the index compacted, 150 radius
   searches of 500 m (a warm, a timed and a traced pass), every search
   held to a float64 haversine oracle within the float32 band; the cell
   scans must launch the scan kernel and every search the distance
   filter (torch ops) on the card; (b) an 8-partition Table of 400,000
   records through multi_set, 20,000 seeded incr / check_and_set /
   check_and_mutate / multi_del / batch_get / ttl / sortkey_count ops
   against an oracle, Table.split 8 -> 16 with a full scan and sampled
   sortkey_counts held to the oracle (the stale half hidden by the scan
   kernel's ownership check), then manual_compact_all, which must launch
   the compaction kernel and keep exactly the oracle's records;
9. integrity: one partition in phase 5's layout (125,000 records,
   `none`) under at-rest encryption (a LocalKmsClient with a fixed root
   key) and as its plaintext twin, 4,000 YCSB-E scans through
   scan_multi: every page of the encrypted store, the twin and a PGT1
   copy of the twin (the same blocks without hash_lo, written by
   write_pgt1) equal to each other and to an oracle; the scan kernel
   must launch on the encrypted store and its key-hash instance on the
   PGT1 copy; ReplicaScrubber.scrub_now passes the twin clean and
   reports exactly the one block of a copy with a flipped byte;
10. the resident image (parallel/mesh_resident.py): BASELINE config #2
   whole (bench.py:190's layout, not cut: 100,000 hashkeys x 10
   sortkeys, 10% expired, over 64 PartitionServers on the card through
   multi_put, `none`, compacted) attached to MESH_SERVING: a [64, B, 32]
   image, B = 16384 or 32768 (printed). Against the host arm (the image
   switched off by `[pegasus.mesh] serving_enabled`): (a) every
   partition's blocks through stacked_block_eval, masks bit-identical
   with the gate pinned open (one round a wave), then a partition's and
   the whole table's wave under the measured gate, its verdict and both
   times printed; (b) count and sum pushdown aggregates over all 64
   partitions, equal, one round each on a frozen epoch second; (c) a
   scan_multi drain of the table, equal, and equal to the oracle; (d) a
   config #3 TTL pass and a config #4 rules pass over the 64 partitions
   (gate pinned open): one round each, survivors equal to the oracle,
   every partition equal to a detached twin, every refresh a survivor
   gather; (e) sharded_scan_step over the image against its plain
   version; (f) csrc/mesh_step.cu (its four instances: the lanes' sum
   off and on, the value-filter mask read or all ones) and the
   compaction kernel's slot gate (slot_gate_kernel, the TTL pass, and
   compaction_filter_kernel's gated rules instance; want_ets off and on)
   against their plain versions at P in {1, 5, 16, 64}, B in {8, 1024,
   4096, 16384, 65536} (clusters of 1, 2 and 8 blocks a slot),
   bit-identical; their times at the phase's P and B beside the bound of
   the bytes each launch reads; what the device runs a round (a wave, a
   sum aggregate, a compaction): no memset, at most one copy home; a
   round's host wall split into launches, the copy home and the unpack;
   then ops/placement's cost constants measured on the card
   (measure_placement). The launches of (a)-(d) must include the
   epilogue, both slot-gate kernels and the scan kernel's static mode.
   (g), before (f), the mesh leg: the image sharded over every card of
   the host (dp their count; on a one-card host four logical shards on
   it, printed): every round and compaction round (a)-(d) ran replayed
   on the one-shard image and on the sharded one, bit-equal; the
   sharded image attached and driven through MESH_SERVING (waves,
   count and sum, each compaction's masks; every count from 0, the
   launches printed a card and read as the kernels line's
   `resident_mesh` path), equal to the one-shard image's answers; a
   refresh after one partition's flush restaging only its shard; a wave
   round's host wall one-shard against sharded; sharded_scan_step on a
   (dp, sp) = (2, 2) mesh against the one-device step;
11. replicated writes: partitions 0..7 of BASELINE config #2 (bench.py
   :190's layout: user%08d hashkeys x 10 sortkeys, 10% already expired,
   values field0=%064d; about 15,625 records a partition), each a
   PacificA group of three replicas (replica/Replica, a PartitionServer
   on the card each) over one SimLoop / SimNetwork, every replica with
   its own WriteFlushWindow as plog sink, open around each message it
   receives. The load goes through the primaries' client_write in
   mutations of 1000 puts (bench.py:219-222), two staged a window; then
   every replica is compacted by hand (the compaction kernel must
   launch), and every replica's L1 blocks must hold the oracle's keys.
   YCSB-E on the primaries (95% scans with phase 4's filter mix and
   lengths, zipfian start keys; 5% inserts through the three-replica
   path), every page against a host oracle, under a CUDA trace that
   gives the device's busy share. A probe of seeded scans on the old
   primaries; then a secondary of every group is promoted at ballot 2
   and answers the same probe with byte-equal pages (wire frames); then
   group 0's remaining secondary, after 8 more writes, is restarted
   from a copy of its files (its engine WAL stale, its plog whole),
   must reach the group's committed decree and answer the probe as its
   primary does. The scan kernel must launch on the old primaries, the
   new primaries and the restarted replica. Printed beside the card:
   writes acknowledged per second, the group-commit window's median
   size, scans per second on the primaries, the device's busy share;
12. the cluster: (a) BASELINE config #2 as bench.py measures it
   (BenchCluster, bench.py:157-236): a port SimCluster of one node (one
   MetaService and one ReplicaStub whose replicas are on the card over
   one SimLoop / SimNetwork), create_table("bench", 64 partitions, one
   replica); 1,000,000 records in bench.py:199-222's layout through each
   primary as client_write messages of 1000 puts; every partition
   compacted by hand (the compaction kernel must launch); then 20,000
   YCSB-E operations as bench.py:236 run_scans draws them, through
   SimCluster.client("bench"), a ClusterClient (95% scans with zipfian
   partition popularity and start keys, coalesced in batches of 32,
   each batch one ClusterClient.scan_multi call, which sends the node
   one client_scan_multi message; 5% inserts, each a
   ClusterClient.set), every page against a BatchedOracle, under a CUDA
   trace; the scan kernel's static contract must launch through the
   stub's read gates. Printed:
   writes/s of the load, the compaction's seconds, scans/s, p50 and p99
   per batch, the device's busy share, launches by contract. (b) the
   meta's cure: four stubs, a table of 8 partitions x 3 replicas
   (80,000 records through client_write messages, compacted
   everywhere), a seeded probe of 200 scans through client_scan_multi;
   the node leading the most partitions is silenced, the failure
   detector declares it dead and the guardian promotes secondaries and
   adds learners until every partition has three replicas; the probe on
   the new primaries must give byte-equal pages (wire frames) and launch
   the scan kernel; the silenced node's stub, restarted from its
   directories, recovers its partition count. Printed: simulated and
   wall seconds to cure, learners added, launches on the new primaries;
13. the services (meta/{backup,bulk_load,duplication}_service.py over
   SimClusters of three nodes on the card): (a) BASELINE config #2
   (1,000,000 records, 10% expired) staged by server/bulk_load's
   SSTGenerator in a LocalBlockService root and ingested into a table of
   64 partitions x 3 replicas by the meta's start_bulk_load verb (a
   rolling OP_INGEST through 2PC; every replica must ingest at one
   decree), 2,000 YCSB-E scans through ClusterClient.scan_multi in
   batches of 32 over the ingested L0 runs (the merge path: the scan
   kernel's `now` contract must launch), every page against an oracle
   without the expired records, under a CUDA trace; then the 64
   primaries compacted by hand (the compaction kernel must launch; the
   survivors must be the oracle's); (b) start_backup of that table to a
   BlobServer on 127.0.0.1 (a free port) through remote://, restore_app
   into a new table, 200 seeded probe scans on both tables: byte-equal
   wire frames, equal to the oracle, the static contract launching on
   both tables' primaries; (c) a second SimCluster ("b." names, cluster
   id 2) on the same loop and network, an 8 x 3 table on each side,
   add_dup, 20,000 writes through the master's ClusterClient (90% set,
   10% del) until the follower confirmed the master's last committed
   decree on every partition, both sides' primaries compacted, 400
   probe scans through both clusters' ClusterClients byte-equal, the
   static contract launching on the follower's primaries. Printed:
   ingest seconds and records/s, scans/s and p50 / p99 a batch, the
   device's busy share, the compaction's seconds, backup and restore
   seconds, mutations shipped a second, envelopes, seconds from the
   last write to the follower's confirmation, launches by part;
14. config #2 served by node processes over TCP (server/node_main.py,
   tools/onebox_cluster.py): (a) 1 meta and 3 replica processes, the
   replicas on the card (each boot line must name it), the store flags
   pinned through cluster.json; (b) table "bench" of 64 partitions x 3
   replicas created and bulk-loaded (1,000,000 records in
   bench.py:190-222's layout, 10% expired, staged by SSTGenerator) by the
   shell's wire mode in one process of its own, started before the
   nodes, which must leave CUDA uninitialized (bulk_load_status sampled
   once a second), then the shell's manual_compact (the env trigger; the
   meta staggers it node by node, its grant lease shortened to 9 s)
   until every replica counted a compaction; each node's boot seconds
   printed, no node log may hold a traceback; (c) 20,000 YCSB-E
   operations through onebox_cluster.connect (a ClusterClient over
   TcpTransport: scans in scan_multi batches of 32, 5% inserts), every
   page against an oracle; the replicas' mask_route_device_raw_count
   must rise; (d) the
   C++ wire client's 200 gets and hashkey scans and
   AsyncPegasusClient.gather_get equal to the ClusterClient and the
   oracle, every node's GET /metrics and /config; (e) 3 writes a
   partition acknowledged, then kill -9 of the replica process leading
   the most primaries, writes from the kill on until the cure and 100 of
   them acknowledged (every acknowledged write read back), a 200-scan probe
   byte-equal before and after, the new primaries' device masks; (f)
   stop, no node process left. Launches are read from the replica
   processes (their `kernel.launches` verb). Printed: boot, staging,
   ingest and compaction seconds, records/s, scans/s and p50 / p99 a
   batch, device-route counts a node, the C++ client's ops/s, seconds
   to cure, the phase's wall.

Phase 3 also holds the compaction-filter kernel bit-exact against its
plain version
(check_compaction: key widths 32, 64 and 256, validation off and on,
default_ttl 0 and not, want_ets and pack on and off, a rotation of
rulesets) and times it at phase 7's chunk shape, and holds the scan
kernel's key-hash instance (blocks without a stored hash_lo, hashed in
the kernel) bit-exact against its plain version on the same seeded
tables with hash_lo dropped, through both entries, K in {32, 64, 256},
and times it at 2^20 records, K = 32.

Phases 4, 5, 8, 9, 10, 11, 12, 13 and 14 pin the store flags `block_codec = none`,
`bloom_bits_per_key = 0`, `phash_index = false` (every block reaches the
kernel); phases 6 and 7 (b, c) pin the defaults, 7 (a) pins `none`
without sidecars. The line before the last lists the
kernels as JSON; the last line is {"ok": true, "device": {...}}.
Since phase 14 came, the whole run cuts it to 100,000 records and 2,000
ops, phase 13 to 150,000 records and 5,000 duplicated writes (250,000
and 10,000 since phase 13 came), phase 12 (a) to 500,000 records and
10,000 ops and phase 4 to 100,000 records (printed cuts; `--onebox-only`,
`--ops-only` and `--cluster-only` run their phases uncut).
Since phase 12 came, the whole run cuts phase 8 (b) to 200,000 records
and 10,000 ops and phase 11 to 50,000 hashkeys, 2,000 ops and a probe
of 400 scans (printed cuts; `--replicated-only` runs phase 11 uncut).
`--records N` sets phase 4's load (default 100,000) and prints any cut
below 1,000,000; `--compact-gb G` sets a phase-7 pass's store (default
0.5 since phase 14 came, 1.0 before). `--times-only [--tree DIR]` builds the kernels of this checkout (or
of DIR) and prints phase 3's times as one JSON line, nothing else;
`--resident-only` builds the kernels and runs phase 10 alone with its
mesh leg (on a host of several cards, over all of them);
`--resident-times [--tree DIR]` likewise prints phase 10 (f)'s kernel
times and a round's wall split on a synthetic image of phase 10's
shape; `--replicated-only` builds the kernels and runs phase 11 alone
(its printed numbers, then one JSON line of its launches);
`--cluster-only` does the same for phase 12, `--ops-only` for phase 13
and `--onebox-only` for phase 14 (uncut). Phases 5 and
6 always load their 1,000,000 records. A
printed cut keeps the whole run near the time it took before phase 6
came: the flavour-axis check runs 64 flavours at key width 32 only (16
at the wider keys).
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
SCALAR_OPS_PER_S = 67e12    # H100 SXM non-tensor peak (float32 rate)

PARTITION_COUNT = 64
PIDX = 0
FULL_RECORDS = 1_000_000
# phase 4's load by default: cut from FULL_RECORDS since phase 5 came,
# and again since phases 12 and 14 came, to keep the whole run under
# 660 s on a slow host
SLICE_RECORDS = 100_000
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
    keeps only kernels whose name holds it (all kernels when empty), and
    then `fn` must launch that kernel once a call: the mean is taken over
    the launches the trace recorded, so a record the trace drops cannot
    lower it. The device-to-device copies of `before` (the L2 flush)
    never count. A trace that recorded no device time at all is taken
    again (at most three); None when none of them did."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _trace in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if before is not None:
                    before()
                fn()
            torch.cuda.synchronize()
        total_us, launches = 0.0, 0
        for ev in prof.key_averages():
            if kernel in ev.key and not ev.key.startswith("Memcpy DtoD"):
                total_us += getattr(ev, "self_device_time_total", 0.0)
                launches += ev.count
        if total_us > 0:
            return total_us / (launches if kernel else iters) / 1e3
        if _trace < 2:
            log(f"torch.profiler recorded no device time for {iters} "
                f"calls; profiling again")
    return None


def _flusher(device):
    """Two L2 flushes over FLUSH_BYTES: a device copy (which leaves dirty
    lines that the next kernel's reads evict, as phase 3 times), and a
    sum that only reads."""
    import torch

    src = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)

    def flush():
        dst.copy_(src)

    def read_flush():
        src.view(torch.int32).sum()

    return flush, read_flush


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


def device_trace():
    """A torch.profiler context that traces the device alone (kernels,
    copies, memsets), for device_busy_s."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def device_busy_s(prof):
    """(seconds the device was busy, spans): the union of the device
    spans of a device_trace()."""
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if str(getattr(ev, "device_type", "")).endswith("CUDA"))
    busy_us, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    return busy_us / 1e6, len(spans)


def kernel_bound(n: int, k: int, *, hash_filter: bool, sort_filter: bool,
                 now: bool, validate: bool, pidx_column: bool,
                 ops: float, mask_rows: int = 1):
    """(bound_ms, bound_by) of one table launch over `n` records of key
    width `k`: each input byte the call needs read once, each output byte
    written once (table_bytes), over HBM; `ops` integer operations over
    the non-tensor peak."""
    nbytes = table_bytes(n, k, hash_filter=hash_filter,
                         sort_filter=sort_filter, now=now, validate=validate,
                         pidx_column=pidx_column, mask_rows=mask_rows)
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    return (mem_ms, "bytes") if mem_ms >= ops_ms else (ops_ms, "operations")


def table_bytes(n: int, k: int, *, hash_filter: bool, sort_filter: bool,
                now: bool, validate: bool, pidx_column: bool,
                mask_rows: int = 1) -> int:
    """The bytes one table launch over `n` records of key width `k`
    moves. Per record: valid 1 B; hash_lo 4 B (and the pidx column 4 B)
    with validation; expire_ts 4 B with `now`; the key row k B and
    hashkey_len 4 B with any filter, key_len 4 B with a sortkey filter.
    Output: a status byte with `now`, a packed keep bit without, in each
    of `mask_rows` rows (the flavour axis writes one row a flavour)."""
    per = 1
    if validate:
        per += 4 + (4 if pidx_column else 0)
    if now:
        per += 4
    if hash_filter or sort_filter:
        per += k + 4
    if sort_filter:
        per += 4
    return n * per + (n if now else mask_rows * -(-n // 8))


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


# flavours of one launch of the kernel's flavour axis
MULTI_KS = (2, 5, 16, 64)
# the check's cut: at key widths past 32 a type pair that would meet 64
# flavours meets 16 (the plain version's time grows with flavours x width)
MULTI_K_WIDE = 16


# pattern lengths of one band: (lowest, highest) at key width k
MULTI_BANDS = {"narrow": lambda k: (0, 4), "middle": lambda k: (5, k // 2 - 1),
               "wide": lambda k: (k // 2, k)}


def multi_patterns(rng, n: int, k: int, band: str) -> list:
    """n patterns of lengths mixed within one band: "narrow" 0..4 bytes,
    empty ones included; "middle" 5..k/2-1 (the sortkey window's 5-8
    bytes and the exact matcher's longer ones); "wide" k/2..k, about as
    long as a row of width k; or "mixed", flavour f from the bands in
    turn (every path of the flavour axis in one launch)."""
    bands = tuple(MULTI_BANDS) if band == "mixed" else (band,)
    out = []
    for f in range(n):
        lo, hi = MULTI_BANDS[bands[f % len(bands)]](k)
        out.append(random_pattern(rng, int(rng.integers(lo, hi + 1))))
    return out


def check_tables_multi(device, widths=(32, 64, 256), ks=MULTI_KS,
                       counts=CHECK_COUNTS) -> dict:
    """Phase 3, correctness of the flavour axis: scan_table_multi against
    scan_table_multi_plain, bit for bit, on the tables of check_tables
    (scalar and column pidx), for K flavours of every filter type pair
    with mixed pattern lengths, validation off and on; plus a lone block
    under pv = -1 through multi_static_block_predicate_submit, which must
    give all-zero rows without a launch."""
    import torch

    from pegasus_tpu_torch.ops import fused_scan
    from pegasus_tpu_torch.ops.predicates import (
        FilterSpec,
        multi_static_block_predicate_submit,
    )

    rng = np.random.default_rng(20261019)
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
        for hft in range(4):
            for sft in range(4):
                # one flavour count a type pair, rotating with the width,
                # so that every count meets every width (the plain
                # version's time grows with the flavours)
                case = hft * 4 + sft + widths.index(k)
                n_flavors = ks[case % len(ks)]
                if k > 32:
                    n_flavors = min(n_flavors, MULTI_K_WIDE)
                # the sortkey window's pairs (no hashkey filter, sortkey
                # PREFIX or POSTFIX) meet every band in one launch; the
                # others rotate through the bands
                band = ("mixed" if hft == 0 and sft in (2, 3) else
                        ("narrow", "middle", "wide")[case // len(ks) % 3])
                flavors = [
                    (FilterSpec.make(hft, hp, device),
                     FilterSpec.make(sft, sp, device))
                    for hp, sp in zip(
                        multi_patterns(rng, n_flavors, k, band),
                        multi_patterns(rng, n_flavors, k, band))]
                for validate in (False, True):
                    plain = [fused_scan.scan_table_multi_plain(
                        [block], [pidx], flavors, validate, pv)
                        for block, pidx in zip(blocks, pidxs)]
                    for lo, hi in CHECK_TABLES:
                        got = fused_scan.scan_table_multi(
                            blocks[lo:hi], pidxs[lo:hi], flavors,
                            validate, pv)
                        want = torch.cat(plain[lo:hi], dim=1)
                        if got.shape != want.shape:
                            fail(f"multi table {lo}:{hi} K={k}: "
                                 f"{tuple(got.shape)}, plain "
                                 f"{tuple(want.shape)}")
                        err = int((got.int() - want.int()).abs().max()) \
                            if want.numel() else 0
                        max_err = max(max_err, err)
                        if err:
                            fail(f"multi kernel != plain: table "
                                 f"{lo}:{hi} K={k} hft={hft} sft={sft} "
                                 f"{n_flavors} flavours "
                                 f"{[(h.raw, s.raw) for h, s in flavors]}"
                                 f" validate={validate}")
                        compared += 1
        # a block alone under pv = -1: the split gate rejects every record
        before = dict(fused_scan.LAUNCHES)
        flavors = [(FilterSpec.none(device),
                    FilterSpec.make(3, p, device)) for p in (b"a", b"b")]
        gated = multi_static_block_predicate_submit(blocks[0], flavors, True,
                                                    0, -1)
        if (fused_scan.LAUNCHES != before or tuple(gated.shape)
                != (2, -(-blocks[0].capacity // 8)) or int(gated.sum())):
            fail(f"a lone block under pv = -1 (K={k}) must give zero rows "
                 f"without a launch")
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
    from pegasus_tpu_torch.ops import fused_scan
    from pegasus_tpu_torch.ops.predicates import FilterSpec

    rng = np.random.default_rng(20261017)
    pv, pidx, now_s = 63, 0, 300_000_000
    flush, read_flush = _flusher(device)
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

    from pegasus_tpu_torch.ops import fused_scan
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
    # a trace that recorded fewer scan kernels than the wrapper launched
    # while it ran dropped records, and cannot count the device ops: take
    # another (at most three)
    for profiles in range(1, 4):
        before = fused_scan.LAUNCHES["static"]
        ops = _device_ops(window)
        launched = fused_scan.LAUNCHES["static"] - before
        recorded = sum(c for name, c in ops["names"].items()
                       if "scan_table_kernel" in name)
        if recorded >= launched:
            break
        log(f"stacked_block_eval: the trace recorded {recorded} of the "
            f"{launched} kernel launches; profiling again")
    return {"blocks": n_blocks, "median_us": float(np.median(seconds)) * 1e6,
            "mean_us": float(np.mean(seconds)) * 1e6, "profiles": profiles,
            **ops}


# the timed shapes of the flavour axis: (name, blocks, records per block,
# K, sortkey POSTFIX patterns (one flavour each), L2 flushed)
MULTI_TIMED_SHAPES = (
    ("cold window, 4 sortkey POSTFIX flavours", 16, 1024, 32,
     (b"a", b"b", b"c", b"d"), False),
    ("large K=32, 8 sortkey POSTFIX flavours", 1, 1 << 20, 32,
     (b"a", b"b", b"c", b"d", b"ab", b"bc", b"cd", b"da"), True),
    # phase 5's own launch: a cold window of a flush's ten one-byte
    # POSTFIX flavours (POSTFIX_PATTERNS)
    ("phase 5 window, 10 sortkey POSTFIX flavours", 16, 1024, 32,
     tuple(b"%d" % i for i in range(10)), False),
)
MULTI_LARGE_SHAPE = 1  # the shape reported in the kernels line


def time_tables_multi(device) -> list:
    """Phase 3, times of the flavour axis: each MULTI_TIMED_SHAPES entry
    with validation on and a scalar pidx per block, as
    scan_coordinator._eval_cross_partition_multi launches it; the same
    columns as time_tables."""
    from pegasus_tpu_torch.ops import fused_scan
    from pegasus_tpu_torch.ops.predicates import FilterSpec

    rng = np.random.default_rng(20261020)
    pv, pidx = 63, 0
    flush, _read_flush = _flusher(device)
    out = []
    for name, n_blocks, n, k, patterns, flushed in MULTI_TIMED_SHAPES:
        cols = [serving_block_columns(rng, n, k, pidx, pv)
                for _ in range(n_blocks)]
        blocks = [device_block(c, device) for c in cols]
        flavors = [(FilterSpec.none(device), FilterSpec.make(3, p, device))
                   for p in patterns]
        pidxs = [pidx] * n_blocks

        def kernel():
            fused_scan.scan_table_multi(blocks, pidxs, flavors, True, pv)

        def plain():
            fused_scan.scan_table_multi_plain(blocks, pidxs, flavors, True,
                                              pv)

        before = flush if flushed else None
        iters, plain_iters = (50, 5) if flushed else (200, 10)
        # the status work once a record, the matches once a flavour
        ops = sum(match_ops(c, ((0, b""), (3, p)), True, pidx, pv, None)
                  for c in cols for p in patterns)
        ops -= 8.0 * n_blocks * n * (len(patterns) - 1)
        bound_ms, bound_by = kernel_bound(
            n_blocks * n, k, hash_filter=False, sort_filter=True, now=False,
            validate=True, pidx_column=False, ops=ops,
            mask_rows=len(patterns))
        row = {"shape": f"{name}: {n_blocks} x {n} records, K={k}, "
                        f"static, validation"
                        + (", L2 flushed" if flushed else ""),
               "ms": _device_ms(kernel, iters, "scan_table_multi_kernel",
                                before),
               "call_ms": _cuda_ms(kernel, iters, before),
               "plain_ms": _device_ms(plain, plain_iters, "", before),
               "plain_call_ms": _cuda_ms(plain, plain_iters, before),
               "bound_ms": bound_ms, "bound_by": bound_by}
        if None in (row["ms"], row["plain_ms"]):
            fail(f"torch.profiler recorded no device time for {name}")
        row["share"] = bound_ms / row["ms"]
        out.append(row)
        del blocks, cols
    return out


# ---- phase 3: the scan kernel's key-hash instance -----------------------

# (name, records, K, filter (type, pattern) of the sortkey) of the
# key-hash instance's timed shape: phase 3's large serving shape without
# its stored hash_lo column, validation on, no filter
KEYHASH_TIMED_SHAPE = ("large K=32, no stored hash_lo", 1 << 20, 32)
KEYHASH_FILTERS = ((0, b"", 0, b""), (2, b"ab", 3, b"c"),
                   (1, b"b", 2, b"a"))
KEYHASH_NOWS = (None, 0x80000010)


def drop_hash(block):
    """The same RecordBlock without its stored hash_lo column, as a PGT1
    file's block reaches the scan kernel."""
    return block._replace(hash_lo=None)


def check_key_hash(device, widths=(32, 64, 256),
                   counts=CHECK_COUNTS) -> dict:
    """Phase 3, correctness of the key-hash instance: check_tables' seeded
    tables with hash_lo dropped (every block, and every other block, so
    that a table mixes stored and hashed columns) through both entries,
    scan_table (static and with `now`) and scan_table_multi, validation
    on, against the plain versions (which hash with
    ops/device_crc.key_hash_device on the same device), bit for bit. Every
    launch must take the instance. Returns the tables compared, the
    largest byte difference and the instance's launches."""
    import torch

    from pegasus_tpu_torch.ops import fused_scan
    from pegasus_tpu_torch.ops.predicates import FilterSpec, pack_mask

    rng = np.random.default_rng(20261016)
    pv = 7
    compared = max_err = 0
    before = fused_scan.LAUNCHES["keyhash"]
    launched = 0
    for k in widths:
        stored, pidxs = [], []
        for i, count in enumerate(counts):
            cols = random_block_columns(rng, count, k)
            stored.append(device_block(cols, device))
            if i % 2:
                owned = rng.random(count) < 0.5
                col = np.where(owned, cols[3] & pv,
                               rng.integers(0, pv + 1, count))
                pidxs.append(torch.from_numpy(col.astype(np.int32)).to(
                    device))
            else:
                pidxs.append(int(rng.integers(0, pv + 1)))
        for mix in ("all", "alternate"):
            blocks = [drop_hash(b) if mix == "all" or i % 2 == 0 else b
                      for i, b in enumerate(stored)]
            for hft, hp, sft, sp in KEYHASH_FILTERS:
                hf = FilterSpec.make(hft, hp, device)
                sf = FilterSpec.make(sft, sp, device)
                for now in KEYHASH_NOWS:
                    plain = []
                    for block, pidx in zip(blocks, pidxs):
                        status = fused_scan.scan_status_plain(
                            block, hf, sf, True, pidx, pv, now)
                        plain.append(status if now is not None else
                                     pack_mask(status
                                               == fused_scan.STATUS_KEEP))
                    for lo, hi in CHECK_TABLES:
                        hashed = any(b.hash_lo is None
                                     for b in blocks[lo:hi])
                        n0 = fused_scan.LAUNCHES["keyhash"]
                        got = fused_scan.scan_table(
                            blocks[lo:hi], pidxs[lo:hi], hf, sf, True, pv,
                            now)
                        want = torch.cat(plain[lo:hi])
                        err = int((got.int() - want.int()).abs().max())
                        max_err = max(max_err, err)
                        if err or got.shape != want.shape:
                            fail(f"key-hash instance != plain: table "
                                 f"{lo}:{hi} K={k} {mix} hft={hft} "
                                 f"sft={sft} now={now}")
                        counted = fused_scan.LAUNCHES["keyhash"] - n0
                        if device.type == "cuda" and counted != hashed:
                            fail(f"table {lo}:{hi} {mix}: the key-hash "
                                 f"instance launched {counted} times")
                        launched += counted
                        compared += 1
            # the flavour axis: 5 sortkey POSTFIX flavours
            flavors = [(FilterSpec.none(device),
                        FilterSpec.make(3, p, device))
                       for p in (b"a", b"b", b"ab", b"", b"dc")]
            plain = [fused_scan.scan_table_multi_plain(
                [block], [pidx], flavors, True, pv)
                for block, pidx in zip(blocks, pidxs)]
            for lo, hi in CHECK_TABLES:
                got = fused_scan.scan_table_multi(
                    blocks[lo:hi], pidxs[lo:hi], flavors, True, pv)
                want = torch.cat(plain[lo:hi], dim=1)
                err = (int((got.int() - want.int()).abs().max())
                       if want.numel() else 0)
                max_err = max(max_err, err)
                if err or got.shape != want.shape:
                    fail(f"key-hash instance (flavour axis) != plain: "
                         f"table {lo}:{hi} K={k} {mix}")
                compared += 1
    if device.type == "cuda":
        torch.cuda.synchronize()
    return {"compared": compared, "max_abs_err": max_err,
            "launches": fused_scan.LAUNCHES["keyhash"] - before}


def key_hash_bound(cols) -> tuple:
    """(bound_ms, bound_by) of the key-hash instance over `cols`, static,
    validation on, no filter: each record's valid 1 B, key row K B,
    key_len 4 B and hashkey_len 4 B read once and its packed keep bit
    written once, over HBM; or about 8 integer operations a hashed byte
    (the crc64 step) and 8 a record (the status), over the non-tensor
    peak, whichever is larger."""
    keys, key_len, _ets, _hash_lo = cols
    n, k = keys.shape
    hkl = np.where(key_len >= 2, (keys[:, 0].astype(np.int64) << 8)
                   | keys[:, 1], 0)
    region = np.clip(np.where(hkl > 0, hkl, key_len - 2), 0, k)
    hashed = float(region[key_len >= 2].sum())
    nbytes = n * (1 + k + 4 + 4) + -(-n // 8)
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (8.0 * hashed + 8.0 * n) / SCALAR_OPS_PER_S * 1e3
    return (mem_ms, "bytes") if mem_ms >= ops_ms else (ops_ms, "operations")


def time_key_hash(device) -> dict:
    """Phase 3, the key-hash instance's times at KEYHASH_TIMED_SHAPE, L2
    flushed before each launch, as time_tables times the stored-hash
    kernel: device time (torch.profiler), per call with the host (CUDA
    events), the plain version's two times, the bound."""
    from pegasus_tpu_torch.ops import fused_scan
    from pegasus_tpu_torch.ops.predicates import FilterSpec

    rng = np.random.default_rng(20261021)
    pv, pidx = 63, 0
    name, n, k = KEYHASH_TIMED_SHAPE
    cols = serving_block_columns(rng, n, k, pidx, pv)
    blocks = [drop_hash(device_block(cols, device))]
    hf, sf = FilterSpec.none(device), FilterSpec.none(device)
    flush, _read_flush = _flusher(device)

    def kernel():
        fused_scan.scan_table(blocks, [pidx], hf, sf, True, pv)

    def plain():
        fused_scan.scan_table_plain(blocks, [pidx], hf, sf, True, pv)

    bound_ms, bound_by = key_hash_bound(cols)
    row = {"shape": f"{name}: 1 x {n} records, K={k}, static, validation, "
                    f"L2 flushed",
           "ms": _device_ms(kernel, 50, "scan_table_kernel", flush),
           "call_ms": _cuda_ms(kernel, 50, flush),
           "plain_ms": _device_ms(plain, 3, "", flush),
           "plain_call_ms": _cuda_ms(plain, 3, flush),
           "bound_ms": bound_ms, "bound_by": bound_by}
    if None in (row["ms"], row["plain_ms"]):
        fail("torch.profiler recorded no device time for the key-hash "
             "instance")
    row["share"] = bound_ms / row["ms"]
    return row


# ---- phase 3: the compaction-filter kernel -------------------------------

# rows of the chunks checked: full 256-row tiles, a ragged tail, one row
COMPACT_CHECK_ROWS = (4096, 4059, 777, 1)
# the rulesets the check rotates through (None: TTL and split only)
COMPACT_RULESETS = (
    None,
    # every match type on both regions, all three update types
    [{"op": "delete_key", "rules": [
        {"type": "hashkey_pattern", "match": "anywhere", "pattern": "bc"},
        {"type": "sortkey_pattern", "match": "prefix", "pattern": "a"}]},
     {"op": "update_ttl", "update_ttl_type": "from_current", "value": 100,
      "rules": [{"type": "sortkey_pattern", "match": "anywhere",
                 "pattern": "dd"}]},
     {"op": "update_ttl", "update_ttl_type": "timestamp",
      "value": 1451606400 + 12345, "rules": [
          {"type": "hashkey_pattern", "match": "postfix", "pattern": "a"}]},
     {"op": "update_ttl", "update_ttl_type": "from_now", "value": 600,
      "rules": [{"type": "hashkey_pattern", "match": "prefix",
                 "pattern": "d"}]},
     {"op": "delete_key", "rules": [
         {"type": "sortkey_pattern", "match": "postfix", "pattern": "cb"},
         {"type": "ttl_range", "start_ttl": 0, "stop_ttl": 0}]}],
    # empty patterns (match nothing) beside a ttl_range delete
    [{"op": "delete_key", "rules": [
        {"type": "hashkey_pattern", "match": "prefix", "pattern": ""}]},
     {"op": "delete_key", "rules": [
         {"type": "sortkey_pattern", "match": "anywhere", "pattern": ""}]},
     {"op": "delete_key", "rules": [
         {"type": "ttl_range", "start_ttl": 100, "stop_ttl": 1000}]}],
    # delete before update on the same rows; ranges and values that wrap
    # past 2^32; a pattern longer than any row
    [{"op": "delete_key", "rules": [
        {"type": "sortkey_pattern", "match": "prefix", "pattern": "a"}]},
     {"op": "update_ttl", "update_ttl_type": "from_now", "value": 7,
      "rules": [{"type": "sortkey_pattern", "match": "prefix",
                 "pattern": "a"}]},
     {"op": "delete_key", "rules": [
         {"type": "ttl_range", "start_ttl": 0xFFFFFF00,
          "stop_ttl": 0xFFFFFFF0}]},
     {"op": "update_ttl", "update_ttl_type": "from_current",
      "value": 0xFFFFFF00, "rules": [
          {"type": "hashkey_pattern", "match": "anywhere", "pattern": "c"}]},
     {"op": "delete_key", "rules": [
         {"type": "hashkey_pattern", "match": "anywhere",
          "pattern": "abcd" * 70}]}],
    # the table's bounds: 16 operations of 4 rules
    [{"op": "update_ttl" if i % 2 else "delete_key",
      "update_ttl_type": "from_now", "value": i, "rules": [
          {"type": "hashkey_pattern", "match": "anywhere",
           "pattern": "abcd"[i % 4] * (1 + i % 3)},
          {"type": "sortkey_pattern", "match": "postfix",
           "pattern": "dcba"[i % 4]},
          {"type": "ttl_range", "start_ttl": 0, "stop_ttl": 1 << 31},
          {"type": "hashkey_pattern", "match": "prefix",
           "pattern": "abcd"[(i + 1) % 4]}]} for i in range(16)],
)
# BASELINE config #4's ruleset (bench.py:763-779)
CONFIG4_RULES = [
    {"op": "delete_key", "rules": [
        {"type": "hashkey_pattern", "match": "prefix",
         "pattern": "user000001"}]},
    {"op": "delete_key", "rules": [
        {"type": "hashkey_pattern", "match": "anywhere", "pattern": "7777"},
        {"type": "sortkey_pattern", "match": "prefix", "pattern": "s0"}]},
]
COMPACT_NOWS = (5000, 0xFFFFFF00)


def compaction_chunk_columns(rng, b: int, k: int):
    """numpy chunk columns as compaction_eval_submit stacks them: keys
    over the 4-letter alphabet with empty hashkeys, malformed headers and
    invalid (padding) rows, hashkey_len from the big-endian prefix,
    expire_ts around both COMPACT_NOWS and past 2^31, random hash_lo, a
    pidx column of 4 partitions (a split in progress)."""
    keys = np.zeros((b, k), dtype=np.uint8)
    key_len = np.zeros(b, dtype=np.int32)
    valid = rng.random(b) >= 0.05
    lens = rng.integers(2, k + 1, b)
    for i in np.flatnonzero(valid):
        n = int(lens[i])
        hkl = int(rng.integers(0, n - 1))
        if rng.random() < 0.05:
            hkl = n + int(rng.integers(0, 40))  # malformed header
        keys[i, 0], keys[i, 1] = hkl >> 8, hkl & 0xFF
        keys[i, 2:n] = rng.choice(ALPHABET, n - 2)
        key_len[i] = n
    hkl = ((key_len > 0) * ((keys[:, 0].astype(np.int32) << 8)
                            | keys[:, 1])).astype(np.int32)
    ets = rng.choice(np.array(
        [0, 0, 100, 5000, 5100, 5300, 0x7FFFFFFF, 0x80000005, 0xFFFFFF10,
         0xFFFFFFF5], np.uint32), b)
    hash_lo = rng.integers(0, 1 << 32, b, dtype=np.uint64).astype(np.uint32)
    pidx = rng.integers(0, 4, b).astype(np.uint32)
    return keys, key_len, hkl, ets, valid, hash_lo, pidx


def _device_columns(cols, device):
    """The chunk columns as eval_block takes them on `device`."""
    import torch

    return [torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                             if a.dtype == np.uint32
                             else np.ascontiguousarray(a)).to(device)
            for a in cols]


def _max_err(got, want, what: str) -> int:
    """Largest difference of two integer or bool tensors of one shape."""
    import torch

    if got.shape != want.shape:
        fail(f"compaction kernel != plain ({what}): shape "
             f"{tuple(got.shape)}, plain {tuple(want.shape)}")
    if not got.numel():
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def check_compaction(device, widths=(32, 64, 256),
                     rows=COMPACT_CHECK_ROWS) -> dict:
    """Phase 3, correctness of the compaction-filter kernel, bit for bit
    against its plain torch version on the same tensors: the bulk
    program (eval_block) at key widths 32, 64 and 256, validation off and
    on (a per-row pidx column across a split), default_ttl 0 and
    non-zero, want_ets and pack on and off, `now` low and near 2^32,
    over a rotation of rulesets (COMPACT_RULESETS: every rule kind and match
    type, empty patterns, all three update types, delete before update,
    values past 2^32, the table's bounds); validation without a hash_lo
    column (the kernel hashes the keys) under every ruleset; the merge
    path's filter
    (compaction_filter_block) and its rules hook (compile_rules) on the
    same chunks; a ruleset past the table's bounds must raise."""
    import torch

    from pegasus_tpu_torch.ops import compaction as tcomp
    from pegasus_tpu_torch.ops import fused_compaction
    from pegasus_tpu_torch.ops.compaction_rules import (
        apply_rules_ops,
        parse_rules,
    )

    rng = np.random.default_rng(20261021)
    rulesets = [None if r is None else tuple(parse_rules(r))
                for r in COMPACT_RULESETS]
    pv = 3
    compared = 0
    max_err = 0
    case = 0
    for k in widths:
        for b in rows:
            cols = _device_columns(compaction_chunk_columns(rng, b, k),
                                   device)
            keys, key_len, hkl, ets, valid, hash_lo, pidx = cols
            for validate in (False, True):
                for dttl in (0, 0x500):
                    for want_ets, pack in ((True, False), (False, True),
                                           (True, True), (False, False)):
                        which = case % len(rulesets)
                        ops = rulesets[which]
                        now = COMPACT_NOWS[case % len(COMPACT_NOWS)]
                        case += 1
                        args = (keys, key_len, hkl, ets, valid, hash_lo,
                                now, dttl, pidx, pv, validate, True)
                        got = tcomp.make_compaction_eval(ops)(
                            *args, want_ets=want_ets, pack=pack)
                        want = tcomp.eval_block_plain(
                            ops, *args, want_ets=want_ets, pack=pack)
                        for g, w, what in zip(got, want, ("drop", "ets2")):
                            err = _max_err(g, w, what)
                            max_err = max(max_err, err)
                            if err:
                                fail(f"compaction kernel != plain: {what} "
                                     f"K={k} B={b} validate={validate} "
                                     f"default_ttl={dttl} want_ets="
                                     f"{want_ets} pack={pack} now={now} "
                                     f"ruleset {which}")
                        compared += 1
            # validation without a hash_lo column: the kernel hashes the
            # keys, under every ruleset
            for which, ops in enumerate(rulesets):
                want_ets, pack = ((True, False), (False, True))[which % 2]
                dttl = (0, 0x500)[which % 2]
                now = COMPACT_NOWS[which % len(COMPACT_NOWS)]
                args = (keys, key_len, hkl, ets, valid, hash_lo, now, dttl,
                        pidx, pv, True, False)
                got = tcomp.make_compaction_eval(ops)(
                    *args, want_ets=want_ets, pack=pack)
                want = tcomp.eval_block_plain(
                    ops, *args, want_ets=want_ets, pack=pack)
                for g, w, what in zip(got, want, ("drop", "ets2")):
                    err = _max_err(g, w, what)
                    max_err = max(max_err, err)
                    if err:
                        fail(f"compaction kernel != plain without hash_lo: "
                             f"{what} K={k} B={b} ruleset {which}")
                compared += 1
            # the merge path's filter: scalar pidx, bool mask, ets2
            for validate, pidx_s, now in ((False, 0, 5000), (True, 2, 5000),
                                          (True, 1, 0xFFFFFF00)):
                got = tcomp.compaction_filter_block(
                    hash_lo, ets, valid, now, 0x500, pidx_s, pv, validate)
                want = tcomp.compaction_filter_block_plain(
                    hash_lo, ets, valid, now, 0x500, pidx_s, pv, validate)
                for g, w in zip(got, want):
                    max_err = max(max_err, _max_err(g, w, "merge filter"))
                compared += 1
            # the merge path's rules hook: no expiry, no validation (the
            # kernel's own mode, so only on the card)
            for ops in rulesets[1:] if device.type == "cuda" else ():
                got = fused_compaction.compaction_filter(
                    keys, key_len, ets, valid, None, 0, ops, 5000, 0, 0,
                    validate_hash=False, expire=False, want_ets=True,
                    pack=False)
                want = apply_rules_ops(ops, keys, key_len, hkl, ets, valid,
                                       5000)
                max_err = max(max_err,
                              _max_err(got[0], want[0], "rules hook drop"),
                              _max_err(got[1].to(torch.int64) & 0xFFFFFFFF,
                                       want[1], "rules hook ets"))
                compared += 1
            if max_err:
                fail(f"compaction kernel != plain (merge path) K={k} B={b}")
    if device.type == "cuda":
        too_big = tuple(parse_rules([COMPACT_RULESETS[-1][0]] * 17))
        try:
            fused_compaction.compaction_filter(
                keys, key_len, ets, valid, None, 0, too_big, 5000, 0, 0,
                validate_hash=False)
            fail("a ruleset of 17 operations must raise")
        except ValueError:
            pass
        torch.cuda.synchronize()
    return {"compared": compared, "max_abs_err": max_err}


def fixture_keys(idx: np.ndarray) -> np.ndarray:
    """uint8[n, 32] key rows of bench.py's compaction fixture for record
    numbers `idx`: hashkey `user%08d` of idx // 10, sortkey `s%02d` of
    idx % 10."""
    n = idx.size
    keys = np.zeros((n, 32), dtype=np.uint8)
    keys[:, 1] = 12  # big-endian u16 hashkey length
    keys[:, 2:14] = np.frombuffer(
        b"".join(b"user%08d" % h for h in (idx // 10).tolist()),
        dtype=np.uint8).reshape(n, 12)
    keys[:, 14:17] = np.frombuffer(
        b"".join(b"s%02d" % s for s in (idx % 10).tolist()),
        dtype=np.uint8).reshape(n, 3)
    return keys


def compaction_bound(rows: int, k: int, *, keys: bool, hash_lo: bool,
                     pidx_col: bool, pack: bool, want_ets: bool,
                     ops: float, slots: int = 0):
    """(bound_ms, bound_by) of one compaction-filter launch over `rows`
    rows: valid 1 B and expire_ts 4 B a row; the key row k B and key_len
    4 B where a pattern rule or the key hash reads them (the hashkey
    length is the row's own first two bytes); hash_lo and a pidx column
    4 B each where read; the slot gate's pidx (4 B) and allowed (1 B)
    once a slot of `slots`; out the drop mask (1/8 B packed, else 1 B)
    and ets2 4 B when asked; `ops` integer operations at the card's
    scalar rate."""
    per = 5 + (k + 4 if keys else 0) + (4 if hash_lo else 0) \
        + (4 if pidx_col else 0) + (4 if want_ets else 0)
    nbytes = rows * per + (-(-rows // 8) if pack else rows) + 5 * slots
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    return (mem_ms, "bytes") if mem_ms >= ops_ms else (ops_ms, "operations")


# the merge path's filter batch: 16 blocks of 1024 records a device
# evaluation (storage/lsm.py LSMStore.compact), its compaction_filter_block
# launch on the padded batch
MERGE_BATCH_ROWS = 16 * 1024
# (name, rows, how): the bulk program at config #4's ruleset ("rules"),
# the same validating a chunk without hash_lo ("rules, hash keys"), the
# merge path's filter ("merge")
COMPACT_TIMED_SHAPES = (
    ("(i) chunk", 1 << 18, "rules"),
    ("(ii) large", 1 << 20, "rules"),
    ("(iii) merge batch", MERGE_BATCH_ROWS, "merge"),
    ("(iv) chunk, validation without hash_lo", 1 << 18, "rules, hash keys"),
)


def compaction_timing_cases(device, rows: int, how: str):
    """(kernel, plain, bound_ms, bound_by, shape) of one
    COMPACT_TIMED_SHAPES entry on `device`: fixture keys (K = 32,
    `user%08d` hashkeys of 12 bytes), 5% of the rows expired; `kernel`
    and `plain` each make one call and return its outputs."""
    from pegasus_tpu_torch.ops import compaction as tcomp
    from pegasus_tpu_torch.ops.compaction_rules import parse_rules

    rng = np.random.default_rng(20261022)
    idx = rng.integers(0, 7_000_000, rows)
    keys = fixture_keys(idx)
    key_len = np.full(rows, 17, dtype=np.int32)
    ets = np.where(rng.random(rows) < 0.05, np.uint32(5000 - 100),
                   np.uint32(0)).astype(np.uint32)
    hash_lo = rng.integers(0, 1 << 32, rows,
                           dtype=np.uint64).astype(np.uint32)
    pidx = (hash_lo & 3).astype(np.uint32)
    cols = _device_columns(
        (keys, key_len, np.full(rows, 12, dtype=np.int32), ets,
         np.ones(rows, bool), hash_lo, pidx), device)
    if how == "merge":
        # phases 4-6: a partition of 64 validating, scalar pidx, bool mask
        # and ets2 back, default_ttl already applied
        _k, _kl, _h, d_ets, d_valid, d_lo, _p = cols
        args = (d_lo, d_ets, d_valid, 5000, 0, 1, 63, True)

        def kernel():
            return tcomp.compaction_filter_block(*args)

        def plain():
            return tcomp.compaction_filter_block_plain(*args)

        bound_ms, bound_by = compaction_bound(
            rows, 32, keys=False, hash_lo=True, pidx_col=False, pack=False,
            want_ets=True, ops=rows * 8.0)
        return (kernel, plain, bound_ms, bound_by,
                f"{rows} rows (the merge path's filter batch), no keys, "
                f"validation against hash_lo, scalar pidx, bool mask and "
                f"ets2, L2 flushed")
    hash_keys = how == "rules, hash keys"
    ops = tuple(parse_rules(CONFIG4_RULES))
    eval_block = tcomp.make_compaction_eval(ops)
    args = (*cols[:6], 5000, 0, cols[6] if hash_keys else 0, 3,
            hash_keys, not hash_keys)

    def kernel():
        return eval_block(*args, want_ets=False, pack=True)

    def plain():
        return tcomp.eval_block_plain(ops, *args, want_ets=False, pack=True)

    # the match work: the 10-byte prefix of rule 1 and the 9 candidate
    # starts of "7777" in a 12-byte hashkey, the 2-byte sortkey prefix
    # where that matched, and ~8 for the rest of a row; the key hash
    # about 8 operations a byte of its 12-byte hashkey region
    hk = keys[:, 2:14]
    ops_n = rows * (8 + 10 + 9) + 2.0 * sum(
        b"7777" in bytes(r) for r in hk[:4096]) * rows / 4096
    if hash_keys:
        ops_n += rows * 8.0 * 12
    bound_ms, bound_by = compaction_bound(
        rows, 32, keys=True, hash_lo=False, pidx_col=hash_keys, pack=True,
        want_ets=False, ops=ops_n)
    return (kernel, plain, bound_ms, bound_by,
            f"{rows} rows, K=32, BASELINE config #4 ruleset, packed, no "
            + ("ets2, validation hashing the keys (no hash_lo), pidx "
               "column" if hash_keys else "ets2, no validation")
            + ", L2 flushed")


def time_compaction(device, shapes=COMPACT_TIMED_SHAPES) -> list:
    """Phase 3, times of the compaction-filter kernel through its
    wrappers at `shapes` (COMPACT_TIMED_SHAPES entries), L2 flushed
    before each launch by writing FLUSH_BYTES (and, for the kernel, again
    after a flush that only reads them, which leaves no dirty lines in L2
    to write back): device time (torch.profiler), per call with the host
    (CUDA events), the plain version's two, the bound, and launches a
    call."""
    import torch

    from pegasus_tpu_torch.ops import fused_compaction

    flush, read_flush = _flusher(device)
    out = []
    for name, rows, how in shapes:
        kernel, plain, bound_ms, bound_by, shape = compaction_timing_cases(
            device, rows, how)
        before = fused_compaction.LAUNCHES["compaction"]
        kernel()
        torch.cuda.synchronize()
        launches = fused_compaction.LAUNCHES["compaction"] - before
        row = {"shape": f"{name}: {shape}", "rows": rows,
               "ms": _device_ms(kernel, 50, "compaction_filter_kernel",
                                flush),
               "ms_read_flushed": _device_ms(
                   kernel, 50, "compaction_filter_kernel", read_flush),
               "call_ms": _cuda_ms(kernel, 50, flush),
               "plain_ms": _device_ms(plain, 10, "", flush),
               "plain_call_ms": _cuda_ms(plain, 10, flush),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "launches_per_call": launches}
        if None in (row["ms"], row["ms_read_flushed"], row["plain_ms"]):
            fail(f"torch.profiler recorded no device time for the "
                 f"compaction kernel at {name}")
        if launches != 1:
            fail(f"the compaction wrapper launched {launches} kernels a "
                 f"call at {name}, not 1")
        row["share"] = bound_ms / row["ms"]
        out.append(row)
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
    fused_scan.LAUNCHES.update(dict.fromkeys(fused_scan.LAUNCHES, 0))
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


# ---- phase 5: the batched cross-partition scan path ----------------------

NODE_PARTITIONS = 8            # one node's share: pidx 0..7 of 64
BATCHED_RECORDS = 1_000_000    # over the node's partitions
BATCHED_OPS = 20_000           # YCSB-E operations (95% scans, 5% inserts)
SCAN_FLUSH = 32                # scans a flush coalesces (bench.py:251)
LEFTOVERS = 100                # split leftovers written to each partition
POSTFIX_PATTERNS = [b"%d" % i for i in range(10)]
STEADY_TTL_S = 600             # TTL of the steady state's rewritten records


def node_hashkeys(counts: dict) -> dict:
    """{pidx: the first counts[pidx] hashkeys user%08d routing to pidx}
    (crc64(hashkey) % PARTITION_COUNT), from one pass over the keys."""
    from pegasus_tpu_torch.base.crc import crc64_batch

    out = {p: [] for p in counts}
    lo, chunk = 0, 1 << 20
    while any(len(out[p]) < n for p, n in counts.items()):
        rows = _user_keys(lo, lo + chunk)
        lens = np.full(rows.shape[0], 12, dtype=np.int64)
        route = crc64_batch(rows, lens) % np.uint64(PARTITION_COUNT)
        for p, n in counts.items():
            for i in np.flatnonzero(route == np.uint64(p))[
                    :n - len(out[p])]:
                out[p].append(rows[i].tobytes())
        lo += chunk
    return out


class BatchedOracle:
    """What one partition's batched one-page scans serve
    (PartitionServer.plan_scan_batch / finish_scan_batch): a scan plans
    the compacted L1 blocks from its start key until 2 * wb + 64 rows
    (wb: the scan's length rounded up to a power of two), keeps the
    planned rows that pass its filter, merges the memtable's rows from
    the start key up to the plan's frontier (past the last planned row
    when the plan reached 2 * want + 64 rows, else unbounded), and
    returns the first `want`. Split leftovers in the memtable are
    foreign, so they are never served. A record with an expire_ts at or
    before the scan's `now` is planned but not served, and counts as
    expired."""

    def __init__(self) -> None:
        self.values: dict = {}     # every served record
        self.expire: dict = {}     # expire_ts of the records with a TTL
        self.keys: list = []       # the L1 keys, in order
        self.starts: list = [0]    # cumulative L1 block starts
        self.overlay: list = []    # served memtable keys, in order

    def compacted(self, runs) -> None:
        metas = [bm for run in runs for bm in run.blocks]
        self.keys = sorted(self.values)
        self.starts = np.cumsum([0] + [bm.count for bm in metas]).tolist()
        if self.starts[-1] != len(self.keys) or any(
                self.keys[i] != bm.first_key
                for i, bm in zip(self.starts, metas)):
            fail(f"compacted store holds {self.starts[-1]} records in "
                 f"{len(metas)} blocks; the oracle has {len(self.keys)}")
        self.overlay = []

    def insert(self, key: bytes, value: bytes) -> None:
        if key not in self.values:
            bisect.insort(self.overlay, key)
        self.values[key] = value

    def expired(self, key: bytes, now: int) -> bool:
        ets = self.expire.get(key, 0)
        return 0 < ets <= now

    def planned(self, start: bytes, want: int):
        """(i, end, capped): the scan plans L1 rows [i, end); `capped`
        when the plan reached 2 * want + 64 rows."""
        keys, starts = self.keys, self.starts
        i = bisect.bisect_left(keys, start)
        wb = 1 << (want - 1).bit_length() if want > 1 else 1
        j = bisect.bisect_right(starts, i) - 1
        rows, end = 0, i
        while j < len(starts) - 1:
            rows += starts[j + 1] - max(i, starts[j])
            end = starts[j + 1]
            j += 1
            if rows >= 2 * wb + 64:
                break
        return i, end, i < len(keys) and rows >= 2 * want + 64

    def expired_in_plan(self, start: bytes, want: int, now: int) -> int:
        """The planned rows expired at `now`: what the server adds to
        abnormal_read_count for the scan."""
        i, end, _capped = self.planned(start, want)
        return sum(self.expired(k, now) for k in self.keys[i:end])

    def page(self, start: bytes, want: int, filters, now: int = 0) -> list:
        from pegasus_tpu_torch.base.key_schema import restore_key
        from pegasus_tpu_torch.ops.predicates import host_match_filter

        hft, hp, sft, sp = filters

        def passes(key: bytes) -> bool:
            if self.expired(key, now):
                return False
            if hft == 0 and sft == 0:
                return True
            hk, sk = restore_key(key)
            return (host_match_filter(hk, hft, hp)
                    and host_match_filter(sk, sft, sp))

        keys = self.keys
        i, end, capped = self.planned(start, want)
        base = []
        for idx in range(i, end):
            if len(base) == want:
                break
            if passes(keys[idx]):
                base.append(keys[idx])
        over = []
        frontier = keys[end - 1] + b"\x00" if capped else None
        for idx in range(bisect.bisect_left(self.overlay, start),
                         len(self.overlay)):
            key = self.overlay[idx]
            if len(over) == want or (frontier and key >= frontier):
                break
            if passes(key):
                over.append(key)
        return [(k, self.values[k]) for k in sorted(base + over)[:want]]


OBS_FLUSHES = 60               # flushes of SCAN_FLUSH scans a pass
OBS_ORDER = "ABBA"             # A: observability off, B: on


def expected_scan_states(oracle, lst) -> list:
    """What one partition's share of a scan_multi flush plans, state by
    state, in the order scan_multi groups the requests (by flavour, in
    order of first appearance): [(requests, rows sent to masks)], the
    rows being every row of every unique L1 block the state's plans
    touch (BatchedOracle.planned's block walk)."""
    groups: dict = {}
    for _r, start, limit, f in lst:
        key = ((0, b"", 0, b"") if f[2] == 0 or not f[3] else f)
        groups.setdefault(key, []).append((start, limit))
    starts = oracle.starts
    out = []
    for reqs in groups.values():
        blocks = set()
        for start, limit in reqs:
            i, end, _capped = oracle.planned(start, limit)
            if end > i:
                j0 = bisect.bisect_right(starts, i) - 1
                j1 = bisect.bisect_right(starts, end - 1) - 1
                blocks.update(range(j0, j1 + 1))
        out.append((len(reqs), sum(starts[j + 1] - starts[j]
                                   for j in blocks)))
    return out


def observability_ab(servers, oracles, flushes, check) -> dict:
    """Phase 5's observability passes over the same seeded flushes, in
    OBS_ORDER: A with the layer off (`[pegasus.perfctx] enabled` false,
    `[pegasus.tracing] sample_ratio` 0), B with it on (PerfContexts,
    sample_ratio 1 with one span a flush, the slow log at threshold 0).
    Every page is checked against the oracle in both. In B, every state
    of every flush must leave one slow-log entry carrying its PerfContext,
    whose rows_evaluated equals the rows its plan sent to masks, and the
    flush's span must carry the JAX package's stage names and the summed
    cost vector. Returns scans/s a pass (flush wall only) and the checks
    counted."""
    from pegasus_tpu_torch.base.value_schema import epoch_now
    from pegasus_tpu_torch.server.scan_coordinator import scan_multi
    from pegasus_tpu_torch.utils import tracing
    from pegasus_tpu_torch.utils.flags import FLAGS

    names = (("pegasus.perfctx", "enabled"),
             ("pegasus.tracing", "sample_ratio"))
    saved = {k: FLAGS.get(*k) for k in names}
    thresholds = [s.slow_log.threshold_ms for s in servers]
    out = {"order": OBS_ORDER, "scans_per_s": [], "entries": 0,
           "spans": 0, "stages": set()}
    try:
        for mode in OBS_ORDER:
            on = mode == "B"
            FLAGS.set("pegasus.perfctx", "enabled", on, force=True)
            FLAGS.set("pegasus.tracing", "sample_ratio", 1.0 if on else 0.0,
                      force=True)
            for s, t in zip(servers, thresholds):
                s.update_app_envs({"replica.slow_query_threshold_ms":
                                   "0" if on else str(t)})
                s.slow_log.dump(clear=True)
            tracing.reset()
            ring = tracing.ring_for("chip-smoke-node")
            wall = 0.0
            n_scans = 0
            for items in flushes:
                now = epoch_now()
                t = time.perf_counter()
                span = (ring.start("scan_multi") if tracing.maybe_sample()
                        else None)
                with tracing.activate(span):
                    got = scan_multi([(servers[p], [r for r, *_ in lst])
                                      for p, lst in items], now)
                if span is not None:
                    span.finish()
                wall += time.perf_counter() - t
                n_scans += sum(len(lst) for _p, lst in items)
                for (p, lst), resps in zip(items, got):
                    for (_r, start, limit, f), resp in zip(lst, resps):
                        check(resp, p, start, limit, f, now)
                if not on:
                    continue
                if span is None:
                    fail("sample_ratio 1 sampled no span")
                total_rows = 0
                for p, lst in items:
                    want = expected_scan_states(oracles[p], lst)
                    entries = servers[p].slow_log.dump(clear=True)
                    got_states = [(e["perf"]["ops"],
                                   e["perf"]["rows_evaluated"])
                                  for e in entries
                                  if e["name"].startswith("scan_batch.")
                                  and "perf" in e]
                    if len(entries) != len(want) or got_states != want:
                        fail(f"partition {p}: slow-log entries "
                             f"{[(e['name'], e.get('perf', {}).get('ops'), e.get('perf', {}).get('rows_evaluated')) for e in entries]}"
                             f", the plan's states {want}")
                    out["entries"] += len(entries)
                    total_rows += sum(r for _o, r in want)
                ann = [a for a, _t in span.annotations]
                if not {"plan", "decode", "finish"} <= set(ann):
                    fail(f"the flush's span carries {ann}")
                pc = span.tags.get("perf")
                if pc is None or pc["rows_evaluated"] != total_rows:
                    fail(f"the flush's span perf {pc}, want rows_evaluated "
                         f"{total_rows}")
                out["spans"] += 1
                out["stages"].update(ann)
            out["scans_per_s"].append(n_scans / wall)
    finally:
        for k, v in saved.items():
            FLAGS.set(*k, v, force=True)
        for s, t in zip(servers, thresholds):
            s.update_app_envs({"replica.slow_query_threshold_ms": str(t)})
        tracing.reset()
    out["stages"] = sorted(out["stages"])
    return out


def run_batched(device, n_records: int = BATCHED_RECORDS,
                n_ops: int = BATCHED_OPS, seed: int = 11,
                card: str = "") -> dict:
    """Phase 5: one node's share of the YCSB-E table (NODE_PARTITIONS
    partitions, each a PartitionServer on `device`) served through
    scan_coordinator.scan_multi in flushes of SCAN_FLUSH scans, every
    page checked against a BatchedOracle; then the steady state: after a
    compaction and MaskPrefresher passes until nothing is left to warm,
    a flush of unfiltered scans must find every mask cached and launch
    nothing. Returns the kernel launches of the traffic by mode."""
    import torch

    from benchmark.core.probe import ExecWall
    from pegasus_tpu_torch.base.key_schema import (
        generate_key,
        key_hash_parts,
        restore_key,
    )
    from pegasus_tpu_torch.base.value_schema import (
        epoch_now,
        expire_ts_from_ttl,
    )
    from pegasus_tpu_torch.ops import fused_scan, record_block
    from pegasus_tpu_torch.ops.predicates import FT_MATCH_POSTFIX
    from pegasus_tpu_torch.server import page
    from pegasus_tpu_torch.server.partition_server import PartitionServer
    from pegasus_tpu_torch.server.scan_coordinator import (
        MaskPrefresher,
        scan_multi,
    )
    from pegasus_tpu_torch.server.types import (
        SCAN_CONTEXT_ID_COMPLETED,
        GetScannerRequest,
        KeyValue,
        MultiPutRequest,
    )

    rng = np.random.default_rng(seed)
    parts = range(NODE_PARTITIONS)
    per_part = n_records // NODE_PARTITIONS
    n_hashkeys = max(1, per_part // 10)
    reserve = n_ops // NODE_PARTITIONS + 64   # fresh hashkeys for inserts
    counts = {p: n_hashkeys + reserve for p in parts}
    # split leftovers: records of the partition p + 32 a split left in p
    counts.update({p + PARTITION_COUNT // 2: LEFTOVERS for p in parts})
    t0 = time.perf_counter()
    hks = node_hashkeys(counts)
    pools = {p: hks[p][n_hashkeys:] for p in parts}
    hashkeys = {p: hks[p][:n_hashkeys] for p in parts}
    log(f"batched: hashkeys of {NODE_PARTITIONS} partitions routed in "
        f"{time.perf_counter() - t0:.1f} s")
    oracles = {p: BatchedOracle() for p in parts}
    gc_pauses = GcPauses()
    data_dir = tempfile.mkdtemp(prefix="pegasus_torch_batched_")
    servers = []
    try:
        servers = [PartitionServer(os.path.join(data_dir, str(p)), pidx=p,
                                   partition_count=PARTITION_COUNT,
                                   device=device) for p in parts]
        t0 = time.perf_counter()
        written = expiring = 0
        for p in parts:
            for hk in hashkeys[p]:
                hnum = int(hk[4:])
                live, short = [], []
                for s, sk in enumerate(SORT_KEYS):
                    kv = KeyValue(sk, b"field0=%064d" % (hnum * 10 + s))
                    (short if rng.random() < 0.10 else live).append(kv)
                for kvs, ttl in ((live, 0), (short, 1)):
                    if kvs and servers[p].on_multi_put(
                            MultiPutRequest(hk, kvs, ttl),
                            partition_hash=key_hash_parts(hk)) != 0:
                        fail("multi_put refused")
                for kv in live:
                    oracles[p].values[generate_key(hk, kv.key)] = kv.value
                written += len(live) + len(short)
                expiring += len(short)
        log(f"batched: loaded {written} records ({expiring} with a 1 s "
            f"TTL) into {NODE_PARTITIONS} partitions in "
            f"{time.perf_counter() - t0:.1f} s")
        deadline = epoch_now() + 2   # every short TTL expired first
        while epoch_now() < deadline:
            time.sleep(0.1)
        t0 = time.perf_counter()
        for p in parts:
            servers[p].manual_compact()
            oracles[p].compacted(servers[p].engine.lsm.l1_runs)
        n_blocks = sum(len(r.blocks) for s in servers
                       for r in s.engine.lsm.l1_runs)
        log(f"batched: flush + manual_compact of {NODE_PARTITIONS} "
            f"partitions in {time.perf_counter() - t0:.1f} s -> "
            f"{sum(len(o.keys) for o in oracles.values())} records in "
            f"{n_blocks} SST blocks")
        for p in parts:
            for hk in hks[p + PARTITION_COUNT // 2]:
                if servers[p].on_put(generate_key(hk, b"s00"),
                                     b"stale") != 0:
                    fail("split leftover refused")

        # the stream, drawn up front (bench.py run_scans' shape)
        weights = 1.0 / (1.0 + rng.permutation(NODE_PARTITIONS))
        pidx_of = rng.choice(NODE_PARTITIONS, n_ops, p=weights / weights.sum())
        ranks = zipf_ranks(rng, n_hashkeys, n_ops)
        orders = {p: rng.permutation(n_hashkeys) for p in parts}
        lens = rng.integers(1, 101, n_ops)
        inserts = rng.random(n_ops) < 0.05
        insert_pidx = rng.integers(0, NODE_PARTITIONS, n_ops)
        filtered = rng.random(n_ops) < 0.15
        patterns = rng.integers(0, len(POSTFIX_PATTERNS), n_ops)

        pending: dict = {}
        flush_s, scan_s, flush_cpu = [], [], 0.0
        stats = {"scans": 0, "flushes": 0, "inserts": 0, "records": 0,
                 "full": 0, "insert_s": 0.0}
        gc_lat = []

        def check(resp, p, start, limit, f, now):
            if resp.error != 0 or resp.context_id != SCAN_CONTEXT_ID_COMPLETED:
                fail(f"batched scan: error {resp.error}, context "
                     f"{resp.context_id}")
            got = [(kv.key, kv.value) for kv in resp.kvs]
            want = oracles[p].page(start, limit, f, now)
            if got != want:
                fail(f"batched scan of partition {p} from {start!r} limit "
                     f"{limit} filters {f}: got {len(got)} records "
                     f"{got[:3]}..., want {len(want)} {want[:3]}...")
            stats["records"] += len(got)
            stats["full"] += len(got) == limit

        def flush_pending():
            if not pending:
                return
            items = list(pending.items())
            g = gc_pauses.count
            now = epoch_now()
            c, t = time.process_time(), time.perf_counter()
            out = scan_multi([(servers[p], [r for r, *_ in lst])
                              for p, lst in items], now)
            seconds = time.perf_counter() - t
            nonlocal flush_cpu
            flush_cpu += time.process_time() - c
            n = sum(len(lst) for _p, lst in items)
            flush_s.append(seconds)
            scan_s.extend([seconds] * n)
            if gc_pauses.count != g:
                gc_lat.append(seconds)
            for (p, lst), resps in zip(items, out):
                for (_r, start, limit, f), resp in zip(lst, resps):
                    check(resp, p, start, limit, f, now)
            stats["flushes"] += 1
            stats["scans"] += n
            pending.clear()

        def request(start, limit, f):
            return GetScannerRequest(
                start_key=start, batch_size=limit,
                validate_partition_hash=True, one_page=True,
                hash_key_filter_type=f[0], hash_key_filter_pattern=f[1],
                sort_key_filter_type=f[2], sort_key_filter_pattern=f[3])

        fused_scan.LAUNCHES.update(dict.fromkeys(fused_scan.LAUNCHES, 0))
        page.SERVE_STATS.update(dict.fromkeys(page.SERVE_STATS, 0))
        record_block.H2D.update(dict.fromkeys(record_block.H2D, 0))
        # what exists now (the oracles' million keys above all) is never
        # garbage: out of the collector's sight, the pauses below are
        # the ones the serving's own allocations cause
        gc.collect()
        gc.freeze()
        gc_pauses.reset()
        # the device's busy time over the traffic, from a CUDA trace
        on_card = device.type == "cuda"
        trace = device_trace() if on_card else contextlib.nullcontext()
        # the flushes' wall by stage of the task profiler, on over the
        # traffic and summed as the stages are observed
        stage_wall = ExecWall()
        t_traffic = time.perf_counter()
        with trace as prof, stage_wall:
            for op in range(n_ops):
                if inserts[op]:
                    flush_pending()  # writes serialize against pending scans
                    p = int(insert_pidx[op])
                    hk = pools[p].pop()
                    t = time.perf_counter()
                    if servers[p].on_put(generate_key(hk, b"s00"), b"inserted",
                                         partition_hash=key_hash_parts(hk)):
                        fail("insert refused")
                    stats["insert_s"] += time.perf_counter() - t
                    oracles[p].insert(generate_key(hk, b"s00"), b"inserted")
                    stats["inserts"] += 1
                    continue
                p = int(pidx_of[op])
                start = generate_key(hashkeys[p][orders[p][ranks[op]]], b"")
                f = ((0, b"", FT_MATCH_POSTFIX, POSTFIX_PATTERNS[patterns[op]])
                     if filtered[op] else (0, b"", 0, b""))
                limit = int(lens[op])
                pending.setdefault(p, []).append(
                    (request(start, limit, f), start, limit, f))
                if sum(len(v) for v in pending.values()) >= SCAN_FLUSH:
                    flush_pending()
            flush_pending()
            if on_card:
                torch.cuda.synchronize()
        traffic_s = time.perf_counter() - t_traffic
        launches = dict(fused_scan.LAUNCHES)
        serve = dict(page.SERVE_STATS)
        h2d = dict(record_block.H2D)
        server_s = sum(flush_s) + stats["insert_s"]
        log(f"batched on {card}: {stats['scans']} scans in "
            f"{stats['flushes']} flushes, {stats['inserts']} inserts, "
            f"{stats['records']} records, {stats['full']} full pages, every "
            f"page equal to the oracle's; {stats['scans'] / server_s} scans/s "
            f"over {server_s} s of server time; per flush "
            f"{percentiles(flush_s)}; per scan {percentiles(scan_s)}; CPU "
            f"{flush_cpu} s of {sum(flush_s)} s flush wall; gc "
            f"{gc_pauses.count} pauses, {gc_pauses.total_s} s, longest "
            f"{gc_pauses.longest_s} s, inside {len(gc_lat)} flushes taking "
            f"{sum(gc_lat)} s")
        log(f"batched: flush time by stage (ms): {stage_wall.ms}")
        if on_card:
            busy_s, n_spans = device_busy_s(prof)
            if not n_spans:
                fail("the CUDA trace of the batched traffic holds no device "
                     "work")
            log(f"batched: device busy {busy_s} s in {n_spans} kernels, "
                f"copies and memsets (torch.profiler CUDA trace, on while "
                f"the traffic ran): {100 * busy_s / traffic_s}% of the "
                f"traffic's {traffic_s} s wall (oracle checks included), "
                f"{100 * busy_s / sum(flush_s)}% of the flush wall; the "
                f"device is idle {100 * (1 - busy_s / traffic_s)}% of the "
                f"traffic")
        log(f"batched: launches {launches}; native serve_batch calls "
            f"{serve['calls']}, requests served natively {serve['served']}, "
            f"arena overflows {serve['overflow']}, re-served by numpy "
            f"{serve['numpy']}, memtable rows merged into pages "
            f"{serve['overlay_rows']}; host-to-device copies of record-block "
            f"columns {h2d['copies']}, {h2d['bytes']} B")
        if on_card and (launches["static"] == 0 or launches["multi"] == 0):
            fail(f"the batched path must launch the static and the multi "
                 f"kernel: {launches}")

        # the observability layer off and on, A B B A, over the same
        # seeded flushes (scans only: the store stays as the oracle has it)
        obs_rng = np.random.default_rng(seed + 1)
        n_obs = OBS_FLUSHES * SCAN_FLUSH
        obs_p = obs_rng.choice(NODE_PARTITIONS, n_obs,
                               p=weights / weights.sum())
        obs_ranks = zipf_ranks(obs_rng, n_hashkeys, n_obs)
        obs_lens = obs_rng.integers(1, 101, n_obs)
        obs_filtered = obs_rng.random(n_obs) < 0.15
        obs_patterns = obs_rng.integers(0, len(POSTFIX_PATTERNS), n_obs)
        obs_flushes = []
        for lo in range(0, n_obs, SCAN_FLUSH):
            items: dict = {}
            for op in range(lo, lo + SCAN_FLUSH):
                p = int(obs_p[op])
                start = generate_key(
                    hashkeys[p][orders[p][obs_ranks[op]]], b"")
                f = ((0, b"", FT_MATCH_POSTFIX,
                      POSTFIX_PATTERNS[obs_patterns[op]])
                     if obs_filtered[op] else (0, b"", 0, b""))
                limit = int(obs_lens[op])
                items.setdefault(p, []).append(
                    (request(start, limit, f), start, limit, f))
            obs_flushes.append(list(items.items()))
        obs = observability_ab(servers, oracles, obs_flushes, check)
        off = [v for m, v in zip(obs["order"], obs["scans_per_s"])
               if m == "A"]
        on = [v for m, v in zip(obs["order"], obs["scans_per_s"])
              if m == "B"]
        log(f"batched: observability {obs['order']} over {OBS_FLUSHES} "
            f"flushes of {SCAN_FLUSH} scans on {card}: scans/s "
            f"{obs['scans_per_s']} (off: perfctx disabled, sample_ratio 0; "
            f"on: PerfContexts, sample_ratio 1, slow log at 0 ms); on/off "
            f"{sum(on) / sum(off)}; {obs['entries']} slow-log entries, "
            f"each with its PerfContext and rows_evaluated equal to its "
            f"plan's; {obs['spans']} spans with stages {obs['stages']}")

        # TTL records for the steady state: 1 in 50 L1 records of each
        # partition rewritten with a TTL of STEADY_TTL_S, so that the
        # compacted blocks carry expire_ts and prepare_serve's host TTL
        # mask has rows to drop once a flush's `now` passes them
        t0 = time.perf_counter()
        ttl_from = epoch_now()
        n_ttl = 0
        for p in parts:
            oracle = oracles[p]
            for idx in np.flatnonzero(rng.random(len(oracle.keys)) < 0.02):
                key = oracle.keys[idx]
                if servers[p].on_put(
                        key, oracle.values[key], ttl_seconds=STEADY_TTL_S,
                        partition_hash=key_hash_parts(restore_key(key)[0])):
                    fail("TTL rewrite refused")
                # the server's expire_ts lies in [this, ttl_to]: the two
                # flushes below read far from that span
                oracle.expire[key] = expire_ts_from_ttl(STEADY_TTL_S,
                                                        ttl_from)
                n_ttl += 1
        ttl_to = expire_ts_from_ttl(STEADY_TTL_S)
        log(f"batched: {n_ttl} records rewritten with a {STEADY_TTL_S} s "
            f"TTL in {time.perf_counter() - t0:.1f} s")

        # steady state: compact, warm every mask, then nothing to launch
        t0 = time.perf_counter()
        for p in parts:
            servers[p].manual_compact()
            oracles[p].compacted(servers[p].engine.lsm.l1_runs)
        compact_s = time.perf_counter() - t0
        prefresher = MaskPrefresher(servers, horizon_s=3600.0)
        passes, warmed = 0, []
        t0 = time.perf_counter()
        while True:
            n = prefresher.refresh_once()
            if not n:
                break
            warmed.append(n)
            passes += 1
            if passes > 100:
                fail("MaskPrefresher did not run out of masks to warm")
        log(f"batched: manual_compact in {compact_s:.1f} s; MaskPrefresher "
            f"warmed {warmed} masks in {passes} passes, "
            f"{time.perf_counter() - t0:.2f} s")
        steady: dict = {}
        for _ in range(SCAN_FLUSH):
            p = int(rng.choice(NODE_PARTITIONS, p=weights / weights.sum()))
            start = generate_key(
                hashkeys[p][int(rng.integers(0, n_hashkeys))], b"")
            limit = int(rng.integers(1, 101))
            steady.setdefault(p, []).append(
                (request(start, limit, (0, b"", 0, b"")), start, limit,
                 (0, b"", 0, b"")))
        items = list(steady.items())
        now = epoch_now()
        if now >= ttl_from + STEADY_TTL_S:
            fail(f"the steady state began {now - ttl_from} s after the TTL "
                 f"rewrite, past its {STEADY_TTL_S} s TTL")
        # the same flush now and once every TTL record has expired: the
        # host TTL mask changes with the second, the static masks do not,
        # so neither flush may launch (a TTL needs no re-warm)
        expired_by_flush = []
        for when in (now, ttl_to + 1):
            for p, lst in items:
                state = servers[p].plan_scan_batch([r for r, *_ in lst],
                                                   now=when)
                if state is None or servers[p].planned_misses(state):
                    fail(f"steady state at now {when}: partition {p} has "
                         f"masks left to evaluate")
            abnormal = sum(s.abnormal_read_count for s in servers)
            fused_scan.LAUNCHES.update(dict.fromkeys(fused_scan.LAUNCHES, 0))
            out = scan_multi([(servers[p], [r for r, *_ in lst])
                              for p, lst in items], when)
            if on_card:
                torch.cuda.synchronize()
            for (p, lst), resps in zip(items, out):
                for (_r, start, limit, f), resp in zip(lst, resps):
                    check(resp, p, start, limit, f, when)
            if any(fused_scan.LAUNCHES.values()):
                fail(f"steady-state flush at now {when} launched kernels: "
                     f"{fused_scan.LAUNCHES}")
            expired = sum(s.abnormal_read_count for s in servers) - abnormal
            want = sum(oracles[p].expired_in_plan(start, limit, when)
                       for p, lst in items for _r, start, limit, _f in lst)
            if expired != want:
                fail(f"steady-state flush at now {when} counted {expired} "
                     f"expired records, the oracle {want}")
            expired_by_flush.append(expired)
        if expired_by_flush[0] or not expired_by_flush[1]:
            fail(f"the steady-state flushes met {expired_by_flush} expired "
                 f"records: the TTL records must be alive in the first and "
                 f"expired in the second")
        log(f"batched: steady-state flush of {SCAN_FLUSH} unfiltered scans "
            f"over {len(items)} partitions, at now and again once the TTL "
            f"records expired, launched nothing ({fused_scan.LAUNCHES}); "
            f"pages equal to the oracle's, expired records planned "
            f"{expired_by_flush}")
    finally:
        gc.unfreeze()
        for s in servers:
            s.close()
        gc_pauses.close()
        shutil.rmtree(data_dir, ignore_errors=True)
    return launches


# ---- phase 6: BASELINE config #1, the batched point-get path -------------

POINT_PARTITIONS = 4           # onebox: one table of 4 partitions
POINT_RECORDS = 1_000_000      # BASELINE config #1
POINT_OPS = 20_000             # YCSB-C gets; misses and scans scale off it
POINT_RUN_RECORDS = 500_000    # the whole run's cut of phase 6 (printed)
GET_FLUSH = 32                 # gets a read-coordinator flush coalesces
#                                (bench.py PEGBENCH_GET_BATCH)
DEEP_L0 = 4                    # overlay flushes (bench.py deepen_l0)
DEEP_L0_ROWS = 500             # rows a flush interleaves over the hashkeys
PUSHDOWN_EVERY = 10            # 1 scan in 10 carries a pushdown aggregate

# the store flags phases 4 and 5 pin (every block reaches the scan
# kernel), and the JAX package's defaults phase 6 pins
NONE_STORE = {("pegasus.storage", "block_codec"): "none",
              ("pegasus.server", "bloom_bits_per_key"): 0,
              ("pegasus.server", "phash_index"): False}
DEFAULT_STORE = {("pegasus.storage", "block_codec"): "dcz2",
                 ("pegasus.server", "bloom_bits_per_key"): 10,
                 ("pegasus.server", "phash_index"): True,
                 ("pegasus.server", "row_cache_bytes"): 33_554_432}


@contextlib.contextmanager
def store_flags(values: dict):
    """Set the port's store flags for a phase and restore them after."""
    import pegasus_tpu_torch.server.partition_server  # noqa: F401 - flags
    from pegasus_tpu_torch.utils.flags import FLAGS

    saved = {k: FLAGS.get(*k) for k in values}
    for (section, name), value in values.items():
        FLAGS.set(section, name, value, force=True)
    try:
        yield
    finally:
        for (section, name), value in saved.items():
            FLAGS.set(section, name, value, force=True)


def point_get_stream(n_ops: int, n_hashkeys: int, seed: int,
                     miss: bool = False) -> list:
    """bench.py's YCSB-C streams as (hash_key, sort_key) pairs:
    _point_get_stream (popularity u^2, sortkey uniform over s00..s09) or,
    with `miss`, _point_miss_stream (uniform hashkeys, sortkeys over
    s00..s19, half of them never written)."""
    rng = np.random.default_rng(seed)
    if miss:
        hk_draw = rng.integers(0, n_hashkeys, size=n_ops)
        sk_draw = rng.integers(0, 20, size=n_ops)
    else:
        hk_draw = (rng.random(n_ops) ** 2.0 * n_hashkeys).astype(np.int64)
        sk_draw = rng.integers(0, 10, size=n_ops)
    return [(b"user%08d" % int(h), b"s%02d" % int(s))
            for h, s in zip(hk_draw, sk_draw)]


def run_point_batch(device, n_records: int = POINT_RECORDS,
                    n_ops: int = POINT_OPS, seed: int = 13,
                    card: str = "") -> dict:
    """Phase 6: BASELINE config #1 (onebox, one table of POINT_PARTITIONS
    partitions, YCSB-C) at the JAX package's default store flags, each
    partition a PartitionServer on `device`. bench.py's records are
    loaded through on_multi_put (10% with a 1 s TTL, dropped by the
    compaction), compacted into dcz2 L1 runs with bloom and perfect-hash
    sidecars, then DEEP_L0 overlay flushes interleave over the hashkeys.
    Traffic, every answer checked against a host oracle: n_ops gets of
    bench.py's _point_get_stream and n_ops / 5 of _point_miss_stream
    through read_coordinator.point_read_multi in flushes of GET_FLUSH,
    then n_ops / 10 one-page scans through scan_coordinator.scan_multi in
    flushes of SCAN_FLUSH (3 in 20 with a sortkey POSTFIX filter, 1 in 10
    a value filter and a count aggregate over one hashkey). Fails if a
    planned block of an encoded run without malformed rows had its mask
    computed on the device. Returns the counts it printed."""
    import torch

    from pegasus_tpu_torch.base.key_schema import (
        generate_key,
        generate_next_bytes,
        key_hash_parts,
        restore_key,
    )
    from pegasus_tpu_torch.base.value_schema import epoch_now
    from pegasus_tpu_torch.ops import fused_scan
    from pegasus_tpu_torch.ops.predicates import (
        FT_MATCH_POSTFIX,
        host_match_filter,
    )
    from pegasus_tpu_torch.ops.pushdown import PushdownSpec, finalize
    from pegasus_tpu_torch.server.partition_server import PartitionServer
    from pegasus_tpu_torch.server.read_coordinator import point_read_multi
    from pegasus_tpu_torch.server.scan_coordinator import scan_multi
    from pegasus_tpu_torch.server.types import (
        SCAN_CONTEXT_ID_COMPLETED,
        GetScannerRequest,
        KeyValue,
        MultiPutRequest,
    )
    from pegasus_tpu_torch.storage.block_codec import _Zstd
    from pegasus_tpu_torch.utils.errors import StorageStatus

    P = POINT_PARTITIONS
    heap = "zstd" if _Zstd.lib() is not None else "zlib"
    rng = np.random.default_rng(seed)
    n_hashkeys = max(1, n_records // 10)
    if n_records < POINT_RECORDS:
        log(f"point: CUT to {n_records} records of config #1's "
            f"{POINT_RECORDS}")
    oracles = {p: BatchedOracle() for p in range(P)}
    data_dir = tempfile.mkdtemp(prefix="pegasus_torch_point_")
    servers = []
    out: dict = {"heap_mode": heap}
    on_card = device.type == "cuda"
    with store_flags(DEFAULT_STORE):
        try:
            servers = [PartitionServer(os.path.join(data_dir, str(p)),
                                       pidx=p, partition_count=P,
                                       device=device) for p in range(P)]
            t0 = time.perf_counter()
            i = 0
            for h in range(n_hashkeys):
                hk = b"user%08d" % h
                p = key_hash_parts(hk) % P
                live, short = [], []
                for s, sk in enumerate(SORT_KEYS):
                    kv = KeyValue(sk, b"field0=%064d" % (i + s))
                    (short if rng.random() < 0.10 else live).append(kv)
                i += len(SORT_KEYS)
                for kvs, ttl in ((live, 0), (short, 1)):
                    if kvs and servers[p].on_multi_put(
                            MultiPutRequest(hk, kvs, ttl),
                            partition_hash=key_hash_parts(hk)) != 0:
                        fail("multi_put refused")
                for kv in live:
                    oracles[p].values[generate_key(hk, kv.key)] = kv.value
            load_s = time.perf_counter() - t0
            deadline = epoch_now() + 2   # every 1 s TTL expired first
            while epoch_now() < deadline:
                time.sleep(0.1)
            t0 = time.perf_counter()
            for p in range(P):
                servers[p].manual_compact()
                oracles[p].compacted(servers[p].engine.lsm.l1_runs)
            compact_s = time.perf_counter() - t0
            runs = [r for s in servers for r in s.engine.lsm.l1_runs]
            if not runs or any(r.codec != "dcz2" or r.bloom is None
                               or r.phash is None for r in runs):
                fail("phase 6's L1 runs must be dcz2 with bloom and phash "
                     "sidecars")
            stored = sum(r.codec_stats["stored_bytes"] for r in runs)
            raw = sum(r.codec_stats["raw_bytes"] for r in runs)
            # bench.py deepen_l0: overlay flushes whose rows interleave
            # across the hashkeys, so every L0 fence spans every get
            step = max(1, n_hashkeys // DEEP_L0_ROWS)
            for g in range(DEEP_L0):
                for h in range(g, n_hashkeys, step):
                    hk = b"user%08d" % h
                    p = key_hash_parts(hk) % P
                    key = generate_key(hk, b"zz%02d" % g)
                    if servers[p].on_put(key, b"l0-%d" % g,
                                         partition_hash=key_hash_parts(hk)):
                        fail("overlay put refused")
                    oracles[p].insert(key, b"l0-%d" % g)
                for s in servers:
                    s.flush()
            n_keys = sum(len(o.values) for o in oracles.values())
            l0 = [t for s in servers for t in s.engine.lsm.l0]
            log(f"point: {len(l0)} L0 tables, {sum(t.phash is not None for t in l0)}"
                f" with a perfect-hash index, "
                f"{sum(t.bloom is not None for t in l0)} with a bloom "
                f"filter")
            log(f"point: loaded {i} records into {P} partitions in "
                f"{load_s:.1f} s, flush + manual_compact in {compact_s:.1f} "
                f"s -> {len(runs)} dcz2 L1 runs of "
                f"{sum(len(r.blocks) for r in runs)} blocks, {stored} of "
                f"{raw} raw bytes ({stored / raw:.3f}), value heaps {heap}; "
                f"{DEEP_L0} L0 flushes; {n_keys} live records")

            not_found = int(StorageStatus.NOT_FOUND)
            # the traffic's counts: the readings now are the baseline
            stats0 = [(s.point_stats, s.mask_routes) for s in servers]
            streams = (("gets", point_get_stream(n_ops, n_hashkeys,
                                                 seed + 1)),
                       ("misses", point_get_stream(n_ops // 5, n_hashkeys,
                                                   seed + 2, miss=True)))
            fused_scan.LAUNCHES.update(dict.fromkeys(fused_scan.LAUNCHES, 0))
            t_traffic = time.perf_counter()
            for name, stream in streams:
                flush_s, found = [], 0
                for off in range(0, len(stream), GET_FLUSH):
                    groups: dict = {}
                    for hk, sk in stream[off:off + GET_FLUSH]:
                        ph = key_hash_parts(hk)
                        groups.setdefault(ph % P, []).append(
                            ("get", generate_key(hk, sk), ph))
                    items = list(groups.items())
                    t = time.perf_counter()
                    res = point_read_multi([(servers[p], ops)
                                            for p, ops in items])
                    flush_s.append(time.perf_counter() - t)
                    for (p, ops), results in zip(items, res):
                        for (_op, key, _ph), got in zip(ops, results):
                            v = oracles[p].values.get(key)
                            want = ((0, v) if v is not None
                                    else (not_found, b""))
                            if got != want:
                                fail(f"point {name}: get {key!r} gave "
                                     f"{got!r}, the oracle {want!r}")
                            found += v is not None
                out[name] = len(stream)
                log(f"point {name} on {card}: {len(stream)} gets in "
                    f"{len(flush_s)} flushes of {GET_FLUSH}, {found} found, "
                    f"every answer equal to the oracle's; "
                    f"{len(stream) / sum(flush_s)} gets/s over "
                    f"{sum(flush_s)} s of server time; per flush "
                    f"{percentiles(flush_s)}")

            # scans: YCSB-E one-page scans, some filtered, some with a
            # pushdown count over one hashkey (served per request)
            n_scans = max(1, n_ops // 10)
            filtered = rng.random(n_scans) < 0.15
            pushed = np.arange(n_scans) % PUSHDOWN_EVERY == 0
            patterns = rng.integers(0, len(POSTFIX_PATTERNS), n_scans)
            digits = rng.integers(0, 10, n_scans)
            ranks = (rng.random(n_scans) ** 2.0
                     * n_hashkeys).astype(np.int64)
            lens = rng.integers(1, 101, n_scans)
            pending: dict = {}
            scan_flush_s = []
            aggs = 0

            def flush_scans():
                nonlocal aggs
                if not pending:
                    return
                items = list(pending.items())
                now = epoch_now()
                t = time.perf_counter()
                res = scan_multi([(servers[p], [r for r, *_ in lst])
                                  for p, lst in items], now)
                scan_flush_s.append(time.perf_counter() - t)
                for (p, lst), resps in zip(items, res):
                    for (req, start, limit, f, vf), resp in zip(lst, resps):
                        if resp.error != 0 or \
                                resp.context_id != SCAN_CONTEXT_ID_COMPLETED:
                            fail(f"point-phase scan: error {resp.error}, "
                                 f"context {resp.context_id}")
                        if vf is None:
                            got = [(kv.key, kv.value) for kv in resp.kvs]
                            want = oracles[p].page(start, limit, f, now)
                            if got != want or resp.pushdown_applied:
                                fail(f"point-phase scan of partition {p} "
                                     f"from {start!r}: got {len(got)} "
                                     f"records, want {len(want)}")
                            continue
                        stop = req.stop_key
                        want = sum(
                            1 for k, v in oracles[p].values.items()
                            if start <= k < stop
                            and host_match_filter(restore_key(k)[1], f[2],
                                                  f[3])
                            and host_match_filter(v, vf[0], vf[1]))
                        if (not resp.pushdown_applied or resp.agg is None
                                or finalize(req.pushdown, resp.agg)
                                != want):
                            fail(f"point-phase pushdown count from "
                                 f"{start!r}: got {resp.agg}, want {want}")
                        aggs += 1
                pending.clear()

            for op in range(n_scans):
                hk = b"user%08d" % int(ranks[op])
                p = key_hash_parts(hk) % P
                start = generate_key(hk, b"")
                f = ((0, b"", FT_MATCH_POSTFIX,
                      POSTFIX_PATTERNS[patterns[op]])
                     if filtered[op] else (0, b"", 0, b""))
                vf = None
                stop = b""
                pd = None
                if pushed[op]:
                    vf = (FT_MATCH_POSTFIX, b"%d" % int(digits[op]))
                    pd = PushdownSpec(value_filter_type=vf[0],
                                      value_filter_pattern=vf[1],
                                      aggregate="count")
                    stop = generate_next_bytes(hk)
                limit = int(lens[op])
                req = GetScannerRequest(
                    start_key=start, stop_key=stop, batch_size=limit,
                    validate_partition_hash=True, one_page=True,
                    sort_key_filter_type=f[2],
                    sort_key_filter_pattern=f[3], pushdown=pd)
                pending.setdefault(p, []).append((req, start, limit, f, vf))
                if sum(len(v) for v in pending.values()) >= SCAN_FLUSH:
                    flush_scans()
            flush_scans()
            if on_card:
                torch.cuda.synchronize()
            traffic_s = time.perf_counter() - t_traffic
            launches = dict(fused_scan.LAUNCHES)
            out["scans"] = n_scans
            out["aggregates"] = aggs
            log(f"point scans on {card}: {n_scans} one-page scans in "
                f"{len(scan_flush_s)} flushes ({int(filtered.sum())} "
                f"POSTFIX-filtered, {aggs} pushdown counts), every page and "
                f"count equal to the oracle's; "
                f"{n_scans / sum(scan_flush_s)} scans/s over "
                f"{sum(scan_flush_s)} s; per flush "
                f"{percentiles(scan_flush_s)}")
            stats = {k: sum(s.point_stats[k] - b[0][k]
                            for s, b in zip(servers, stats0))
                     for k in servers[0].point_stats}
            routes = {k: sum(s.mask_routes[k] - b[1][k]
                             for s, b in zip(servers, stats0))
                      for k in servers[0].mask_routes}
            out.update(point_stats=stats, mask_routes=routes,
                       launches=launches)
            log(f"point: bloom pruned {stats['bloom_pruned']}, phash "
                f"located {stats['phash_located']}, phash rejected "
                f"{stats['phash_pruned']}; row cache hits "
                f"{stats['row_cache_hit']}, misses "
                f"{stats['row_cache_miss']}; first-touch static masks: "
                f"{routes['encoded']} on the host from the encoded blocks, "
                f"{routes['device_raw'] + routes['device_malformed']} on "
                f"the device {routes}; kernel launches {launches} "
                f"(the pushdown counts' merge-path validation); traffic "
                f"{traffic_s:.1f} s")
            if routes["device_raw"] or routes["device_malformed"]:
                # every run is dcz2 and no key is malformed: the JAX
                # package masks every such block on the host
                fail(f"a planned block of an encoded run without malformed "
                     f"rows had its mask computed on the device: {routes}")
            if not routes["encoded"]:
                fail("no planned block was masked from its encoded form")
        finally:
            for s in servers:
                s.close()
            shutil.rmtree(data_dir, ignore_errors=True)
    return out


# ---- phase 7: BASELINE configs #3 and #4, bulk manual compaction ---------

# a pass's store (bench.py's PEGBENCH_COMPACT_GB): 1.0 GB until phase 14
# came, cut to keep the whole run under 660 s
COMPACT_GB = 0.5
COMPACT_FULL_GB = 10.0  # BASELINE config #3's table
COMPACT_PARTS = 8       # partitions compacted at once, plus one warm one
COMPACT_VALUE = 100     # bytes a value
COMPACT_BLOCK = 4096    # records a block (bench.py's archival blocks)
RECORD_BYTES = 145      # bench.py's on-disk estimate of a record
# (pass, what, store flags, expired fraction, ruleset)
COMPACT_PASSES = (
    ("a", "config #3, TTL only, block_codec none", "none", 0.5, False),
    ("b", "config #3, TTL only, dcz2 + sidecars", "dcz2", 0.5, False),
    ("c", "config #4, rules, dcz2 + sidecars", "dcz2", 0.05, True),
)


def _config4_drops(h_lo: int, h_hi: int, s_count: int = 10):
    """(hashkey drop, hashkey ANYWHERE hit, sortkey prefix hit) of
    BASELINE config #4's ruleset for hashkey numbers [h_lo, h_hi) and
    sortkey numbers [0, s_count), in plain Python over the key strings."""
    hks = [b"user%08d" % h for h in range(h_lo, h_hi)]
    prefix = np.array([hk.startswith(b"user000001") for hk in hks])
    anywhere = np.array([b"7777" in hk for hk in hks])
    sk_prefix = np.array([(b"s%02d" % s).startswith(b"s0")
                          for s in range(s_count)])
    return prefix, anywhere, sk_prefix


def _digests():
    import hashlib

    return {name: hashlib.sha256()
            for name in ("keys", "key_len", "expire_ts", "values")}


def build_compaction_partition(pdir: str, part: int, per_part: int,
                               expired_frac: float, seed: int, now: int,
                               rules: bool) -> dict:
    """One partition of bench.py:782 build_compact_store's fixture,
    written with the port's SSTableWriter under the current store flags
    as L1 runs of L1_RUN_CAPACITY records in blocks of 4096: keys
    `user%08d` + `s%02d` (K = 32), 100-byte random values, `expired_frac`
    of the records with a TTL 100 s in the past. Returns the oracle of
    the compacted partition: the digests of the surviving records' keys,
    lengths, TTLs and values and their count, from the generator and the
    ruleset evaluated in plain Python."""
    from pegasus_tpu_torch.ops.record_block import hash_lo_column
    from pegasus_tpu_torch.storage.lsm import L1_RUN_CAPACITY
    from pegasus_tpu_torch.storage.sstable import SSTableWriter

    rng = np.random.default_rng(seed + part)
    sst = os.path.join(pdir, "sst")
    os.makedirs(sst, exist_ok=True)
    meta = {"last_flushed_decree": 1, "data_version": 1}
    names, seq, writer, in_run = [], 0, None, 0
    base0 = part * per_part
    oracle = _digests()
    kept = 0
    for base in range(0, per_part, COMPACT_BLOCK):
        n = min(COMPACT_BLOCK, per_part - base)
        idx = np.arange(base0 + base, base0 + base + n)
        keys = fixture_keys(idx)
        key_len = np.full(n, 17, dtype=np.int32)
        ets = np.where(rng.random(n) < expired_frac,
                       np.uint32(max(1, now - 100)),
                       np.uint32(0)).astype(np.uint32)
        heap = rng.integers(32, 126, size=n * COMPACT_VALUE, dtype=np.uint8)
        offs = np.arange(n + 1, dtype=np.uint32) * COMPACT_VALUE
        if writer is None:
            writer = SSTableWriter(os.path.join(sst, f"l1-{seq}.sst"),
                                   meta=meta, async_io=True,
                                   block_capacity=COMPACT_BLOCK)
            seq += 1
        writer.add_block_columnar(keys, key_len, ets,
                                  hash_lo_column(keys, key_len),
                                  np.zeros(n, dtype=np.uint8), offs,
                                  heap.tobytes())
        in_run += n
        if in_run >= L1_RUN_CAPACITY:
            writer.finish()
            names.append(os.path.basename(writer.path))
            writer, in_run = None, 0
        # the oracle: expired records drop, then the ruleset's deletes
        keep = ets == 0
        if rules:
            h_lo = int(idx[0]) // 10
            prefix, anywhere, sk_prefix = _config4_drops(
                h_lo, int(idx[-1]) // 10 + 1)
            h, s = idx // 10 - h_lo, idx % 10
            keep &= ~(prefix[h] | (anywhere[h] & sk_prefix[s]))
        oracle["keys"].update(keys[keep].tobytes())
        oracle["key_len"].update(key_len[keep].tobytes())
        oracle["expire_ts"].update(ets[keep].tobytes())
        oracle["values"].update(
            heap.reshape(n, COMPACT_VALUE)[keep].tobytes())
        kept += int(keep.sum())
    if writer is not None:
        writer.finish()
        names.append(os.path.basename(writer.path))
    with open(os.path.join(sst, "MANIFEST.json"), "w") as f:
        json.dump({"seq": seq, "l1": names}, f)
    return {"count": kept,
            **{k: h.hexdigest() for k, h in oracle.items()}}


def compacted_digest(engine) -> dict:
    """The digests of a compacted partition's records, read back block by
    block from its L1 runs, in the oracle's form."""
    got = _digests()
    count = 0
    for run in engine.lsm.l1_runs:
        for i in range(len(run.blocks)):
            blk = run.read_block(i)
            if blk.keys.shape[1] != 32:
                fail(f"compacted block of key width {blk.keys.shape[1]}")
            offs = np.asarray(blk.value_offs, dtype=np.int64)
            heap = np.asarray(blk.value_heap, dtype=np.uint8)
            got["keys"].update(np.ascontiguousarray(blk.keys).tobytes())
            got["key_len"].update(
                np.asarray(blk.key_len, dtype=np.int32).tobytes())
            got["expire_ts"].update(
                np.asarray(blk.expire_ts, dtype=np.uint32).tobytes())
            got["values"].update(heap[offs[0]:offs[-1]].tobytes())
            count += blk.count
    return {"count": count, **{k: h.hexdigest() for k, h in got.items()}}


def check_chunk(engine, operations, now: int, device) -> int:
    """The first chunk of a partition's compaction (up to 2^18 rows of
    its first blocks, stacked as compaction_eval_submit stacks them)
    through the kernel and through its plain version on the same device:
    the largest difference of the packed drop masks (0: identical). Read
    through a reader of its own, so the compaction's block cache stays
    cold."""
    from pegasus_tpu_torch.ops import compaction as tcomp
    from pegasus_tpu_torch.storage.sstable import SSTable

    run = SSTable(engine.lsm.l1_runs[0].path)
    try:
        chunk, rows = [], 0
        for i in range(len(run.blocks)):
            if rows + run.blocks[i].count > tcomp.COMPACT_CHUNK_ROWS:
                break
            chunk.append(((0, i), run.read_block(i), 0))
            rows += run.blocks[i].count
        cols, _spans, use_lo = tcomp.stack_chunk(chunk, rows, False)
        cols = _device_columns(cols, device)
        args = (*cols[:6], now, 0, cols[6], 0, False, use_lo)
        got = tcomp.make_compaction_eval(operations)(*args, want_ets=False,
                                                     pack=True)
        want = tcomp.eval_block_plain(operations, *args, want_ets=False,
                                      pack=True)
        return _max_err(got[0], want[0], "phase-7 chunk")
    finally:
        run.close()


def _store_bytes(dirs) -> int:
    total = 0
    for d in dirs:
        sst = os.path.join(d, "sst")
        total += sum(os.path.getsize(os.path.join(sst, n))
                     for n in os.listdir(sst) if n.endswith(".sst"))
    return total


def run_compaction(device, gb: float = COMPACT_GB,
                   n_parts: int = COMPACT_PARTS, seed: int = 7,
                   card: str = "", cut_b: int = 0) -> dict:
    """Phase 7: the three passes of COMPACT_PASSES, each timed as
    bench.py:890 measure_compaction_scaled times it — a fresh fixture of
    `gb` GB in `n_parts` partitions plus one untimed warm partition, every
    partition's bulk manual compaction through
    StorageEngine(device).manual_compact on a thread pool at once, GB/s =
    store bytes before / wall seconds. Every partition's survivors must
    equal the oracle, the first chunk of every partition must mask the
    same through the kernel as through its plain version, and the
    kernel's launches must be > 0 in passes a and c and 0 in pass b (the
    host route). `cut_b` > 0 compacts that many partitions in pass b.
    Returns {pass: result}."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from pegasus_tpu_torch.base.value_schema import epoch_now
    from pegasus_tpu_torch.ops import fused_compaction
    from pegasus_tpu_torch.ops.compaction_rules import (
        compile_rules,
        parse_rules,
    )
    from pegasus_tpu_torch.storage.engine import StorageEngine

    n_records = int(gb * 1e9 / RECORD_BYTES)
    per_part = n_records // n_parts
    results = {}
    for name, what, codec, expired_frac, rules in COMPACT_PASSES:
        parts = cut_b if name == "b" and cut_b else n_parts
        if parts != n_parts:
            log(f"compact[{name}]: CUT to {parts} of {n_parts} partitions "
                f"(keeps the run near its time before phase 7)")
        flags = NONE_STORE if codec == "none" else DEFAULT_STORE
        data_dir = tempfile.mkdtemp(prefix="pegasus_torch_compact_")
        try:
            with store_flags(flags):
                now = epoch_now()
                t0 = time.perf_counter()
                dirs = [os.path.join(data_dir, f"p{p}")
                        for p in range(parts + 1)]
                with ThreadPoolExecutor(min(parts + 1, 9)) as ex:
                    oracles = list(ex.map(
                        lambda p: build_compaction_partition(
                            dirs[p], p, per_part, expired_frac, seed, now,
                            rules), range(parts + 1)))
                build_s = time.perf_counter() - t0
                rf = compile_rules(CONFIG4_RULES, device=device) \
                    if rules else None
                ops = tuple(parse_rules(CONFIG4_RULES)) if rules else None
                engines = [StorageEngine(d, device=device) for d in dirs]
                for eng in engines:
                    if not eng.lsm.bulk_compact_eligible():
                        fail(f"compact[{name}]: the fixture must take the "
                             f"bulk path")
                warm = engines.pop(0)
                oracles.pop(0)
                warm.manual_compact(rules_filter=rf)
                warm.close()
                chunk_err = max(check_chunk(e, ops, epoch_now(), device)
                                for e in engines)
                if chunk_err:
                    fail(f"compact[{name}]: a chunk's kernel mask differs "
                         f"from the plain version's by {chunk_err}")
                if device.type == "cuda":
                    torch.cuda.synchronize()
                os.sync()
                timed = dirs[1:]
                size_before = _store_bytes(timed)
                fused_compaction.LAUNCHES["compaction"] = 0
                trace = (device_trace() if name == "c"
                         and device.type == "cuda"
                         else contextlib.nullcontext())
                with trace as prof:
                    t0 = time.perf_counter()
                    with ThreadPoolExecutor(parts) as ex:
                        for f in [ex.submit(e.manual_compact,
                                            rules_filter=rf)
                                  for e in engines]:
                            f.result()
                    if device.type == "cuda":
                        torch.cuda.synchronize()
                    secs = time.perf_counter() - t0
                launches = fused_compaction.LAUNCHES["compaction"]
                # the pipelines' stall milliseconds, summed by stage
                stalls = {stage: sum(
                    getattr(e.last_pipeline, f"{stage}_stall_ms", 0)
                    for e in engines) for stage in ("read", "filter",
                                                    "write")}
                size_after = _store_bytes(timed)
                busy = None
                if prof is not None:
                    busy_s, spans = device_busy_s(prof)
                    busy = {"busy_s": busy_s, "spans": spans,
                            "share": busy_s / secs}
                for p, (eng, want) in enumerate(zip(engines, oracles)):
                    got = compacted_digest(eng)
                    if got != want:
                        fail(f"compact[{name}] partition {p + 1}: survivors "
                             f"{got['count']} differ from the oracle's "
                             f"{want['count']} ({got} != {want})")
                    eng.close()
                if device.type == "cuda" and (launches == 0) != (name == "b"):
                    fail(f"compact[{name}]: {launches} kernel launches; "
                         f"pass b must launch none, a and c some")
                res = {"gb_s": size_before / secs / 1e9, "seconds": secs,
                       "bytes_in": size_before, "bytes_out": size_after,
                       "records": per_part * parts,
                       "survivors": sum(o["count"] for o in oracles),
                       "launches": launches, "stall_ms": stalls,
                       "build_s": build_s, "partitions": parts,
                       "device_busy": busy}
                log(f"compact[{name}] {what} on {card}: "
                    f"{res['gb_s']} GB/s ({secs} s, {size_before} -> "
                    f"{size_after} bytes, {per_part * parts} records, "
                    f"{res['survivors']} survivors equal to the oracle); "
                    f"kernel launches {launches}; pipeline stalls (ms) "
                    f"{stalls}; fixture built in {build_s:.1f} s"
                    + (f"; device busy {busy['busy_s']} s of {secs} s "
                       f"({100 * busy['share']}%) in {busy['spans']} spans"
                       if busy else ""))
                results[name] = res
        finally:
            shutil.rmtree(data_dir, ignore_errors=True)
    return results


# ---- main --------------------------------------------------------------


# ---- phase 8: the in-process client, geo radius search and split --------

GEO_PARTITIONS = 8      # bench.py:3020 measure_geo: two tables of 8
GEO_POINTS = 20_000     # points in a ~20 x 20 km box around (40, -74)
GEO_SEARCHES = 150      # radius searches a pass
GEO_RADIUS_M = 500.0
CLIENT_PARTITIONS = 8
CLIENT_HASHKEYS = 40_000   # x 10 sortkeys: 400,000 records
CLIENT_OPS = 20_000
# phase 8 (b) in the whole run: a printed cut since phase 12 came
CLIENT_RUN_HASHKEYS = 20_000
CLIENT_RUN_OPS = 10_000
CLIENT_SAMPLED = 2_000     # hashkeys whose sortkey_count is checked
SHORT_TTL_EVERY = 50       # 1 hashkey in 50 loaded with a 2 s TTL
LONG_TTL_EVERY = 7         # 1 in 7 with a one-day TTL


def haversine_m64(lat: float, lng: float, lats, lngs) -> np.ndarray:
    """geo/cells.haversine_m in float64 over arrays: the oracle."""
    p1, p2 = np.radians(lat), np.radians(lats)
    dl = np.radians(lngs - lng)
    a = (np.sin((p2 - p1) / 2) ** 2
         + np.cos(p1) * np.cos(p2) * np.sin(dl / 2) ** 2)
    return 2 * 6_371_000.0 * np.arcsin(np.minimum(1.0, np.sqrt(a)))


# float32 operations of the distance filter a candidate: two radians, two
# differences, two halvings, sin, cos, sin, two squares, two products,
# the sum, sqrt, the clamp, asin, the scale, the compare and the `and`
# (a transcendental counted as one operation at the float32 rate)
HAVERSINE_OPS = 21
# bytes a candidate: latitude and longitude in (float32 each), the valid
# flag in, the keep flag and the float32 distance out
HAVERSINE_BYTES = 4 + 4 + 1 + 1 + 4


def haversine_bound_us(candidates: float):
    """(µs, "bytes" or "operations"): the least time the card could take
    to filter `candidates` rows."""
    by_bytes = candidates * HAVERSINE_BYTES / HBM_BYTES_PER_S
    by_ops = candidates * HAVERSINE_OPS / SCALAR_OPS_PER_S
    if by_bytes >= by_ops:
        return by_bytes * 1e6, "bytes"
    return by_ops * 1e6, "operations"


def run_geo(device, n_points: int = GEO_POINTS,
            n_searches: int = GEO_SEARCHES, seed: int = 11,
            card: str = "") -> dict:
    """Phase 8 (a): BASELINE config #5 in the shape of bench.py:3020
    measure_geo. A raw and an index Table of GEO_PARTITIONS partitions
    on `device`, n_points loaded through GeoClient.set, flushed, the
    index compacted (pure L1, so the cell scans ride scan_multi's
    batched path), then n_searches radius searches of GEO_RADIUS_M: a
    warm pass, a timed pass and, on the card, a pass under a CUDA trace.
    Every search of every pass is checked against a float64 haversine
    over all the points: no hit beyond the radius plus the float32 band
    (ops/geo.f32_error_band_m), no point inside the radius minus the
    band missed. Returns the launches and times it printed."""
    import torch

    from pegasus_tpu_torch.client import PegasusClient, Table
    from pegasus_tpu_torch.geo import GeoClient
    from pegasus_tpu_torch.ops import fused_scan
    from pegasus_tpu_torch.ops import geo as geo_ops

    on_card = device.type == "cuda"
    rng = np.random.default_rng(seed)
    lats = 40.0 + (rng.random(n_points) - 0.5) * 0.18
    lngs = -74.0 + (rng.random(n_points) - 0.5) * 0.24
    values = [b"%f|%f|poi-%d" % (lats[i], lngs[i], i)
              for i in range(n_points)]
    # the stored coordinates are the values' 6-decimal text
    st_lat = np.array([float(v.split(b"|")[0]) for v in values])
    st_lng = np.array([float(v.split(b"|")[1]) for v in values])
    centers = rng.integers(0, n_points, size=n_searches)
    data_dir = tempfile.mkdtemp(prefix="pegasus_torch_geo_")
    tables = []
    try:
        fused_scan.LAUNCHES.update(dict.fromkeys(fused_scan.LAUNCHES, 0))
        geo_ops.LAUNCHES["radius_filter"] = 0
        for app_id, name in ((1, "raw"), (2, "idx")):
            tables.append(Table(os.path.join(data_dir, name), app_id=app_id,
                                partition_count=GEO_PARTITIONS,
                                device=device))
        raw, idx = tables
        geo = GeoClient(PegasusClient(raw), PegasusClient(idx))
        if geo.device != device:
            fail(f"GeoClient runs on {geo.device}, its index on {device}")
        t0 = time.perf_counter()
        for i in range(n_points):
            if geo.set(b"poi%06d" % i, b"s", values[i]) != 0:
                fail(f"geo.set of point {i} refused")
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        raw.flush_all()
        idx.flush_all()
        idx.manual_compact_all()
        compact_s = time.perf_counter() - t0

        def check(results, what: str) -> int:
            hits = 0
            for ci, res in zip(centers, results):
                c_lat, c_lng = float(lats[ci]), float(lngs[ci])
                d64 = haversine_m64(c_lat, c_lng, st_lat, st_lng)
                band = geo_ops.f32_error_band_m(c_lat, c_lng, GEO_RADIUS_M)
                got = set()
                for r in res:
                    i = int(r.hash_key[3:])
                    if r.sort_key != b"s" or r.value != values[i]:
                        fail(f"geo {what}: hit {r.hash_key!r} returned "
                             f"{r.sort_key!r} / {r.value!r}")
                    if d64[i] > GEO_RADIUS_M + band:
                        fail(f"geo {what}: hit {i} lies {d64[i]} m from "
                             f"the centre, beyond {GEO_RADIUS_M} + {band}")
                    if abs(r.distance_m - d64[i]) > band:
                        fail(f"geo {what}: hit {i} at {r.distance_m} m, "
                             f"float64 {d64[i]} m, band {band}")
                    got.add(i)
                if len(got) != len(res):
                    fail(f"geo {what}: a point returned twice")
                missed = set(np.flatnonzero(
                    d64 <= GEO_RADIUS_M - band).tolist()) - got
                if missed:
                    fail(f"geo {what}: points {sorted(missed)[:5]} inside "
                         f"the radius were missed")
                dists = [r.distance_m for r in res]
                if dists != sorted(dists):
                    fail(f"geo {what}: hits not sorted by distance")
                hits += len(res)
            return hits

        def search_pass():
            return [geo.search_radial(float(lats[ci]), float(lngs[ci]),
                                      GEO_RADIUS_M) for ci in centers]

        def launched_since(before):
            return {k: fused_scan.LAUNCHES[k] - before[k] for k in before}

        before = dict(fused_scan.LAUNCHES)
        t0 = time.perf_counter()
        warm = search_pass()
        warm_s = time.perf_counter() - t0
        warm_launches = launched_since(before)
        hits = check(warm, "warm pass")
        before = dict(fused_scan.LAUNCHES)
        rf_before = geo_ops.LAUNCHES["radius_filter"]
        rows_before = geo_ops.ROWS["radius_filter"]
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed = search_pass()
        if on_card:
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        timed_launches = launched_since(before)
        rf_launches = geo_ops.LAUNCHES["radius_filter"] - rf_before
        candidates = geo_ops.ROWS["radius_filter"] - rows_before
        if check(timed, "timed pass") != hits:
            fail("geo: the timed pass found other hits than the warm one")
        out = {"searches_per_s": n_searches / secs, "hits": hits,
               "warm": warm_launches, "timed": timed_launches,
               "radius_filter_launches": rf_launches}
        log(f"geo: {n_points} points loaded through GeoClient.set into two "
            f"tables of {GEO_PARTITIONS} partitions in {load_s:.1f} s, "
            f"flushed and the index compacted in {compact_s:.1f} s; warm "
            f"pass {warm_s:.2f} s, scan kernel launches {warm_launches}")
        log(f"geo on {card}: {n_searches} radius searches of "
            f"{GEO_RADIUS_M} m: {out['searches_per_s']} searches/s "
            f"({secs} s, timed pass), {hits} hits, every search equal to "
            f"a float64 haversine over all {n_points} points within the "
            f"float32 band; timed pass scan kernel launches "
            f"{timed_launches}, radius_filter launches {rf_launches}")
        if on_card:
            if rf_launches != n_searches:
                fail(f"radius_filter ran {rf_launches} times on the card "
                     f"for {n_searches} searches")
            if warm_launches["static"] == 0:
                fail("the warm pass's cell scans never launched the scan "
                     "kernel")
            before = dict(fused_scan.LAUNCHES)
            with device_trace() as prof:
                traced = search_pass()
                torch.cuda.synchronize()
            if check(traced, "traced pass") != hits:
                fail("geo: the traced pass found other hits")
            if any(launched_since(before).values()):
                fail("geo: the traced pass launched the scan kernel")
            kernel_us = sum(
                getattr(ev, "self_device_time_total", 0.0)
                for ev in prof.key_averages()
                if str(getattr(ev, "device_type", "")).endswith("CUDA")
                and not ev.key.startswith(("Memcpy", "Memset")))
            busy_s, spans = device_busy_s(prof)
            bound_us, bound_by = haversine_bound_us(candidates / n_searches)
            out.update(rf_kernel_us=kernel_us / n_searches,
                       rf_busy_us=busy_s * 1e6 / n_searches,
                       candidates=candidates, bound_us=bound_us)
            log(f"geo on {card}: radius_filter device time per search "
                f"{out['rf_kernel_us']} us in kernels, {out['rf_busy_us']} "
                f"us busy with its copies ({spans} device spans over "
                f"{n_searches} searches, traced pass; the scan masks were "
                f"cached, so every span is the filter's); "
                f"{candidates / n_searches} candidates a search (timed "
                f"pass), bound {bound_us} us ({bound_by}), "
                f"{100 * bound_us / out['rf_kernel_us']}% of it")
        out["launches"] = dict(fused_scan.LAUNCHES)
    finally:
        for t in tables:
            t.close()
        shutil.rmtree(data_dir, ignore_errors=True)
    return out


class ClientOracle:
    """What phase 8 (b)'s table must hold: (hash_key, sort_key) -> (user
    value, lowest and highest possible expire_ts); the two differ only
    for a TTL set while the clock's second could tick."""

    def __init__(self) -> None:
        self.rows: dict = {}

    def put(self, hk, sk, value, lo=0, hi=0) -> None:
        self.rows[(hk, sk)] = (value, lo, hi)

    def visible(self, hk, sk, now: int):
        row = self.rows.get((hk, sk))
        if row is None or (row[1] and row[2] <= now):
            return None
        if row[1] and row[1] <= now:
            fail(f"oracle: the expiry of {hk!r}/{sk!r} is ambiguous at "
                 f"{now}")
        return row

    def live(self, now: int) -> dict:
        return {k: r for k, r in self.rows.items()
                if self.visible(k[0], k[1], now) is not None}


CLIENT_OPS_KINDS = ("incr", "check_and_set", "check_and_mutate",
                    "multi_del", "batch_get", "ttl", "sortkey_count")


def _client_op(c, oracle, rng, hashkeys, i) -> str:
    """One seeded op of phase 8 (b) through PegasusClient `c`, checked
    against `oracle`, which it updates. Returns the op's name."""
    from pegasus_tpu_torch.base.value_schema import epoch_now
    from pegasus_tpu_torch.server.types import (
        CasCheckType,
        Mutate,
        MutateOperation,
    )
    from pegasus_tpu_torch.utils.errors import StorageStatus

    ok, try_again = int(StorageStatus.OK), int(StorageStatus.TRY_AGAIN)
    hk = hashkeys[int(rng.integers(0, len(hashkeys)))]
    f = b"f%d" % int(rng.integers(0, 10))
    kind = CLIENT_OPS_KINDS[int(rng.integers(0, len(CLIENT_OPS_KINDS)))]
    now = epoch_now()

    def value_of(h, s):
        row = oracle.visible(h, s, now)
        return None if row is None else row[0]

    if kind == "incr":
        sk = b"cnt" if rng.random() < 0.9 else f
        inc = int(rng.integers(-5, 100))
        resp = c.incr(hk, sk, inc)
        row = oracle.visible(hk, sk, now)
        old = row[0] if row else b"0"
        if not old.lstrip(b"-").isdigit():
            want = (int(StorageStatus.INVALID_ARGUMENT),)
            got = (resp.error,)
        else:
            want = (ok, int(old) + inc)
            got = (resp.error, resp.new_value)
            oracle.put(hk, sk, b"%d" % want[1],
                       *(row[1:] if row else (0, 0)))
    elif kind == "check_and_set":
        cur = value_of(hk, f)
        if rng.random() < 0.5:
            ct, operand = CasCheckType.CT_VALUE_EXIST, b""
            passed = cur is not None
        else:
            operand = (cur if cur is not None and rng.random() < 0.6
                       else b"v-none")
            ct = CasCheckType.CT_VALUE_BYTES_EQUAL
            passed = cur is not None and cur == operand
        new = b"cas-%d" % i
        resp = c.check_and_set(hk, f, int(ct), operand, b"cas", new,
                               return_check_value=True)
        want = (ok if passed else try_again, True, cur is not None,
                cur or b"")
        got = (resp.error, resp.check_value_returned,
               resp.check_value_exist, resp.check_value)
        if passed:
            oracle.put(hk, b"cas", new)
    elif kind == "check_and_mutate":
        locked = value_of(hk, b"lock") is not None
        muts = [Mutate(int(MutateOperation.MO_PUT), b"lock", b"l%d" % i)]
        for _ in range(int(rng.integers(1, 4))):
            sk = b"f%d" % int(rng.integers(0, 10))
            if rng.random() < 0.5:
                muts.append(Mutate(int(MutateOperation.MO_DELETE), sk))
            else:
                muts.append(Mutate(int(MutateOperation.MO_PUT), sk,
                                   b"m%d" % i))
        resp = c.check_and_mutate(hk, b"lock",
                                  int(CasCheckType.CT_VALUE_NOT_EXIST),
                                  b"", muts)
        want, got = (try_again if locked else ok), resp.error
        if not locked:
            for m in muts:  # in list order: the last op on a key wins
                if m.operation == MutateOperation.MO_DELETE:
                    oracle.rows.pop((hk, m.sort_key), None)
                else:
                    oracle.put(hk, m.sort_key, m.value)
        if rng.random() < 0.5:  # release the lock
            if c.delete(hk, b"lock") != ok:
                fail(f"client op {i}: delete of the lock refused")
            oracle.rows.pop((hk, b"lock"), None)
    elif kind == "multi_del":
        sks = [b"f%d" % int(s) for s in rng.integers(0, 10, size=3)]
        got = c.multi_del(hk, sks)
        want = (ok, 3)
        for sk in sks:
            oracle.rows.pop((hk, sk), None)
    elif kind == "batch_get":
        keys = [(hashkeys[int(rng.integers(0, len(hashkeys)))],
                 b"f%d" % int(rng.integers(0, 10)))
                for _ in range(int(rng.integers(1, 7)))]
        err, rows = c.batch_get(keys)
        got = (err, sorted(rows))
        want = (ok, sorted((h, s, value_of(h, s)) for h, s in keys
                           if value_of(h, s) is not None))
    elif kind == "ttl":
        err, ttl = c.ttl(hk, f)
        after = epoch_now()
        row = oracle.visible(hk, f, now)
        if row is None:
            want, got = (int(StorageStatus.NOT_FOUND),), (err,)
        elif row[1] == 0:
            want, got = (ok, -1), (err, ttl)
        else:
            want = (ok, True)
            got = (err, row[1] - after <= ttl <= row[2] - now)
    else:
        got = c.sortkey_count(hk)
        sks = [b"f%d" % j for j in range(10)] + [b"cnt", b"cas", b"lock"]
        want = (ok, sum(value_of(hk, sk) is not None for sk in sks))
    if got != want:
        fail(f"client op {i} ({kind} on {hk!r}): got {got}, oracle "
             f"{want}")
    return kind


def run_client_split(device, n_hashkeys: int = CLIENT_HASHKEYS,
                     n_ops: int = CLIENT_OPS, seed: int = 17,
                     card: str = "") -> dict:
    """Phase 8 (b): an 8-partition Table on `device` loaded with
    n_hashkeys x 10 records through PegasusClient.multi_set (1 hashkey
    in SHORT_TTL_EVERY with a 2 s TTL, expired before the traffic, 1 in
    LONG_TTL_EVERY with a one-day TTL), n_ops seeded incr /
    check_and_set / check_and_mutate / multi_del / batch_get / ttl /
    sortkey_count ops each checked against a ClientOracle, then
    Table.split 8 -> 16: a full unordered scan and the sortkey_count of
    CLIENT_SAMPLED hashkeys must equal the oracle with the stale half
    hidden by the scan kernel's ownership check; then manual_compact_all
    must launch the compaction kernel and leave exactly the oracle's
    records, each in the partition that owns it. Returns the launches
    and seconds of each step."""
    from pegasus_tpu_torch.base.key_schema import key_hash_parts, restore_key
    from pegasus_tpu_torch.base.value_schema import (
        epoch_now,
        extract_user_data,
    )
    from pegasus_tpu_torch.client import PegasusClient, ScanOptions, Table
    from pegasus_tpu_torch.ops import fused_compaction, fused_scan
    from pegasus_tpu_torch.utils.errors import StorageStatus

    on_card = device.type == "cuda"
    rng = np.random.default_rng(seed)
    hashkeys = [b"acct%08d" % h for h in range(n_hashkeys)]
    oracle = ClientOracle()
    data_dir = tempfile.mkdtemp(prefix="pegasus_torch_client_")
    table = None
    secs = {}
    launches = {}

    def reset() -> None:
        fused_scan.LAUNCHES.update(dict.fromkeys(fused_scan.LAUNCHES, 0))
        fused_compaction.LAUNCHES["compaction"] = 0

    def step(name: str, t0: float) -> None:
        secs[name] = time.perf_counter() - t0
        launches[name] = dict(fused_scan.LAUNCHES,
                              compaction=fused_compaction.LAUNCHES[
                                  "compaction"])
        reset()

    try:
        reset()
        t0 = time.perf_counter()
        table = Table(data_dir, app_id=3, partition_count=CLIENT_PARTITIONS,
                      device=device)
        c = PegasusClient(table)
        short_hi = 0
        for h, hk in enumerate(hashkeys):
            ttl = (2 if h % SHORT_TTL_EVERY == 0
                   else 86_400 if h % LONG_TTL_EVERY == 0 else 0)
            kvs = {b"f%d" % j: b"v%d-%d" % (h, j) for j in range(10)}
            lo = epoch_now()
            if c.multi_set(hk, kvs, ttl) != 0:
                fail(f"multi_set of {hk!r} refused")
            hi = epoch_now()
            for sk, v in kvs.items():
                oracle.put(hk, sk, v, *((lo + ttl, hi + ttl) if ttl
                                        else (0, 0)))
            if ttl == 2:
                short_hi = hi + ttl
        while epoch_now() <= short_hi:  # every 2 s TTL has expired
            time.sleep(0.1)
        step("load", t0)
        t0 = time.perf_counter()
        counts = dict.fromkeys(CLIENT_OPS_KINDS, 0)
        for i in range(n_ops):
            counts[_client_op(c, oracle, rng, hashkeys, i)] += 1
        step("ops", t0)
        log(f"client: {n_hashkeys * 10} records loaded through multi_set "
            f"into {CLIENT_PARTITIONS} partitions in {secs['load']:.1f} s; "
            f"{n_ops} ops {counts} equal to the oracle in "
            f"{secs['ops']:.1f} s; kernel launches {launches['ops']}")
        t0 = time.perf_counter()
        table.split()
        step("split", t0)
        pv = table.partition_count - 1
        if table.partition_count != 2 * CLIENT_PARTITIONS or any(
                p.partition_version != pv or p.device != device
                for p in table.all_partitions()):
            fail("split: the partitions did not flip to the doubled count")
        live = oracle.live(epoch_now())
        t0 = time.perf_counter()
        rows = {}
        for sc in c.get_unordered_scanners(
                table.partition_count, ScanOptions(batch_size=1000)):
            for hk, sk, v in sc:
                if (hk, sk) in rows:
                    fail(f"scan after the split: {hk!r}/{sk!r} twice")
                rows[(hk, sk)] = v
        if rows != {k: r[0] for k, r in live.items()}:
            fail(f"scan after the split: {len(rows)} rows, oracle "
                 f"{len(live)}; missing {sorted(set(live) - set(rows))[:3]}"
                 f", extra {sorted(set(rows) - set(live))[:3]}")
        per_hk = {}
        for hk, _sk in live:
            per_hk[hk] = per_hk.get(hk, 0) + 1
        sampled = rng.choice(n_hashkeys, size=min(CLIENT_SAMPLED,
                                                  n_hashkeys),
                             replace=False)
        for h in sampled:
            hk = hashkeys[int(h)]
            got = c.sortkey_count(hk)
            if got != (int(StorageStatus.OK), per_hk.get(hk, 0)):
                fail(f"sortkey_count of {hk!r} after the split: {got}, "
                     f"oracle {per_hk.get(hk, 0)}")
        step("scan", t0)
        physical = sum(sum(t.total_count for t in p.engine.lsm.l0)
                       + sum(t.total_count for t in p.engine.lsm.l1_runs)
                       + len(p.engine.lsm.memtable)
                       for p in table.all_partitions())
        if physical <= len(live):
            fail(f"split: {physical} physical rows, {len(live)} live: the "
                 f"stale halves should still be on disk")
        t0 = time.perf_counter()
        table.manual_compact_all()
        step("compact", t0)
        survivors = {}
        for p in table.all_partitions():
            for key, value, ets in p.engine.iterate():
                hk, sk = restore_key(key)
                if key_hash_parts(hk, sk) & pv != p.pidx:
                    fail(f"compaction kept {hk!r}/{sk!r} in partition "
                         f"{p.pidx}, which no longer owns it")
                survivors[(hk, sk)] = (extract_user_data(1, value), ets)
        live = oracle.live(epoch_now())
        bad = [k for k, r in live.items()
               if k not in survivors or survivors[k][0] != r[0]
               or not r[1] <= survivors[k][1] <= r[2]]
        if bad or len(survivors) != len(live):
            fail(f"compaction survivors: {len(survivors)}, oracle "
                 f"{len(live)}; wrong {bad[:3]}")
        log(f"client: split 8 -> 16 in {secs['split']:.1f} s; the full "
            f"unordered scan ({len(rows)} rows) and {len(sampled)} "
            f"sortkey_counts equal the oracle over {physical} physical "
            f"rows in {secs['scan']:.1f} s, kernel launches "
            f"{launches['scan']}; manual_compact_all in "
            f"{secs['compact']:.1f} s kept {len(survivors)} records, each "
            f"in its owner, kernel launches {launches['compact']}")
        if on_card:
            if launches["ops"]["now"] == 0:
                fail("the ops' sortkey_counts never launched the scan "
                     "kernel's now contract")
            if launches["scan"]["static"] + launches["scan"]["now"] == 0:
                fail("the scans after the split never launched the scan "
                     "kernel")
            if launches["compact"]["compaction"] == 0:
                fail("manual_compact_all after the split never launched "
                     "the compaction kernel")
    finally:
        if table is not None:
            table.close()
        shutil.rmtree(data_dir, ignore_errors=True)
    return {"secs": secs, "launches": launches}


# ---- phase 9: integrity on the card -------------------------------------

INTEGRITY_RECORDS = 125_000    # phase 5's partition: 12,500 hashkeys x 10
INTEGRITY_SCANS = 4_000        # scans over each store, in flushes of 32
INTEGRITY_ROOT_KEY = b"chip-smoke-phase-9-kms-root-key!"


def write_pgt1(src: str, dst: str) -> int:
    """Write `src`, a `none`-codec SST, as a PGT1 file at `dst`: the
    format before the hash_lo column, the same blocks without it, their
    CRCs and the index recomputed, no bloom or perfect-hash sidecar.
    Returns the blocks written."""
    import json as _json
    from zlib import crc32 as block_crc32

    from pegasus_tpu_torch.base.crc import crc32
    from pegasus_tpu_torch.storage.sstable import (
        _BLOCK_HDR,
        FOOTER,
        MAGIC_V1,
        SSTable,
    )

    table = SSTable(src, cache_bytes=0)
    if table.codec is not None:
        fail(f"{src}: a PGT1 copy needs a `none` file, not {table.codec}")
    parts = [MAGIC_V1]
    offset = len(MAGIC_V1)
    blocks = []
    for i, bm in enumerate(table.blocks):
        blk = table.read_block(i)
        heap = np.asarray(blk.value_heap, dtype=np.uint8).tobytes()
        buf = b"".join((
            _BLOCK_HDR.pack(blk.count, blk.keys.shape[1], len(heap)),
            np.ascontiguousarray(blk.keys, dtype=np.uint8).tobytes(),
            np.ascontiguousarray(blk.key_len, dtype=np.int32).tobytes(),
            np.ascontiguousarray(blk.expire_ts, dtype=np.uint32).tobytes(),
            np.ascontiguousarray(blk.flags, dtype=np.uint8).tobytes(),
            np.ascontiguousarray(blk.value_offs, dtype=np.uint32).tobytes(),
            heap))
        blocks.append({"off": offset, "size": len(buf), "count": blk.count,
                       "kw": int(blk.keys.shape[1]),
                       "first": bm.first_key.hex(), "last": bm.last_key.hex(),
                       "crc": block_crc32(buf)})
        parts.append(buf)
        offset += len(buf)
    blob = _json.dumps({"blocks": blocks, "meta": table.meta,
                        "total_count": table.total_count}).encode()
    parts.append(blob)
    parts.append(FOOTER.pack(offset, len(blob), crc32(blob), MAGIC_V1))
    table.close()
    tmp = dst + ".pgt1.tmp"
    with open(tmp, "wb") as f:
        f.write(b"".join(parts))
    os.replace(tmp, dst)
    return len(blocks)


def _ssts(root: str) -> list:
    return sorted(os.path.join(d, f) for d, _s, fs in os.walk(root)
                  for f in fs if f.endswith(".sst"))


def run_integrity(device, n_records: int = INTEGRITY_RECORDS,
                  n_scans: int = INTEGRITY_SCANS, seed: int = 19,
                  card: str = "") -> dict:
    """Phase 9: one partition in phase 5's layout (partition 0 of 64,
    `n_records` records at `none`) built twice, under at-rest encryption
    (a LocalKmsClient with a fixed root key) and as its plaintext twin.
    YCSB-E scans through scan_multi on `device`, 15% sortkey POSTFIX,
    must give the same pages from the encrypted store, the twin, and a
    PGT1 copy of the twin (its blocks without hash_lo, written by
    write_pgt1), all equal to a BatchedOracle; the scan kernel must
    launch on the encrypted store and the key-hash instance on the PGT1
    copy. ReplicaScrubber.scrub_now must pass the twin clean and report
    exactly the one block of a copy with one flipped byte. Returns the
    kernel launches by store and the scrub results."""
    import torch

    from pegasus_tpu_torch.base.key_schema import generate_key, key_hash_parts
    from pegasus_tpu_torch.base.value_schema import epoch_now
    from pegasus_tpu_torch.ops import fused_scan
    from pegasus_tpu_torch.ops.predicates import FT_MATCH_POSTFIX
    from pegasus_tpu_torch.security.kms import KeyProvider, LocalKmsClient
    from pegasus_tpu_torch.server.partition_server import PartitionServer
    from pegasus_tpu_torch.server.scan_coordinator import scan_multi
    from pegasus_tpu_torch.server.types import (
        SCAN_CONTEXT_ID_COMPLETED,
        GetScannerRequest,
        KeyValue,
        MultiPutRequest,
    )
    from pegasus_tpu_torch.storage import efile
    from pegasus_tpu_torch.storage.scrub import ReplicaScrubber

    rng = np.random.default_rng(seed)
    n_hashkeys = n_records // len(SORT_KEYS)
    hashkeys = node_hashkeys({PIDX: n_hashkeys})[PIDX]
    root = tempfile.mkdtemp(prefix="pegasus_torch_integrity_")
    dirs = {name: os.path.join(root, name)
            for name in ("encrypted", "plain", "flipped", "pgt1")}
    servers: dict = {}
    out: dict = {}
    try:
        os.makedirs(dirs["encrypted"])
        efile.enable_encryption(dirs["encrypted"], KeyProvider(
            dirs["encrypted"], LocalKmsClient(INTEGRITY_ROOT_KEY)))
        oracle = BatchedOracle()
        t0 = time.perf_counter()
        for name in ("encrypted", "plain"):
            srv = PartitionServer(dirs[name], pidx=PIDX,
                                  partition_count=PARTITION_COUNT,
                                  device=device)
            for hk in hashkeys:
                hnum = int(hk[4:])
                kvs = [KeyValue(sk, b"field0=%064d" % (hnum * 10 + s))
                       for s, sk in enumerate(SORT_KEYS)]
                if srv.on_multi_put(MultiPutRequest(hk, kvs),
                                    partition_hash=key_hash_parts(hk)):
                    fail("multi_put refused")
                if name == "plain":
                    for kv in kvs:
                        oracle.values[generate_key(hk, kv.key)] = kv.value
            srv.manual_compact()
            servers[name] = srv
        oracle.compacted(servers["plain"].engine.lsm.l1_runs)
        enc_ssts = _ssts(dirs["encrypted"])
        if not enc_ssts or not all(efile.is_encrypted(p) for p in enc_ssts):
            fail("the encrypted store's SST files are not encrypted")
        log(f"integrity: 2 x {len(oracle.keys)} records (encrypted, plain) "
            f"loaded and compacted in {time.perf_counter() - t0:.1f} s; "
            f"{len(enc_ssts)} encrypted SST files")

        # the twin's copies: one with a flipped byte, one as PGT1
        servers.pop("plain").close()
        for name in ("flipped", "pgt1"):
            shutil.copytree(dirs["plain"], dirs[name])
        n_pgt1 = sum(write_pgt1(p, p) for p in _ssts(dirs["pgt1"]))
        for name in ("plain", "pgt1"):
            servers[name] = PartitionServer(
                dirs[name], pidx=PIDX, partition_count=PARTITION_COUNT,
                device=device)
        runs = servers["pgt1"].engine.lsm.l1_runs
        if not runs or any(r._has_hash_lo for r in runs):
            fail("the PGT1 copy's runs carry hash_lo")
        log(f"integrity: PGT1 copy of the twin: {n_pgt1} blocks without "
            f"hash_lo")

        # the same seeded scans through every store
        ranks = zipf_ranks(rng, n_hashkeys, n_scans)
        lens = rng.integers(1, 101, n_scans)
        filtered = rng.random(n_scans) < 0.15
        patterns = rng.integers(0, len(POSTFIX_PATTERNS), n_scans)
        flushes = []
        for lo in range(0, n_scans, SCAN_FLUSH):
            reqs = []
            for i in range(lo, min(lo + SCAN_FLUSH, n_scans)):
                start = generate_key(hashkeys[int(ranks[i])], b"")
                f = ((0, b"", FT_MATCH_POSTFIX, POSTFIX_PATTERNS[patterns[i]])
                     if filtered[i] else (0, b"", 0, b""))
                reqs.append((GetScannerRequest(
                    start_key=start, batch_size=int(lens[i]),
                    validate_partition_hash=True, one_page=True,
                    hash_key_filter_type=f[0], hash_key_filter_pattern=f[1],
                    sort_key_filter_type=f[2], sort_key_filter_pattern=f[3]),
                    start, int(lens[i]), f))
            flushes.append(reqs)
        pages = {}
        for name in ("encrypted", "plain", "pgt1"):
            srv = servers[name]
            fused_scan.LAUNCHES.update(dict.fromkeys(fused_scan.LAUNCHES, 0))
            t0 = time.perf_counter()
            got = []
            for reqs in flushes:
                now = epoch_now()
                resps = scan_multi([(srv, [r for r, *_ in reqs])], now)[0]
                for (_r, start, limit, f), resp in zip(reqs, resps):
                    if (resp.error != 0
                            or resp.context_id != SCAN_CONTEXT_ID_COMPLETED):
                        fail(f"integrity {name}: scan error {resp.error}")
                    page = [(kv.key, kv.value) for kv in resp.kvs]
                    if page != oracle.page(start, limit, f, now):
                        fail(f"integrity {name}: the page from {start!r} "
                             f"limit {limit} filters {f} differs from the "
                             f"oracle's")
                    got.append(page)
            if device.type == "cuda":
                torch.cuda.synchronize()
            pages[name] = got
            out[name] = {"launches": dict(fused_scan.LAUNCHES),
                         "seconds": time.perf_counter() - t0}
            log(f"integrity {name} on {card}: {n_scans} scans in "
                f"{len(flushes)} flushes in {out[name]['seconds']:.2f} s, "
                f"every page equal to the oracle's; scan kernel launches "
                f"{out[name]['launches']}")
        if not pages["encrypted"] == pages["plain"] == pages["pgt1"]:
            fail("the encrypted store, its twin and the PGT1 copy served "
                 "different pages")
        if device.type == "cuda":
            enc, pgt = out["encrypted"]["launches"], out["pgt1"]["launches"]
            if enc["static"] == 0 or enc["keyhash"]:
                fail(f"the encrypted store must launch the scan kernel "
                     f"with stored hashes: {enc}")
            if pgt["keyhash"] == 0:
                fail(f"the PGT1 copy must launch the key-hash instance: "
                     f"{pgt}")

        # the scrubber: the twin clean, then one flipped byte found
        def scrub(name):
            hits = []
            rep = type("Replica", (), {"server": servers[name]})()
            sc = ReplicaScrubber(lambda: {(1, PIDX): rep},
                                 lambda gpid, exc: hits.append((gpid, exc)))
            return sc.scrub_now((1, PIDX), rep), hits

        t0 = time.perf_counter()
        clean, hits = scrub("plain")
        n_blocks = sum(len(r.blocks) for r in servers["plain"].engine.lsm.l1_runs)
        if clean.get("state") != "clean" or hits \
                or clean["blocks_scanned"] != n_blocks:
            fail(f"scrub of the twin: {clean}, {hits}")
        tables = [os.path.basename(t.path) for t in
                  list(servers["plain"].engine.lsm.l0)
                  + list(servers["plain"].engine.lsm.l1_runs)]
        ti = len(tables) // 2
        target = os.path.join(os.path.dirname(
            servers["plain"].engine.lsm.l1_runs[0].path), tables[ti])
        flipped = target.replace(dirs["plain"], dirs["flipped"])
        tbl = servers["plain"].engine.lsm.l1_runs[ti]
        bi = len(tbl.blocks) // 2
        bm = tbl.blocks[bi]
        with open(flipped, "r+b") as f:
            f.seek(bm.offset + bm.size // 2)
            b = f.read(1)
            f.seek(bm.offset + bm.size // 2)
            f.write(bytes([b[0] ^ 0x10]))
        servers["flipped"] = PartitionServer(
            dirs["flipped"], pidx=PIDX, partition_count=PARTITION_COUNT,
            device=device)
        found, hits = scrub("flipped")
        before = sum(len(t.blocks) for t in
                     servers["plain"].engine.lsm.l1_runs[:ti])
        if (found.get("state") != "corrupt" or len(hits) != 1
                or found["blocks_scanned"] != before + bi
                or f"block {bi} crc mismatch" not in found["detail"]
                or os.path.basename(flipped) not in found["detail"]):
            fail(f"scrub of the flipped copy: {found}, {len(hits)} hits; "
                 f"the flip is in {os.path.basename(flipped)} block {bi}")
        out["scrub"] = {"clean_blocks": clean["blocks_scanned"],
                        "corrupt": found["detail"],
                        "seconds": time.perf_counter() - t0}
        log(f"integrity: scrub of the twin clean over {n_blocks} blocks; "
            f"the copy with one flipped byte reported exactly "
            f"{os.path.basename(flipped)} block {bi} "
            f"({found['detail']!r}) in {out['scrub']['seconds']:.2f} s")
    finally:
        for s in servers.values():
            s.close()
        efile.disable_encryption(dirs["encrypted"])
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---- phase 10: the resident image -------------------------------------

RESIDENT_PARTITIONS = 64       # BASELINE config #2: the whole table
RESIDENT_HASHKEYS = 100_000    # x 10 sortkeys: 1,000,000 records
RESIDENT_EXPIRED = 0.10        # bench.py: 10% of the records expired
RESIDENT_APP = 10              # the phase's table; its twin is app 11
RESIDENT_VALUE_FILTER = b"77"  # the aggregates' value filter (ANYWHERE)
# (f): the epilogue and the slot gate against their plain versions
RESIDENT_CHECK_P = (1, 5, 16, 64)
RESIDENT_CHECK_B = (8, 1024, 4096, 16384, 65536)


class FrozenClock:
    """Stands in for a module's `time` while a check needs one epoch
    second: `time()` is frozen at `t`, the rest is the real module."""

    def __init__(self, t: float) -> None:
        self.t = t

    def time(self) -> float:
        return self.t

    def __getattr__(self, name):
        return getattr(time, name)


@contextlib.contextmanager
def frozen_epoch():
    """Freeze the port's epoch clock (base/value_schema's `time`)."""
    from pegasus_tpu_torch.base import value_schema

    real = value_schema.time
    value_schema.time = FrozenClock(time.time())
    try:
        yield
    finally:
        value_schema.time = real


@contextlib.contextmanager
def gate_open(name: str):
    """Pin one placement gate (ops/placement.mesh_wave_pays or
    mesh_compact_pays) to True for an identity check."""
    from pegasus_tpu_torch.ops import placement

    real = getattr(placement, name)
    setattr(placement, name, lambda *_a, **_k: True)
    try:
        yield
    finally:
        setattr(placement, name, real)


def mesh_step_row_bytes(with_sum: bool, extra: bool) -> float:
    """The bytes one epilogue launch moves a row: 1/8 B static mask, 4 B
    expire_ts, 1 B present and 1/8 B out (a wave's instance: 5.25 B);
    1 B more where it reads a value-filter mask, 16 B of lanes with the
    sum."""
    return 5.25 + (1 if extra else 0) + (16 if with_sum else 0)


def mesh_step_bound(rows: int, with_sum: bool, extra: bool = True):
    """(bound_ms, "bytes") of one epilogue launch over `rows` rows."""
    per = mesh_step_row_bytes(with_sum, extra)
    return rows * per / HBM_BYTES_PER_S * 1e3, "bytes"


def resident_load(device, data_dir: str, seed: int,
                  n_hashkeys: int = RESIDENT_HASHKEYS):
    """BASELINE config #2 (bench.py:190 build_cluster's layout, not cut):
    `n_hashkeys` hashkeys x 10 sortkeys over RESIDENT_PARTITIONS
    PartitionServers on `device`, through multi_put; RESIDENT_EXPIRED of
    the records carry a 1 s TTL and the compaction runs at the load's
    start, so the expired records stay in the store as bench.py's do.
    Returns (servers, {pidx: sorted live keys}, {pidx: sorted expiring
    keys}, load seconds, compaction seconds)."""
    from pegasus_tpu_torch.base.crc import crc64_batch
    from pegasus_tpu_torch.base.key_schema import generate_key, key_hash_parts
    from pegasus_tpu_torch.base.value_schema import epoch_now
    from pegasus_tpu_torch.server.partition_server import PartitionServer
    from pegasus_tpu_torch.server.types import KeyValue, MultiPutRequest

    rng = np.random.default_rng(seed)
    rows = _user_keys(0, n_hashkeys)
    hashes = crc64_batch(rows, np.full(len(rows), 12, np.int64))
    route = (hashes % np.uint64(RESIDENT_PARTITIONS)).astype(np.int64)
    expiring = rng.random((n_hashkeys, len(SORT_KEYS))) \
        < RESIDENT_EXPIRED
    servers = [PartitionServer(os.path.join(data_dir, str(p)),
                               app_id=RESIDENT_APP, pidx=p,
                               partition_count=RESIDENT_PARTITIONS,
                               device=device)
               for p in range(RESIDENT_PARTITIONS)]
    live = {p: [] for p in range(RESIDENT_PARTITIONS)}
    dead = {p: [] for p in range(RESIDENT_PARTITIONS)}
    t0 = time.perf_counter()
    start = epoch_now()
    for h in range(n_hashkeys):
        hk = rows[h].tobytes()
        p = int(route[h])
        groups = ([], [])
        for s, sk in enumerate(SORT_KEYS):
            short = bool(expiring[h, s])
            groups[short].append(KeyValue(sk, b"field0=%064d" % (h * 10 + s)))
            (dead if short else live)[p].append(generate_key(hk, sk))
        for kvs, ttl in zip(groups, (0, 1)):
            if kvs and servers[p].on_multi_put(
                    MultiPutRequest(hk, kvs, ttl),
                    partition_hash=key_hash_parts(hk)) != 0:
                fail("resident: multi_put refused")
    load_s = time.perf_counter() - t0
    deadline = epoch_now() + 2   # every 1 s TTL runs out first
    t0 = time.perf_counter()
    for s in servers:
        s.manual_compact(now=start)   # before any TTL ran out
    for d in (live, dead):
        for keys in d.values():
            keys.sort()
    compact_s = time.perf_counter() - t0
    while epoch_now() < deadline:
        time.sleep(0.1)
    return servers, live, dead, load_s, compact_s


def partition_blocks(server) -> list:
    """[(ckey, device block, pidx, rows)] of every L1 block of
    `server`."""
    out = []
    for run in server.engine.lsm.l1_runs:
        for i, bm in enumerate(run.blocks):
            ckey = (run.path, bm.offset)
            blk = run.read_block(i)
            out.append((ckey, server._device_cached_block(ckey, blk),
                        server.pidx, blk.count))
    return out


def clear_masks(servers) -> None:
    for s in servers:
        with s._mask_lock:
            s._mask_cache.clear()


def survivor_keys(engine) -> list:
    out = []
    for run in engine.lsm.l1_runs:
        for i in range(len(run.blocks)):
            blk = run.read_block(i)
            out.extend(blk.key_at(j) for j in range(blk.count))
    return out


def drain_multi(servers, now: int) -> dict:
    """Every partition's whole range through scan_multi (one flush of the
    first pages) and on_scan (the rest): {pidx: [(key, value)]}."""
    from pegasus_tpu_torch.server.scan_coordinator import scan_multi
    from pegasus_tpu_torch.server.types import (
        SCAN_CONTEXT_ID_COMPLETED,
        GetScannerRequest,
    )

    resps = scan_multi([(s, [GetScannerRequest(batch_size=4096)])
                        for s in servers], now)
    out = {}
    for s, (resp,) in zip(servers, resps):
        rows = []
        while True:
            if resp.error != 0:
                fail(f"resident drain: error {resp.error}")
            rows.extend((kv.key, kv.value) for kv in resp.kvs)
            if resp.context_id == SCAN_CONTEXT_ID_COMPLETED:
                break
            resp = s.on_scan(resp.context_id)
        out[s.pidx] = rows
    return out


def lone_shard(stack):
    """The tensors of a one-shard image: its one shard (a checkout from
    before the sharded image: the stack itself)."""
    return stack.shards[0] if hasattr(stack, "shards") else stack


def one_shard_stack(device, slabs):
    """mesh_resident._build_stack of `slabs` on `device` alone (a
    checkout from before the sharded image takes the device)."""
    from pegasus_tpu_torch.parallel import mesh_resident

    if not hasattr(mesh_resident, "_Shard"):
        return mesh_resident._build_stack(device, slabs)
    from pegasus_tpu_torch.parallel import make_mesh

    return mesh_resident._build_stack(make_mesh(devices=[device]), slabs)


def run_round(stack, validate: bool, pv: int, fkey, now: int, mask,
              with_sum: bool):
    """MeshServing._run_program with `mask` (bool[P, B] on the card, or
    None) as the value-filter mask: since the sharded image a round takes
    the value filter, whose mask each shard caches, so each shard is
    handed its tile of `mask` under a key of its own (a checkout from
    before takes the mask)."""
    from pegasus_tpu_torch.parallel.mesh_resident import MESH_SERVING

    if mask is None or not hasattr(stack, "shards"):
        return MESH_SERVING._run_program(stack, validate, pv, fkey, now,
                                         mask, with_sum)
    vf = ("chip_smoke mask", id(mask))
    for sh in stack.shards:
        sh._extra_cache[vf] = mask[sh.slot0:sh.slot0 + sh.P,
                                   sh.row0:sh.row0 + sh.B].contiguous()
    return MESH_SERVING._run_program(stack, validate, pv, fkey, now, vf,
                                     with_sum)


def measure_placement(device, win: dict, stack) -> dict:
    """ops/placement's cost constants, measured on this card:
    H2D_GBPS_EST (a pageable copy of 64 MB to the card, median of 5),
    D2H_GBPS_EST (64 MB home into page-locked memory, as a round copies
    its results, median of 5; the pageable copy is measured beside it
    for the record), ROUND_FIXED_S_EST (one resident round at P = 1,
    B = 8: its two launches, the one copy home and the wait; median of
    50),
    HOST_DISPATCH_S_EST (phase 3's stacked_block_eval over 8 resident
    blocks of 1024: one table call of the scan kernel with its host
    cost, masks on the host), HOST_FILTER_GBPS_EST (numpy's TTL compare
    over a uint32 column of 16 Mi rows, median of 5) and
    MESH_EVAL_GBPS_EST (one round of the "rules" class at this phase's P
    and B, L2 flushed before each launch: the scan kernel's static launch
    with a sortkey filter, so it reads the key rows, plus the epilogue;
    the bytes the two launches really move over the sum of their device
    times, each timed a launch; fails above the card's HBM rate). The
    same round with no key filter (the "ttl" class) is timed beside it
    for the record."""
    import torch

    from pegasus_tpu_torch.ops import fused_mesh
    from pegasus_tpu_torch.ops.fused_scan import scan_table
    from pegasus_tpu_torch.ops.predicates import FT_MATCH_POSTFIX, FilterSpec
    from pegasus_tpu_torch.parallel.mesh_resident import MESH_SERVING, _Slab

    def median(fn, n):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return sorted(times)[n // 2]

    host = torch.ones(64 << 20, dtype=torch.uint8)
    card = host.to(device)
    torch.cuda.synchronize()

    def h2d():
        host.to(device)
        torch.cuda.synchronize()

    h2d_s = median(h2d, 5)
    d2h_pageable_s = median(card.cpu, 5)
    pinned = torch.empty(card.shape, dtype=torch.uint8, pin_memory=True)

    def d2h():
        pinned.copy_(card, non_blocking=True)
        torch.cuda.synchronize()

    d2h_s = median(d2h, 5)
    ets = np.random.default_rng(3).integers(
        0, 1 << 32, 16 << 20, dtype=np.uint64).astype(np.uint32)
    now32 = np.uint32(1 << 31)
    filt_s = median(lambda: (ets > 0) & (ets <= now32), 5)

    tiny = _Slab(None, 0, 0)
    tiny.n_rows, tiny.width = 8, 32
    tiny.keys = np.zeros((8, 32), np.uint8)
    tiny.key_len = np.full(8, 2, np.int32)
    tiny.hashkey_len = np.zeros(8, np.int32)
    tiny.expire_ts = np.zeros(8, np.uint32)
    tiny.valid = np.ones(8, bool)
    tiny.hash_lo = np.zeros(8, np.uint32)
    tiny_stack = one_shard_stack(device, [(0, tiny)])
    fkey = (0, b"", 0, b"")
    round_s = median(lambda: MESH_SERVING._run_program(
        tiny_stack, False, -1, fkey, 0, None, False), 50)
    tiny_split = round_split(device, tiny_stack, n=50)["wave"]

    stack = lone_shard(stack)
    allowed = torch.ones(stack.P, dtype=torch.uint8, device=device)
    flush, _read_flush = _flusher(device)
    rows, k = stack.P * stack.B, stack.flat.keys.shape[1]
    none = FilterSpec.none(device)
    classes = {}
    for cls, sort in (("rules", FilterSpec.make(FT_MATCH_POSTFIX, b"5",
                                                device)),
                      ("ttl", none)):

        def static_mask(sort=sort):
            return scan_table([stack.flat], [stack.pidx_rows], none, sort,
                              True, RESIDENT_PARTITIONS - 1)

        static = static_mask().view(stack.P, stack.B // 8)

        def epilogue(static=static):
            fused_mesh.mesh_step_buffer(static, allowed, stack.ets2d,
                                        stack.present, None, None, 0, False)

        # each kernel's time a launch (a trace may drop some launches)
        parts = (_device_ms(static_mask, 20, "scan_table_kernel", flush),
                 _device_ms(epilogue, 20, "mesh_step_kernel", flush))
        if None in parts:
            fail("torch.profiler recorded no device time for a resident "
                 "round")
        nbytes = table_bytes(rows, k, hash_filter=False,
                             sort_filter=cls == "rules", now=False,
                             validate=True, pidx_column=True) \
            + rows * mesh_step_row_bytes(False, False)
        gbps = nbytes / sum(parts) / 1e6
        if gbps * 1e9 > HBM_BYTES_PER_S:
            fail(f"the resident round ({cls}) moved {nbytes} B at "
                 f"{gbps:.1f} GB/s, above the card's HBM rate")
        classes[cls] = {"device_ms": sum(parts), "bytes": nbytes,
                        "gbps": gbps}
    return {
        "H2D_GBPS_EST": host.numel() / h2d_s / 1e9,
        "D2H_GBPS_EST": host.numel() / d2h_s / 1e9,
        "d2h_pageable_gbps": host.numel() / d2h_pageable_s / 1e9,
        "ROUND_FIXED_S_EST": round_s,
        "HOST_DISPATCH_S_EST": win["median_us"] / 1e6,
        "HOST_FILTER_GBPS_EST": ets.nbytes / filt_s / 1e9,
        "MESH_EVAL_GBPS_EST": classes["rules"]["gbps"],
        "round_device_ms": classes["rules"]["device_ms"],
        "round_fixed_split": tiny_split,
        "rounds": classes,
    }


def check_mesh_step(device) -> dict:
    """(f) the epilogue kernel against its plain version at every P of
    RESIDENT_CHECK_P and B of RESIDENT_CHECK_B (a slot's cluster of 1, 2
    or 8 blocks), its four instances (the lanes' sum off and on, a
    value-filter mask or None): random packed masks, an allowed gate
    with slots shut, TTLs around `now` and past 2^31, rows past each
    slot's count, a value-filter mask; the result buffer's three views
    bit-identical to the plain outputs."""
    import torch

    from pegasus_tpu_torch.ops import fused_mesh

    rng = np.random.default_rng(1010)
    now = 300_000_000
    compared = 0
    for p in RESIDENT_CHECK_P:
        for b in RESIDENT_CHECK_B:
            packed = torch.from_numpy(rng.integers(
                0, 256, (p, b // 8), dtype=np.uint8)).to(device)
            allowed = torch.from_numpy(
                (rng.random(p) < 0.8).astype(np.uint8)).to(device)
            ets = torch.from_numpy(rng.choice(np.array(
                [0, 1, now - 1, now, now + 1, 0x80000010, 0xFFFFFFFF],
                np.uint32), (p, b)).view(np.int32)).to(device)
            present = torch.from_numpy(
                np.arange(b)[None, :] < rng.integers(0, b + 1, (p, 1))
            ).to(device)
            mask = torch.from_numpy(rng.random((p, b)) < 0.6).to(device)
            lanes = torch.from_numpy(rng.integers(
                0, 1 << 16, (p, b, 4)).astype(np.int32)).to(device)
            for with_sum in (False, True):
                for extra in (None, mask):
                    got = fused_mesh.mesh_step(packed, allowed, ets,
                                               present, extra, lanes, now,
                                               with_sum)
                    want = fused_mesh.mesh_step_plain(
                        packed, allowed, ets, present, extra, lanes, now,
                        with_sum)
                    torch.cuda.synchronize()
                    for g, w, what in zip(got, want, ("mask", "counts",
                                                      "lane sums")):
                        if not torch.equal(g, w):
                            fail(f"mesh_step kernel != plain ({what}) at "
                                 f"P={p}, B={b}, sum={with_sum}, "
                                 f"extra={extra is not None}")
                    compared += 1
    return {"compared": compared, "max_abs_err": 0}


def check_slot_gate(device) -> dict:
    """(f) the compaction kernel's slot gate (mesh_compact_step on the
    card) against eval_block_plain with the same gate on the same
    tensors, at every P and B of (f), want_ets off and on: the TTL pass
    (no ruleset: slot_gate_kernel) and config #4's ruleset
    (compaction_filter_kernel's gated rules instance) each time, a
    default TTL in turns; fixture keys, hash_lo owned by the slot's pidx
    for 90% of the rows, slots above the version; bit-identical."""
    import torch

    from pegasus_tpu_torch.ops import compaction as tcomp
    from pegasus_tpu_torch.ops.compaction_rules import parse_rules

    rng = np.random.default_rng(1011)
    config4 = tuple(parse_rules(CONFIG4_RULES))
    pv = 47
    compared = turn = 0
    for p in RESIDENT_CHECK_P:
        for b in RESIDENT_CHECK_B:
            rows = p * b
            keys = fixture_keys(rng.integers(0, 7_000_000, rows))
            pidx = rng.permutation(RESIDENT_PARTITIONS)[:p].astype(np.int32)
            noise = rng.integers(0, 1 << 32, rows, dtype=np.uint64)
            hash_lo = np.where(rng.random(rows) < 0.9,
                               (noise & ~np.uint64(63))
                               | np.repeat(pidx, b).astype(np.uint64),
                               noise).astype(np.uint32)
            ets = rng.choice(np.array([0, 0, 4900, 5000, 5100], np.uint32),
                             rows)
            present = (np.arange(b)[None, :]
                       < rng.integers(0, b + 1, (p, 1)))
            cols = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                    for a in (keys.reshape(p, b, 32),
                              np.full((p, b), 17, np.int32),
                              np.full((p, b), 12, np.int32),
                              ets.view(np.int32).reshape(p, b), present,
                              hash_lo.view(np.int32).reshape(p, b), pidx,
                              pidx <= pv)]
            k, kl, hkl, e, pr, lo, pi, al = cols
            for want_ets in (False, True):
                for ops in ((), config4):
                    ttl = 600 if turn % 3 == 0 else 0
                    turn += 1
                    got = tcomp.mesh_compact_step(
                        *cols, 5000, ttl, pv, operations=ops,
                        validate_hash=True, want_ets=want_ets)
                    want = tcomp.eval_block_plain(
                        ops, k.reshape(rows, 32), kl.reshape(rows),
                        hkl.reshape(rows), e.reshape(rows),
                        pr.reshape(rows), lo.reshape(rows), 5000, ttl, pi,
                        pv, True, True, want_ets=want_ets, pack=True,
                        slot_allowed=al)
                    torch.cuda.synchronize()
                    what = "rules" if ops else "TTL pass"
                    if not torch.equal(got[0].reshape(-1), want[0]):
                        fail(f"slot gate ({what}) != plain (drop) at "
                             f"P={p}, B={b}, want_ets={want_ets}")
                    if want_ets and not torch.equal(got[1].reshape(-1),
                                                    want[1]):
                        fail(f"slot gate ({what}) != plain (ets2) at "
                             f"P={p}, B={b}")
                    compared += 1
    return {"compared": compared, "max_abs_err": 0}


def time_resident_kernels(device, stack) -> dict:
    """(f) times at this image's P and B, L2 flushed before each launch:
    the epilogue's three instances on the main path (a wave: no sum and
    no value-filter mask; an aggregate with a value filter: the mask
    read; a sum aggregate: the mask and the lanes' sum), and the slot
    gate in the TTL pass's shape (no ruleset, validation against the
    resident hash_lo, pidx once a slot, packed, no ets2) in turns with
    the same launch through compaction_filter_kernel's row-a-thread
    instance (new, row, row, new). Against a checkout from before the
    epilogue's redesign (no `mesh_step_buffer`) the wave instance reads
    an all-ones mask, as that design did, and both slot-gate arms are
    the row-a-thread kernel. Each kernel is also timed after a flush
    that only reads (`ms_read_flushed`)."""
    import torch

    from pegasus_tpu_torch.ops import compaction as tcomp
    from pegasus_tpu_torch.ops import fused_compaction, fused_mesh
    from pegasus_tpu_torch.ops.fused_scan import scan_table
    from pegasus_tpu_torch.ops.predicates import FilterSpec

    flush, read_flush = _flusher(device)
    new = hasattr(fused_mesh, "mesh_step_buffer")
    stack = lone_shard(stack)
    p, b = stack.P, stack.B
    rows = p * b
    none = FilterSpec.none(device)
    static = scan_table([stack.flat], [stack.pidx_rows], none, none, True,
                        RESIDENT_PARTITIONS - 1).view(p, b // 8)
    allowed = torch.ones(p, dtype=torch.uint8, device=device)
    mask = torch.ones((p, b), dtype=torch.bool, device=device)
    lanes = stack.lanes_dev()
    out = {}
    for name, with_sum, extra in (("wave", False, None if new else mask),
                                  ("extra", False, mask),
                                  ("sum", True, mask)):
        args = (static, allowed, stack.ets2d, stack.present, extra, lanes,
                0, with_sum)

        def kernel(a=args):
            return fused_mesh.mesh_step(*a)

        def plain(a=args):
            return fused_mesh.mesh_step_plain(*a)

        bound_ms, bound_by = mesh_step_bound(rows, with_sum,
                                             extra is not None)
        row = {"shape": f"P={p}, B={b} ({rows} rows), lanes' sum "
                        f"{'on' if with_sum else 'off'}, value-filter mask "
                        f"{'read' if extra is not None else 'none'}, L2 "
                        f"flushed",
               "ms": _device_ms(kernel, 50, "mesh_step_kernel", flush),
               "ms_read_flushed": _device_ms(kernel, 50, "mesh_step_kernel",
                                             read_flush),
               "call_ms": _cuda_ms(kernel, 50, flush),
               "plain_ms": _device_ms(plain, 10, "", flush),
               "plain_call_ms": _cuda_ms(plain, 10, flush),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "row_bytes": mesh_step_row_bytes(with_sum, extra is not None)}
        if None in (row["ms"], row["ms_read_flushed"], row["plain_ms"]):
            fail("torch.profiler recorded no device time for mesh_step")
        row["share"] = bound_ms / row["ms"]
        out[name] = row
    flat = stack.flat
    valid = stack.present.view(-1)

    def gated():
        return tcomp.mesh_compact_step(
            stack.view(flat.keys), stack.view(flat.key_len),
            stack.view(flat.hashkey_len), stack.ets2d, stack.present,
            stack.view(flat.hash_lo), stack.pidx, allowed, 5000, 0,
            RESIDENT_PARTITIONS - 1, validate_hash=True, want_ets=False)

    def row_a_thread():
        return fused_compaction.compaction_filter(
            flat.keys, flat.key_len, flat.expire_ts, valid, flat.hash_lo,
            stack.pidx, (), 5000, 0, RESIDENT_PARTITIONS - 1,
            validate_hash=True, expire=True, want_ets=False, pack=True,
            slot_allowed=allowed)

    def plain_gate():
        return tcomp.eval_block_plain(
            (), flat.keys, flat.key_len, flat.hashkey_len, flat.expire_ts,
            valid, flat.hash_lo, 5000, 0, stack.pidx,
            RESIDENT_PARTITIONS - 1, True, True, want_ets=False, pack=True,
            slot_allowed=allowed)

    bound_ms, bound_by = compaction_bound(
        rows, 32, keys=False, hash_lo=True, pidx_col=False, pack=True,
        want_ets=False, ops=rows * 8.0, slots=p)
    gate_kernel = ("slot_gate_kernel"
                   if hasattr(fused_compaction, "slot_gate_filter")
                   else "compaction_filter_kernel")
    row = {"shape": f"P={p}, B={b} ({rows} rows), the TTL pass: no "
                    f"ruleset, validation against hash_lo, pidx once a "
                    f"slot, packed, no ets2, L2 flushed",
           "kernel": gate_kernel,
           "ms_read_flushed": _device_ms(gated, 50, gate_kernel, read_flush),
           "call_ms": _cuda_ms(gated, 50, flush),
           "plain_ms": _device_ms(plain_gate, 10, "", flush),
           "plain_call_ms": _cuda_ms(plain_gate, 10, flush),
           "bound_ms": bound_ms, "bound_by": bound_by}
    turns = [_device_ms(fn, 50, name, flush)
             for fn, name in ((gated, gate_kernel),
                              (row_a_thread, "compaction_filter_kernel"),
                              (row_a_thread, "compaction_filter_kernel"),
                              (gated, gate_kernel))]
    if None in turns or None in (row["plain_ms"], row["ms_read_flushed"]):
        fail("torch.profiler recorded no device time for the slot gate")
    row["ms"] = (turns[0] + turns[3]) / 2
    row["row_a_thread_ms"] = (turns[1] + turns[2]) / 2
    row["turns_ms"] = turns
    row["share"] = bound_ms / row["ms"]
    out["slot_gate"] = row
    return out


def round_split(device, stack, n: int = 30) -> dict:
    """A resident round's host wall, median of `n`, for a wave (no sum,
    no value filter, one slot unpacked) and a sum aggregate (a value
    mask and the lanes' sum, every slot's total recombined), split into
    the launches (scan kernel and epilogue enqueued), the copy home
    (with the wait for the kernels) and the unpack; and the whole of
    `MeshServing._run_program` beside it. Against a checkout from before
    the one-buffer contract (no `mesh_step_buffer`), the copy is its
    three pageable copies."""
    import torch

    from pegasus_tpu_torch.ops import fused_mesh
    from pegasus_tpu_torch.ops.fused_scan import scan_table
    from pegasus_tpu_torch.ops.predicates import FilterSpec

    new = hasattr(fused_mesh, "mesh_step_buffer")
    image, stack = stack, lone_shard(stack)
    p, b = stack.P, stack.B
    pv = RESIDENT_PARTITIONS - 1
    none = FilterSpec.none(device)
    allowed = torch.ones(p, dtype=torch.uint8, device=device)
    mask = torch.ones((p, b), dtype=torch.bool, device=device)
    lanes = stack.lanes_dev()
    fkey = (0, b"", 0, b"")
    out = {"contract": "one buffer, one pinned copy" if new
           else "three outputs, three pageable copies"}
    for kind in ("wave", "sum"):
        with_sum = kind == "sum"
        extra = mask if with_sum or not new else None
        splits = []
        for _ in range(n):
            t0 = time.perf_counter()
            static = scan_table([stack.flat], [stack.pidx_rows], none, none,
                                True, pv).view(p, b // 8)
            args = (static, allowed, stack.ets2d, stack.present, extra,
                    lanes if with_sum else None, 0, with_sum)
            if new:
                from pegasus_tpu_torch.ops import result_buffer

                buf = fused_mesh.mesh_step_buffer(*args)
            else:
                parts = fused_mesh.mesh_step(*args)
            t1 = time.perf_counter()
            if new:
                packed, counts, sums = result_buffer.views(
                    result_buffer.home(buf), fused_mesh.result_layout(p, b))
            else:
                packed, counts, sums = (parts[0].cpu().numpy(),
                                        parts[1].cpu().numpy(),
                                        parts[2].cpu().numpy().view(
                                            np.uint32))
            t2 = time.perf_counter()
            if with_sum:
                ln = sums.astype(np.uint64)
                with np.errstate(over="ignore"):   # wraps mod 2^64
                    [int(ln[s, 0] + (ln[s, 1] << np.uint64(16))
                         + (ln[s, 2] << np.uint64(32))
                         + (ln[s, 3] << np.uint64(48))) for s in range(p)]
            else:
                np.unpackbits(packed[0]).astype(bool)
            t3 = time.perf_counter()
            splits.append((t1 - t0, t2 - t1, t3 - t2, t3 - t0))
        med = [sorted(col)[n // 2] for col in zip(*splits)]
        walls = sorted(run_round(image, True, pv, fkey, 0, extra,
                                 with_sum)[0] for _ in range(n))
        out[kind] = {"launch_s": med[0], "copy_s": med[1],
                     "unpack_s": med[2], "total_s": med[3],
                     "run_program_s": walls[n // 2]}
    return out


def copies_after(events, last: str) -> list:
    """From device events [(start, name)]: the number of copies home
    (`Memcpy DtoH`) after each launch whose name holds `last` and before
    the next one. A trace can drop its first records, so rounds before
    the first recorded launch are not counted."""
    out = []
    for _start, name in sorted(events):
        if last in name:
            out.append(0)
        elif name.startswith("Memcpy DtoH") and out:
            out[-1] += 1
    return out


def round_device_ops(stack, rounds_n: int = 40) -> dict:
    """What the device runs a resident round, from torch.profiler over
    `rounds_n` rounds each: a wave, a sum aggregate with a value mask,
    and a compaction round (the TTL pass's shape, want_ets on). Each
    recorded round's last kernel (the epilogue, the slot gate) must be
    followed by exactly one copy home; fails on a memset anywhere in the
    trace, or if no round was recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pegasus_tpu_torch.parallel.mesh_resident import MESH_SERVING

    device = lone_shard(stack).device
    pv = RESIDENT_PARTITIONS - 1
    fkey = (0, b"", 0, b"")
    mask = torch.ones((stack.P, stack.B), dtype=torch.bool, device=device)
    allowed = (np.ones(stack.P, bool) if hasattr(stack, "shards")
               else torch.ones(stack.P, dtype=torch.uint8, device=device))
    params = MESH_SERVING._compact_params(5000, 0, pv, True, (), True)
    rounds = {
        "wave": ("mesh_step_kernel", lambda: MESH_SERVING._run_program(
            stack, True, pv, fkey, 0, None, False)),
        "sum": ("mesh_step_kernel", lambda: run_round(
            stack, True, pv, fkey, 0, mask, True)),
        "compaction": ("slot_gate_kernel",
                       lambda: MESH_SERVING._compact_round(
                           stack, allowed, params, ())),
    }
    out = {}
    for name, (last, fn) in rounds.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(rounds_n):
                fn()
            torch.cuda.synchronize()
        events = [(ev.time_range.start, ev.name) for ev in prof.events()
                  if str(getattr(ev, "device_type", "")).endswith("CUDA")]
        memsets = sum("Memset" in n for _t, n in events)
        copies = copies_after(events, last)
        if memsets:
            fail(f"resident round ({name}) issued {memsets} memsets over "
                 f"{rounds_n} rounds")
        if not copies or any(c != 1 for c in copies):
            fail(f"resident round ({name}): copies home after each "
                 f"recorded {last} launch {copies}, not one each")
        out[name] = {"recorded": len(copies), "d2h": sum(copies),
                     "memsets": memsets}
    return out


def synthetic_stack(device, p: int = RESIDENT_PARTITIONS, n: int = 15_625,
                    seed: int = 11):
    """A [p, B, 32] resident image of `n` rows a slot from seeded numpy
    columns (fixture keys, 10% expired, hash_lo owned by the slot, random
    value lanes), built by mesh_resident._build_stack: phase 10's image
    shape without its load, for --resident-times."""
    from pegasus_tpu_torch.parallel.mesh_resident import _Slab

    rng = np.random.default_rng(seed)
    slabs = []
    for part in range(p):
        slab = _Slab(None, 0, 0)
        slab.n_rows, slab.width = n, 32
        slab.keys = fixture_keys(rng.integers(0, 7_000_000, n))
        slab.key_len = np.full(n, 17, np.int32)
        slab.hashkey_len = np.full(n, 12, np.int32)
        slab.expire_ts = np.where(rng.random(n) < RESIDENT_EXPIRED,
                                  np.uint32(1), np.uint32(0))
        slab.valid = np.ones(n, bool)
        noise = rng.integers(0, 1 << 32, n, dtype=np.uint64)
        slab.hash_lo = ((noise & ~np.uint64(63)) | np.uint64(part)).astype(
            np.uint32)
        slab.lanes = rng.integers(0, 1 << 16, (n, 4)).astype(np.uint32)
        slabs.append((part, slab))
    return one_shard_stack(device, slabs)


def resident_times(torch, tree: str) -> int:
    """--resident-times: phase 10 (f)'s kernel times and a round's wall
    split on a synthetic image of phase 10's shape, for the
    pegasus_tpu_torch imported from `tree`, as one JSON line: to hold two
    revisions against each other on one card, run each in its own
    process in turns (P C C P)."""
    from concurrent.futures import ThreadPoolExecutor

    from pegasus_tpu_torch.ops import fused_compaction, fused_mesh, fused_scan

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    device = torch.device("cuda", torch.cuda.current_device())
    with ThreadPoolExecutor(3) as pool:
        builds = [pool.submit(m.build, force=True)
                  for m in (fused_scan, fused_compaction, fused_mesh)]
        for b in builds:
            b.result()
    stack = synthetic_stack(device)
    times = time_resident_kernels(device, stack)
    split = round_split(device, stack)
    log(json.dumps({"tree": tree, "card": smi.stdout.strip(),
                    "P": stack.P, "B": stack.B,
                    "times": {k: {f: v[f] for f in (
                        "ms", "ms_read_flushed", "call_ms", "bound_ms",
                        "share") if f in v}
                              | ({"row_a_thread_ms": v["row_a_thread_ms"],
                                  "turns_ms": v["turns_ms"]}
                                 if "turns_ms" in v else {})
                              for k, v in times.items()},
                    "round_split": split}))
    return 0


def resident_waves(blocks, pv: int, fkey) -> tuple:
    """Every partition's blocks through stacked_block_eval, one wave a
    partition: ({ckey: mask[:rows]}, seconds)."""
    from pegasus_tpu_torch.server.scan_coordinator import stacked_block_eval

    masks, secs = {}, 0.0
    for part in blocks.values():
        rows = {ck: n for ck, _d, _p, n in part}
        t0 = time.perf_counter()
        got = list(stacked_block_eval([(ck, d, p) for ck, d, p, _n in part],
                                      True, pv, filter_key=fkey))
        secs += time.perf_counter() - t0
        for ck, keep in got:
            masks[ck] = np.asarray(keep)[:rows[ck]]
    return masks, secs


MESH_LOGICAL_SHARDS = 4   # the leg's shards on a one-card host
MESH_WALL_ROUNDS = 30     # rounds a round's host-wall median takes
MESH_LEG_BUDGET_S = 30.0  # what the leg may take of the whole run


@contextlib.contextmanager
def recorded_rounds(serving):
    """Record the parameters of every round `serving` runs inside the
    block (not the image): {"program": {(validate, pv, filter key, now,
    value filter, with_sum)}, "compact": {(params, ops key):
    (params, operations)}}."""
    from pegasus_tpu_torch.ops.fused_compaction import ops_key

    rec = {"program": {}, "compact": {}}
    run, compact = serving._run_program, serving._compact_round

    def run_rec(stack, validate, pv, fkey, now, vf, with_sum):
        rec["program"][(bool(validate), int(pv), tuple(fkey), int(now), vf,
                        bool(with_sum))] = None
        return run(stack, validate, pv, fkey, now, vf, with_sum)

    def compact_rec(stack, allowed, params, operations):
        rec["compact"][(params, ops_key(operations))] = (params, operations)
        return compact(stack, allowed, params, operations)

    serving._run_program, serving._compact_round = run_rec, compact_rec
    try:
        yield rec
    finally:
        del serving._run_program, serving._compact_round


def leg_mesh(device):
    """(mesh, cards) of phase 10's mesh leg: every card of the host with
    dp their count; on a one-card host (or the CPU rehearsal) four
    logical shards on the one device."""
    import torch

    from pegasus_tpu_torch.parallel import make_mesh

    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    if cards > 1:
        return make_mesh(), cards
    return make_mesh(devices=[device] * MESH_LOGICAL_SHARDS), 1


def device_launches() -> dict:
    """{kernel: {card index: launches}} of the hand-written kernels,
    from their wrappers' DEVICE_LAUNCHES."""
    from pegasus_tpu_torch.ops import fused_compaction, fused_mesh, fused_scan

    out = {}
    for m in (fused_scan, fused_mesh, fused_compaction):
        for (kind, index), n in sorted(m.DEVICE_LAUNCHES.items(),
                                       key=lambda kv: (kv[0][0],
                                                       kv[0][1] or 0)):
            out.setdefault(kind, {})[str(index)] = n
    return out


def zero_launches() -> None:
    from pegasus_tpu_torch.ops import fused_compaction, fused_mesh, fused_scan

    for m in (fused_scan, fused_mesh, fused_compaction):
        for k in m.LAUNCHES:
            m.LAUNCHES[k] = 0
        m.DEVICE_LAUNCHES.clear()


def run_mesh_leg(device, servers, one, recorded: dict, pv: int, flavours,
                 card: str) -> dict:
    """Phase 10 (g): the resident image sharded over a mesh (every card
    of the host, dp their count; four logical shards on a one-card host)
    against the one-shard image `one`, bit for bit:
    (1) every round (a)-(d) ran (`recorded`: its waves, aggregates and
    bulk compactions' parameters) replayed on `one` and on the same
    slabs staged over the mesh: packed masks, counts, lane sums, drop
    masks and rewritten TTLs equal; (2) the mesh attached to
    MESH_SERVING and driven through its entry points, every count from
    0: each partition's wave through stacked_block_eval (gate pinned
    open), the count and sum aggregates over every partition, and each
    recorded compaction's try_compact_masks for partition 0, each equal
    to the one-shard image's answers; launches a card printed; (3) a
    refresh after partition 0's flush restages one shard of the mesh;
    (4) a wave round's host wall, one-shard against sharded (median of
    MESH_WALL_ROUNDS); (5) sharded_scan_step on a (dp, sp) = (2, 2)
    mesh against the one-device step."""
    import torch

    from pegasus_tpu_torch.base.key_schema import key_hash_parts
    from pegasus_tpu_torch.base.value_schema import epoch_now
    from pegasus_tpu_torch.ops.predicates import (
        FT_MATCH_ANYWHERE,
        FT_MATCH_POSTFIX,
        FilterSpec,
    )
    from pegasus_tpu_torch.ops.pushdown import PushdownSpec
    from pegasus_tpu_torch.parallel import make_mesh, sharded_scan_step
    from pegasus_tpu_torch.parallel.mesh_resident import (
        MESH_SERVING,
        _build_stack,
    )
    from pegasus_tpu_torch.parallel.partition_mesh import StackedBlocks
    from pegasus_tpu_torch.server.types import (
        SCAN_CONTEXT_ID_COMPLETED,
        GetScannerRequest,
        KeyValue,
        MultiPutRequest,
    )
    from pegasus_tpu_torch.utils.flags import FLAGS

    t_leg = time.perf_counter()
    pmesh, cards = leg_mesh(device)
    n_shards = len(pmesh.devices)
    where = "card" if device.type == "cuda" else "host"
    if cards == 1:
        log(f"mesh: {n_shards} shards on 1 {where} (no cross-card launch "
            f"or copy ran)")
    else:
        log(f"mesh: {n_shards} shards on {cards} cards (dp = {pmesh.dp}, "
            f"sp = {pmesh.sp})")
    out = {"shards": n_shards, "cards": cards, "dp": pmesh.dp,
           "sp": pmesh.sp}

    def equal(want, got, what: str) -> None:
        p = one.P
        if want is None or got is None:
            if (want is None) != (got is None):
                fail(f"resident (g) {what}: one arm has no result")
            return
        if not np.array_equal(np.asarray(want)[:p], np.asarray(got)[:p]) \
                or np.asarray(got)[p:].any():
            fail(f"resident (g) {what}: the sharded image differs from "
                 f"the one-shard image")

    # (1) the phase's rounds, replayed on both images
    t0 = time.perf_counter()
    sharded = _build_stack(pmesh, one.slots)
    out["stage_s"] = time.perf_counter() - t0
    if len(sharded.shards) != n_shards:
        fail(f"resident (g): {len(sharded.shards)} shards on a mesh of "
             f"{n_shards}")
    for key in recorded["program"]:
        want = MESH_SERVING._run_program(one, *key)[1]
        got = MESH_SERVING._run_program(sharded, *key)[1]
        for name, w, g in zip(("packed mask", "counts", "lane sums"), want,
                              got):
            equal(w, g, f"round {key[:4]} {name}")
    for params, ops in recorded["compact"].values():
        from pegasus_tpu_torch.parallel.partition_mesh import (
            partition_allowed,
        )

        drops = [MESH_SERVING._compact_round(
            st, partition_allowed(st.pidx_np, params[3], params[2]), params,
            ops) for st in (one, sharded)]
        equal(drops[0][0], drops[1][0], f"compaction {params} drop mask")
        equal(drops[0][1], drops[1][1], f"compaction {params} ets2")
    out["replayed"] = {"rounds": len(recorded["program"]),
                       "compactions": len(recorded["compact"])}
    log(f"resident (g) {len(recorded['program'])} rounds and "
        f"{len(recorded['compact'])} compaction rounds of (a)-(d) replayed "
        f"on the one-shard image and on the image over the mesh (P="
        f"{sharded.P}, B={sharded.B}, {n_shards} shards of "
        f"{sharded.shards[0].P} slots x {sharded.shards[0].B} rows, staged "
        f"in {out['stage_s']} s): packed masks, counts, lane sums, drop "
        f"masks and TTLs bit-equal")

    # (2) the entry points over each image
    blocks = {s.pidx: partition_blocks(s) for s in servers}

    def drive() -> dict:
        res = {}
        MESH_SERVING.ensure_current()
        for fkey in flavours:
            clear_masks(servers)
            w0 = MESH_SERVING.wave_dispatches
            with gate_open("mesh_wave_pays"):
                res[("wave", str(fkey))] = resident_waves(blocks, pv,
                                                          fkey)[0]
            if MESH_SERVING.wave_dispatches - w0 != len(servers):
                fail("resident (g): a wave declined the image")
        # as (b): no paging budget, so every partition's whole range is
        # one page the resident round may answer
        budget = FLAGS.get("pegasus.server", "rocksdb_max_iteration_count")
        FLAGS.set("pegasus.server", "rocksdb_max_iteration_count", 0,
                  force=True)
        with frozen_epoch():
            for kind in ("count", "sum"):
                MESH_SERVING._agg_cache.clear()
                a0 = MESH_SERVING.agg_dispatches
                for s in servers:
                    resp = s.on_get_scanner(GetScannerRequest(
                        pushdown=PushdownSpec(
                            value_filter_type=FT_MATCH_ANYWHERE,
                            value_filter_pattern=RESIDENT_VALUE_FILTER,
                            aggregate=kind)))
                    while resp.context_id != SCAN_CONTEXT_ID_COMPLETED:
                        resp = s.on_scan(resp.context_id)
                    res[(kind, s.pidx)] = resp.agg
                if MESH_SERVING.agg_dispatches - a0 != 1:
                    fail(f"resident (g): {kind} took "
                         f"{MESH_SERVING.agg_dispatches - a0} rounds")
        FLAGS.set("pegasus.server", "rocksdb_max_iteration_count", budget,
                  force=True)
        s0 = servers[0]
        lsm = s0.engine.lsm
        entries = lsm.bulk_compact_entries()
        for params, ops in recorded["compact"].values():
            MESH_SERVING._compact_cache.clear()
            c0 = MESH_SERVING.compact_dispatches
            with gate_open("mesh_compact_pays"):
                got = MESH_SERVING.try_compact_masks(
                    lsm, entries, params[0], params[1], s0.pidx, params[2],
                    params[3], ops, want_ets=params[5])
            if got is None or MESH_SERVING.compact_dispatches - c0 != 1:
                fail("resident (g): a compaction declined the image")
            res[("compact", params)] = {
                (run.path, i): m for (run, i), m in got.items()}
        return res

    serving_mesh = MESH_SERVING._pmesh
    MESH_SERVING.use_mesh(pmesh)
    MESH_SERVING.ensure_current()
    zero_launches()
    got = drive()
    launches = device_launches()
    out["launches"] = {"static": sum(launches.get("static", {}).values()),
                       "mesh_step": sum(launches.get("mesh_step",
                                                     {}).values()),
                       "compaction": sum(launches.get("compaction",
                                                      {}).values()),
                       "slot_gate": sum(launches.get("slot_gate",
                                                     {}).values()),
                       "slot_gate_columns": sum(launches.get(
                           "slot_gate_columns", {}).values())}
    out["launches_by_card"] = launches
    MESH_SERVING.use_mesh(make_mesh(devices=[device]))
    want = drive()
    if want.keys() != got.keys():
        fail("resident (g): the drives' answers differ in shape")
    for k in want:
        w, g = want[k], got[k]
        if k[0] == "wave":
            same = w.keys() == g.keys() and all(
                np.array_equal(w[c], g[c]) for c in w)
        elif k[0] == "compact":
            same = w.keys() == g.keys() and all(
                np.array_equal(w[c][0], g[c][0])
                and (w[c][1] is None) == (g[c][1] is None)
                and (w[c][1] is None or np.array_equal(w[c][1], g[c][1]))
                for c in w)
        else:
            same = w == g
        if not same:
            fail(f"resident (g) {k[0]}: the image over the mesh answered "
                 f"otherwise than the one-shard image")
    if device.type == "cuda":
        for k in ("static", "mesh_step", "slot_gate"):
            if not out["launches"][k]:
                fail(f"resident (g): no {k} launch over the mesh")
    log(f"resident (g) the image over the mesh through MESH_SERVING "
        f"({len(flavours)} x {len(servers)} partition waves, count and "
        f"sum over {len(servers)} partitions, "
        f"{len(recorded['compact'])} compactions' masks): every answer "
        f"equal to the one-shard image's; launches {out['launches']}, "
        f"by card {json.dumps(launches)}")

    # (3) a refresh after one partition's flush, over the mesh
    MESH_SERVING.use_mesh(pmesh)
    MESH_SERVING.ensure_current()
    stages1, reuses1 = MESH_SERVING.shard_stages, MESH_SERVING.shard_reuses
    s0 = servers[0]
    hk = next(iter(s0.engine.lsm.iterate()))[0][2:14]
    if s0.on_multi_put(MultiPutRequest(hk, [KeyValue(b"mesh-leg",
                                                     b"field0=mesh")], 0),
                       partition_hash=key_hash_parts(hk)) != 0:
        fail("resident (g): the refresh's write was refused")
    s0.engine.flush()
    MESH_SERVING.ensure_current()
    restaged = MESH_SERVING.shard_stages - stages1
    kept = MESH_SERVING.shard_reuses - reuses1
    fresh = MESH_SERVING._tables[RESIDENT_APP].stack
    if (fresh.P, fresh.B) == (sharded.P, sharded.B) and \
            restaged != pmesh.sp:
        fail(f"resident (g): a flush of one partition restaged {restaged} "
             f"shards, not the {pmesh.sp} holding its slot")
    check = _build_stack(make_mesh(devices=[device]), fresh.slots)
    key = next(iter(recorded["program"]))
    for name, w, g in zip(("packed mask", "counts", "lane sums"),
                          MESH_SERVING._run_program(check, *key)[1],
                          MESH_SERVING._run_program(fresh, *key)[1]):
        equal(w, g, f"refreshed round {name}")
    out["refresh"] = {"restaged": restaged, "kept": kept}
    log(f"resident (g) partition 0 flushed: the refresh restaged "
        f"{restaged} of {n_shards} shards and kept {kept}; the refreshed "
        f"image's round equal to a one-shard image of the same slabs")

    # (4) a wave round's host wall, one-shard against sharded
    wave = (True, pv, (0, b"", 0, b""), 0, None, False)
    walls = {}
    for name, st in (("one_shard", check), ("sharded", fresh),
                     ("sharded_again", fresh), ("one_shard_again", check)):
        walls[name] = sorted(MESH_SERVING._run_program(st, *wave)[0]
                             for _ in range(MESH_WALL_ROUNDS))[
            MESH_WALL_ROUNDS // 2]
    out["round_wall_s"] = walls
    log(f"resident (g) a wave round's host wall on {card} (median of "
        f"{MESH_WALL_ROUNDS}; one-shard, sharded, sharded, one-shard): "
        f"{walls['one_shard'] * 1e6} / {walls['sharded'] * 1e6} / "
        f"{walls['sharded_again'] * 1e6} / "
        f"{walls['one_shard_again'] * 1e6} us")

    # (5) the dryrun's (dp, sp) = (2, 2) shape over the image
    sh = lone_shard(check)
    flat = sh.flat
    stacked = StackedBlocks(sh.view(flat.keys), sh.view(flat.key_len),
                            sh.view(flat.hashkey_len), sh.ets2d,
                            sh.view(flat.valid), sh.pidx)
    sort = FilterSpec.make(FT_MATCH_POSTFIX, b"3", device)
    n_dev = cards if cards > 1 else 1
    grid = make_mesh(dp=2, devices=[torch.device(device.type, i % n_dev)
                                    if device.type == "cuda" else device
                                    for i in range(4)])
    if (grid.dp, grid.sp) != (2, 2):
        fail(f"resident (g): the step's mesh is {grid.dp} x {grid.sp}")
    now = epoch_now()
    want_step = sharded_scan_step(make_mesh(devices=[device]), stacked, now,
                                  sort, pv, True)
    got_step = sharded_scan_step(grid, stacked, now, sort, pv, True)
    for g, w in zip(got_step, want_step):
        if not torch.equal(g.cpu(), w.cpu()):
            fail("resident (g): sharded_scan_step on the (2, 2) mesh "
                 "differs from the one-device step")
    out["step_2x2"] = {"kept": int(got_step[1]),
                       "expired": int(got_step[2])}
    log(f"resident (g) sharded_scan_step on a (dp, sp) = (2, 2) mesh over "
        f"the image: equal to the one-device step; kept "
        f"{int(got_step[1])}, expired {int(got_step[2])}")
    MESH_SERVING.use_mesh(serving_mesh)
    out["leg_s"] = time.perf_counter() - t_leg
    log(f"resident (g) the mesh leg in {out['leg_s']:.1f} s (its budget "
        f"{MESH_LEG_BUDGET_S} s)")
    return out


def run_resident(device, win=None, n_hashkeys: int = RESIDENT_HASHKEYS,
                 seed: int = 10, card: str = "") -> dict:
    """Phase 10: BASELINE config #2's whole table in the resident image on
    the card (parallel/mesh_resident.py), every answer held against the
    host arm (the image switched off by `[pegasus.mesh] serving_enabled`)
    or an oracle, then the resident round's kernels against their plain
    versions. Returns the launches of the main path's run ((a)-(d)),
    the checks, the times and the measured placement constants. On the
    CPU (a rehearsal at a small `n_hashkeys`) (a)-(e) run on the plain
    versions, and the launch checks, (f) and the measurements are left
    out."""
    import torch

    from pegasus_tpu_torch.base.value_schema import epoch_now
    from pegasus_tpu_torch.ops import fused_compaction, fused_mesh, fused_scan
    from pegasus_tpu_torch.ops import placement
    from pegasus_tpu_torch.ops.compaction_rules import compile_rules
    from pegasus_tpu_torch.ops.predicates import (
        FT_MATCH_ANYWHERE,
        FT_MATCH_POSTFIX,
        FT_NO_FILTER,
        FilterSpec,
    )
    from pegasus_tpu_torch.ops.pushdown import PushdownSpec
    from pegasus_tpu_torch.parallel import make_mesh, sharded_scan_step
    from pegasus_tpu_torch.parallel.mesh_resident import MESH_SERVING
    from pegasus_tpu_torch.parallel.partition_mesh import StackedBlocks
    from pegasus_tpu_torch.server.partition_server import PartitionServer
    from pegasus_tpu_torch.server.scan_coordinator import stacked_block_eval
    from pegasus_tpu_torch.server.types import (
        SCAN_CONTEXT_ID_COMPLETED,
        GetScannerRequest,
    )
    from pegasus_tpu_torch.utils.flags import FLAGS

    def serving(on: bool) -> None:
        FLAGS.set("pegasus.mesh", "serving_enabled", on, force=True)

    out = {}
    data_dir = tempfile.mkdtemp(prefix="pegasus_torch_resident_")
    servers, twins = [], []
    rounds_cm = contextlib.ExitStack()
    iter_budget = FLAGS.get("pegasus.server", "rocksdb_max_iteration_count")
    try:
        servers, live, dead, load_s, compact_s = resident_load(
            device, os.path.join(data_dir, "main"), seed, n_hashkeys)
        for s in servers:
            s.close()
        shutil.copytree(os.path.join(data_dir, "main"),
                        os.path.join(data_dir, "twin"))

        def reopen(sub, app_id):
            return [PartitionServer(os.path.join(data_dir, sub, str(p)),
                                    app_id=app_id, pidx=p,
                                    partition_count=RESIDENT_PARTITIONS,
                                    device=device)
                    for p in range(RESIDENT_PARTITIONS)]

        servers = reopen("main", RESIDENT_APP)
        twins = reopen("twin", RESIDENT_APP + 1)
        rows_of = [sum(int(bm.count) for run in s.engine.lsm.l1_runs
                       for bm in run.blocks) for s in servers]
        log(f"resident: loaded {sum(rows_of)} records (BASELINE config #2, "
            f"{n_hashkeys} hashkeys x {len(SORT_KEYS)}, "
            f"{sum(len(d) for d in dead.values())} of them expired) into "
            f"{RESIDENT_PARTITIONS} partitions through multi_put in "
            f"{load_s:.1f} s, compacted in {compact_s:.1f} s; "
            f"{min(rows_of)}..{max(rows_of)} rows a partition")
        MESH_SERVING.reset()
        # (a)-(f) hold the one-shard image on the servers' own device;
        # (g) shards it over every card of the host
        MESH_SERVING.use_mesh(make_mesh(devices=[device]))
        t0 = time.perf_counter()
        for s in servers:
            MESH_SERVING.attach(s)
        MESH_SERVING.ensure_current()
        stack = MESH_SERVING._tables[RESIDENT_APP].stack
        if stack is None:
            fail("resident: the table does not fit the image")
        log(f"resident: image P={stack.P}, B={stack.B}, K={stack.K} "
            f"({stack.rows_total} rows, {stack.batch_bytes} predicate "
            f"bytes) staged in {time.perf_counter() - t0:.1f} s")
        if n_hashkeys != RESIDENT_HASHKEYS:
            log(f"resident: CUT to {n_hashkeys} hashkeys (the configuration "
                f"holds {RESIDENT_HASHKEYS})")
        elif (stack.P, stack.K) != (RESIDENT_PARTITIONS, 32) \
                or stack.B not in (16384, 32768):
            fail(f"resident: image {stack.P} x {stack.B} x {stack.K}, not "
                 f"64 x 16384|32768 x 32")
        pv = RESIDENT_PARTITIONS - 1
        blocks = {s.pidx: partition_blocks(s) for s in servers}
        flavours = (None, (FT_NO_FILTER, b"", FT_MATCH_POSTFIX, b"3"))

        # the main path's run: every count from 0; the parameters of
        # every round (a)-(d) run are kept for the mesh leg (g)
        zero_launches()
        recorded = rounds_cm.enter_context(recorded_rounds(MESH_SERVING))

        # (a) waves: every partition's blocks detached, then attached
        # with the gate pinned open: bit-identical masks
        waves = {}
        for fkey in flavours:
            serving(False)
            clear_masks(servers)
            host, host_s = resident_waves(blocks, pv, fkey)
            serving(True)
            clear_masks(servers)
            w0 = MESH_SERVING.wave_dispatches
            with gate_open("mesh_wave_pays"):
                mesh, mesh_s = resident_waves(blocks, pv, fkey)
            served = MESH_SERVING.wave_dispatches - w0
            if served != RESIDENT_PARTITIONS:
                fail(f"resident (a): {served} rounds for "
                     f"{RESIDENT_PARTITIONS} waves")
            if host.keys() != mesh.keys() or any(
                    not np.array_equal(host[ck], mesh[ck]) for ck in host):
                fail(f"resident (a): masks differ with the image attached "
                     f"(filter {fkey})")
            waves[str(fkey)] = {"host_s": host_s, "mesh_s": mesh_s,
                                "rounds": served}
            log(f"resident (a) {RESIDENT_PARTITIONS} partition waves, "
                f"filter {fkey}: masks bit-identical; host arm {host_s} s, "
                f"resident {mesh_s} s ({served} rounds, gate pinned open)")
        # the same under the measured gate: a partition's wave and the
        # whole table's wave
        part = blocks[0]
        part_bytes = sum(d.keys.numel() + 9 * d.expire_ts.numel()
                         for _c, d, _p, _n in part)
        whole = [b for p in sorted(blocks) for b in blocks[p]]
        whole_bytes = sum(d.keys.numel() + 9 * d.expire_ts.numel()
                          for _c, d, _p, _n in whole)
        def stacked_launches(wave) -> int:
            """The stacked path's table launches for `wave`, as try_wave
            counts them: up to 16 blocks of one (key width, capacity)
            a launch."""
            flavours = {}
            for _c, d, _p, _n in wave:
                key = (d.key_width, d.capacity)
                flavours[key] = flavours.get(key, 0) + 1
            return sum(-(-c // 16) for c in flavours.values())

        gate = {}
        for name, wave, nbytes in (("partition", part, part_bytes),
                                   ("table", whole, whole_bytes)):
            n_prog = stacked_launches(wave)
            verdict = placement.mesh_wave_pays(n_prog, nbytes,
                                               stack.batch_bytes)
            timed = {}
            for on in (False, True):
                serving(on)
                clear_masks(servers)
                w0 = MESH_SERVING.wave_dispatches
                t0 = time.perf_counter()
                list(stacked_block_eval([(c, d, p) for c, d, p, _n in wave],
                                        True, pv))
                timed[on] = (time.perf_counter() - t0,
                             MESH_SERVING.wave_dispatches - w0)
            if bool(timed[True][1]) != verdict:
                fail(f"resident (a): the measured gate said {verdict} but "
                     f"{timed[True][1]} rounds ran ({name})")
            gate[name] = {"programs": n_prog, "bytes": nbytes,
                          "pays": verdict, "host_s": timed[False][0],
                          "gated_s": timed[True][0]}
            log(f"resident (a) measured gate, one {name} wave ({len(wave)} "
                f"blocks, {n_prog} stacked launches, {nbytes} B): "
                f"{'resident round' if verdict else 'stacked path'}; host "
                f"arm {timed[False][0] * 1e3} ms, gated "
                f"{timed[True][0] * 1e3} ms")
        out["waves"], out["gate"] = waves, gate

        # (b) aggregates: count and sum over all 64 partitions, one round
        # per (predicate, now) on a frozen epoch second
        FLAGS.set("pegasus.server", "rocksdb_max_iteration_count", 0,
                  force=True)
        aggs = {}
        with frozen_epoch():
            for kind in ("count", "sum"):
                def fold():
                    res = {}
                    for s in servers:
                        req = GetScannerRequest(pushdown=PushdownSpec(
                            value_filter_type=FT_MATCH_ANYWHERE,
                            value_filter_pattern=RESIDENT_VALUE_FILTER,
                            aggregate=kind))
                        resp = s.on_get_scanner(req)
                        while resp.context_id != SCAN_CONTEXT_ID_COMPLETED:
                            resp = s.on_scan(resp.context_id)
                        res[s.pidx] = resp.agg
                    return res

                serving(False)
                host = fold()   # the value masks, cached per block
                serving(True)
                a0 = MESH_SERVING.agg_dispatches
                mesh = fold()   # the image's lanes and value mask, built
                rounds = MESH_SERVING.agg_dispatches - a0
                if mesh != host:
                    fail(f"resident (b): {kind} differs from the host arm")
                if rounds != 1:
                    fail(f"resident (b): {kind} took {rounds} rounds, not 1")
                # warm times: each arm again, the resident one a new round
                serving(False)
                t0 = time.perf_counter()
                host_again = fold()
                host_s = time.perf_counter() - t0
                serving(True)
                MESH_SERVING._agg_cache.clear()
                t0 = time.perf_counter()
                mesh_again = fold()
                mesh_s = time.perf_counter() - t0
                if host_again != host or mesh_again != host:
                    fail(f"resident (b): {kind} changed between passes")
                aggs[kind] = {"host_s": host_s, "mesh_s": mesh_s,
                              "total": sum(int(a["count"])
                                           for a in host.values())}
                log(f"resident (b) {kind} over {RESIDENT_PARTITIONS} "
                    f"partitions (value filter ANYWHERE "
                    f"{RESIDENT_VALUE_FILTER!r}): equal to the host arm, "
                    f"{aggs[kind]['total']} rows folded, one round; warm: "
                    f"host arm {host_s} s, resident {mesh_s} s")
        FLAGS.set("pegasus.server", "rocksdb_max_iteration_count",
                  iter_budget, force=True)
        out["aggregates"] = aggs

        # (c) a scan_multi drain of the whole table, detached and attached
        now = epoch_now()
        serving(False)
        clear_masks(servers)
        t0 = time.perf_counter()
        host = drain_multi(servers, now)
        host_s = time.perf_counter() - t0
        serving(True)
        clear_masks(servers)
        w0 = MESH_SERVING.wave_dispatches
        t0 = time.perf_counter()
        mesh = drain_multi(servers, now)
        mesh_s = time.perf_counter() - t0
        if mesh != host:
            fail("resident (c): the drain differs with the image attached")
        want = sum(len(v) for v in live.values())
        if sum(len(v) for v in host.values()) != want:
            fail(f"resident (c): drained {sum(len(v) for v in host.values())}"
                 f" records, the oracle holds {want}")
        out["drain"] = {"host_s": host_s, "mesh_s": mesh_s,
                        "rounds": MESH_SERVING.wave_dispatches - w0}
        log(f"resident (c) scan_multi drain of {want} records: equal "
            f"detached and attached ({out['drain']['rounds']} rounds under "
            f"the measured gate); host arm {host_s} s, attached {mesh_s} s")

        # (d) bulk compactions of all 64 partitions: config #3 (TTL), then
        # config #4 (rules), against the detached twin and the oracle
        rules = compile_rules(CONFIG4_RULES, device=device)
        prefix, anywhere, _sk = _config4_drops(0, n_hashkeys)
        dropped = {b"user%08d" % h for h in
                   np.flatnonzero(prefix | anywhere).tolist()}
        compact = {}
        for name, rf in (("config #3 TTL", None), ("config #4 rules", rules)):
            now = epoch_now()
            st0 = MESH_SERVING.status()
            secs = {}
            for arm, group in (("resident", servers), ("twin", twins)):
                t0 = time.perf_counter()
                with gate_open("mesh_compact_pays"):
                    for s in group:
                        s.manual_compact(default_ttl=0, rules_filter=rf,
                                         now=now)
                secs[arm] = time.perf_counter() - t0
            MESH_SERVING.ensure_current()
            st1 = MESH_SERVING.status()
            delta = {k: st1[k] - st0[k] for k in (
                "compact_dispatches", "compact_mask_serves",
                "refresh_reuses", "refresh_rebuilds")}
            if delta["compact_dispatches"] != 1 or \
                    delta["compact_mask_serves"] != RESIDENT_PARTITIONS:
                fail(f"resident (d) {name}: {delta}, not one round serving "
                     f"{RESIDENT_PARTITIONS} partitions")
            if delta["refresh_reuses"] != RESIDENT_PARTITIONS or \
                    delta["refresh_rebuilds"]:
                fail(f"resident (d) {name}: refresh {delta}, not "
                     f"{RESIDENT_PARTITIONS} survivor reuses")
            if rf is not None:
                for p in live:
                    live[p] = [k for k in live[p]
                               if k[2:14] not in dropped]
            for s, t in zip(servers, twins):
                if survivor_keys(s.engine) != live[s.pidx]:
                    fail(f"resident (d) {name}: partition {s.pidx}'s "
                         f"survivors differ from the oracle")
                if compacted_digest(s.engine) != compacted_digest(t.engine):
                    fail(f"resident (d) {name}: partition {s.pidx} differs "
                         f"from its detached twin")
            compact[name] = {"resident_s": secs["resident"],
                             "twin_s": secs["twin"], **delta}
            log(f"resident (d) {name}: {RESIDENT_PARTITIONS} partitions "
                f"compacted, survivors equal to the oracle and to the "
                f"detached twin; one round, {delta['refresh_reuses']} "
                f"survivor-gather refreshes; resident {secs['resident']} s, "
                f"twin {secs['twin']} s (gate pinned open; the measured "
                f"gate: {placement.compact_breakdown(stack.batch_bytes)})")
        out["compact"] = compact
        out["launches"] = {"static": fused_scan.LAUNCHES["static"],
                           "now": fused_scan.LAUNCHES["now"],
                           "multi": fused_scan.LAUNCHES["multi"],
                           "mesh_step": fused_mesh.LAUNCHES["mesh_step"],
                           "compaction": fused_compaction.LAUNCHES[
                               "compaction"],
                           "slot_gate": fused_compaction.LAUNCHES[
                               "slot_gate"],
                           "slot_gate_columns": fused_compaction.LAUNCHES[
                               "slot_gate_columns"]}
        rounds_cm.close()
        log(f"resident: launches of (a)-(d) {out['launches']}, by card "
            f"{json.dumps(device_launches())}")
        on_card = device.type == "cuda"
        for k in ("mesh_step", "slot_gate", "slot_gate_columns", "static"):
            if on_card and not out["launches"][k]:
                fail(f"resident: no {k} launch on the main path")

        # (e) sharded_scan_step over the image against its plain version
        stack = MESH_SERVING._tables[RESIDENT_APP].stack
        sh = lone_shard(stack)
        flat = sh.flat
        stacked = StackedBlocks(sh.view(flat.keys), sh.view(flat.key_len),
                                sh.view(flat.hashkey_len), sh.ets2d,
                                sh.view(flat.valid), sh.pidx)
        sort = FilterSpec.make(FT_MATCH_POSTFIX, b"3", device)
        now = epoch_now()
        got = sharded_scan_step(make_mesh(devices=[device]), stacked, now,
                                sort, pv, True)
        cpu = StackedBlocks(*(t.cpu() for t in stacked))
        want = sharded_scan_step(make_mesh(devices=[torch.device("cpu")]),
                                 cpu, now, sort, pv, True)
        for g, w in zip(got, want):
            if not torch.equal(g.cpu(), w):
                fail("resident (e): sharded_scan_step differs from its "
                     "plain version")
        out["sharded"] = {"kept": int(got[1]), "expired": int(got[2])}
        log(f"resident (e) sharded_scan_step over the image (validating, "
            f"key-hash instance): equal to the plain version; kept "
            f"{int(got[1])}, expired {int(got[2])}")

        # (g) the image sharded over a mesh, against the one-shard image
        out["mesh"] = run_mesh_leg(device, servers, stack, recorded, pv,
                                   flavours, card)

        if not on_card:
            return out

        # (f) the kernels against their plain versions, and their times
        t0 = time.perf_counter()
        out["check_mesh_step"] = check_mesh_step(device)
        out["check_slot_gate"] = check_slot_gate(device)
        log(f"resident (f) mesh_step: {out['check_mesh_step']['compared']} "
            f"launches (sum off/on, value mask None/read) bit-identical to "
            f"the plain version; slot gate: "
            f"{out['check_slot_gate']['compared']} launches (TTL pass and "
            f"rules, want_ets off/on) bit-identical; P in "
            f"{RESIDENT_CHECK_P}, B in {RESIDENT_CHECK_B}, in "
            f"{time.perf_counter() - t0:.1f} s")
        out["device_ops"] = round_device_ops(stack)
        for name, ops in out["device_ops"].items():
            log(f"resident (f) a {name} round on the device: one copy home "
                f"after each of its {ops['recorded']} recorded rounds (of "
                f"40, torch.profiler), no memset")
        out["times"] = time_resident_kernels(device, stack)
        for name, t in out["times"].items():
            log(f"resident (f) {name} {t['shape']}: device time kernel "
                f"{t['ms'] * 1e3} us ({t['ms_read_flushed'] * 1e3} us after "
                f"a read-only flush), plain {t['plain_ms'] * 1e3} us "
                f"(profiler); per call with the host kernel "
                f"{t['call_ms'] * 1e3} us, plain {t['plain_call_ms'] * 1e3} "
                f"us (CUDA events); bound {t['bound_ms'] * 1e3} us "
                f"({t['bound_by']}), {100 * t['share']}% of it"
                + (f"; the same launch through compaction_filter_kernel "
                   f"(a row a thread) {t['row_a_thread_ms'] * 1e3} us "
                   f"(new, row, row, new: "
                   f"{[x * 1e3 for x in t['turns_ms']]} us)"
                   if "row_a_thread_ms" in t else ""))
        out["round_split"] = round_split(device, stack)
        log(f"resident (f) a round's host wall (median of 30; launches, "
            f"copy home with the wait, unpack): "
            f"{json.dumps(out['round_split'])}")
        out["placement"] = measure_placement(device, win, stack)
        log(f"resident: placement constants measured on this card: "
            f"{json.dumps(out['placement'])}")
        return out
    finally:
        rounds_cm.close()
        FLAGS.set("pegasus.mesh", "serving_enabled", True, force=True)
        FLAGS.set("pegasus.server", "rocksdb_max_iteration_count",
                  iter_budget, force=True)
        MESH_SERVING.reset()
        for s in servers + twins:
            s.close()
        shutil.rmtree(data_dir, ignore_errors=True)


# ---- phase 11: replicated writes through PacificA groups on the card ------

REPL_PARTITIONS = 8            # partitions 0..7 of BASELINE config #2's 64
REPL_HASHKEYS = 100_000        # config #2's table: x 10 sortkeys
REPL_EXPIRED = 0.10            # bench.py: 10% of the records expired
REPL_REPLICAS = 3              # Pegasus's default: a primary, 2 secondaries
REPL_MUTATION_OPS = 1000       # bench.py:219-222: puts a mutation
REPL_OPS = 4000                # YCSB-E ops over the 8 primaries
REPL_PROBE = 800               # scans each set of primaries answers
REPL_RESTART_WRITES = 8        # small writes the restarted replica misses
REPL_APP = 12
# phase 11 in the whole run (--replicated-only runs it uncut): a printed
# cut since phase 12 came
REPL_RUN_HASHKEYS = 50_000
REPL_RUN_OPS = 2000
REPL_RUN_PROBE = 400


def repl_filters() -> list:
    """Phase 4's filter mix: 17 in 20 scans unfiltered, then a sortkey
    POSTFIX, a sortkey ANYWHERE and a PREFIX on both keys."""
    from pegasus_tpu_torch.ops.predicates import (
        FT_MATCH_ANYWHERE,
        FT_MATCH_POSTFIX,
        FT_MATCH_PREFIX,
    )

    return [(0, b"", 0, b"")] * 17 + [
        (0, b"", FT_MATCH_POSTFIX, b"5"),
        (0, b"", FT_MATCH_ANYWHERE, b"s0"),
        (FT_MATCH_PREFIX, b"user00", FT_MATCH_PREFIX, b"s0")]


class ReplicaGroups:
    """REPL_PARTITIONS PacificA groups of REPL_REPLICAS replicas each, all
    over one SimLoop / SimNetwork. Every replica has its own
    WriteFlushWindow as plog sink, open around each message it receives
    (as a replica stub opens one a dispatch) and around the client
    writes a primary takes."""

    def __init__(self, device, data_dir: str, parts) -> None:
        from pegasus_tpu_torch.replica import ReplicaConfig
        from pegasus_tpu_torch.runtime import SimLoop, SimNetwork

        self.device = device
        self.data_dir = data_dir
        self.loop = SimLoop(seed=13)
        self.net = SimNetwork(self.loop)
        self.replicas: dict = {}
        self.windows: dict = {}
        self.configs: dict = {}
        for p in parts:
            names = [f"p{p}r{j}" for j in range(REPL_REPLICAS)]
            for name in names:
                self.open(name, p, os.path.join(data_dir, name))
            self.configs[p] = ReplicaConfig(1, names[0], names[1:])
            for name in names:
                self.replicas[name].assign_config(self.configs[p])

    def open(self, name: str, p: int, path: str):
        from pegasus_tpu_torch.replica import Replica, WriteFlushWindow
        from pegasus_tpu_torch.utils.metrics import METRICS

        r = Replica(name, path, self.net, app_id=REPL_APP, pidx=p,
                    partition_count=PARTITION_COUNT, device=self.device)
        w = WriteFlushWindow(self.net, name,
                             METRICS.entity("write", f"smoke-{name}"))
        r.plog_sink = w

        def dispatch(src, msg_type, payload, r=r, w=w):
            with w:
                r.on_message(src, msg_type, payload)

        self.net.register(name, dispatch)
        self.replicas[name] = r
        self.windows[name] = w
        return r

    def primary(self, p: int):
        return self.replicas[self.configs[p].primary]

    def members(self, p: int) -> list:
        c = self.configs[p]
        return [self.replicas[n] for n in [c.primary] + c.secondaries]

    def group_check(self) -> None:
        for p in self.configs:
            self.primary(p).broadcast_group_check()
        self.loop.run_until_idle()

    def write(self, p: int, ops, acks: list) -> None:
        """One client write through partition p's primary, run until the
        loop is idle; its responses land in `acks`."""
        prim = self.primary(p)
        with self.windows[prim.name]:
            prim.client_write(ops, acks.append)
        self.loop.run_until_idle()

    def close(self) -> None:
        for r in self.replicas.values():
            r.close()


def launch_counter():
    """Zero the scan and compaction kernels' launch counts; `take(stage)`
    records the counts since the last take under `stage` in `launches`
    and zeroes them again."""
    from pegasus_tpu_torch.ops import fused_compaction, fused_scan

    fused_scan.LAUNCHES.update(dict.fromkeys(fused_scan.LAUNCHES, 0))
    fused_compaction.LAUNCHES["compaction"] = 0
    launches: dict = {}

    def take(stage: str) -> dict:
        launches[stage] = {"static": fused_scan.LAUNCHES["static"],
                           "now": fused_scan.LAUNCHES["now"],
                           "multi": fused_scan.LAUNCHES["multi"],
                           "compaction": fused_compaction.LAUNCHES[
                               "compaction"]}
        fused_scan.LAUNCHES.update(dict.fromkeys(fused_scan.LAUNCHES, 0))
        fused_compaction.LAUNCHES["compaction"] = 0
        return launches[stage]

    return launches, take


def repl_request(start: bytes, limit: int, f):
    from pegasus_tpu_torch.server.types import GetScannerRequest

    return GetScannerRequest(
        start_key=start, batch_size=limit, validate_partition_hash=True,
        one_page=True, hash_key_filter_type=f[0],
        hash_key_filter_pattern=f[1], sort_key_filter_type=f[2],
        sort_key_filter_pattern=f[3])


def run_replicated(device, n_hashkeys: int = REPL_HASHKEYS,
                   n_ops: int = REPL_OPS, n_probe: int = REPL_PROBE,
                   seed: int = 17, card: str = "") -> dict:
    """Phase 11: partitions 0..7 of BASELINE config #2 (bench.py:190's
    layout), each a PacificA group of three replicas whose
    PartitionServers are on `device`, loaded through the primaries'
    client_write in mutations of 1000 puts under group-commit windows,
    compacted, serving YCSB-E on the primaries (every page against a
    host oracle); then a failover to a secondary of every group with a
    higher ballot, the same scans on the new primaries (byte-equal
    pages), and one replica restarted from its plog with a stale engine
    WAL, which must reach the group's committed decree and answer the
    same pages. Returns the kernel launches by stage and the numbers."""
    import torch

    from pegasus_tpu_torch.base.crc import crc64_batch
    from pegasus_tpu_torch.base.key_schema import generate_key
    from pegasus_tpu_torch.base.value_schema import epoch_now
    from pegasus_tpu_torch.replica import PartitionStatus, ReplicaConfig
    from pegasus_tpu_torch.replica import WriteOp
    from pegasus_tpu_torch.rpc.codec import OP_PUT
    from pegasus_tpu_torch.rpc.message import encode_message
    from pegasus_tpu_torch.server.partition_server import LOOKAHEAD
    from pegasus_tpu_torch.utils.flags import FLAGS

    on_card = device.type == "cuda"
    parts = range(REPL_PARTITIONS)
    rng = np.random.default_rng(seed)
    filters = repl_filters()
    if n_hashkeys != REPL_HASHKEYS:
        log(f"replicated: CUT to {n_hashkeys} hashkeys of the table's "
            f"{REPL_HASHKEYS} (partitions 0..{REPL_PARTITIONS - 1} of "
            f"{PARTITION_COUNT} kept)")
    # bench.py:190's layout over the whole table; the groups hold their
    # partitions' share, about 15,625 records each
    rows = _user_keys(0, 2 * n_hashkeys)
    route = (crc64_batch(rows, np.full(len(rows), 12, np.int64))
             % np.uint64(PARTITION_COUNT)).astype(np.int64)
    expiring = rng.random((n_hashkeys, len(SORT_KEYS))) < REPL_EXPIRED
    now = epoch_now()
    budget = FLAGS.get("pegasus.server", "rocksdb_max_iteration_count")
    oracles = {p: Oracle(budget, LOOKAHEAD) for p in parts}
    hashkeys = {p: [] for p in parts}
    pools = {p: [] for p in parts}   # fresh hashkeys for the inserts
    ops = {p: [] for p in parts}
    for h in np.flatnonzero(route < REPL_PARTITIONS):
        p, hk = int(route[h]), rows[h].tobytes()
        if h >= n_hashkeys:
            pools[p].append(hk)
            continue
        hashkeys[p].append(hk)
        for s, sk in enumerate(SORT_KEYS):
            key, value = generate_key(hk, sk), b"field0=%064d" % (h * 10 + s)
            dead = bool(expiring[h, s])
            ops[p].append(WriteOp(OP_PUT, (key, value,
                                           max(1, now - 100) if dead else 0)))
            if not dead:
                oracles[p].put(key, value)
    n_records = sum(len(v) for v in ops.values())
    launches, take = launch_counter()
    data_dir = tempfile.mkdtemp(prefix="pegasus_torch_replicated_")
    groups = None
    try:
        groups = ReplicaGroups(device, data_dir, parts)

        # load: mutations of 1000 puts, two staged a window (the
        # pipelining depth), every group's round run to its acks
        acks: list = []
        chunks = {p: [ops[p][i:i + REPL_MUTATION_OPS]
                      for i in range(0, len(ops[p]), REPL_MUTATION_OPS)]
                  for p in parts}
        t0 = time.perf_counter()
        while any(chunks.values()):
            for p in parts:
                prim = groups.primary(p)
                with groups.windows[prim.name]:
                    for _ in range(prim.PIPELINE_DEPTH):
                        if chunks[p]:
                            prim.client_write(chunks[p].pop(0), acks.append)
            groups.loop.run_until_idle()
        load_s = time.perf_counter() - t0
        acked = sum(len(a) for a in acks)
        if acked != n_records or any(x != 0 for a in acks for x in a):
            fail(f"replicated: {acked} of {n_records} puts acknowledged OK")
        groups.group_check()
        mutations = {p: -(-len(ops[p]) // REPL_MUTATION_OPS) for p in parts}
        for p in parts:
            for r in groups.members(p):
                if r.last_committed_decree != mutations[p]:
                    fail(f"replicated: {r.name} committed decree "
                         f"{r.last_committed_decree}, the group "
                         f"{mutations[p]}")
        window_medians = [
            groups.windows[groups.primary(p).name]._group_commit_size
            .quantiles((50.0,))[0] for p in parts]
        log(f"replicated on {card}: loaded {n_records} records "
            f"({sum(map(len, hashkeys.values()))} hashkeys x 10, "
            f"{int(sum(len(ops[p]) for p in parts) - sum(len(o.keys) for o in oracles.values()))} "
            f"expired) into {REPL_PARTITIONS} groups of {REPL_REPLICAS} "
            f"replicas in {load_s} s: {acked / load_s} writes acknowledged "
            f"per second through the three-replica path, "
            f"{sum(mutations.values())} mutations of up to "
            f"{REPL_MUTATION_OPS} puts; group-commit window (median "
            f"mutations staged a window, each primary): {window_medians}, "
            f"median {float(np.median(window_medians))}")
        take("load")

        # a manual compaction of every replica: the expired records go
        t0 = time.perf_counter()
        for p in parts:
            for r in groups.members(p):
                r.server.manual_compact()
                oracles[p].compacted(r.server.engine.lsm.l1_runs)
        compact_s = time.perf_counter() - t0
        take("compaction")
        log(f"replicated: manual_compact of {len(groups.replicas)} "
            f"replicas in {compact_s} s -> "
            f"{sum(len(o.keys) for o in oracles.values())} records a "
            f"replica set, every replica's L1 blocks as the oracle's; "
            f"compaction kernel launches "
            f"{launches['load']['compaction'] + launches['compaction']['compaction']}")
        if on_card and launches["compaction"]["compaction"] == 0:
            fail("replicated: the compactions launched no compaction kernel")

        # YCSB-E on every primary: 95% scans, 5% inserts
        ranks = zipf_ranks(rng, min(map(len, hashkeys.values())), n_ops)
        orders = {p: rng.permutation(len(hashkeys[p])) for p in parts}
        part_of = rng.integers(0, REPL_PARTITIONS, n_ops)
        lens = rng.integers(1, 101, n_ops)
        fsel = rng.integers(0, len(filters), n_ops)
        inserts = rng.random(n_ops) < 0.05
        scan_s, insert_s, full, n_ins = [], 0.0, 0, 0
        insert_acks: list = []
        trace = device_trace() if on_card else contextlib.nullcontext()
        t_traffic = time.perf_counter()
        with trace as prof:
            for op in range(n_ops):
                p = int(part_of[op])
                if inserts[op]:
                    key = generate_key(pools[p].pop(0), b"s00")
                    t = time.perf_counter()
                    groups.write(p, [WriteOp(OP_PUT, (key, b"inserted", 0))],
                                 insert_acks)
                    insert_s += time.perf_counter() - t
                    oracles[p].put(key, b"inserted")
                    n_ins += 1
                    continue
                start = generate_key(
                    hashkeys[p][orders[p][ranks[op]]], b"")
                limit, f = int(lens[op]), filters[fsel[op]]
                t = time.perf_counter()
                resp = groups.primary(p).server.on_get_scanner(
                    repl_request(start, limit, f))
                scan_s.append(time.perf_counter() - t)
                full += check_page(resp, oracles[p], start, limit, f)
            if on_card:
                torch.cuda.synchronize()
        traffic_s = time.perf_counter() - t_traffic
        if insert_acks != [[0]] * n_ins:
            fail(f"replicated: inserts acknowledged {insert_acks[:5]}...")
        groups.group_check()
        line = (f"replicated on {card}: YCSB-E on the primaries: "
                f"{len(scan_s)} scans, {n_ins} inserts through the "
                f"three-replica path, {full} full pages, every page equal "
                f"to the oracle's; {len(scan_s) / (sum(scan_s) + insert_s)} "
                f"ops/s, {len(scan_s) / sum(scan_s)} scans/s over "
                f"{sum(scan_s)} s of server time, {percentiles(scan_s)}")
        if on_card:
            busy_s, n_spans = device_busy_s(prof)
            if not n_spans:
                fail("replicated: the CUDA trace of the traffic holds no "
                     "device work")
            line += (f"; device busy {busy_s} s in {n_spans} kernels, "
                     f"copies and memsets (torch.profiler CUDA trace), "
                     f"{100 * busy_s / traffic_s}% of the traffic's "
                     f"{traffic_s} s wall (oracle checks included)")
        log(line)
        take("traffic")

        # the probe: the same scans on the old primaries, then the new
        probe_rng = np.random.default_rng(seed + 1)
        probe = [(int(probe_rng.integers(0, REPL_PARTITIONS)),
                  int(probe_rng.integers(1, 101)),
                  filters[int(probe_rng.integers(0, len(filters)))])
                 for _ in range(n_probe)]
        probe_ranks = zipf_ranks(probe_rng, min(map(len, hashkeys.values())),
                                 n_probe)
        probe = [(p, generate_key(hashkeys[p][orders[p][int(rk)]], b""),
                  limit, f) for (p, limit, f), rk in zip(probe, probe_ranks)]

        def probe_pages(server_of, only=None) -> list:
            out = []
            for p, start, limit, f in probe:
                if only is not None and p != only:
                    continue
                resp = server_of(p).on_get_scanner(
                    repl_request(start, limit, f))
                check_page(resp, oracles[p], start, limit, f)
                out.append(encode_message("", "", "scan", resp))
            return out

        t0 = time.perf_counter()
        old_pages = probe_pages(lambda p: groups.primary(p).server)
        take("old_primaries")
        old_names = {p: groups.configs[p].primary for p in parts}
        for p in parts:
            c = groups.configs[p]
            groups.net.partition(c.primary)
            groups.configs[p] = ReplicaConfig(c.ballot + 1,
                                              c.secondaries[0],
                                              c.secondaries[1:])
            for r in [groups.replicas[c.primary]] + groups.members(p):
                r.assign_config(groups.configs[p])
        groups.loop.run_until_idle()
        for p in parts:
            prim = groups.primary(p)
            if (prim.status != PartitionStatus.PRIMARY or prim.ballot != 2
                    or not prim.ready_to_serve()):
                fail(f"replicated: {prim.name} not a serving primary "
                     f"at ballot 2 after the failover")
        new_pages = probe_pages(lambda p: groups.primary(p).server)
        take("new_primaries")
        if new_pages != old_pages:
            bad = sum(a != b for a, b in zip(old_pages, new_pages))
            fail(f"replicated: {bad} of {len(old_pages)} pages of the new "
                 f"primaries differ from the old primaries'")
        failover_s = time.perf_counter() - t0
        log(f"replicated: failover {old_names} -> "
            f"{ {p: groups.configs[p].primary for p in parts} } at ballot "
            f"2; {len(new_pages)} scans on the old and the new primaries, "
            f"every page byte-equal (wire frames) and equal to the "
            f"oracle's, in {failover_s} s")

        # restart: group 0's secondary misses its last engine-WAL frames
        p0 = 0
        sec = groups.members(p0)[1]
        extra_acks: list = []
        for i in range(REPL_RESTART_WRITES):
            key = generate_key(pools[p0].pop(0), b"s01")
            groups.write(p0, [WriteOp(OP_PUT, (key, b"late%d" % i, 0))],
                         extra_acks)
            oracles[p0].put(key, b"late%d" % i)
        groups.group_check()
        committed = groups.primary(p0).last_committed_decree
        if (extra_acks != [[0]] * REPL_RESTART_WRITES
                or sec.last_committed_decree != committed):
            fail(f"replicated: the late writes reached {sec.name} at "
                 f"decree {sec.last_committed_decree} of {committed}")
        crash_dir = os.path.join(data_dir, f"{sec.name}-crash")
        shutil.copytree(sec.data_dir, crash_dir)   # what a crash leaves
        sec.close()
        t0 = time.perf_counter()
        restarted = groups.open(sec.name, p0, crash_dir)
        stale = restarted.server.engine.last_committed_decree
        if stale >= committed:
            fail(f"replicated: the restarted engine holds decree {stale}: "
                 f"its WAL on disk is not stale (group at {committed})")
        restarted.assign_config(groups.configs[p0])
        groups.group_check()
        if restarted.last_committed_decree != committed:
            fail(f"replicated: the restarted {restarted.name} reached "
                 f"decree {restarted.last_committed_decree} of {committed}")
        restart_s = time.perf_counter() - t0
        want = probe_pages(lambda p: groups.primary(p).server, only=p0)
        take("restart_primary")
        got = probe_pages(lambda p: restarted.server, only=p0)
        take("restarted")
        if got != want:
            fail(f"replicated: {sum(a != b for a, b in zip(got, want))} of "
                 f"{len(want)} pages of the restarted replica differ from "
                 f"its primary's")
        log(f"replicated: {restarted.name} restarted from its plog with "
            f"its engine at decree {stale} of the group's {committed}, "
            f"caught up in {restart_s} s; {len(got)} scans byte-equal to "
            f"the primary's and the oracle's")
        log(f"replicated: scan kernel launches by stage {launches}")
        if on_card:
            for stage in ("old_primaries", "new_primaries", "restarted"):
                st = launches[stage]
                if st["static"] + st["now"] == 0:
                    fail(f"replicated: the {stage} scans launched no scan "
                         f"kernel")
            if launches["traffic"]["static"] + launches["traffic"]["now"] \
                    == 0:
                fail("replicated: the YCSB-E traffic launched no scan "
                     "kernel")
        scan = {k: sum(st[k] for st in launches.values())
                for k in ("static", "now", "multi")}
        return {"launches": launches, "scan": scan,
                "compaction": sum(st["compaction"]
                                  for st in launches.values()),
                "writes_per_s": acked / load_s,
                "window_median": float(np.median(window_medians)),
                "scans_per_s": len(scan_s) / sum(scan_s)}
    finally:
        if groups is not None:
            groups.close()
        shutil.rmtree(data_dir, ignore_errors=True)


# ---- phase 12: BASELINE config #2 through the meta and the replica stub --

CLUSTER_HASHKEYS = 100_000     # BASELINE config #2: x 10 sortkeys
CLUSTER_OPS = 20_000           # YCSB-E operations (bench.py run_scans)
CLUSTER_EXPIRED = 0.10         # bench.py:211: 10% of the records expired
CLUSTER_MUTATION_OPS = 1000    # bench.py:219-222: puts a mutation
CLUSTER_APP = "bench"          # bench.py:167-169
# the whole run's cut of phase 12 (a) (printed; --cluster-only runs it
# uncut)
CLUSTER_RUN_HASHKEYS = 50_000
CLUSTER_RUN_OPS = 10_000
CURE_NODES = 4
CURE_PARTITIONS = 8
CURE_REPLICAS = 3
CURE_HASHKEYS = 8_000          # 80,000 records
CURE_PROBE = 200               # seeded scans before and after the cure
CURE_ROUNDS = 40               # beacon rounds the cure may take


class StubCluster:
    """One port MetaService and `n_nodes` port ReplicaStubs (their
    replicas on `device`) over one SimLoop / SimNetwork, with a "client"
    endpoint whose replies are kept by rid: tests/test_meta.py's harness,
    the parts bench.py's BenchCluster runs (bench.py:157-183). Every
    client call is followed by a beacon round once 3 s of simulated time
    have passed, so the stubs' leases stay valid."""

    def __init__(self, device, data_dir: str, n_nodes: int,
                 seed: int = 0) -> None:
        from pegasus_tpu_torch.meta import MetaService
        from pegasus_tpu_torch.runtime import SimLoop, SimNetwork

        self.device = device
        self.data_dir = data_dir
        self.loop = SimLoop(seed=seed)
        self.net = SimNetwork(self.loop)
        self.base = time.time()
        self.meta = MetaService("meta", os.path.join(data_dir, "meta"),
                                self.net, lambda: self.loop.now)
        self.stubs: dict = {}
        for i in range(n_nodes):
            self.start(f"node{i}")
        self.replies: dict = {}
        self._rid = 0
        self.net.register("client", lambda _src, _mt, p:
                          self.replies.__setitem__(p["rid"], p))
        self._beacon_at = self.loop.now
        self.beacons(2)

    def clock(self) -> float:
        return self.base + self.loop.now

    def start(self, name: str):
        from pegasus_tpu_torch.replica.stub import ReplicaStub

        stub = ReplicaStub(name, os.path.join(self.data_dir, name), self.net,
                           clock=self.clock, device=self.device)
        stub.meta_addr = "meta"
        self.stubs[name] = stub
        return stub

    def beacons(self, rounds: int = 1, skip=None) -> None:
        for _ in range(rounds):
            for name, stub in self.stubs.items():
                if name != skip:
                    stub.send_beacon()
            self.loop.run_for(3.0)
            self.meta.tick()
        self.loop.run_until_idle()
        self._beacon_at = self.loop.now

    def keep_alive(self, skip=None) -> None:
        if self.loop.now - self._beacon_at >= 3.0:
            self.beacons(1, skip)

    def send(self, node: str, msg_type: str, payload: dict) -> int:
        self._rid += 1
        self.net.send("client", node, msg_type, dict(payload, rid=self._rid))
        return self._rid

    def call(self, node: str, msg_type: str, payload: dict, skip=None):
        rid = self.send(node, msg_type, payload)
        self.loop.run_until_idle()
        reply = self.replies.pop(rid)
        self.keep_alive(skip)
        return reply

    def primary(self, app_id: int, pidx: int) -> str:
        return self.meta.state.get_partition(app_id, pidx).primary

    def replica(self, node: str, app_id: int, pidx: int):
        return self.stubs[node].get_replica((app_id, pidx))

    def close(self) -> None:
        for stub in self.stubs.values():
            stub.close()


def cluster_layout(n_hashkeys: int, partitions: int, rng):
    """bench.py:199-222's layout over `partitions`: b"user%08d" hashkeys
    x s00..s09, values field0=%064d, 10% of the records already expired
    at now - 100; routed by crc64(hashkey) % partitions. Returns the puts
    a partition ({p: [(OP_PUT, (key, value, expire_ts))]}) and a
    BatchedOracle a partition holding the live records."""
    from pegasus_tpu_torch.base.crc import crc64_batch
    from pegasus_tpu_torch.base.key_schema import generate_key
    from pegasus_tpu_torch.base.value_schema import epoch_now
    from pegasus_tpu_torch.rpc.codec import OP_PUT

    rows = _user_keys(0, n_hashkeys)
    route = (crc64_batch(rows, np.full(len(rows), 12, np.int64))
             % np.uint64(partitions)).astype(np.int64)
    expiring = rng.random((n_hashkeys, len(SORT_KEYS))) < CLUSTER_EXPIRED
    dead_ts = max(1, epoch_now() - 100)
    ops = {p: [] for p in range(partitions)}
    oracles = {p: BatchedOracle() for p in range(partitions)}
    for h in range(n_hashkeys):
        p, hk = int(route[h]), rows[h].tobytes()
        for s, sk in enumerate(SORT_KEYS):
            key, value = generate_key(hk, sk), b"field0=%064d" % (h * 10 + s)
            if expiring[h, s]:
                ops[p].append((OP_PUT, (key, value, dead_ts)))
            else:
                ops[p].append((OP_PUT, (key, value, 0)))
                oracles[p].values[key] = value
    return ops, oracles


def cluster_load(c, app_id: int, ops: dict) -> tuple:
    """Every partition's puts through its primary as client_write
    messages of CLUSTER_MUTATION_OPS puts (one mutation each), two in
    flight a partition; (acknowledged puts, seconds)."""
    chunks = {p: [lst[i:i + CLUSTER_MUTATION_OPS]
                  for i in range(0, len(lst), CLUSTER_MUTATION_OPS)]
              for p, lst in ops.items()}
    acked = 0
    t0 = time.perf_counter()
    while any(chunks.values()):
        sent = []
        for p, todo in chunks.items():
            for _ in range(2):
                if todo:
                    batch = todo.pop(0)
                    sent.append((c.send(c.primary(app_id, p), "client_write",
                                        {"gpid": (app_id, p), "ops": batch}),
                                 len(batch)))
        c.loop.run_until_idle()
        for rid, n in sent:
            reply = c.replies.pop(rid)
            if reply["err"] != 0 or reply["results"] != [0] * n:
                fail(f"cluster load: client_write answered err "
                     f"{reply['err']}, results {reply['results'][:4]}...")
            acked += n
        c.keep_alive()
    return acked, time.perf_counter() - t0


NO_FILTER = (0, b"", 0, b"")


def check_cluster_page(resp, oracle, start: bytes, limit: int,
                       now: int) -> int:
    from pegasus_tpu_torch.server.types import SCAN_CONTEXT_ID_COMPLETED

    if resp.error != 0 or resp.context_id != SCAN_CONTEXT_ID_COMPLETED:
        fail(f"cluster scan: error {resp.error}, context "
             f"{resp.context_id}")
    got = [(kv.key, kv.value) for kv in resp.kvs]
    want = oracle.page(start, limit, NO_FILTER, now)
    if got != want:
        fail(f"cluster scan from {start!r} limit {limit}: got {len(got)} "
             f"records {got[:2]}..., want {len(want)} {want[:2]}...")
    return len(got)


def scan_multi_call(c, app_id: int, items: list, skip=None) -> list:
    """[(pidx, start, limit)] as one client_scan_multi message to each
    node leading some of the partitions; the ScanResponses in the order
    of `items`."""
    by_node: dict = {}
    for i, (p, start, limit) in enumerate(items):
        node = c.primary(app_id, p)
        by_node.setdefault(node, {}).setdefault(p, []).append(
            (i, repl_request(start, limit, NO_FILTER)))
    out = [None] * len(items)
    for node, groups in by_node.items():
        reply = c.call(node, "client_scan_multi", {"groups": [
            ((app_id, p), [r for _i, r in lst]) for p, lst in
            groups.items()]}, skip)
        if reply["err"] != 0:
            fail(f"cluster: client_scan_multi to {node} answered "
                 f"{reply['err']}")
        for (p, resps), (p2, lst) in zip(reply["result"], groups.items()):
            if p != p2 or len(resps) != len(lst):
                fail(f"cluster: client_scan_multi slots {p}/{p2}")
            for (i, _r), resp in zip(lst, resps):
                out[i] = resp
    return out


class SimFront:
    """A "loader" endpoint on a port SimCluster's network with the
    surface StubCluster gives cluster_load (send, primary, replica,
    replies, keep_alive), plus the meta's admin verbs. keep_alive runs
    the cluster's timer round (beacons, group checks, config sync, the
    duplication timer) once a beacon interval of simulated time has
    passed."""

    def __init__(self, cluster, name: str = "loader") -> None:
        self.cluster = cluster
        self.loop = cluster.loop
        self.net = cluster.net
        self.name = name
        self.replies: dict = {}
        self._rid = 0
        self.net.register(name, lambda _src, _mt, p:
                          self.replies.__setitem__(p["rid"], p))

    def send(self, node: str, msg_type: str, payload: dict) -> int:
        self._rid += 1
        self.net.send(self.name, node, msg_type, dict(payload, rid=self._rid))
        return self._rid

    def primary(self, app_id: int, pidx: int) -> str:
        return self.cluster.meta.state.get_partition(app_id, pidx).primary

    def replica(self, node: str, app_id: int, pidx: int):
        return self.cluster.stubs[node].get_replica((app_id, pidx))

    def keep_alive(self, skip=None) -> None:
        c = self.cluster
        if self.loop.now - c._last_step_time >= c.beacon_interval:
            c.step()

    def admin(self, cmd: str, args: dict):
        meta = self.cluster.meta
        rid = self.send(meta.name, "admin", {"cmd": cmd, "args": args})
        self.loop.run_until_idle()
        reply = self.replies.pop(rid)
        if reply["err"] != 0:
            fail(f"admin {cmd} answered {reply['err']}: {reply['result']}")
        return reply["result"]


def client_scan_batch(client, items: list) -> list:
    """[(pidx, start, limit)] as one ClusterClient.scan_multi call (the
    client groups the partitions by node, one client_scan_multi message
    a node); the ScanResponses in the order of `items`."""
    groups: dict = {}
    for p, start, limit in items:
        groups.setdefault(p, []).append(repl_request(start, limit,
                                                     NO_FILTER))
    result = client.scan_multi(groups)
    taken = {p: 0 for p in groups}
    out = []
    for p, _start, _limit in items:
        resps = result.get(p)
        if resps is None or len(resps) != len(groups[p]):
            fail(f"scan_multi: partition {p} answered "
                 f"{None if resps is None else len(resps)} of "
                 f"{len(groups[p])} scans")
        out.append(resps[taken[p]])
        taken[p] += 1
    return out


def run_cluster(device, n_hashkeys: int = CLUSTER_HASHKEYS,
                n_ops: int = CLUSTER_OPS, seed: int = 23,
                card: str = "") -> dict:
    """Phase 12 (a): BASELINE config #2 as bench.py measures it
    (BenchCluster, build_cluster, run_scans): a port SimCluster of one
    node (one MetaService, one ReplicaStub whose replicas are on
    `device`), create_table("bench", 64 partitions, one replica); the
    records go through each primary as client_write messages of 1000
    puts; every partition compacted by hand; then YCSB-E through
    SimCluster.client("bench"), a ClusterClient: 95% scans coalesced in
    batches of 32, each batch one ClusterClient.scan_multi call (one
    client_scan_multi message to the node), and 5% inserts, each a
    ClusterClient.set; every page against a BatchedOracle. Returns the
    numbers and the launches by stage."""
    import torch

    from pegasus_tpu_torch.base.key_schema import (
        generate_key,
        key_hash_parts,
    )
    from pegasus_tpu_torch.base.value_schema import epoch_now
    from pegasus_tpu_torch.tools.cluster import SimCluster

    on_card = device.type == "cuda"
    rng = np.random.default_rng(seed)
    if n_hashkeys != CLUSTER_HASHKEYS:
        log(f"cluster: CUT to {n_hashkeys * 10} records of config #2's "
            f"{CLUSTER_HASHKEYS * 10}")
    t0 = time.perf_counter()
    ops, oracles = cluster_layout(n_hashkeys, PARTITION_COUNT, rng)
    layout_s = time.perf_counter() - t0
    launches, take = launch_counter()
    data_dir = tempfile.mkdtemp(prefix="pegasus_torch_cluster_")
    sim = None
    try:
        sim = SimCluster(data_dir, n_nodes=1, seed=seed, device=device)
        app_id = sim.create_table(CLUSTER_APP,
                                  partition_count=PARTITION_COUNT,
                                  replica_count=1)
        client = sim.client(CLUSTER_APP)
        client.refresh_config()
        c = SimFront(sim)
        node = c.primary(app_id, 0)
        log(f"cluster: front end SimCluster(n_nodes=1).client("
            f"{CLUSTER_APP!r}): ClusterClient.scan_multi for the scans, "
            f"ClusterClient.set for the inserts")
        acked, load_s = cluster_load(c, app_id, ops)
        n_records = sum(map(len, ops.values()))
        if acked != n_records:
            fail(f"cluster: {acked} of {n_records} puts acknowledged")
        servers = [c.replica(node, app_id, p).server
                   for p in range(PARTITION_COUNT)]
        log(f"cluster on {card}: {n_records} records ({n_hashkeys} "
            f"hashkeys x 10, "
            f"{n_records - sum(len(o.values) for o in oracles.values())} "
            f"expired) loaded through the stub into {PARTITION_COUNT} "
            f"partitions in {load_s} s: {acked / load_s} writes/s "
            f"(client_write messages of {CLUSTER_MUTATION_OPS} puts; the "
            f"layout took {layout_s} s)")
        take("load")
        t0 = time.perf_counter()
        for p, srv in enumerate(servers):
            srv.manual_compact()
            oracles[p].compacted(srv.engine.lsm.l1_runs)
        compact_s = time.perf_counter() - t0
        st = take("compaction")
        log(f"cluster: manual_compact of {PARTITION_COUNT} partitions in "
            f"{compact_s} s -> "
            f"{sum(len(o.keys) for o in oracles.values())} records, every "
            f"partition's L1 blocks as the oracle's; compaction kernel "
            f"launches {st['compaction']}")
        if on_card and st["compaction"] == 0:
            fail("cluster: the compactions launched no compaction kernel")

        # bench.py run_scans: zipfian partition popularity and start keys
        ranks = rng.permutation(PARTITION_COUNT)
        weights = 1.0 / (1.0 + ranks.astype(float))
        weights /= weights.sum()
        zipf_u = rng.random(n_ops) ** 2.0
        pidx_of = rng.choice(PARTITION_COUNT, size=n_ops, p=weights)
        insert_draw = rng.random(n_ops)
        lens = rng.integers(1, 101, size=n_ops)
        insert_hks = rng.integers(0, 1 << 30, size=n_ops)
        pending: list = []
        batch_s: list = []
        stats = {"scans": 0, "batches": 0, "inserts": 0, "records": 0,
                 "insert_s": 0.0}

        def flush() -> None:
            if not pending:
                return
            now = epoch_now()
            t = time.perf_counter()
            resps = client_scan_batch(client, pending)
            batch_s.append(time.perf_counter() - t)
            for (p, start, limit), resp in zip(pending, resps):
                stats["records"] += check_cluster_page(
                    resp, oracles[p], start, limit, now)
            stats["scans"] += len(pending)
            stats["batches"] += 1
            pending.clear()

        gc.collect()
        gc.freeze()
        trace = device_trace() if on_card else contextlib.nullcontext()
        t_traffic = time.perf_counter()
        with trace as prof:
            for op in range(n_ops):
                if insert_draw[op] < 0.05:
                    flush()
                    hk = b"user%08d" % int(insert_hks[op])
                    p = key_hash_parts(hk) % PARTITION_COUNT
                    key = generate_key(hk, b"s00")
                    t = time.perf_counter()
                    err = client.set(hk, b"s00", b"inserted")
                    stats["insert_s"] += time.perf_counter() - t
                    if err != 0:
                        fail(f"cluster insert answered {err}")
                    oracles[p].insert(key, b"inserted")
                    stats["inserts"] += 1
                    continue
                start = generate_key(
                    b"user%08d" % int(zipf_u[op] * n_hashkeys), b"")
                pending.append((int(pidx_of[op]), start, int(lens[op])))
                if len(pending) >= SCAN_FLUSH:
                    flush()
            flush()
            if on_card:
                torch.cuda.synchronize()
        traffic_s = time.perf_counter() - t_traffic
        gc.unfreeze()
        st = take("traffic")
        scans_per_s = stats["scans"] / sum(batch_s)
        line = (f"cluster on {card}: YCSB-E through ClusterClient and "
                f"the stub: {stats['scans']} scans in {stats['batches']} "
                f"scan_multi calls (client_scan_multi messages), "
                f"{stats['inserts']} inserts (ClusterClient.set), "
                f"{stats['records']} records, "
                f"every page equal to the oracle's; {scans_per_s} scans/s "
                f"over {sum(batch_s)} s of batch wall, per batch "
                f"{percentiles(batch_s)}; inserts {stats['insert_s']} s; "
                f"launches {st}")
        busy = None
        if on_card:
            busy_s, n_spans = device_busy_s(prof)
            if not n_spans:
                fail("cluster: the CUDA trace of the traffic holds no "
                     "device work")
            busy = busy_s / traffic_s
            line += (f"; device busy {busy_s} s in {n_spans} kernels, "
                     f"copies and memsets (torch.profiler CUDA trace), "
                     f"{100 * busy}% of the traffic's {traffic_s} s wall "
                     f"(oracle checks included)")
        log(line)
        if on_card and st["static"] == 0:
            fail("cluster: the scans through the stub launched no static "
                 "scan kernel")
        a = np.asarray(batch_s) * 1e3
        return {"launches": launches,
                "scan": {k: sum(s[k] for s in launches.values())
                         for k in ("static", "now", "multi")},
                "compaction": sum(s["compaction"]
                                  for s in launches.values()),
                "writes_per_s": acked / load_s, "load_s": load_s,
                "compact_s": compact_s, "scans_per_s": scans_per_s,
                "batch_p50_ms": float(np.percentile(a, 50)),
                "batch_p99_ms": float(np.percentile(a, 99)),
                "busy_share": busy}
    finally:
        if sim is not None:
            sim.close()
        shutil.rmtree(data_dir, ignore_errors=True)


def run_cure(device, n_hashkeys: int = CURE_HASHKEYS,
             n_probe: int = CURE_PROBE, seed: int = 29,
             card: str = "") -> dict:
    """Phase 12 (b): the meta's cure. Four stubs on `device`, a table of
    8 partitions x 3 replicas loaded in config #2's layout through
    client_write messages and compacted everywhere; a seeded probe of
    scans through client_scan_multi on the primaries; the node leading
    the most partitions is silenced, the failure detector declares it
    dead and the guardian promotes secondaries and adds learners until
    every partition has three replicas again; the same probe on the new
    primaries must give byte-equal pages (wire frames); the silenced
    node's stub, restarted from its directories, recovers its partition
    count. Returns the numbers and the launches by stage."""
    from pegasus_tpu_torch.base.key_schema import generate_key
    from pegasus_tpu_torch.base.value_schema import epoch_now
    from pegasus_tpu_torch.replica.replica import PartitionStatus
    from pegasus_tpu_torch.rpc.message import encode_message

    on_card = device.type == "cuda"
    rng = np.random.default_rng(seed)
    ops, oracles = cluster_layout(n_hashkeys, CURE_PARTITIONS, rng)
    launches, take = launch_counter()
    data_dir = tempfile.mkdtemp(prefix="pegasus_torch_cure_")
    c = None
    try:
        c = StubCluster(device, data_dir, CURE_NODES, seed=seed)
        app_id = c.meta.create_app("t", CURE_PARTITIONS, CURE_REPLICAS)
        c.loop.run_until_idle()
        acked, load_s = cluster_load(c, app_id, ops)
        for p in range(CURE_PARTITIONS):
            c.replica(c.primary(app_id, p), app_id, p) \
                .broadcast_group_check()
        c.loop.run_until_idle()
        for p in range(CURE_PARTITIONS):
            pc = c.meta.state.get_partition(app_id, p)
            members = [c.replica(n, app_id, p) for n in pc.members()]
            for r in members:
                r.server.manual_compact()
            oracles[p].compacted(members[0].server.engine.lsm.l1_runs)
            for r in members[1:]:
                if (sum(bm.count for run in r.server.engine.lsm.l1_runs
                        for bm in run.blocks) != len(oracles[p].keys)):
                    fail(f"cure: {r.name} holds other records than its "
                         f"primary after the compaction")
        take("load")
        log(f"cure: {acked} records through client_write messages into "
            f"{CURE_PARTITIONS} partitions x {CURE_REPLICAS} replicas on "
            f"{CURE_NODES} stubs in {load_s} s, every replica compacted")

        probe_ranks = zipf_ranks(rng, n_hashkeys, n_probe)
        probe = [(int(rng.integers(0, CURE_PARTITIONS)),
                  generate_key(b"user%08d" % int(rk), b""),
                  int(rng.integers(1, 101))) for rk in probe_ranks]

        def probe_pages(skip=None) -> list:
            out = []
            now = epoch_now()
            for lo in range(0, len(probe), SCAN_FLUSH):
                items = probe[lo:lo + SCAN_FLUSH]
                for (p, start, limit), resp in zip(
                        items, scan_multi_call(c, app_id, items, skip)):
                    check_cluster_page(resp, oracles[p], start, limit, now)
                    out.append(encode_message("", "", "scan", resp))
            return out

        before = probe_pages()
        take("probe_before")
        configs = {p: c.meta.state.get_partition(app_id, p)
                   for p in range(CURE_PARTITIONS)}
        leads: dict = {}
        for pc in configs.values():
            leads[pc.primary] = leads.get(pc.primary, 0) + 1
        dead = max(sorted(leads), key=lambda n: leads[n])
        hosted = sorted(g for g in c.stubs[dead].replicas)
        c.net.partition(dead)
        sim0, wall0 = c.loop.now, time.perf_counter()
        rounds = 0
        while True:
            c.beacons(1, skip=dead)
            rounds += 1
            now_cfg = [c.meta.state.get_partition(app_id, p)
                       for p in range(CURE_PARTITIONS)]
            if (all(dead not in pc.members()
                    and len(pc.members()) == CURE_REPLICAS
                    for pc in now_cfg) and not c.meta._pending_learns):
                break
            if rounds >= CURE_ROUNDS:
                fail(f"cure: not cured after {rounds} beacon rounds: "
                     f"{[pc.to_json() for pc in now_cfg]}")
        cure_sim_s = c.loop.now - sim0
        cure_wall_s = time.perf_counter() - wall0
        learners = sum(len(set(pc.members()) - set(configs[p].members()))
                       for p, pc in enumerate(now_cfg))
        promoted = sum(configs[p].primary == dead
                       for p in range(CURE_PARTITIONS))
        for p, pc in enumerate(now_cfg):
            r = c.replica(pc.primary, app_id, p)
            if r.status != PartitionStatus.PRIMARY or not r.ready_to_serve():
                fail(f"cure: {pc.primary} is not a serving primary of "
                     f"partition {p}")
        take("cure")
        after = probe_pages(skip=dead)
        st = take("probe_after")
        if after != before:
            bad = sum(a != b for a, b in zip(before, after))
            fail(f"cure: {bad} of {len(before)} probe pages on the new "
                 f"primaries differ from the pages before the failure")
        log(f"cure on {card}: {dead} (leading {leads[dead]} of "
            f"{CURE_PARTITIONS} partitions) silenced; the meta cured in "
            f"{cure_sim_s} s of simulated time, {cure_wall_s} s wall, "
            f"{rounds} beacon rounds: {promoted} secondaries promoted, "
            f"{learners} learners added, every partition at "
            f"{CURE_REPLICAS} replicas; {len(after)} probe pages on the "
            f"new primaries byte-equal (wire frames) to those before and "
            f"equal to the oracle's; scan kernel launches on the new "
            f"primaries {st}")
        if on_card and st["static"] + st["now"] + st["multi"] == 0:
            fail("cure: the probe on the new primaries launched no scan "
                 "kernel")
        c.stubs[dead].close()
        restarted = c.start(dead)
        back = sorted(restarted.replicas)
        counts = {g: r.server.partition_count
                  for g, r in restarted.replicas.items()}
        if back != hosted or set(counts.values()) != {CURE_PARTITIONS}:
            fail(f"cure: the restarted {dead} recovered {back} with counts "
                 f"{counts}; it hosted {hosted}")
        log(f"cure: {dead} restarted from its directories with its "
            f"{len(back)} replicas, each at partition count "
            f"{CURE_PARTITIONS}")
        take("restart")
        return {"launches": launches,
                "scan": {k: sum(s[k] for s in launches.values())
                         for k in ("static", "now", "multi")},
                "compaction": sum(s["compaction"]
                                  for s in launches.values()),
                "cure_sim_s": cure_sim_s, "cure_wall_s": cure_wall_s,
                "learners": learners, "new_primaries": st}
    finally:
        if c is not None:
            c.close()
        shutil.rmtree(data_dir, ignore_errors=True)


def run_phase12(device, card: str, cut: bool = False) -> tuple:
    """Phase 12 (a) and (b) under the store flags phase 11 pins. `cut`:
    the whole run's printed cut of (a)."""
    import torch

    n_hashkeys, n_ops = CLUSTER_HASHKEYS, CLUSTER_OPS
    if cut:
        n_hashkeys, n_ops = CLUSTER_RUN_HASHKEYS, CLUSTER_RUN_OPS
        log(f"cluster: (a) CUT to {n_ops} ops (the phase's {CLUSTER_OPS}); "
            f"--cluster-only runs the phase uncut")
    with store_flags(NONE_STORE):
        t0 = time.perf_counter()
        cluster = run_cluster(device, n_hashkeys=n_hashkeys, n_ops=n_ops,
                              card=card)
        torch.cuda.synchronize()
        log(f"cluster: (a) in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cure = run_cure(device, card=card)
        torch.cuda.synchronize()
        log(f"cluster: (b) in {time.perf_counter() - t0:.1f} s")
    return cluster, cure


BULK_PARTITIONS = 64           # BASELINE config #2's table
BULK_HASHKEYS = 100_000        # x 10 sortkeys: 1,000,000 records
BULK_NODES = 3
BULK_REPLICAS = 3              # Pegasus's default: a primary, 2 secondaries
BULK_SCANS = 2_000             # YCSB-E scans on the bulk-loaded table
BULK_APP = "bulk"
RESTORE_APP = "restored"
RESTORE_PROBE = 200            # probe scans on the backed-up and restored
DUP_APP = "dup"
DUP_PARTITIONS = 8
DUP_OPS = 20_000               # writes to the master: 90% set, 10% del
DUP_DEL_SHARE = 0.10
DUP_HASHKEYS = 4_000           # the master's key space: x 10 sortkeys
DUP_PROBE = 400                # probe scans on the master and follower
SERVICE_ROUNDS = 400           # timer rounds a service may take
# the whole run's cut of phase 13 (printed; --ops-only runs it uncut)
SERVICES_RUN_HASHKEYS = 15_000
SERVICES_RUN_DUP_OPS = 5_000


def bulk_records(n_hashkeys: int, partitions: int, rng) -> tuple:
    """bench.py:199-222's layout for SSTGenerator: b"user%08d" hashkeys
    x s00..s09, values field0=%064d, 10% of the records already expired
    at now - 100. Returns the (hash_key, sort_key, value, expire_ts)
    records and a BatchedOracle a partition (routed by
    key_schema.partition_index) holding the live ones."""
    from pegasus_tpu_torch.base.crc import crc64_batch
    from pegasus_tpu_torch.base.key_schema import generate_key
    from pegasus_tpu_torch.base.value_schema import epoch_now

    rows = _user_keys(0, n_hashkeys)
    route = (crc64_batch(rows, np.full(len(rows), 12, np.int64))
             % np.uint64(partitions)).astype(np.int64)
    expiring = rng.random((n_hashkeys, len(SORT_KEYS))) < CLUSTER_EXPIRED
    dead_ts = max(1, epoch_now() - 100)
    records = []
    oracles = {p: BatchedOracle() for p in range(partitions)}
    for h in range(n_hashkeys):
        p, hk = int(route[h]), rows[h].tobytes()
        for s, sk in enumerate(SORT_KEYS):
            value = b"field0=%064d" % (h * 10 + s)
            if expiring[h, s]:
                records.append((hk, sk, value, dead_ts))
            else:
                records.append((hk, sk, value, 0))
                oracles[p].values[generate_key(hk, sk)] = value
    return records, oracles


def uncompacted(oracles: dict) -> None:
    """Before a compaction every live record sits in the overlay: an
    ingested L0 run (or a memtable) above no L1 run, served by the merge
    path, which skips the expired records and answers each one-page scan
    with the first live records from its start key (the iteration budget
    of 1000 records is never reached by a page of at most 100)."""
    for o in oracles.values():
        o.keys, o.starts, o.overlay = [], [0], sorted(o.values)


def wait_rounds(cluster, done, what: str, rounds: int = SERVICE_ROUNDS,
                other=None) -> int:
    """Timer rounds (and `other`'s, paired) until done(); fails after
    `rounds`. Returns the rounds taken."""
    for n in range(1, rounds + 1):
        cluster.step()
        if other is not None:
            other.step(advance=False)
        if done():
            return n
    fail(f"{what}: not done after {rounds} timer rounds")


def ycsb_scans(rng, n_scans: int, partitions: int, n_hashkeys: int) -> list:
    """bench.py run_scans' scan draws: zipfian partition popularity and
    start keys, lengths uniform in 1..100; [(pidx, start, limit)]."""
    from pegasus_tpu_torch.base.key_schema import generate_key

    ranks = rng.permutation(partitions)
    weights = 1.0 / (1.0 + ranks.astype(float))
    weights /= weights.sum()
    zipf_u = rng.random(n_scans) ** 2.0
    pidx_of = rng.choice(partitions, size=n_scans, p=weights)
    lens = rng.integers(1, 101, size=n_scans)
    return [(int(pidx_of[i]),
             generate_key(b"user%08d" % int(zipf_u[i] * n_hashkeys), b""),
             int(lens[i])) for i in range(n_scans)]


def kill_batch(partitions: int) -> list:
    """ONEBOX_KILL_WRITES hashkeys of each partition, `kill%05d` from 0 up
    (sorting before every user%08d key), in order."""
    from pegasus_tpu_torch.base.key_schema import key_hash_parts

    need, out, i = [ONEBOX_KILL_WRITES] * partitions, [], 0
    while any(need):
        hk = b"kill%05d" % i
        p = key_hash_parts(hk) % partitions
        if need[p]:
            need[p] -= 1
            out.append(hk)
        i += 1
    return out


def probe_frames(client, items: list, oracles=None) -> list:
    """`items` through client_scan_batch in batches of SCAN_FLUSH; each
    page checked against `oracles` when given; the pages' wire frames."""
    from pegasus_tpu_torch.base.value_schema import epoch_now
    from pegasus_tpu_torch.rpc.message import encode_message

    out = []
    for lo in range(0, len(items), SCAN_FLUSH):
        batch = items[lo:lo + SCAN_FLUSH]
        now = epoch_now()
        for (p, start, limit), resp in zip(batch,
                                           client_scan_batch(client, batch)):
            if oracles is not None:
                check_cluster_page(resp, oracles[p], start, limit, now)
            elif resp.error != 0:
                fail(f"probe scan: error {resp.error}")
            out.append(encode_message("", "", "scan", resp))
    return out


def compact_primaries(front, app_id: int, partitions: int, oracles) -> float:
    """Every primary of the table compacted by hand; its L1 blocks must
    hold exactly its oracle's records. Returns the seconds."""
    t0 = time.perf_counter()
    for p in range(partitions):
        srv = front.replica(front.primary(app_id, p), app_id, p).server
        srv.manual_compact()
        oracles[p].compacted(srv.engine.lsm.l1_runs)
    return time.perf_counter() - t0


def count_messages(net, msg_type: str) -> dict:
    """Count the messages of `msg_type` sent on `net` from now on."""
    box = {"n": 0, "bytes": 0}
    send = net.send

    def counting(src, dst, mt, payload, *a, **kw):
        if mt == msg_type:
            box["n"] += 1
            box["bytes"] += len(payload.get("ops_blob") or b"")
        return send(src, dst, mt, payload, *a, **kw)

    net.send = counting
    return box


def run_services(device, n_hashkeys: int = BULK_HASHKEYS,
                 n_scans: int = BULK_SCANS, n_dup_ops: int = DUP_OPS,
                 seed: int = 31, card: str = "") -> dict:
    """Phase 13: the services of ROADMAP 6(b)(4) on a port SimCluster of
    three nodes on `device`. (a) bulk load: BASELINE config #2 (bench.py
    :199-222's layout, 1,000,000 records, 10% expired) staged by
    SSTGenerator in a LocalBlockService root, ingested into a table of 64
    partitions x 3 replicas by the meta's start_bulk_load verb (a rolling
    OP_INGEST through 2PC, every replica at one decree), then YCSB-E
    scans through ClusterClient.scan_multi in batches of 32, every page
    against an oracle without the expired records, then the 64 primaries
    compacted by hand (the compaction kernel must launch; survivors equal
    the oracle's). (b) backup to a BlobServer on 127.0.0.1 through
    remote://, restore_app into a new table, seeded probe scans on both
    tables with byte-equal wire frames. (c) duplication: a second
    SimCluster ("b." names, cluster id 2) on the same loop and network,
    add_dup of an 8 x 3 table, 90% set / 10% del through ClusterClient
    to the master until the follower confirmed the master's last
    committed decree on every partition, both sides' primaries compacted,
    probe scans through both clusters' ClusterClients byte-equal. The
    scan kernel's static contract must launch on the bulk-loaded, the
    restored and the follower tables. Returns the numbers and the
    launches by part."""
    import torch

    from pegasus_tpu_torch.base.key_schema import generate_key, key_hash_parts
    from pegasus_tpu_torch.base.value_schema import epoch_now
    from pegasus_tpu_torch.server.bulk_load import SSTGenerator
    from pegasus_tpu_torch.storage.blob_server import BlobServer
    from pegasus_tpu_torch.storage.block_service import LocalBlockService
    from pegasus_tpu_torch.tools.cluster import SimCluster
    from pegasus_tpu_torch.utils.metrics import METRICS

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    rng = np.random.default_rng(seed)
    if n_hashkeys != BULK_HASHKEYS:
        log(f"services: CUT to {n_hashkeys * 10} records of config #2's "
            f"{BULK_HASHKEYS * 10}")
    launches, take = launch_counter()
    data_dir = tempfile.mkdtemp(prefix="pegasus_torch_services_")
    a = b = blob = None
    out: dict = {"launches": launches}
    try:
        # ---- (a) bulk load ------------------------------------------
        t0 = time.perf_counter()
        records, oracles = bulk_records(n_hashkeys, BULK_PARTITIONS, rng)
        root = os.path.join(data_dir, "bulk_root")
        counts = SSTGenerator(LocalBlockService(root), BULK_APP,
                              BULK_PARTITIONS).generate(records)
        stage_s = time.perf_counter() - t0
        n_live = sum(len(o.values) for o in oracles.values())
        if sum(counts.values()) != len(records):
            fail(f"bulk: SSTGenerator staged {sum(counts.values())} of "
                 f"{len(records)} records")
        del records
        a = SimCluster(os.path.join(data_dir, "A"), n_nodes=BULK_NODES,
                       seed=seed, device=device)
        front = SimFront(a)
        app_id = a.create_table(BULK_APP, BULK_PARTITIONS, BULK_REPLICAS)
        a.step()
        take("create")
        t0 = time.perf_counter()
        sim0 = a.loop.now
        front.admin("start_bulk_load", {"app_name": BULK_APP,
                                        "root": root})
        rounds = wait_rounds(a, lambda: front.admin(
            "bulk_load_status", {"app_name": BULK_APP})["complete"],
            "bulk load")
        ingest_s = time.perf_counter() - t0
        status = front.admin("bulk_load_status", {"app_name": BULK_APP})
        if status.get("failed"):
            fail(f"bulk load failed: {status}")
        decrees = {}
        for p in range(BULK_PARTITIONS):
            pc = a.meta.state.get_partition(app_id, p)
            a.stubs[pc.primary].get_replica((app_id, p)) \
                .broadcast_group_check()
        a.loop.run_until_idle()
        for p in range(BULK_PARTITIONS):
            pc = a.meta.state.get_partition(app_id, p)
            seen = set()
            for node in pc.members():
                r = front.replica(node, app_id, p)
                l0 = r.server.engine.lsm.l0
                if len(l0) != 1 or l0[0].total_count != counts.get(p, 0):
                    fail(f"bulk: {node} partition {p} holds "
                         f"{[t.total_count for t in l0]} ingested records, "
                         f"staged {counts.get(p, 0)}")
                seen.add((l0[0].meta["last_flushed_decree"],
                          r.last_committed_decree))
            if len(seen) != 1 or len(pc.members()) != BULK_REPLICAS:
                fail(f"bulk: partition {p}'s replicas ingested at "
                     f"{sorted(seen)}")
            decrees[p] = seen.pop()[0]
        st = take("ingest")
        log(f"bulk on {card}: {sum(counts.values())} records ({n_hashkeys} "
            f"hashkeys x 10, {sum(counts.values()) - n_live} expired) "
            f"staged by SSTGenerator in {stage_s} s; start_bulk_load "
            f"ingested them into {BULK_PARTITIONS} partitions x "
            f"{BULK_REPLICAS} replicas in {ingest_s} s wall "
            f"({a.loop.now - sim0} s simulated, {rounds} timer rounds): "
            f"{sum(counts.values()) / ingest_s} records/s; every replica "
            f"of a partition ingested at one decree "
            f"(decrees {min(decrees.values())}..{max(decrees.values())}); "
            f"launches {st}")
        client = a.client(BULK_APP)
        client.refresh_config()
        uncompacted(oracles)
        items = ycsb_scans(rng, n_scans, BULK_PARTITIONS, n_hashkeys)
        batch_s = []
        n_records = 0
        gc.collect()
        gc.freeze()
        trace = device_trace() if on_card else contextlib.nullcontext()
        t_traffic = time.perf_counter()
        with trace as prof:
            for lo in range(0, len(items), SCAN_FLUSH):
                batch = items[lo:lo + SCAN_FLUSH]
                now = epoch_now()
                t = time.perf_counter()
                resps = client_scan_batch(client, batch)
                batch_s.append(time.perf_counter() - t)
                for (p, start, limit), resp in zip(batch, resps):
                    n_records += check_cluster_page(resp, oracles[p], start,
                                                    limit, now)
            sync()
        traffic_s = time.perf_counter() - t_traffic
        gc.unfreeze()
        st = take("bulk_scans")
        scans_per_s = len(items) / sum(batch_s)
        bl = np.asarray(batch_s) * 1e3
        line = (f"bulk on {card}: {len(items)} YCSB-E scans through "
                f"ClusterClient.scan_multi in {len(batch_s)} batches of "
                f"{SCAN_FLUSH} on the bulk-loaded table (its ingested L0 "
                f"runs, served by the merge path: the scan kernel's `now` "
                f"contract), {n_records} "
                f"records, every page equal to the oracle's (expired "
                f"records never served); {scans_per_s} scans/s over "
                f"{sum(batch_s)} s of batch wall, per batch "
                f"{percentiles(batch_s)}; launches {st}")
        busy = None
        if on_card:
            busy_s, n_spans = device_busy_s(prof)
            if not n_spans:
                fail("bulk: the CUDA trace of the scans holds no device "
                     "work")
            busy = busy_s / traffic_s
            line += (f"; device busy {busy_s} s in {n_spans} kernels, "
                     f"copies and memsets, {100 * busy}% of the scans' "
                     f"{traffic_s} s wall (oracle checks included)")
        log(line)
        if on_card and st["static"] + st["now"] == 0:
            fail("bulk: the scans of the bulk-loaded table launched no "
                 "scan kernel")
        compact_s = compact_primaries(front, app_id, BULK_PARTITIONS,
                                      oracles)
        sync()
        st = take("bulk_compaction")
        log(f"bulk: manual_compact of the {BULK_PARTITIONS} primaries in "
            f"{compact_s} s -> {sum(len(o.keys) for o in oracles.values())} "
            f"records, every primary's L1 blocks as the oracle's (the "
            f"expired dropped); compaction kernel launches "
            f"{st['compaction']}")
        if on_card and st["compaction"] == 0:
            fail("bulk: the compaction launched no compaction kernel")
        out["bulk"] = {"records": sum(counts.values()), "live": n_live,
                       "stage_s": stage_s, "ingest_s": ingest_s,
                       "ingest_records_per_s": sum(counts.values())
                       / ingest_s,
                       "scans_per_s": scans_per_s,
                       "batch_p50_ms": float(np.percentile(bl, 50)),
                       "batch_p99_ms": float(np.percentile(bl, 99)),
                       "compact_s": compact_s, "busy_share": busy}

        # ---- (b) backup to remote://, restore into a new table ------
        blob = BlobServer(os.path.join(data_dir, "blobs"), host="127.0.0.1",
                          port=0)
        broot = f"{blob.url}/backups"
        t0 = time.perf_counter()
        backup_id = front.admin("start_backup", {"app_name": BULK_APP,
                                                 "root": broot})
        wait_rounds(a, lambda: front.admin(
            "backup_status", {"backup_id": backup_id})["complete"],
            "backup")
        backup_s = time.perf_counter() - t0
        take("backup")
        t0 = time.perf_counter()
        rid = front.admin("restore_app", {
            "new_name": RESTORE_APP, "root": broot,
            "backup_id": backup_id, "replica_count": BULK_REPLICAS})

        def restored() -> bool:
            if any(g[0] == rid for g in a.meta.pending_restores):
                return False
            for p in range(BULK_PARTITIONS):
                pc = a.meta.state.get_partition(rid, p)
                r = (front.replica(pc.primary, rid, p) if pc.primary
                     else None)
                if r is None or r.restoring or not r.ready_to_serve():
                    return False
            return True

        wait_rounds(a, restored, "restore")
        restore_s = time.perf_counter() - t0
        take("restore")
        log(f"backup on {card}: start_backup of {BULK_APP!r} to a "
            f"BlobServer on 127.0.0.1:{blob.port} through remote:// in "
            f"{backup_s} s; restore_app into {RESTORE_APP!r} (app "
            f"{rid}) in {restore_s} s")
        probe = ycsb_scans(rng, RESTORE_PROBE, BULK_PARTITIONS, n_hashkeys)
        rclient = a.client(RESTORE_APP)
        rclient.refresh_config()
        src_frames = probe_frames(client, probe, oracles)
        sync()
        st = take("backup_probe_source")
        if on_card and st["static"] == 0:
            fail("bulk: the probe of the compacted bulk-loaded table "
                 "launched no static scan kernel")
        dst_frames = probe_frames(rclient, probe, oracles)
        sync()
        st = take("backup_probe_restored")
        if dst_frames != src_frames:
            bad = sum(x != y for x, y in zip(src_frames, dst_frames))
            fail(f"restore: {bad} of {len(src_frames)} probe pages of the "
                 f"restored table differ from the source's")
        log(f"restore: {len(probe)} probe scans on {BULK_APP!r} and "
            f"{RESTORE_APP!r} through ClusterClient.scan_multi give "
            f"byte-equal pages (wire frames), equal to the oracle's; "
            f"launches on the bulk-loaded (compacted) primaries "
            f"{launches['backup_probe_source']}, on the restored "
            f"primaries {st}")
        if on_card and st["static"] == 0:
            fail("restore: the probe of the restored table launched no "
                 "static scan kernel")
        blob.close()
        blob = None
        out["backup"] = {"backup_s": backup_s, "restore_s": restore_s}

        # ---- (c) duplication to a second cluster --------------------
        b = SimCluster(os.path.join(data_dir, "B"), n_nodes=BULK_NODES,
                       seed=seed, name_prefix="b.", loop=a.loop, net=a.net,
                       cluster_id=2, device=device)
        front_b = SimFront(b, name="b.loader")
        a_app = a.create_table(DUP_APP, DUP_PARTITIONS, BULK_REPLICAS)
        b_app = b.create_table(DUP_APP, DUP_PARTITIONS, BULK_REPLICAS)
        for _ in range(2):
            a.step()
            b.step(advance=False)
        envelopes = count_messages(a.net, "dup_apply_batch")
        confirmed0 = sum(
            ent.get("metrics", {}).get("dup_confirmed_mutations",
                                       {}).get("value", 0)
            for ent in METRICS.snapshot("duplication"))
        t_dup = time.perf_counter()
        dupid = front.admin("add_dup", {"app_name": DUP_APP,
                                        "follower_meta": b.metas[0].name,
                                        "follower_app": DUP_APP})
        ca = a.client(DUP_APP)
        ca.refresh_config()
        dup_oracles = {p: BatchedOracle() for p in range(DUP_PARTITIONS)}
        hks = rng.integers(0, DUP_HASHKEYS, size=n_dup_ops)
        sks = rng.integers(0, len(SORT_KEYS), size=n_dup_ops)
        dels = rng.random(n_dup_ops) < DUP_DEL_SHARE
        n_set = n_del = 0
        for i in range(n_dup_ops):
            hk = b"user%08d" % int(hks[i])
            sk = SORT_KEYS[int(sks[i])]
            o = dup_oracles[key_hash_parts(hk) % DUP_PARTITIONS]
            key = generate_key(hk, sk)
            if dels[i]:
                err = ca.delete(hk, sk)
                o.values.pop(key, None)
                n_del += 1
            else:
                value = b"field0=%064d" % i
                err = ca.set(hk, sk, value)
                o.values[key] = value
                n_set += 1
            if err != 0:
                fail(f"dup: write {i} to the master answered {err}")
            if a.loop.now - b._last_step_time >= b.beacon_interval:
                b.step(advance=False)
        write_s = time.perf_counter() - t_dup
        t_last, sim_last = time.perf_counter(), a.loop.now

        def sessions() -> dict:
            got = {}
            for stub in a.stubs.values():
                for (gpid, d), sess in stub._dup_sessions.items():
                    if gpid[0] == a_app and d == dupid:
                        got[gpid[1]] = sess
            return got

        def confirmed() -> bool:
            sess = sessions()
            for p in range(DUP_PARTITIONS):
                pc = a.meta.state.get_partition(a_app, p)
                r = front.replica(pc.primary, a_app, p)
                if (p not in sess or sess[p].confirmed_decree
                        < r.last_committed_decree):
                    return False
            return True

        rounds = wait_rounds(a, confirmed, "duplication", other=b)
        confirm_s = time.perf_counter() - t_last
        confirm_sim_s = a.loop.now - sim_last
        dup_s = time.perf_counter() - t_dup
        shipped = sum(
            ent.get("metrics", {}).get("dup_confirmed_mutations",
                                       {}).get("value", 0)
            for ent in METRICS.snapshot("duplication")) - confirmed0
        take("dup_writes")
        a_cmp = compact_primaries(front, a_app, DUP_PARTITIONS, dup_oracles)
        b_oracles = {p: BatchedOracle() for p in range(DUP_PARTITIONS)}
        for p, o in dup_oracles.items():
            b_oracles[p].values = dict(o.values)
        b_cmp = compact_primaries(front_b, b_app, DUP_PARTITIONS, b_oracles)
        sync()
        st_cmp = take("dup_compaction")
        cb = b.client(DUP_APP)
        cb.refresh_config()
        probe = ycsb_scans(rng, DUP_PROBE, DUP_PARTITIONS, DUP_HASHKEYS)
        a_frames = probe_frames(ca, probe, dup_oracles)
        take("dup_probe_master")
        b_frames = probe_frames(cb, probe, b_oracles)
        sync()
        st = take("dup_probe_follower")
        if a_frames != b_frames:
            bad = sum(x != y for x, y in zip(a_frames, b_frames))
            fail(f"dup: {bad} of {len(a_frames)} probe pages of the "
                 f"follower differ from the master's")
        log(f"dup on {card}: add_dup of {DUP_APP!r} ({DUP_PARTITIONS} x "
            f"{BULK_REPLICAS} on each side) to a second SimCluster "
            f"(b. names, cluster id 2) on the same loop and network; "
            f"{n_set} sets and {n_del} dels through ClusterClient in "
            f"{write_s} s; the follower confirmed the master's last "
            f"committed decree on every partition {confirm_s} s wall "
            f"({confirm_sim_s} s simulated, {rounds} timer rounds) after "
            f"the last write; {shipped} mutations shipped in "
            f"{envelopes['n']} dup_apply_batch envelopes "
            f"({envelopes['bytes']} payload bytes), "
            f"{shipped / dup_s} mutations/s over the {dup_s} s from "
            f"add_dup to the confirmation; both sides' primaries compacted "
            f"({a_cmp} s, {b_cmp} s; compaction launches "
            f"{st_cmp['compaction']}); {len(probe)} probe scans through "
            f"both clusters' ClusterClients byte-equal (wire frames) and "
            f"equal to the oracle's; launches on the follower's primaries "
            f"{st}")
        if on_card and st["static"] == 0:
            fail("dup: the probe of the follower table launched no static "
                 "scan kernel")
        out["dup"] = {"sets": n_set, "dels": n_del, "write_s": write_s,
                      "shipped": shipped, "envelopes": envelopes["n"],
                      "envelope_bytes": envelopes["bytes"],
                      "mutations_per_s": shipped / dup_s,
                      "confirm_s": confirm_s,
                      "confirm_sim_s": confirm_sim_s}
        out["scan"] = {k: sum(s[k] for s in launches.values())
                       for k in ("static", "now", "multi")}
        out["compaction"] = sum(s["compaction"] for s in launches.values())
        return out
    finally:
        if blob is not None:
            blob.close()
        for c in (b, a):
            if c is not None:
                c.close()
        shutil.rmtree(data_dir, ignore_errors=True)


def run_phase13(device, card: str, cut: bool) -> dict:
    """Phase 13 under the store flags phases 4-12 pin: every block
    reaches the kernel. `cut`: the whole run's printed cut."""
    import torch

    n_hashkeys, n_dup_ops = BULK_HASHKEYS, DUP_OPS
    if cut:
        n_hashkeys, n_dup_ops = SERVICES_RUN_HASHKEYS, SERVICES_RUN_DUP_OPS
        log(f"services: CUT to {n_dup_ops} duplicated writes (the "
            f"phase's {DUP_OPS}); --ops-only runs the phase uncut")
    with store_flags(NONE_STORE):
        t0 = time.perf_counter()
        services = run_services(device, n_hashkeys=n_hashkeys,
                                n_dup_ops=n_dup_ops, card=card)
        torch.cuda.synchronize()
        log(f"services: (a)-(c) in {time.perf_counter() - t0:.1f} s")
    return services


ONEBOX_NODES = 3               # replica processes, beside one meta process
ONEBOX_PARTITIONS = 64         # BASELINE config #2's table
ONEBOX_REPLICAS = 3            # Pegasus's default: a primary, 2 secondaries
ONEBOX_HASHKEYS = 100_000      # x 10 sortkeys: 1,000,000 records
ONEBOX_OPS = 20_000            # YCSB-E operations (bench.py run_scans)
ONEBOX_APP = "bench"
ONEBOX_CLIENT_OPS = 200        # seeded gets and scans of the other clients
ONEBOX_PROBE = 200             # probe scans before the kill and after
ONEBOX_DEADLINE_S = 180.0      # what a wait (boot, load, cure) may take
ONEBOX_OUTAGE_TIMEOUT_MS = 2000  # a write's deadline while a node is down
ONEBOX_KILL_WRITES = 3         # a partition's writes acked before the kill
ONEBOX_OUTAGE_ACKS = 100       # writes since the kill that must be acked
# the meta's compaction stagger keeps a node's grant at least a third of
# its lease after granting it (the default 30 s: 10 s a node, however
# short its compaction); 9 s keeps that third above one config-sync
# round (2.5 s), the delivery race the hold covers
ONEBOX_GRANT_LEASE_S = 9.0
ONEBOX_FLAGS = {**NONE_STORE, ("pegasus.meta", "compaction_grant_lease_s"):
                ONEBOX_GRANT_LEASE_S}
# the whole run's cut of phase 14 (printed; --onebox-only runs it uncut)
ONEBOX_RUN_HASHKEYS = 10_000
ONEBOX_RUN_OPS = 2_000

# the shell's wire mode in a process of its own, which must not initialize
# CUDA: it reads one JSON [directory, argv] a line, runs
# `shell.main(["--cluster", directory, *argv])` and ends what the verb
# printed with one _SHELL_DONE line
_SHELL_DONE = "\x00shell-done "
_SHELL_LOOP = (
    "import json, sys\n"
    "import torch\n"
    "from pegasus_tpu_torch.tools import shell\n"
    "for line in sys.stdin:\n"
    "    d, argv = json.loads(line)\n"
    "    rc = shell.main(['--cluster', d, *argv])\n"
    f"    print({_SHELL_DONE!r} + json.dumps({{'rc': rc, "
    "'cuda_initialized': torch.cuda.is_initialized()}), flush=True)\n")


class ShellWire:
    """The shell's wire mode on onebox `d`: one process for every call,
    started before the nodes so that its imports overlap their boot.
    Each call fails unless the verb answers 0 and CUDA stayed
    uninitialized in that process."""

    def __init__(self, tree: str, d: str) -> None:
        self.d = d
        self._err = tempfile.TemporaryFile()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _SHELL_LOOP], cwd=tree,
            env=dict(os.environ, PYTHONPATH=tree), stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=self._err, text=True)

    def call(self, argv: list, timeout: float = 300) -> str:
        """Runs one verb; returns what it printed."""
        self.proc.stdin.write(json.dumps([self.d, argv]) + "\n")
        self.proc.stdin.flush()
        kill = threading.Timer(timeout, self.proc.kill)
        kill.start()
        try:
            out = []
            for line in self.proc.stdout:
                if _SHELL_DONE in line:
                    head, _, tail = line.partition(_SHELL_DONE)
                    out.append(head)
                    res = json.loads(tail)
                    if res["rc"]:
                        fail(f"shell {argv} answered {res['rc']}: "
                             f"{''.join(out)[-2000:]}")
                    if res["cuda_initialized"]:
                        fail(f"shell {argv}: the wire mode initialized CUDA")
                    return "".join(out)
                out.append(line)
        finally:
            kill.cancel()
        self._err.seek(0)
        fail(f"shell {argv}: exit {self.proc.wait()}: "
             f"{self._err.read()[-2000:].decode(errors='replace')}")

    def close(self) -> None:
        self.proc.stdin.close()
        try:
            self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self._err.close()


def wait_until(done, what: str, timeout: float = ONEBOX_DEADLINE_S,
               poll: float = 0.25, explain=None) -> float:
    """Polls done() (a PegasusError counts as not yet) until it holds;
    fails after `timeout` seconds, with what explain() returns. Returns
    the seconds waited."""
    from pegasus_tpu_torch.utils.errors import PegasusError

    t0 = time.perf_counter()
    while True:
        try:
            if done():
                return time.perf_counter() - t0
        except PegasusError:
            pass
        if time.perf_counter() - t0 > timeout:
            fail(f"onebox: {what} not done after {timeout} s"
                 + (f": {explain()}" if explain is not None else ""))
        time.sleep(poll)


def node_counters(admin, nodes, entity_type: str, metric: str) -> dict:
    """{(node, entity id): value} of one counter on every node's
    entities of `entity_type`, read through the `metrics` verb."""
    out = {}
    for n in nodes:
        for ent in admin.remote_command(n, "metrics", [entity_type]):
            m = ent.get("metrics", {}).get(metric)
            if m is not None:
                out[(n, ent["id"])] = m["value"]
    return out


def node_launches(admin, nodes) -> dict:
    """The kernel launches of the replica processes since the last read
    (each node's `kernel.launches reset`), summed as launch_counter's
    stages count them."""
    tot = {"static": 0, "now": 0, "multi": 0, "compaction": 0}
    for n in nodes:
        got = admin.remote_command(n, "kernel.launches", ["reset"])
        for k in ("static", "now", "multi"):
            tot[k] += got["fused_scan"][k]
        tot["compaction"] += got["fused_compaction"]["compaction"]
    return tot


def busiest_stacks(http_port: int, n: int = 6) -> list:
    """A node's most sampled Python stacks over 2 s that are not waiting
    (its HTTP server's /pprof/profile), for a failure's report."""
    import urllib.request

    url = f"http://127.0.0.1:{http_port}/pprof/profile?seconds=2"
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            stacks = json.load(r)["stacks"]
    except OSError as e:
        return [f"no profile: {e}"]
    idle = ("wait", "select", "accept", "_read_loop", "sleep")
    return [(s["count"], s["stack"][-400:]) for s in stacks
            if not s["stack"].endswith(idle)][:n]


def primaries(client) -> dict:
    client.refresh_config()
    return {p: pc["primary"] for p, pc in enumerate(client._configs)}


def gpid_of(engine_dir: str) -> str:
    """The partition of an engine entity: its data directory is
    <data_root>/<node>/<app>.<pidx>/app."""
    return os.path.basename(os.path.dirname(engine_dir.rstrip("/")))


def reap(pids: list, timeout: float = 30.0) -> list:
    """Wait for every child pid to exit and reap it; returns the pids
    still running after `timeout`, killed (SIGKILL)."""
    import signal

    left, t0 = list(pids), time.perf_counter()
    while left and time.perf_counter() - t0 < timeout:
        for pid in list(left):
            try:
                done, _status = os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                done = pid  # reaped elsewhere (or not our child)
                if os.path.exists(f"/proc/{pid}"):
                    done = 0
            if done:
                left.remove(pid)
        time.sleep(0.1)
    for pid in left:
        try:
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
        except (ProcessLookupError, ChildProcessError):
            pass
    return left


def run_onebox(device, n_hashkeys: int = ONEBOX_HASHKEYS,
               n_ops: int = ONEBOX_OPS, seed: int = 37,
               card: str = "") -> dict:
    """Phase 14: BASELINE config #2 served by node processes over TCP
    (tools/onebox_cluster.py, server/node_main.py). (a) 1 meta and 3
    replica processes, the replicas on the card `device`, every node's
    store flags pinned to NONE_STORE and the meta's grant lease set to
    ONEBOX_GRANT_LEASE_S through cluster.json, each node's boot seconds
    read from its log; (b) table "bench" of 64 partitions
    x 3 replicas created through the shell's wire mode, config #2
    (bench.py:190-222's layout, 10% expired) staged by SSTGenerator in a
    LocalBlockService root and ingested by the shell's start_bulk_load
    (bulk_load_status sampled once a second),
    then the shell's manual_compact (the env trigger), until every
    replica's engine counted a compaction; (c) YCSB-E through
    onebox_cluster.connect, a ClusterClient over TcpTransport (95% scans
    in scan_multi batches of 32, 5% inserts through set), every page
    against an oracle; the replicas' mask_route_device_raw_count must
    rise; (d) the C++ wire client (200 gets, 200 hashkey scans) equal to
    the ClusterClient and the oracle, AsyncPegasusClient.gather_get
    equal, every node's GET /metrics and /config (block_codec none);
    (e) a seeded batch of writes acknowledged just before a kill -9 of
    the replica process leading the most primaries (ONEBOX_KILL_WRITES
    a partition, so every partition's share sits in the victim's plog
    and memtable), writes from the kill on until the meta's cure and
    ONEBOX_OUTAGE_ACKS of them acknowledged, every acknowledged write
    read back, a seeded probe of
    200 scans taken before the kill byte-equal after it (wire frames),
    the new primaries' mask_route_device_raw_count rising; (f) stop, no
    node process left, no node log holding a traceback. Kernel launches
    are read from the replica processes (`kernel.launches`). Returns the
    numbers and the launches by stage."""
    import asyncio
    import urllib.request

    import torch

    from pegasus_tpu_torch.base.key_schema import (
        generate_key,
        key_hash_parts,
    )
    from pegasus_tpu_torch.base.value_schema import epoch_now
    from pegasus_tpu_torch.client.aio import AsyncPegasusClient
    from pegasus_tpu_torch.native import wire_client
    from pegasus_tpu_torch.server.bulk_load import SSTGenerator
    from pegasus_tpu_torch.storage.block_service import LocalBlockService
    from pegasus_tpu_torch.tools import onebox_cluster as ob
    from pegasus_tpu_torch.utils.errors import PegasusError

    partitions = ONEBOX_PARTITIONS
    rng = np.random.default_rng(seed)
    tree = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(ob.__file__))))
    if n_hashkeys != ONEBOX_HASHKEYS or n_ops != ONEBOX_OPS:
        log(f"onebox: CUT to {n_hashkeys * 10} records and {n_ops} ops "
            f"(config #2's {ONEBOX_HASHKEYS * 10} and the phase's "
            f"{ONEBOX_OPS}; --onebox-only runs the phase uncut)")
    d = tempfile.mkdtemp(prefix="pegasus_torch_onebox_")
    launches: dict = {}
    out: dict = {"launches": launches}
    pids: list = []
    closers: list = []
    http: dict = {}
    t_phase = time.perf_counter()
    try:
        # ---- (a) the node processes --------------------------------------
        t0 = time.perf_counter()
        shell = ShellWire(tree, d)
        closers.append(shell.close)
        cfg = ob.start(d, n_replica=ONEBOX_NODES, flags=ONEBOX_FLAGS)
        with open(os.path.join(d, "pids.json")) as f:
            pid_of = json.load(f)
        pids = list(pid_of.values())
        admin = ob.OneboxAdmin(d)
        closers.append(admin.close)
        nodes = [n for n, c in cfg["nodes"].items() if c["role"] == "replica"]
        wait_until(lambda: len(admin.call("list_nodes", timeout=6))
                   == ONEBOX_NODES, "the replica nodes' registration")
        boot_s = time.perf_counter() - t0
        served_on = {}
        node_boot_s = {}
        for n in cfg["nodes"]:
            with open(os.path.join(d, "logs", f"{n}.log")) as f:
                text = f.read()
            m = re.search(r"serving on \S+ http=(\d+)(?: device=(.*))?",
                          text)
            b = re.search(r"booted in (\S+) s \((\S+) s before the port",
                          text)
            if m is None or b is None:
                fail(f"onebox: {n} printed no boot line: {text[-2000:]}")
            http[n] = int(m.group(1))
            node_boot_s[n] = (float(b.group(1)), float(b.group(2)))
            if n in nodes:
                served_on[n] = m.group(2)
        log(f"onebox on {card}: each node's boot, from its module's "
            f"import to serving (of it, the role's imports and the "
            f"message registry before its port opened): "
            + ", ".join(f"{n} {t} s ({pre} s)"
                        for n, (t, pre) in node_boot_s.items()))
        want = f"{device} ({torch.cuda.get_device_name(device)})"
        for n, dev in served_on.items():
            if dev != want:
                fail(f"onebox: {n} serves on {dev!r}, not {want!r}")
        log(f"onebox on {card}: 1 meta + {ONEBOX_NODES} replica processes "
            f"(python -m pegasus_tpu_torch.server.node_main, flags "
            f"{ {k[1]: v for k, v in ONEBOX_FLAGS.items()} } through "
            f"cluster.json) up and registered in {boot_s} s; replicas "
            f"serve on {sorted(set(served_on.values()))}")
        smi = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        log(f"onebox: nvidia-smi compute apps (informative; node pids "
            f"{pid_of}): {smi.stdout.strip() or '(none listed)'}")

        # ---- (b) the load --------------------------------------------------
        t0 = time.perf_counter()
        records, oracles = bulk_records(n_hashkeys, partitions, rng)
        root = os.path.join(d, "bulk_root")
        counts = SSTGenerator(LocalBlockService(root), ONEBOX_APP,
                              partitions).generate(records)
        stage_s = time.perf_counter() - t0
        n_records = len(records)
        del records
        if sum(counts.values()) != n_records:
            fail(f"onebox: SSTGenerator staged {sum(counts.values())} of "
                 f"{n_records} records")
        t0 = time.perf_counter()
        shell.call(["create_app", ONEBOX_APP, "-p", str(partitions)])
        client = ob.connect(ONEBOX_APP, d, client_name="chip-smoke")
        closers.append(client.net.close)
        client.refresh_config()
        app_id = client.app_id

        def serving() -> dict:
            """{(node, pidx): (status, ballot, committed, prepared)} of
            the table's replicas, through each node's replica.info."""
            out = {}
            for n in nodes:
                for r in admin.remote_command(n, "replica.info"):
                    if r["gpid"][0] == app_id:
                        out[(n, r["gpid"][1])] = (
                            r["status"], r["ballot"], r["last_committed"],
                            r["last_prepared"])
            return out

        def opened() -> bool:
            client.refresh_config()
            got = serving()
            return all(
                got.get((pc["primary"], p), ("",))[0] == "PRIMARY"
                and all(got.get((n, p), ("",))[0] == "SECONDARY"
                        for n in pc["secondaries"])
                for p, pc in enumerate(client._configs))

        # an ingest's 2PC needs every member in its role: start the load
        # once all are
        wait_until(opened, "the table's replicas opening", poll=0.5,
                   explain=lambda: sorted(serving().items())[:12])
        open_s = time.perf_counter() - t0
        # bulk_load_status once a second from the shell's call on, by an
        # admin client of its own: the load may end before the shell's
        # process does. A sample is (s since the call, partitions pending,
        # in flight, complete); before the meta takes the call it reads
        # complete, with no load.
        progress: list = []
        sampled = threading.Event()
        sampler_admin = ob.OneboxAdmin(d, name="chip-smoke-sampler")
        closers.append(sampler_admin.close)

        def sample() -> None:
            while not sampled.is_set():
                t = time.perf_counter() - t_load
                try:
                    st = sampler_admin.call("bulk_load_status",
                                            app_name=ONEBOX_APP, timeout=6)
                    progress.append((round(t, 3), len(st["pending"]),
                                     len(st["inflight"]), st["complete"]))
                except PegasusError as e:
                    progress.append((round(t, 3), repr(e)))
                sampled.wait(len(progress) - (time.perf_counter() - t_load))

        t_load = time.perf_counter()
        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        shell.call(["start_bulk_load", ONEBOX_APP, "--bucket", root])

        def loaded() -> bool:
            st = admin.call("bulk_load_status", app_name=ONEBOX_APP)
            if st.get("failed"):
                fail(f"onebox: bulk load failed: {st}")
            return st["complete"]

        def load_state() -> str:
            try:
                st = admin.call("bulk_load_status", app_name=ONEBOX_APP)
            except PegasusError as e:
                return f"the meta answers no bulk_load_status ({e})"
            got = serving()
            flying = {k: v for k, v in got.items()
                      if k[1] in st.get("inflight", [])}
            return (f"{st}; the replicas in flight (status, ballot, "
                    f"committed, prepared): {flying}")

        wait_until(loaded, "the bulk load", explain=load_state)
        ingest_s = time.perf_counter() - t0
        load_s = time.perf_counter() - t_load
        sampled.set()
        sampler.join(timeout=30)
        launches["ingest"] = node_launches(admin, nodes)
        log(f"onebox on {card}: bulk_load_status once a second (s since "
            f"the shell's start_bulk_load call, partitions pending, in "
            f"flight, complete): {progress}; complete after {load_s} s: "
            f"{n_records / load_s} records/s from that call")
        log(f"onebox on {card}: load route start_bulk_load (the shell's "
            f"wire mode) of an SSTGenerator-staged LocalBlockService root: "
            f"{n_records} records ({n_hashkeys} hashkeys x 10, "
            f"{n_records - sum(len(o.values) for o in oracles.values())} "
            f"expired) staged in {stage_s} s, ingested into "
            f"{partitions} partitions x {ONEBOX_REPLICAS} replicas in "
            f"{ingest_s} s: {n_records / ingest_s} records/s "
            f"({n_records / (stage_s + ingest_s)} with the staging; the "
            f"ingest's seconds count from create_app, whose "
            f"{partitions * ONEBOX_REPLICAS} replicas opened in {open_s} "
            f"s); launches {launches['ingest']}")
        client.refresh_config()
        before = node_counters(admin, nodes, "engine", "compaction_count")
        t_compact = time.perf_counter()
        shell.call(["manual_compact", ONEBOX_APP])

        def compacted(members) -> bool:
            now = node_counters(admin, nodes, "engine", "compaction_count")
            done = {(n, gpid_of(e)) for (n, e), v in now.items()
                    if v > before.get((n, e), 0)}
            return all((n, f"{app_id}.{p}") in done
                       for p, pc in enumerate(client._configs)
                       for n in members(pc))

        wait_until(lambda: compacted(lambda pc: [pc["primary"]]),
                   "the primaries' manual compaction", poll=0.5)
        compact_s = time.perf_counter() - t_compact
        for o in oracles.values():
            # every replica's store is one compacted L1 run without the
            # expired records: a one-page scan serves the first records
            # from its start key (the block layout cannot change a page)
            o.keys = sorted(o.values)
            o.starts = [0, len(o.keys)]
            o.overlay = []
        log(f"onebox on {card}: manual_compact {ONEBOX_APP} (the shell's "
            f"wire mode: the manual_compact.once.trigger_time env) done on "
            f"the {partitions} primaries in {compact_s} s")

        # ---- (c) YCSB-E over TCP -------------------------------------------
        launches["compaction_primaries"] = node_launches(admin, nodes)
        raw0 = node_counters(admin, nodes, "replica",
                             "mask_route_device_raw_count")
        items = ycsb_scans(rng, n_ops, partitions, n_hashkeys)
        insert_draw = rng.random(n_ops)
        insert_hks = rng.integers(0, 1 << 30, size=n_ops)
        pending: list = []
        batch_s: list = []
        stats = {"scans": 0, "batches": 0, "inserts": 0, "records": 0,
                 "insert_s": 0.0}

        def flush() -> None:
            if not pending:
                return
            now = epoch_now()
            t = time.perf_counter()
            resps = client_scan_batch(client, pending)
            batch_s.append(time.perf_counter() - t)
            for (p, start, limit), resp in zip(pending, resps):
                stats["records"] += check_cluster_page(
                    resp, oracles[p], start, limit, now)
            stats["scans"] += len(pending)
            stats["batches"] += 1
            pending.clear()

        t_traffic = time.perf_counter()
        for op in range(n_ops):
            if insert_draw[op] < 0.05:
                flush()
                hk = b"user%08d" % int(insert_hks[op])
                t = time.perf_counter()
                err = client.set(hk, b"s00", b"inserted")
                stats["insert_s"] += time.perf_counter() - t
                if err != 0:
                    fail(f"onebox insert answered {err}")
                oracles[key_hash_parts(hk) % partitions].insert(
                    generate_key(hk, b"s00"), b"inserted")
                stats["inserts"] += 1
                continue
            pending.append(items[op])
            if len(pending) >= SCAN_FLUSH:
                flush()
        flush()
        traffic_s = time.perf_counter() - t_traffic
        launches["traffic"] = node_launches(admin, nodes)
        raw1 = node_counters(admin, nodes, "replica",
                             "mask_route_device_raw_count")
        raw_by_node = {n: sum(v - raw0.get(k, 0) for k, v in raw1.items()
                              if k[0] == n) for n in nodes}
        scans_per_s = stats["scans"] / sum(batch_s)
        bl = np.asarray(batch_s) * 1e3
        log(f"onebox on {card}: YCSB-E over TCP through "
            f"onebox_cluster.connect (ClusterClient, TcpTransport): "
            f"{stats['scans']} scans in {stats['batches']} scan_multi "
            f"calls, {stats['inserts']} inserts (set), {stats['records']} "
            f"records, every page equal to the oracle's; {scans_per_s} "
            f"scans/s over {sum(batch_s)} s of batch wall, per batch "
            f"p50 {np.percentile(bl, 50)} ms, p99 {np.percentile(bl, 99)} "
            f"ms; inserts {stats['insert_s']} s; traffic {traffic_s} s "
            f"wall; mask_route_device_raw_count rose by {raw_by_node} "
            f"(per node); launches {launches['traffic']}")
        if sum(raw_by_node.values()) <= 0:
            fail("onebox: no replica computed a block's mask on the device "
                 "(mask_route_device_raw_count did not rise)")
        if launches["traffic"]["static"] == 0:
            fail("onebox: the scans launched no static scan kernel in the "
                 "replica processes")

        # ---- (d) the other clients -----------------------------------------
        book = {n: (c["host"], c["port"]) for n, c in cfg["nodes"].items()}
        metas = [n for n, c in cfg["nodes"].items() if c["role"] == "meta"]
        nc = wire_client.NativeClient("chip-smoke-cpp", book, metas,
                                      ONEBOX_APP)
        closers.append(nc.close)
        if not nc.refresh() or nc.partition_count != partitions:
            fail(f"onebox: the C++ client's config: {nc.last_error()}")
        hs = rng.integers(0, n_hashkeys, size=ONEBOX_CLIENT_OPS)
        ss = rng.integers(0, len(SORT_KEYS), size=ONEBOX_CLIENT_OPS)
        keys = [(b"user%08d" % int(h), SORT_KEYS[int(s)])
                for h, s in zip(hs, ss)]
        t0 = time.perf_counter()
        native_gets = [nc.get(hk, sk) for hk, sk in keys]
        native_scans = [list(nc.scan(hk)) for hk, _sk in keys]
        native_s = time.perf_counter() - t0
        cluster_gets = [client.get(hk, sk) for hk, sk in keys]
        cluster_scans = [[(sk, v) for _hk, sk, v in client.get_scanner(hk)]
                         for hk, _sk in keys]
        for i, (hk, sk) in enumerate(keys):
            o = oracles[key_hash_parts(hk) % partitions].values
            v = o.get(generate_key(hk, sk))
            want_get = (0, v) if v is not None else 1
            got = native_gets[i] if v is not None else native_gets[i][0]
            if got != want_get or (cluster_gets[i] if v is not None else
                                   cluster_gets[i][0]) != want_get:
                fail(f"onebox get {hk!r}/{sk!r}: C++ {native_gets[i]}, "
                     f"ClusterClient {cluster_gets[i]}, oracle {v!r}")
            want_scan = [(s, o[generate_key(hk, s)]) for s in SORT_KEYS
                         if generate_key(hk, s) in o]
            if native_scans[i] != want_scan or cluster_scans[i] != want_scan:
                fail(f"onebox scan {hk!r}: C++ {len(native_scans[i])} rows, "
                     f"ClusterClient {len(cluster_scans[i])}, oracle "
                     f"{len(want_scan)}")
        aio_client = ob.connect(ONEBOX_APP, d, client_name="chip-smoke-aio")
        closers.append(aio_client.net.close)
        ac = AsyncPegasusClient(aio_client)
        closers.append(ac.close)
        aio_gets = asyncio.run(ac.gather_get(keys))
        if list(aio_gets) != cluster_gets:
            fail("onebox: AsyncPegasusClient.gather_get differs from the "
                 "ClusterClient's gets")
        for n, port in http.items():
            base = f"http://127.0.0.1:{port}"
            with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
                if not isinstance(json.load(r), list):
                    fail(f"onebox: {n} GET /metrics is not a list")
            with urllib.request.urlopen(base + "/config", timeout=30) as r:
                codec = json.load(r)["pegasus.storage"]["block_codec"]
            if codec != "none":
                fail(f"onebox: {n} GET /config shows block_codec {codec}")
        found = sum(1 for g in native_gets if g[0] == 0)
        log(f"onebox on {card}: the C++ wire client (native/"
            f"wire_client.cpp, built into _build/) answered "
            f"{len(keys)} gets ({found} found) and {len(keys)} hashkey "
            f"scans ({sum(map(len, native_scans))} rows) equal to the "
            f"ClusterClient's and the oracle's: "
            f"{2 * len(keys) / native_s} ops/s; "
            f"AsyncPegasusClient.gather_get answered the same {len(keys)} "
            f"gets; GET /metrics and /config answered on all "
            f"{len(http)} nodes (block_codec none); the shell's "
            f"--cluster calls left CUDA uninitialized in their process "
            f"(one, started before the nodes)")

        # ---- (e) a node's death -----------------------------------------------
        # the secondaries compacted meanwhile (or now): a promoted one
        # serves the same compacted run
        wait_until(lambda: compacted(lambda pc: [pc["primary"],
                                                 *pc["secondaries"]]),
                   "the secondaries' manual compaction", poll=0.5)
        all_compact_s = time.perf_counter() - t_compact
        launches["compaction"] = node_launches(admin, nodes)
        n_compact = sum(s["compaction"] for s in launches.values())
        log(f"onebox on {card}: every one of the "
            f"{partitions * ONEBOX_REPLICAS} replicas compacted "
            f"{all_compact_s} s after manual_compact; launches since the "
            f"traffic (the clients' reads, the last compactions) "
            f"{launches['compaction']}; compaction kernel launches so far "
            f"{n_compact}")
        if n_compact == 0:
            fail("onebox: the compactions launched no compaction kernel")
        prim = primaries(client)
        led = {n: sum(1 for v in prim.values() if v == n) for n in nodes}
        victim = max(nodes, key=lambda n: (led[n], n))
        probe = ycsb_scans(rng, ONEBOX_PROBE, partitions, n_hashkeys)
        frames = probe_frames(client, probe, oracles)
        launches["probe"] = node_launches(admin, nodes)
        survivors = [n for n in nodes if n != victim]
        writer = ob.connect(ONEBOX_APP, d, client_name="chip-smoke-outage",
                            op_timeout_ms=ONEBOX_OUTAGE_TIMEOUT_MS)
        closers.append(writer.net.close)

        def cured() -> bool:
            client.refresh_config()
            return all(pc["primary"] and victim not in
                       [pc["primary"], *pc["secondaries"]]
                       for pc in client._configs)

        # a seeded batch acknowledged just before the kill: the victim
        # serves a replica of every partition, so each partition's share
        # sits in its plog and memtable when it dies
        acked: dict = {}
        for hk in kill_batch(partitions):
            value = b"pre-kill-%s" % hk
            err = client.set(hk, b"s", value)
            if err != 0:
                fail(f"onebox: the write of {hk!r} before the kill "
                     f"answered {err}")
            acked[hk] = value
        n_pre = len(acked)
        ob.kill_node(victim, d)
        t_kill = time.perf_counter()
        sent, n_outage, cure_s = 0, 0, None
        # every partition counts the victim among its members, so no
        # write commits before the cure: write on past it until
        # ONEBOX_OUTAGE_ACKS of the writes since the kill are acknowledged
        while cure_s is None or n_outage < ONEBOX_OUTAGE_ACKS:
            hk = b"out%05d" % sent   # sorts before every user%08d key
            value = b"outage-%d" % sent
            try:
                if writer.set(hk, b"s", value) == 0:
                    acked[hk] = value
                    n_outage += 1
            except PegasusError:
                pass
            sent += 1
            if cure_s is None and (sent % 10 == 0
                                   or time.perf_counter() - t_kill > 1.0):
                if cured():
                    cure_s = time.perf_counter() - t_kill
                    sent_by_cure, acked_by_cure = sent, n_outage
                    # the writer's routes still name the victim, and a
                    # write sent there waits out its deadline
                    writer.refresh_config()
            if time.perf_counter() - t_kill > ONEBOX_DEADLINE_S:
                fail(f"onebox: {n_outage} of {sent} writes since the kill "
                     f"of {victim} acknowledged, cured: {cure_s is not None}, "
                     f"after {ONEBOX_DEADLINE_S} s")
        lost = [hk for hk, v in acked.items()
                if client.get(hk, b"s") != (0, v)]
        if lost:
            fail(f"onebox: {len(lost)} of {len(acked)} acknowledged writes "
                 f"lost after the kill: {lost[:5]}")
        moved = {p for p, n in prim.items() if n == victim}
        new_prim = primaries(client)
        raw0 = node_counters(admin, survivors, "replica",
                             "mask_route_device_raw_count")
        after = probe_frames(client, probe, oracles)
        launches["cure"] = node_launches(admin, survivors)
        raw1 = node_counters(admin, survivors, "replica",
                             "mask_route_device_raw_count")
        if after != frames:
            bad = sum(x != y for x, y in zip(frames, after))
            fail(f"onebox: {bad} of {len(frames)} probe pages differ after "
                 f"the cure")
        probed = {p for p, _s, _l in probe} & moved
        rose = sum(raw1.get((new_prim[p], f"{app_id}.{p}"), 0)
                   - raw0.get((new_prim[p], f"{app_id}.{p}"), 0)
                   for p in probed)
        log(f"onebox on {card}: kill -9 of {victim} (primary of "
            f"{led[victim]} partitions; onebox_cluster.kill_node) after "
            f"{n_pre} writes acknowledged ({ONEBOX_KILL_WRITES} a "
            f"partition); {sent_by_cure} writes sent before the cure, "
            f"{acked_by_cure} acknowledged; {sent} sent in all until "
            f"{n_outage} were acknowledged; all {len(acked)} acknowledged "
            f"writes read back; cured (no partition names {victim}, every "
            f"partition has a primary) {cure_s} s after the kill; the "
            f"{len(probe)}-scan probe byte-equal before and after (wire "
            f"frames); mask_route_device_raw_count of the new "
            f"primaries of the {len(probed)} probed moved partitions rose "
            f"by {rose}; launches on the survivors {launches['cure']}")
        if not probed or rose <= 0:
            fail("onebox: the new primaries computed no mask on the device")
        if launches["cure"]["static"] == 0:
            fail("onebox: the probe on the new primaries launched no static "
                 "scan kernel")
        out.update({
            "boot_s": boot_s, "node_boot_s": node_boot_s,
            "stage_s": stage_s, "ingest_s": ingest_s, "load_s": load_s,
            "load_progress": progress,
            "records_per_s": n_records / ingest_s, "compact_s": compact_s,
            "scans_per_s": scans_per_s,
            "batch_p50_ms": float(np.percentile(bl, 50)),
            "batch_p99_ms": float(np.percentile(bl, 99)),
            "device_raw": raw_by_node,
            "native_ops_per_s": 2 * len(keys) / native_s,
            "cure_s": cure_s, "pre_kill_acked": n_pre,
            "outage_sent": sent, "outage_acked": n_outage})
        out["scan"] = {k: sum(s[k] for s in launches.values())
                       for k in ("static", "now", "multi")}
        out["compaction"] = sum(s["compaction"] for s in launches.values())
        return out
    finally:
        if sys.exc_info()[0] is not None:
            for n, port in http.items():
                print(f"onebox: {n}'s busiest stacks: "
                      f"{busiest_stacks(port)}", file=sys.stderr,
                      flush=True)
            for n in sorted(os.listdir(os.path.join(d, "logs"))):
                with open(os.path.join(d, "logs", n), "rb") as f:
                    tail = f.read()[-3000:].decode(errors="replace")
                print(f"onebox: the tail of {n}:\n{tail}", file=sys.stderr,
                      flush=True)
        for close in reversed(closers):
            try:
                close()
            except Exception:  # noqa: BLE001 - stopping regardless
                pass
        ob.stop(d)
        left = reap(pids)
        tracebacks = {}
        for n in sorted(os.listdir(os.path.join(d, "logs"))):
            with open(os.path.join(d, "logs", n), "rb") as f:
                text = f.read().decode(errors="replace")
            if "Traceback" in text:
                tracebacks[n] = text[text.index("Traceback"):][:3000]
        shutil.rmtree(d, ignore_errors=True)
        log(f"onebox: stopped; {len(pids)} node processes, "
            f"{len(left)} had to be killed; node logs holding a traceback: "
            f"{sorted(tracebacks) or 'none'}; phase wall "
            f"{time.perf_counter() - t_phase} s")
        if left:
            fail(f"onebox: node processes {left} outlived stop")
        if tracebacks and sys.exc_info()[0] is None:
            fail(f"onebox: tracebacks in the node logs: {tracebacks}")


def run_phase14(device, card: str, cut: bool) -> dict:
    """Phase 14 under the store flags phases 4-13 pin, set in the node
    processes through cluster.json. `cut`: the whole run's printed
    cut."""
    n_hashkeys, n_ops = ONEBOX_HASHKEYS, ONEBOX_OPS
    if cut:
        n_hashkeys, n_ops = ONEBOX_RUN_HASHKEYS, ONEBOX_RUN_OPS
    return run_onebox(device, n_hashkeys=n_hashkeys, n_ops=n_ops, card=card)


def times_only(torch, tree: str) -> int:
    """Phase 3's times of the kernels of the pegasus_tpu_torch imported
    from `tree`, as one JSON line: to hold two revisions' kernels against
    each other on one card, run each in its own process in turns (P C C
    P), `--tree` naming the other revision's unpacked checkout."""
    from concurrent.futures import ThreadPoolExecutor

    from pegasus_tpu_torch.ops import fused_compaction, fused_scan

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    device = torch.device("cuda", torch.cuda.current_device())
    with ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(fused_scan.build, force=True),
                  pool.submit(fused_compaction.build, force=True)]
        for b in builds:
            b.result()
    times = {"scan": time_tables(device),
             "multi": time_tables_multi(device),
             "keyhash": time_key_hash(device),
             "compaction": time_compaction(device)}
    log(json.dumps({"tree": tree, "card": smi.stdout.strip(),
                    "times": {name: [{k: row[k] for k in ("shape", "ms",
                                                           "call_ms")}
                                     for row in (rows if isinstance(rows, list)
                                                 else [rows])]
                              for name, rows in times.items()}}))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--records", type=int, default=SLICE_RECORDS,
                        help="records of partition 0 to load in phase 4 "
                        f"(default {SLICE_RECORDS:,}; a cut below "
                        f"{FULL_RECORDS:,} is printed)")
    parser.add_argument("--compact-gb", type=float, default=COMPACT_GB,
                        help="GB of store a phase-7 pass compacts "
                        f"(default {COMPACT_GB}; the configuration's table "
                        f"is {COMPACT_FULL_GB} GB, a printed cut)")
    parser.add_argument("--times-only", action="store_true",
                        help="build the kernels, print phase 3's times as "
                        "one JSON line and stop")
    parser.add_argument("--resident-times", action="store_true",
                        help="build the kernels, print phase 10 (f)'s "
                        "kernel times and a round's wall split on a "
                        "synthetic image as one JSON line and stop")
    parser.add_argument("--resident-only", action="store_true",
                        help="build the kernels, run phase 10 (BASELINE "
                        "config #2's resident image, its mesh leg over "
                        "every card of the host) alone, print its "
                        "launches and the mesh leg as one JSON line and "
                        "stop")
    parser.add_argument("--replicated-only", action="store_true",
                        help="build the kernels, run phase 11 (replicated "
                        "writes through PacificA groups) alone, print its "
                        "launches as one JSON line and stop")
    parser.add_argument("--cluster-only", action="store_true",
                        help="build the kernels, run phase 12 (BASELINE "
                        "config #2 through the meta and the replica stub, "
                        "then the meta's cure) alone, print its launches "
                        "as one JSON line and stop")
    parser.add_argument("--ops-only", action="store_true",
                        help="build the kernels, run phase 13 (bulk load, "
                        "backup and restore, duplication on SimClusters) "
                        "alone, print its launches as one JSON line and "
                        "stop")
    parser.add_argument("--onebox-only", action="store_true",
                        help="build the kernels, run phase 14 (BASELINE "
                        "config #2 served by node processes over TCP) "
                        "alone and uncut, print its launches as one JSON "
                        "line and stop")
    parser.add_argument("--tree", default=None,
                        help="with --times-only or --resident-times: the "
                        "checkout whose "
                        "pegasus_tpu_torch (and kernel sources) to time "
                        "(default this one)")
    args = parser.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    here = os.path.dirname(os.path.abspath(__file__))
    tree = os.path.abspath(args.tree) if args.tree else here
    if not os.path.isdir(os.path.join(tree, "pegasus_tpu_torch")):
        fail("run from a checkout: pegasus_tpu_torch/ is missing")
    sys.path.insert(0, tree)
    from pegasus_tpu_torch.ops import fused_compaction, fused_scan

    if args.times_only:
        return times_only(torch, tree)
    if args.resident_times:
        return resident_times(torch, tree)

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

    # 2. build: one nvcc a kernel source and g++, all started together
    from concurrent.futures import ThreadPoolExecutor

    from pegasus_tpu_torch import native

    from pegasus_tpu_torch.native import wire_client
    from pegasus_tpu_torch.ops import fused_mesh

    def wire_build() -> float:
        t = time.perf_counter()
        wire_client.load()
        return time.perf_counter() - t

    with ThreadPoolExecutor(5) as pool:
        cuda_build = pool.submit(fused_scan.build, force=True)
        compact_build = pool.submit(fused_compaction.build, force=True)
        mesh_build = pool.submit(fused_mesh.build, force=True)
        native_build = pool.submit(native.build, force=True)
        wire_future = pool.submit(wire_build)
        build_s, build_log = cuda_build.result()
        compact_s, compact_log = compact_build.result()
        mesh_s, mesh_log = mesh_build.result()
        native_s, native_log = native_build.result()
        wire_s = wire_future.result()
    log(f"build: csrc/scan_predicate.cu -> sm_90a in {build_s:.2f} s; "
        f"csrc/compaction_filter.cu -> sm_90a in {compact_s:.2f} s; "
        f"csrc/mesh_step.cu -> sm_90a in {mesh_s:.2f} s; "
        f"native/packer.cpp -> g++ -O3 in {native_s:.2f} s; "
        f"native/wire_client.cpp -> g++ -O2 (when missing or stale) in "
        f"{wire_s:.2f} s")
    print((build_log + compact_log + mesh_log + native_log).strip(),
          file=sys.stderr, flush=True)
    if args.resident_only:
        t0 = time.perf_counter()
        with store_flags(NONE_STORE):
            resident = run_resident(device, time_window(device), card=card)
        torch.cuda.synchronize()
        log(f"resident: phase 10 done in {time.perf_counter() - t0:.1f} s")
        log(json.dumps({"resident": {"launches": resident["launches"],
                                     "mesh": resident["mesh"]}}))
        return 0
    if args.replicated_only:
        t0 = time.perf_counter()
        with store_flags(NONE_STORE):
            replicated = run_replicated(device, card=card)
        torch.cuda.synchronize()
        log(f"replicated: done in {time.perf_counter() - t0:.1f} s")
        log(json.dumps({"replicated": replicated}))
        return 0
    if args.cluster_only:
        t0 = time.perf_counter()
        cluster, cure = run_phase12(device, card)
        log(f"cluster: phase 12 done in {time.perf_counter() - t0:.1f} s")
        log(json.dumps({"cluster": cluster, "cure": cure}))
        return 0
    if args.ops_only:
        t0 = time.perf_counter()
        services = run_phase13(device, card, cut=False)
        log(f"services: phase 13 done in {time.perf_counter() - t0:.1f} s")
        log(json.dumps({"services": services}))
        return 0
    if args.onebox_only:
        t0 = time.perf_counter()
        onebox = run_phase14(device, card, cut=False)
        log(f"onebox: phase 14 done in {time.perf_counter() - t0:.1f} s")
        log(json.dumps({"onebox": onebox}))
        return 0

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
    t0 = time.perf_counter()
    cmp_multi = check_tables_multi(device)
    log(f"flavour axis vs plain: {cmp_multi['compared']} tables "
        f"bit-identical (max |diff| {cmp_multi['max_abs_err']}) in "
        f"{time.perf_counter() - t0:.1f} s (CUT: {max(MULTI_KS)} flavours "
        f"at key width 32 only, {MULTI_K_WIDE} at the wider keys)")
    timings_multi = time_tables_multi(device)
    for t in timings_multi:
        log(f"scan_predicate_multi {t['shape']} on {card}: device time "
            f"kernel {t['ms'] * 1e3} us, plain {t['plain_ms'] * 1e3} us "
            f"(profiler); per call with the host kernel "
            f"{t['call_ms'] * 1e3} us, plain {t['plain_call_ms'] * 1e3} us "
            f"(CUDA events); bound {t['bound_ms'] * 1e3} us "
            f"({t['bound_by']}), {100 * t['share']}% of it")
    t0 = time.perf_counter()
    cmp_keyhash = check_key_hash(device)
    log(f"key-hash instance vs plain: {cmp_keyhash['compared']} tables "
        f"bit-identical (max |diff| {cmp_keyhash['max_abs_err']}), hash_lo "
        f"dropped from every block and from every other block, both "
        f"entries, K in {{32, 64, 256}}, {cmp_keyhash['launches']} launches "
        f"of the instance, in {time.perf_counter() - t0:.1f} s")
    tk = time_key_hash(device)
    log(f"scan_predicate key-hash instance {tk['shape']} on {card}: device "
        f"time kernel {tk['ms'] * 1e3} us, plain {tk['plain_ms'] * 1e3} us "
        f"(profiler); per call with the host kernel {tk['call_ms'] * 1e3} "
        f"us, plain {tk['plain_call_ms'] * 1e3} us (CUDA events); bound "
        f"{tk['bound_ms'] * 1e3} us ({tk['bound_by']}), "
        f"{100 * tk['share']}% of it")
    t0 = time.perf_counter()
    cmp_compact = check_compaction(device)
    log(f"compaction kernel vs plain: {cmp_compact['compared']} chunks "
        f"bit-identical (max |diff| {cmp_compact['max_abs_err']}) in "
        f"{time.perf_counter() - t0:.1f} s")
    timings_compact = time_compaction(device)
    for t in timings_compact:
        log(f"compaction_filter {t['shape']} on {card}: device time "
            f"kernel {t['ms'] * 1e3} us ({t['ms_read_flushed'] * 1e3} us "
            f"after a read-only flush), plain {t['plain_ms'] * 1e3} us "
            f"(profiler); per call with the host kernel "
            f"{t['call_ms'] * 1e3} us, plain {t['plain_call_ms'] * 1e3} us "
            f"(CUDA events); bound {t['bound_ms'] * 1e3} us "
            f"({t['bound_by']}), {100 * t['share']}% of it; "
            f"{t['launches_per_call']} launch a call")
    tc = timings_compact[0]
    log(f"phase 3 in {time.perf_counter() - t_start:.1f} s since the start")
    fused_compaction.LAUNCHES["compaction"] = 0

    # 4. the slice
    if args.records != FULL_RECORDS:
        log(f"slice: CUT to {args.records} records of partition {PIDX} "
            f"(the configuration loads {FULL_RECORDS})")
    t0 = time.perf_counter()
    with store_flags(NONE_STORE):
        launches = run_slice(device, args.records, card=card)
    torch.cuda.synchronize()
    log(f"slice: done in {time.perf_counter() - t0:.1f} s; kernel launches "
        f"static {launches['static']}, now {launches['now']}")

    # 5. the batched cross-partition scan path
    t0 = time.perf_counter()
    with store_flags(NONE_STORE):
        batched = run_batched(device, card=card)
    torch.cuda.synchronize()
    log(f"batched: done in {time.perf_counter() - t0:.1f} s; kernel "
        f"launches {batched}")

    # 6. the point-get path at the default store flags
    t0 = time.perf_counter()
    point = run_point_batch(device, n_records=POINT_RUN_RECORDS,
                            card=card)["launches"]
    torch.cuda.synchronize()
    log(f"point: done in {time.perf_counter() - t0:.1f} s; kernel "
        f"launches {point}")
    # the merge-path compactions of phases 4-6 went through the
    # compaction-filter kernel too
    merge_launches = fused_compaction.LAUNCHES["compaction"]
    log(f"compaction_filter launches of phases 4-6 (merge-path "
        f"compactions): {merge_launches}")
    log(f"chip_smoke: phases 1-6 in {time.perf_counter() - t_start:.1f} s")

    # 7. bulk manual compaction, BASELINE configs #3 and #4
    t0 = time.perf_counter()
    log(f"compact: CUT to {args.compact_gb} GB a pass (BASELINE config "
        f"#3's table is {COMPACT_FULL_GB} GB)")
    compact = run_compaction(device, gb=args.compact_gb, card=card)
    log(f"compact: done in {time.perf_counter() - t0:.1f} s")
    log(f"chip_smoke: phases 1-7 in {time.perf_counter() - t_start:.1f} s")

    # 8. the in-process client: geo radius search (BASELINE config #5),
    # then the atomic writes and a split
    t0 = time.perf_counter()
    with store_flags(NONE_STORE):
        geo = run_geo(device, card=card)
    torch.cuda.synchronize()
    log(f"geo: done in {time.perf_counter() - t0:.1f} s; scan kernel "
        f"launches {geo['launches']}")
    t0 = time.perf_counter()
    log(f"client: CUT to {CLIENT_RUN_HASHKEYS * 10} records and "
        f"{CLIENT_RUN_OPS} ops (the phase's {CLIENT_HASHKEYS * 10} and "
        f"{CLIENT_OPS})")
    with store_flags(NONE_STORE):
        client = run_client_split(device, n_hashkeys=CLIENT_RUN_HASHKEYS,
                                  n_ops=CLIENT_RUN_OPS, card=card)
    torch.cuda.synchronize()
    client_scan = {k: sum(step[k] for step in client["launches"].values())
                   for k in ("static", "now", "multi")}
    client_compact = sum(step["compaction"]
                         for step in client["launches"].values())
    log(f"client: done in {time.perf_counter() - t0:.1f} s; seconds "
        f"{client['secs']}; scan kernel launches {client_scan}, "
        f"compaction kernel launches {client_compact}")

    log(f"chip_smoke: phases 1-8 in {time.perf_counter() - t_start:.1f} s")

    # 9. integrity on the card: an encrypted store, its plaintext twin, a
    # PGT1 copy through the key-hash instance, the scrubber
    t0 = time.perf_counter()
    with store_flags(NONE_STORE):
        integrity = run_integrity(device, card=card)
    torch.cuda.synchronize()
    keyhash_launches = integrity["pgt1"]["launches"]["keyhash"]
    integrity_scan = {k: sum(integrity[s]["launches"][k]
                             for s in ("encrypted", "plain", "pgt1"))
                      for k in ("static", "now", "multi")}
    log(f"integrity: done in {time.perf_counter() - t0:.1f} s; scan kernel "
        f"launches {integrity_scan}, of them key-hash instance "
        f"{keyhash_launches}")

    log(f"chip_smoke: phases 1-9 in {time.perf_counter() - t_start:.1f} s")

    # 10. the resident image: BASELINE config #2's whole table on the card
    t0 = time.perf_counter()
    with store_flags(NONE_STORE):
        resident = run_resident(device, win, card=card)
    torch.cuda.synchronize()
    log(f"resident: done in {time.perf_counter() - t0:.1f} s")

    log(f"chip_smoke: phases 1-10 in {time.perf_counter() - t_start:.1f} s")

    # 11. replicated writes: PacificA groups of three replicas on the card
    t0 = time.perf_counter()
    log(f"replicated: CUT to {REPL_RUN_OPS} YCSB-E ops and a probe of "
        f"{REPL_RUN_PROBE} scans (the phase's {REPL_OPS} and {REPL_PROBE}; "
        f"--replicated-only runs it uncut)")
    with store_flags(NONE_STORE):
        replicated = run_replicated(device, n_hashkeys=REPL_RUN_HASHKEYS,
                                    n_ops=REPL_RUN_OPS,
                                    n_probe=REPL_RUN_PROBE, card=card)
    torch.cuda.synchronize()
    repl_scan = replicated["scan"]
    log(f"replicated: done in {time.perf_counter() - t0:.1f} s; scan kernel "
        f"launches {repl_scan}, compaction kernel launches "
        f"{replicated['compaction']}")

    log(f"chip_smoke: phases 1-11 in {time.perf_counter() - t_start:.1f} s")

    # 12. BASELINE config #2 through the meta and the replica stub, then
    # the meta's cure of a silenced node
    t0 = time.perf_counter()
    cluster, cure = run_phase12(device, card, cut=True)
    cl_scan = {k: cluster["scan"][k] + cure["scan"][k]
               for k in ("static", "now", "multi")}
    cl_compact = cluster["compaction"] + cure["compaction"]
    log(f"cluster: phase 12 done in {time.perf_counter() - t0:.1f} s; scan "
        f"kernel launches {cl_scan}, compaction kernel launches "
        f"{cl_compact}")

    log(f"chip_smoke: phases 1-12 in {time.perf_counter() - t_start:.1f} s")

    # 13. bulk load, backup and restore, duplication through the meta's
    # services on SimClusters
    t0 = time.perf_counter()
    services = run_phase13(device, card, cut=True)
    sv_scan = services["scan"]
    log(f"services: phase 13 done in {time.perf_counter() - t0:.1f} s; "
        f"scan kernel launches {sv_scan}, compaction kernel launches "
        f"{services['compaction']}")

    log(f"chip_smoke: phases 1-13 in {time.perf_counter() - t_start:.1f} s")

    # 14. BASELINE config #2 served by node processes over TCP
    t0 = time.perf_counter()
    onebox = run_phase14(device, card, cut=True)
    ob_scan = onebox["scan"]
    log(f"onebox: phase 14 done in {time.perf_counter() - t0:.1f} s; scan "
        f"kernel launches {ob_scan}, compaction kernel launches "
        f"{onebox['compaction']} (read from the replica processes)")

    # summary
    log(f"chip_smoke: phases 1-14 in {time.perf_counter() - t_start:.1f} s")
    rl = resident["launches"]
    rm = resident["mesh"]["launches"]
    rt = resident["times"]
    t = timings[LARGE_SHAPE]
    tm = timings_multi[MULTI_LARGE_SHAPE]
    log(json.dumps({"kernels": [{
        "name": "scan_predicate", "route": "cuda",
        "source": "pegasus_tpu_torch/csrc/scan_predicate.cu",
        "replaces": "pegasus_tpu/ops/pallas_scan.py:43",
        "launches": (launches["static"] + launches["now"]
                     + batched["static"] + point["static"] + point["now"]
                     + geo["launches"]["static"] + client_scan["static"]
                     + client_scan["now"] + integrity_scan["static"]
                     + rl["static"] + rl["now"] + rm["static"]
                     + repl_scan["static"] + repl_scan["now"]
                     + cl_scan["static"] + cl_scan["now"]
                     + sv_scan["static"] + sv_scan["now"]
                     + ob_scan["static"] + ob_scan["now"]),
        "max_abs_err": cmp["max_abs_err"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "call_ms": t["call_ms"], "shape": t["shape"],
        "launches_by_path": {"slice": launches["static"] + launches["now"],
                             "batched": batched["static"],
                             "point": point["static"] + point["now"],
                             "geo": geo["launches"]["static"],
                             "client": client_scan["static"]
                             + client_scan["now"],
                             "integrity": integrity_scan["static"],
                             "resident": rl["static"] + rl["now"],
                             "resident_mesh": rm["static"],
                             "replicated": repl_scan["static"]
                             + repl_scan["now"],
                             "cluster": cl_scan["static"]
                             + cl_scan["now"],
                             "services": sv_scan["static"]
                             + sv_scan["now"],
                             "onebox": ob_scan["static"]
                             + ob_scan["now"]}}, {
        "name": "scan_predicate_multi", "route": "cuda",
        "source": "pegasus_tpu_torch/csrc/scan_predicate.cu",
        "replaces": "pegasus_tpu/ops/predicates.py:539",
        "launches": (batched["multi"] + point["multi"]
                     + geo["launches"]["multi"] + client_scan["multi"]
                     + integrity_scan["multi"] + rl["multi"]
                     + repl_scan["multi"] + cl_scan["multi"]
                     + sv_scan["multi"] + ob_scan["multi"]),
        "max_abs_err": cmp_multi["max_abs_err"], "ms": tm["ms"],
        "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
        "bound_by": tm["bound_by"], "library_ms": None,
        "call_ms": tm["call_ms"], "shape": tm["shape"]}, {
        "name": "scan_predicate_keyhash", "route": "cuda",
        "source": "pegasus_tpu_torch/csrc/scan_predicate.cu",
        "replaces": "pegasus_tpu/ops/device_crc.py:65",
        "launches": keyhash_launches,
        "max_abs_err": cmp_keyhash["max_abs_err"], "ms": tk["ms"],
        "plain_ms": tk["plain_ms"], "bound_ms": tk["bound_ms"],
        "bound_by": tk["bound_by"], "library_ms": None,
        "call_ms": tk["call_ms"], "shape": tk["shape"],
        "launches_by_path": {"integrity_pgt1": keyhash_launches}}, {
        "name": "compaction_filter", "route": "cuda",
        "source": "pegasus_tpu_torch/csrc/compaction_filter.cu",
        "replaces": "pegasus_tpu/ops/compaction.py:110",
        "launches": (sum(r["launches"] for r in compact.values())
                     + client_compact + rl["compaction"] + rm["compaction"]
                     + replicated["compaction"] + cl_compact
                     + services["compaction"] + onebox["compaction"]),
        "launches_by_path": {"compaction": sum(r["launches"]
                                               for r in compact.values()),
                             "client": client_compact,
                             "resident": rl["compaction"],
                             "resident_mesh": rm["compaction"],
                             "replicated": replicated["compaction"],
                             "cluster": cl_compact,
                             "services": services["compaction"],
                             "onebox": onebox["compaction"]},
        "launches_by_pass": {p: r["launches"] for p, r in compact.items()},
        "launches_client_split": client_compact,
        "launches_resident": rl["compaction"],
        "launches_merge_path": merge_launches,
        "max_abs_err": cmp_compact["max_abs_err"], "ms": tc["ms"],
        "plain_ms": tc["plain_ms"], "bound_ms": tc["bound_ms"],
        "bound_by": tc["bound_by"], "library_ms": None,
        "call_ms": tc["call_ms"], "shape": tc["shape"]}, {
        "name": "mesh_step", "route": "cuda",
        "source": "pegasus_tpu_torch/csrc/mesh_step.cu",
        "replaces": "pegasus_tpu/parallel/mesh_resident.py:119",
        "launches": rl["mesh_step"] + rm["mesh_step"],
        "launches_by_path": {"resident": rl["mesh_step"],
                             "resident_mesh": rm["mesh_step"]},
        "launches_by_card": {
            "resident_mesh": resident["mesh"]["launches_by_card"]},
        "max_abs_err": resident["check_mesh_step"]["max_abs_err"],
        "ms": rt["wave"]["ms"], "plain_ms": rt["wave"]["plain_ms"],
        "bound_ms": rt["wave"]["bound_ms"],
        "bound_by": rt["wave"]["bound_by"], "library_ms": None,
        "call_ms": rt["wave"]["call_ms"], "shape": rt["wave"]["shape"],
        "instances": {name: {k: rt[name][k] for k in (
            "ms", "plain_ms", "bound_ms", "call_ms", "shape")}
            for name in ("extra", "sum")}}, {
        "name": "compaction_filter_slot_gate", "route": "cuda",
        "source": "pegasus_tpu_torch/csrc/compaction_filter.cu",
        "kernel": rt["slot_gate"]["kernel"],
        "replaces": "pegasus_tpu/ops/compaction.py:178",
        "launches": rl["slot_gate_columns"] + rm["slot_gate_columns"],
        "launches_by_path": {"resident": rl["slot_gate_columns"],
                             "resident_mesh": rm["slot_gate_columns"]},
        "launches_gated_rules": (rl["slot_gate"] - rl["slot_gate_columns"]
                                 + rm["slot_gate"]
                                 - rm["slot_gate_columns"]),
        "max_abs_err": resident["check_slot_gate"]["max_abs_err"],
        "ms": rt["slot_gate"]["ms"], "plain_ms": rt["slot_gate"]["plain_ms"],
        "bound_ms": rt["slot_gate"]["bound_ms"],
        "bound_by": rt["slot_gate"]["bound_by"], "library_ms": None,
        "call_ms": rt["slot_gate"]["call_ms"],
        "row_a_thread_ms": rt["slot_gate"]["row_a_thread_ms"],
        "shape": rt["slot_gate"]["shape"]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
