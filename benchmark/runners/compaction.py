"""Runner of a compaction cell: BASELINE config #3's sweep of expired
data, every partition's manual compaction at once under the TTL filter,
timed as GB/s of input.

Set-up draws the configuration's records from the seed
(`reference/compaction.TtlTable`) and stages them once as each
partition's L1 runs, written by the port's SST writer, then runs the
traffic's warm-up passes untimed. A pass hard-links the staged SSTs
into a fresh directory a partition (no SST is rewritten), opens a
standalone `PartitionServer` on each and calls every server's
`manual_compact()` at once on a pool of threads; only those calls are
timed. Passes run until their summed seconds reach `--seconds`. After
each pass its output is read back and judged against the reference,
and deleted; staging and judging lie outside the timed calls.

`compact_gbps` is the staged SST bytes of the timed passes over their
summed seconds. A traced run wraps each timed pass in the device trace
and records the compaction filter's launches and their shapes.
"""

from __future__ import annotations

import contextlib
import gc
import inspect
import json
import os
import shutil
import tempfile
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

from benchmark.core.harness import (
    PEGASUS_EPOCH,
    ForbiddenModules,
    Run,
    describe,
    forbidden_loaded,
    log,
    memory_peak,
    reader,
    sync,
)
from benchmark.reference.compaction import (
    CHECKS,
    Judge,
    Output,
    TtlTable,
    survivors,
)


def run_cell(args, t_start: float, device, parts: dict, overrides=None,
             plant=None, repo: str = None) -> dict:
    """One run of a compaction cell; the result's dict, "checks" last.
    `overrides` replace configuration keys (the tests' small stores);
    `plant(compactor)` breaks the timed path, or puts the control in the
    program's place, after the warm-up."""
    from benchmark.core import probe
    from benchmark.core.system import build_kernels, set_store_flags

    config = dict(parts["config"], **(overrides or {}))
    traffic = parts["traffic"]
    bench_dir = os.path.join(repo, "benchmark")
    split = {"imports_s": time.perf_counter() - t_start}
    split["build_s"] = build_kernels(device)
    set_store_flags(config["store"])
    root = tempfile.mkdtemp(prefix="pegasus-bench-compact-")
    compactor = None
    try:
        t0 = time.perf_counter()
        table = TtlTable(config, args.seed)
        dead_ts = int(time.time()) - PEGASUS_EPOCH \
            - int(config["expired_age_s"])
        compactor = Compactor(table, config, device, root,
                              int(traffic["partitions_at_once"]))
        compactor.stage(dead_ts)
        split["stage_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        written = compactor.staged_bytes
        for _ in range(int(traffic["warmup_passes"])):
            servers = compactor.open()
            errors = compactor.compact(servers)
            written += compactor.output_bytes(servers)
            compactor.close(servers)
            compactor.drop_pass()
            if any(errors):
                raise RuntimeError(f"warm-up pass failed: {errors}")
        sync(device)
        split["warmup_s"] = time.perf_counter() - t0
        if plant is not None:
            plant(compactor)
        run = Run()
        run.bytes_in = 0
        run.setup_s = time.perf_counter() - t_start
        log("setup split: " + json.dumps(split))

        from pegasus_tpu_torch.ops import fused_compaction

        faults = dict.fromkeys(CHECKS, 0)
        stalls = dict.fromkeys(("read", "filter", "write"), 0.0)
        launches: dict = {}
        traces: list = []
        attempted = failed = 0
        judge_s = 0.0
        judge = Judge(compactor.records)
        pass_s: list = []
        peak_output = 0
        while run.window_s < args.seconds:
            servers = compactor.open()
            run.bytes_in += compactor.staged_bytes
            # the last pass's deletes and the collector's work settle
            # before the timed calls, not inside them
            os.sync()
            gc.collect()
            before = dict(fused_compaction.LAUNCHES)
            with contextlib.ExitStack() as stack:
                if args.trace:
                    shapes = stack.enter_context(FilterLaunches())
                    trace = stack.enter_context(probe.DeviceTrace(device))
                t0 = time.perf_counter()
                with (trace.span("bench.compact") if args.trace
                      else contextlib.nullcontext()):
                    errors = compactor.compact(servers)
                sync(device)
                pass_s.append(time.perf_counter() - t0)
                run.window_s += pass_s[-1]
            if args.trace:
                run.launch_shapes += shapes.shapes
                run.trace_window_s += trace.window_s
                traces.append(trace.summary)
            for k, v in fused_compaction.LAUNCHES.items():
                launches[k] = launches.get(k, 0) + v - before.get(k, 0)
            for srv in servers:
                pipe = getattr(srv.engine, "last_pipeline", None)
                for stage in stalls:
                    stalls[stage] += getattr(pipe, f"{stage}_stall_ms", 0)
            t0 = time.perf_counter()
            out_bytes = compactor.output_bytes(servers)
            peak_output = max(peak_output, out_bytes)
            written += out_bytes
            outputs = compactor.outputs(servers)
            compactor.close(servers)
            bad = [p for p, (err, (_out, published)) in
                   enumerate(zip(errors, outputs))
                   if err is not None or not published]
            if bad:
                log(f"pass {len(pass_s)}: partitions {bad} failed or did "
                    f"not publish: {[e for e in errors if e]}")
            attempted += len(servers)
            failed += len(bad)
            faults["passes_failed"] += int(bool(bad))
            # a partition a thread: the judge's numpy work runs in parallel
            for found in compactor.pool.map(
                    lambda p: judge.partition(p, outputs[p][0]),
                    range(len(outputs))):
                for name, n in found.items():
                    faults[name] += n
            compactor.drop_pass()
            judge_s += time.perf_counter() - t0
        run.counters = {"compaction_launches": launches,
                        "compact_stall_ms": stalls}
        run.trace = merge_summaries(traces)
        peak = memory_peak(device)
        device_info = describe(device, peak)
        log(f"{len(pass_s)} passes of {compactor.staged_bytes} B in "
            f"{run.window_s} s, seconds a pass {json.dumps(pass_s)}; the "
            f"reference judged them in {judge_s} s; on disk "
            f"{compactor.staged_bytes} B staged and at most {peak_output} B "
            f"of a pass's output beside it; SST bytes written {written}")
    finally:
        if compactor is not None:
            compactor.shutdown()
        shutil.rmtree(root, ignore_errors=True)

    checks = {name: {"value": faults[name], "limit": 0} for name in CHECKS}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    group = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in parts[group]:
        value = reader(m["name"], bench_dir)(run)
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


class Compactor:
    """The system under test: the staged store, and a pass's partition
    servers over a fresh copy of it."""

    def __init__(self, table: TtlTable, config: dict, device, root: str,
                 threads: int) -> None:
        self.table = table
        self.config = config
        self.device = device
        self.staged = os.path.join(root, "staged")
        self.pass_dir = os.path.join(root, "pass")
        self.pool = ThreadPoolExecutor(threads)
        self.records: list = []
        self.dead_ts = 0
        self.staged_bytes = 0
        self._inputs: list = []
        # what a planted fault patched, put back when the run ends
        self.undo: list = []

    def stage(self, dead_ts: int) -> None:
        """Every partition's records as L1 runs of L1_RUN_CAPACITY records
        in blocks of `block_records`, one directory a partition; the
        expired ones with the expire time `dead_ts`."""
        self.dead_ts = dead_ts
        parts = range(self.table.partitions)
        self.records = list(self.pool.map(self.table.partition, parts))
        self._inputs = list(self.pool.map(
            lambda p: stage_partition(
                os.path.join(self.staged, f"p{p}", "sst"), self.records[p],
                dead_ts, int(self.config["block_records"])), parts))
        self.staged_bytes = sum(
            os.path.getsize(os.path.join(self.staged, f"p{p}", "sst", n))
            for p in parts for n in self._inputs[p])

    def open(self) -> list:
        """A fresh copy of the staged store (hard links of its SSTs, a copy
        of each manifest) and a standalone server on each partition."""
        from pegasus_tpu_torch.server.partition_server import PartitionServer

        servers = []
        for p in range(self.table.partitions):
            src = os.path.join(self.staged, f"p{p}", "sst")
            dst = os.path.join(self.pass_dir, f"p{p}", "sst")
            os.makedirs(dst)
            for name in self._inputs[p]:
                os.link(os.path.join(src, name), os.path.join(dst, name))
            shutil.copy(os.path.join(src, "MANIFEST.json"), dst)
            servers.append(PartitionServer(
                os.path.dirname(dst), int(self.config["app_id"]), p,
                self.table.partitions, device=self.device))
        return servers

    def compact_one(self, srv) -> None:
        srv.manual_compact()

    def compact(self, servers: list) -> list:
        """Every server's manual compaction at once; an error or None a
        partition."""
        def one(srv):
            try:
                self.compact_one(srv)
            except Exception:  # noqa: BLE001 - judged as a failed pass
                return traceback.format_exc()
            return None

        return list(self.pool.map(one, servers))

    def outputs(self, servers: list) -> list:
        """(rows, published) a partition: every row of its L1 runs in run
        and block order, and whether the compaction published new runs in
        place of every input run, with no L0 run or memtable row left."""
        return list(self.pool.map(self.output, range(len(servers)),
                                  servers))

    def output(self, p: int, srv) -> tuple:
        """(rows, published) of partition `p`, as `outputs` gives them."""
        import numpy as np

        lsm = srv.engine.lsm
        names = {os.path.basename(r.path) for r in lsm.l1_runs}
        published = (bool(names) and not names & set(self._inputs[p])
                     and not lsm.l0 and len(lsm.memtable) == 0)
        blocks = [run.read_block(i) for run in lsm.l1_runs
                  for i in range(len(run.blocks))]
        width = blocks[0].keys.shape[1] if blocks else self.table.key_width
        offs, heaps, base = [np.zeros(1, dtype=np.int64)], [], 0
        for b in blocks:
            o = np.asarray(b.value_offs, dtype=np.int64)
            offs.append(o[1:] - o[0] + base)
            heaps.append(np.asarray(b.value_heap, dtype=np.uint8)
                         [o[0]:o[-1]])
            base += int(o[-1] - o[0])
        return (Output(
            np.concatenate([np.zeros((0, width), dtype=np.uint8)]
                           + [b.keys for b in blocks]),
            np.concatenate([np.zeros(0, dtype=np.int32)]
                           + [b.key_len for b in blocks]),
            np.concatenate([np.zeros(0, dtype=np.uint32)]
                           + [b.expire_ts for b in blocks]),
            np.concatenate(offs),
            np.concatenate([np.zeros(0, dtype=np.uint8)] + heaps)),
            published)

    def output_bytes(self, servers: list) -> int:
        """The bytes of the runs a pass wrote."""
        return sum(os.path.getsize(r.path)
                   for p, srv in enumerate(servers)
                   for r in srv.engine.lsm.l1_runs
                   if os.path.basename(r.path) not in self._inputs[p])

    def close(self, servers: list) -> None:
        for srv in servers:
            srv.close()

    def drop_pass(self) -> None:
        shutil.rmtree(self.pass_dir)

    def shutdown(self) -> None:
        self.pool.shutdown(wait=True)
        for undo in reversed(self.undo):
            undo()


def stage_partition(sst: str, rec, dead_ts: int, block_records: int) -> list:
    """One partition's records written by the port's SST writer as L1
    runs (bench.py:782 build_compact_store's layout) with their manifest;
    the run files' names."""
    import numpy as np

    from pegasus_tpu_torch.ops.record_block import hash_lo_column
    from pegasus_tpu_torch.storage.lsm import L1_RUN_CAPACITY
    from pegasus_tpu_torch.storage.sstable import SSTableWriter

    os.makedirs(sst)
    meta = {"last_flushed_decree": 1, "data_version": 1}
    names, writer, in_run = [], None, 0
    vb = rec.values.shape[1]
    ets = np.where(rec.expired, np.uint32(dead_ts), np.uint32(0))
    for lo in range(0, rec.keys.shape[0], block_records):
        hi = min(lo + block_records, rec.keys.shape[0])
        keys, key_len = rec.keys[lo:hi], rec.key_len[lo:hi]
        if writer is None:
            writer = SSTableWriter(
                os.path.join(sst, f"l1-{len(names)}.sst"), meta=meta,
                async_io=True, block_capacity=block_records)
        writer.add_block_columnar(
            keys, key_len, ets[lo:hi], hash_lo_column(keys, key_len),
            np.zeros(hi - lo, dtype=np.uint8),
            np.arange(hi - lo + 1, dtype=np.uint32) * vb,
            rec.values[lo:hi].tobytes())
        in_run += hi - lo
        if in_run >= L1_RUN_CAPACITY:
            writer.finish()
            names.append(os.path.basename(writer.path))
            writer, in_run = None, 0
    if writer is not None:
        writer.finish()
        names.append(os.path.basename(writer.path))
    with open(os.path.join(sst, "MANIFEST.json"), "w") as f:
        json.dump({"seq": len(names), "l1": names}, f)
    return names


class FilterLaunches:
    """The compaction filter's launches in a traced pass, with the shape
    each one had: `ops/fused_compaction.compaction_filter` and
    `slot_gate_filter`, which the callers look up on the module at each
    call, wrapped for the pass. Each shape is roofline/compaction.
    filter_bytes's arguments."""

    def __init__(self) -> None:
        self.shapes: list = []

    def __enter__(self):
        from pegasus_tpu_torch.ops import fused_compaction as fc

        self._saved = (fc.compaction_filter, fc.slot_gate_filter)
        filt, gate = self._saved
        filt_sig, gate_sig = inspect.signature(filt), inspect.signature(gate)

        def compaction_filter(*a, **kw):
            out = filt(*a, **kw)
            b = filt_sig.bind(*a, **kw)
            b.apply_defaults()
            x = b.arguments
            rows = int(x["expire_ts"].shape[0])
            if rows:
                hash_keys = x["validate_hash"] and x["hash_lo"] is None
                slots = x["slot_allowed"]
                self.shapes.append({
                    "rows": rows,
                    "k": (32 if x["keys"] is None
                          else int(x["keys"].shape[1])),
                    "keys": hash_keys or reads_keys(x["operations"]),
                    "hash_lo": x["validate_hash"] and not hash_keys,
                    "pidx_col": (slots is None
                                 and hasattr(x["pidx"], "shape")),
                    "pack": x["pack"], "want_ets": x["want_ets"],
                    "slots": 0 if slots is None else int(slots.shape[0])})
            return out

        def slot_gate_filter(*a, **kw):
            out = gate(*a, **kw)
            b = gate_sig.bind(*a, **kw)
            b.apply_defaults()
            x = b.arguments
            rows = int(x["expire_ts"].shape[0])
            if rows:
                self.shapes.append({
                    "rows": rows, "k": 32, "keys": False, "hash_lo": True,
                    "pidx_col": False, "pack": True,
                    "want_ets": x["ets"] is not None,
                    "slots": int(x["slot_allowed"].shape[0])})
            return out

        fc.compaction_filter = compaction_filter
        fc.slot_gate_filter = slot_gate_filter
        return self

    def __exit__(self, *exc) -> None:
        from pegasus_tpu_torch.ops import fused_compaction as fc

        fc.compaction_filter, fc.slot_gate_filter = self._saved


def reads_keys(operations) -> bool:
    """Whether a parsed ruleset has a pattern rule, which reads the key
    rows (a ttl_range rule and an empty pattern read none)."""
    return any(r.kind != "ttl_range" and r.filter.raw
               for op in operations or () for r in op.rules)


def merge_summaries(summaries: list) -> dict:
    """probe.summarize's results of the traced passes as one: seconds
    added by device op, the ten longest idle gaps of all the passes."""
    summaries = [s for s in summaries if s]
    if not summaries:
        return {}
    by_name: dict = {}
    for s in summaries:
        for name, secs in s["device_s_by_name"].items():
            by_name[name] = by_name.get(name, 0.0) + secs
    gaps = sorted((g for s in summaries for g in s["idle_gaps"]),
                  key=lambda g: -g[1])
    return {"busy_s": sum(s["busy_s"] for s in summaries),
            "device_s_by_name": by_name,
            "device_ops": sorted(([n, s] for n, s in by_name.items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": gaps[:10],
            "device_spans": sum(s["device_spans"] for s in summaries)}


# ---- faults planted under the timed path, and the control ---------------
#
# Each takes the Compactor after the warm-up and breaks the pass beneath
# it; what it patches is put back when the run ends (`Compactor.undo`).


def _patch(compactor, owner, name: str, new) -> None:
    old = getattr(owner, name)
    setattr(owner, name, new)
    compactor.undo.append(lambda: setattr(owner, name, old))


def plant_keep_every_row(compactor) -> None:
    """The filter keeps every row: its drop mask comes back all clear,
    from the kernel on the card and from the plain version on the CPU."""
    from pegasus_tpu_torch.ops import compaction, fused_compaction

    filt, plain = fused_compaction.compaction_filter, \
        compaction.eval_block_plain

    def kernel(*a, **kw):
        drop, ets = filt(*a, **kw)
        return drop.zero_(), ets

    def plain_version(*a, **kw):
        out = plain(*a, **kw)
        return (out[0].zero_(),) + tuple(out[1:])

    _patch(compactor, fused_compaction, "compaction_filter", kernel)
    _patch(compactor, compaction, "eval_block_plain", plain_version)


def plant_drop_one_live_row(compactor) -> None:
    """The rewrite leaves out the first row the filter kept, once."""
    from pegasus_tpu_torch.storage import lsm

    survivor_mask = lsm.survivor_mask
    lock, done = threading.Lock(), []

    def dropping(drop, flags):
        keep = survivor_mask(drop, flags)
        with lock:
            if not done and keep.any():
                keep = keep.copy()
                keep[keep.argmax()] = False
                done.append(True)
        return keep

    _patch(compactor, lsm, "survivor_mask", dropping)


def plant_return_before_publish(compactor) -> None:
    """The rewrite reads every filtered block and returns without writing
    or publishing a run (a step that returns its state unchanged)."""
    from pegasus_tpu_torch.storage.lsm import LSMStore

    def rewrite(self, per_block, meta, *a, **kw):
        for _ in per_block:
            pass

    _patch(compactor, LSMStore, "bulk_compact_rewrite", rewrite)


def plant_skip_half(compactor) -> None:
    """Half of the partitions are left out of each pass."""
    compact_one = compactor.compact_one
    compactor.compact_one = lambda srv: (None if srv.pidx % 2
                                         else compact_one(srv))


def plant_alter_value(compactor) -> None:
    """One byte of one value is altered where the rewrite writes it."""
    from pegasus_tpu_torch.storage.sstable import SSTableWriter

    add = SSTableWriter.add_block_columnar
    lock, done = threading.Lock(), []

    def altering(self, keys, key_len, ets, hash_lo, flags, offs, heap):
        with lock:
            if not done and len(heap):
                heap = bytearray(bytes(heap))
                heap[0] ^= 0x01
                heap = bytes(heap)
                done.append(True)
        return add(self, keys, key_len, ets, hash_lo, flags, offs, heap)

    _patch(compactor, SSTableWriter, "add_block_columnar", altering)


def plant_swap_two_rows(compactor) -> None:
    """The first two rows of one rewritten block change places: every row
    is still written once and unchanged, out of key order."""
    import numpy as np

    from pegasus_tpu_torch.storage.sstable import SSTableWriter

    add = SSTableWriter.add_block_columnar
    lock, done = threading.Lock(), []

    def swapping(self, keys, key_len, ets, hash_lo, flags, offs, heap):
        with lock:
            if not done and int(keys.shape[0]) > 1:
                order = np.arange(int(keys.shape[0]))
                order[:2] = (1, 0)
                o = [int(x) for x in offs[:3]]
                heap = bytes(heap)
                heap = (heap[:o[0]] + heap[o[1]:o[2]] + heap[o[0]:o[1]]
                        + heap[o[2]:])
                offs = np.array(offs, copy=True)
                offs[1] = o[0] + o[2] - o[1]
                keys, key_len, ets, hash_lo, flags = (
                    np.asarray(x)[order]
                    for x in (keys, key_len, ets, hash_lo, flags))
                done.append(True)
        return add(self, keys, key_len, ets, hash_lo, flags, offs, heap)

    _patch(compactor, SSTableWriter, "add_block_columnar", swapping)


FAULTS = {"keep_every_row": plant_keep_every_row,
          "drop_one_live_row": plant_drop_one_live_row,
          "return_before_publish": plant_return_before_publish,
          "skip_half": plant_skip_half,
          "alter_value": plant_alter_value,
          "swap_two_rows": plant_swap_two_rows}

# the control judges TTLs an hour late: a record whose TTL passed 100 s
# before the pass stays (the configuration's TTL guarantee broken)
CONTROL_LATE_S = 3600


def plant_control(compactor) -> None:
    """The plain reference in the program's place: each pass's output is
    `reference/compaction.survivors` of the generated records, with TTLs
    judged CONTROL_LATE_S late."""
    kept: list = []

    def compact(servers):
        now = int(time.time()) - PEGASUS_EPOCH
        kept[:] = [survivors(rec, compactor.dead_ts, now, CONTROL_LATE_S)
                   for rec in compactor.records]
        return [None] * len(servers)

    compactor.compact = compact
    compactor.outputs = lambda servers: [(out, True) for out in kept]
