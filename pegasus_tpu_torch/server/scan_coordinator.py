"""Stacked and cross-partition evaluation of static scan masks.

Records of a predicate are independent, so the blocks of a scan window
go to the scan-predicate kernel as one table of up to STACK_CHUNK
resident blocks, each with its own pidx: one launch and one copy of the
bit-packed masks back to the host per table, no block copied. One
launch per block would be launch-latency bound (see
csrc/scan_predicate.cu).

`scan_multi` is the node-level batched scan path
(pegasus_tpu/server/scan_coordinator.py:50): a flush of scans spread
over the partitions a node hosts is planned per partition and flavour,
the missing masks of all of them are evaluated together (blocks of
many partitions share a table, each with its own pidx), flavours that
share filter types go through the kernel's flavour axis in one launch a
table, and one native call packs the pages of the whole flush.

Masks are static per (block, filter, partition_version): TTL expiry, the
only `now`-dependent predicate, is applied on the host from the block's
expire_ts column, so a block needs one evaluation in its lifetime and
steady-state serving launches nothing.

A wave whose blocks all lie in a table's resident image
(parallel/mesh_resident.py) is answered by the image's one round when
the placement model says that pays (`stacked_block_eval` asks it
first). Each evaluated wave is audited as in the JAX package: one drift
sample of ops/placement's prediction against the measured wall time
(server/workload.DRIFT, class `ttl` without a key filter, `rules` with
one), and on the participating ops' PerfContexts (the ambient one and
every coordinated state's) the route (`device` for the kernel on the
card, `host-XLA`, the JAX package's host-backend string, for the plain
version on the CPU), `predicted_kernel_ms` and the wave's wall time up
to its masks on the host (`measured_kernel_ms`).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np

from pegasus_tpu_torch.ops import placement
from pegasus_tpu_torch.ops.fused_scan import MAX_TABLE_BLOCKS, scan_table
from pegasus_tpu_torch.ops.predicates import (
    FT_NO_FILTER,
    FilterSpec,
    multi_static_block_predicate_submit,
    static_block_predicate,
)
from pegasus_tpu_torch.ops.record_block import next_bucket
from pegasus_tpu_torch.server.workload import DRIFT
from pegasus_tpu_torch.utils import perf_context as perf
from pegasus_tpu_torch.utils.profiler import PROFILER

STACK_CHUNK = MAX_TABLE_BLOCKS

# flavours one multi-flavour evaluation takes; more are evaluated in
# halves
MULTI_FLAVOR_MAX = 64


def scan_multi(servers_and_reqs: List[Tuple[object, list]], now: int
               ) -> List[list]:
    """[(PartitionServer, [GetScannerRequest])] -> [[ScanResponse]].

    Requests are grouped per (validate, filter) flavour, so a flush
    mixing filter patterns still takes the batched path (one plan per
    flavour, one multi-flavour evaluation); a group that cannot take it
    (a large overlay, count-only, a pushdown aggregate, an unknown
    filter type) is served per request. With the task profiler on, each
    phase is a stage of it: pegasus.scan.plan, .mask_eval, .prepare and
    .pack here, .overlay and .assemble in finish_scan_batch."""
    from pegasus_tpu_torch.server import page
    from pegasus_tpu_torch.server.partition_server import (
        SCAN_BYTES_CAP,
        _normalize_filter_key,
        header_length,
    )

    stage = PROFILER.stage
    states = []
    with stage("pegasus.scan.plan"):
        for server, reqs in servers_and_reqs:
            groups: "OrderedDict[tuple, list]" = OrderedDict()
            for i, r in enumerate(reqs):
                # the pushdown identity joins the group key (a request
                # with another value filter or an aggregate must not
                # knock its flavour off the batched path) but not the
                # plan flavour: the device mask inputs are key-side only
                fl = (bool(r.validate_partition_hash
                           and server.validate_partition_hash),
                      _normalize_filter_key(r),
                      r.pushdown.key if r.pushdown is not None else None)
                groups.setdefault(fl, []).append(i)
            sub = []
            for fl, idxs in groups.items():
                state = server.plan_scan_batch([reqs[i] for i in idxs],
                                               now=now, flavor=fl[:2])
                sub.append((idxs, state))
            states.append((server, reqs, sub))

    # misses across partitions and flavours; an evaluation group shares
    # (validate, partition_version, filter types, pattern pad widths)
    with stage("pegasus.scan.mask_eval"):
        eval_groups: Dict[tuple, dict] = {}
        for server, _reqs, sub in states:
            for _idxs, state in sub:
                if state is None or "precomputed" in state:
                    continue
                misses = server.planned_misses(state)
                if not misses:
                    continue
                hft, hfp, sft, sfp = state["filter_key"]
                gkey = (state["validate"], server.partition_version,
                        hft, sft, next_bucket(len(hfp)),
                        next_bucket(len(sfp)))
                flavor = eval_groups.setdefault(gkey, {}).setdefault(
                    state["filter_key"], [])
                for ckey, dev in misses.items():
                    flavor.append((server, state, ckey, dev))
        for (validate, pv, *_types), flavors in eval_groups.items():
            if len(flavors) == 1:
                (fkey, entries), = flavors.items()
                _eval_cross_partition(entries, validate, pv, fkey)
            else:
                _eval_cross_partition_multi(flavors, validate, pv)

    # every partition's fast-path (overlay-free) requests are packed by
    # ONE native call per flush: a 32-scan flush spread over a node's
    # partitions gives each only a few, so the call's setup is shared
    fast_all: list = []
    fast_refs: list = []
    hdr_set = set()
    with stage("pegasus.scan.prepare"):
        for server, _reqs, sub in states:
            for _idxs, state in sub:
                if state is None or "precomputed" in state:
                    continue
                fast = server.prepare_serve(state, state["cached_keep"])
                if not fast:
                    continue
                hdr_set.add(header_length(server.data_version))
                fast_refs.append((state, len(fast)))
                fast_all.extend(fast)
    if fast_all and len(hdr_set) == 1:
        with stage("pegasus.scan.pack"):
            served_all = page.serve_batch(fast_all, SCAN_BYTES_CAP,
                                          hdr_set.pop())
        if served_all is not None:
            off = 0
            for state, n in fast_refs:
                state["_served"] = served_all[off:off + n]
                off += n

    out = []
    for server, reqs, sub in states:
        resps = [None] * len(reqs)
        for idxs, state in sub:
            if state is None:
                rs = [server.on_get_scanner(reqs[i]) for i in idxs]
            elif "precomputed" in state:  # the read gate refused them
                rs = state["precomputed"]
            else:
                rs = server.finish_scan_batch(
                    state, state["cached_keep"],
                    served=state.pop("_served", None))
            for i, r in zip(idxs, rs):
                resps[i] = r
        out.append(resps)
    return out


def stacked_block_eval(blocks, validate: bool, pv: int, filter_key=None,
                       perf_ctxs=()):
    """`blocks`: [(tag, device RecordBlock, pidx)] -> yields
    (tag, static_keep bool numpy[cap]). Every table is launched before
    the first result is copied to the host; the wave is audited on the
    ambient PerfContext and on `perf_ctxs`."""
    blocks = list(blocks)
    if not blocks:
        return
    # the resident image first: when every block of the wave lives in a
    # table's image and the placement model says one round pays, that
    # round answers the wave (and audits itself under "mesh"); a decline
    # falls through unchanged
    from pegasus_tpu_torch.parallel.mesh_resident import MESH_SERVING

    if MESH_SERVING.enabled:
        served = MESH_SERVING.try_wave(blocks, validate, pv,
                                       filter_key=filter_key,
                                       perf_ctxs=perf_ctxs)
        if served is not None:
            yield from served
            return
    t0 = time.perf_counter()
    submitted = list(stacked_block_submit(blocks, validate, pv,
                                          filter_key))
    fetched = [packed.cpu().numpy() for _group, packed in submitted]
    _audit_kernel_wave(blocks, filter_key, time.perf_counter() - t0,
                       perf_ctxs)
    for (group, _packed), host in zip(submitted, fetched):
        offset = 0
        for tag, dev, _p in group:
            cap = dev.capacity
            nbytes = -(-cap // 8)
            yield tag, np.unpackbits(host[offset:offset + nbytes],
                                     count=cap).astype(bool)
            offset += nbytes


def _audit_kernel_wave(blocks, filter_key, measured_s: float,
                       perf_ctxs=()) -> None:
    """One drift sample a wave: the placement model's prediction against
    the measured wall time, process-wide and on every participating op's
    PerfContext (the ambient one and each coordinated state's: the
    cross-partition path has no single ambient op). Every op waited the
    whole wave, so each carries its full wall time. Waves without a key
    filter are the "ttl" class, filtered ones "rules"."""
    cls = ("ttl" if filter_key is None
           or (filter_key[0] == FT_NO_FILTER
               and filter_key[2] == FT_NO_FILTER) else "rules")
    batch_bytes = sum(dev.keys.numel() + 9 * dev.expire_ts.numel()
                      for _t, dev, _p in blocks)
    device = blocks[0][1].device
    predicted_s = placement.predict_kernel_seconds(cls, batch_bytes, device)
    DRIFT.note(cls, predicted_s, measured_s)
    pcs = {id(pc): pc for pc in perf_ctxs if pc is not None}
    amb = perf.current()
    if amb is not None:
        pcs[id(amb)] = amb
    if not pcs:
        return
    verdict = placement.placement_verdict(cls, device)
    for pc in pcs.values():
        pc.placement = verdict
        pc.predicted_kernel_ms += predicted_s * 1000.0
        pc.measured_kernel_ms += measured_s * 1000.0


def _state_perf_ctxs(states) -> list:
    """Distinct PerfContexts of the coordinated states (the prefresher's
    placeholder states have none)."""
    out = {}
    for state in states:
        getter = getattr(state, "get", None)
        if getter is None:
            continue
        pc = getter("perf")
        if pc is not None:
            out[id(pc)] = pc
    return list(out.values())


def stacked_block_submit(blocks, validate: bool, pv: int, filter_key=None):
    """Launch the static predicate of every table without waiting; yields
    (group, packed keep masks on the device, block after block)."""
    hft, hfp, sft, sfp = filter_key or (FT_NO_FILTER, b"",
                                        FT_NO_FILTER, b"")
    for group in _tables(blocks):
        dev = group[0][1].device
        hash_f = FilterSpec.make(hft, hfp, dev)
        sort_f = FilterSpec.make(sft, sfp, dev)
        if len(group) == 1:
            # a block alone keeps the split gate of its scalar pidx, as
            # in the reference, where only a stack carries a pidx column
            _tag, block, pidx = group[0]
            packed = static_block_predicate(
                block, hash_filter=hash_f, sort_filter=sort_f,
                validate_hash=validate, pidx=pidx, partition_version=pv,
                pack=True)
        else:
            packed = scan_table([d for _t, d, _p in group],
                                [p for _t, _d, p in group], hash_f, sort_f,
                                validate, pv)
        yield group, packed


def _tables(blocks):
    """Groups of up to STACK_CHUNK blocks sharing (key width, capacity),
    one launch each. The capacity key keeps the reference's chunks, so a
    block is evaluated alone exactly where the reference's is."""
    buckets: "OrderedDict[tuple, list]" = OrderedDict()
    for tag, dev, pidx in blocks:
        buckets.setdefault((dev.key_width, dev.capacity), []).append(
            (tag, dev, pidx))
    for group in buckets.values():
        for off in range(0, len(group), STACK_CHUNK):
            yield group[off:off + STACK_CHUNK]


def _eval_cross_partition(entries, validate: bool, pv: int,
                          filter_key=None) -> None:
    """One flavour's misses of many partitions: their blocks share
    tables, each block with its owning partition's pidx."""
    blocks = [((server, state, ckey), dev, server.pidx)
              for server, state, ckey, dev in entries]
    pcs = _state_perf_ctxs(state for _srv, state, _ck, _d in entries)
    for (server, state, ckey), keep in stacked_block_eval(
            blocks, validate, pv, filter_key=filter_key, perf_ctxs=pcs):
        state["cached_keep"][ckey] = keep
        server.store_mask(state, ckey, keep)


def _flavor_specs(fkeys, device) -> list:
    """[(hash FilterSpec, sort FilterSpec)] on `device` for the flavour
    axis. (The reference pads K to a power of two to bound XLA compile
    shapes; a kernel launch needs no such padding.)"""
    return [(FilterSpec.make(hft, hfp, device),
             FilterSpec.make(sft, sfp, device))
            for hft, hfp, sft, sfp in fkeys]


def _eval_cross_partition_multi(flavors: dict, validate: bool,
                                pv: int) -> None:
    """K filter flavours times the union of their missing blocks, one
    launch of the kernel's flavour axis per table. Every (flavour,
    block) mask that comes back for a requesting state is handed to it
    and cached; pairs beyond a flavour's own misses are cached only for
    warm flavours (a flood of one-shot patterns must not evict the warm
    masks that steady-state serving depends on)."""
    fkeys = list(flavors)
    if len(fkeys) > MULTI_FLAVOR_MAX:
        items = list(flavors.items())
        mid = len(items) // 2
        _eval_cross_partition_multi(dict(items[:mid]), validate, pv)
        _eval_cross_partition_multi(dict(items[mid:]), validate, pv)
        return

    # the union of blocks across flavours (several may miss one block)
    union: "OrderedDict[tuple, tuple]" = OrderedDict()
    wanted: Dict[tuple, list] = {}
    for fkey, entries in flavors.items():
        for server, state, ckey, dev in entries:
            ukey = (id(server), ckey)
            union.setdefault(ukey, (server, ckey, dev))
            wanted.setdefault((fkey, ukey), []).append(state)
    blocks = [((server, ckey), dev, server.pidx)
              for server, ckey, dev in union.values()]
    specs = _flavor_specs(fkeys, blocks[0][1].device)

    # every table is launched before the first copy to the host
    t0 = time.perf_counter()
    submitted = []
    for group in _tables(blocks):
        if len(group) == 1:
            _tag, dev, pidx = group[0]
            packed = multi_static_block_predicate_submit(
                dev, specs, validate, pidx, pv)
        else:
            packed = multi_static_block_predicate_submit(
                [d for _t, d, _p in group], specs, validate,
                [p for _t, _d, p in group], pv)
        submitted.append((group, packed))
    fetched = [packed.cpu().numpy() for _group, packed in submitted]
    # any filtered flavour makes the wave the "rules" class
    audit_fkey = next((fk for fk in fkeys
                       if fk[0] != FT_NO_FILTER or fk[2] != FT_NO_FILTER),
                      fkeys[0])
    _audit_kernel_wave(blocks, audit_fkey, time.perf_counter() - t0,
                       _state_perf_ctxs(st for states in wanted.values()
                                        for st in states))
    for (group, _packed), host in zip(submitted, fetched):
        offset = 0
        for (server, ckey), dev, _p in group:
            cap = dev.capacity
            nbytes = -(-cap // 8)
            masks = np.unpackbits(host[:, offset:offset + nbytes], axis=1,
                                  count=cap).astype(bool)
            offset += nbytes
            ukey = (id(server), ckey)
            for fkey, keep in zip(fkeys, masks):
                states = wanted.get((fkey, ukey))
                if states is None:
                    with server._mask_lock:
                        warm = (validate, fkey) in server._warm_flavors
                    if not warm:
                        continue
                server.store_mask_for(ckey, validate, fkey, keep,
                                      computed_pv=pv)
                for state in states or ():
                    state["cached_keep"][ckey] = keep


class MaskPrefresher:
    """Background mask warmer: keeps first-touch device work off the
    serving path.

    Static masks never expire (TTL is applied on the host), so in steady
    state it has nothing to do: it evaluates masks only for blocks that
    recently appeared (a flush or compaction rewrote the SSTs), for the
    scan flavours serving has been using (PartitionServer._warm_flavors,
    registered in planned_misses), slightly ahead of the next scan.
    Flavours age out after `horizon_s` without a scan. One per node;
    `servers` is a list of PartitionServers or a zero-argument callable
    returning one.
    """

    def __init__(self, servers, horizon_s: float = 15.0,
                 poll_s: float = 0.2):
        self._servers = servers if callable(servers) \
            else (lambda s=list(servers): s)
        self.horizon_s = horizon_s
        self.poll_s = poll_s
        self._stop = threading.Event()
        self._thread = None
        self.refreshed = 0  # masks warmed

    @property
    def servers(self):
        return self._servers()

    def start(self) -> "MaskPrefresher":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run,
                                            name="mask-prefresher",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.refresh_once()
            except Exception:  # noqa: BLE001 - a dead warmer only costs
                pass           # latency: serving evaluates its misses
            self._stop.wait(self.poll_s)

    def refresh_once(self) -> int:
        """One warm pass over hot blocks missing their static mask;
        returns the masks stored. Flavours sharing filter types and
        pattern widths warm in one multi-flavour launch a table. The
        pass is the task profiler's stage pegasus.prefresh.pass, apart
        from the serving handlers' stages."""
        with PROFILER.stage("pegasus.prefresh.pass"):
            warmed = self._warm_pass()
        self.refreshed += warmed
        return warmed

    def _warm_pass(self) -> int:
        wall = time.monotonic()
        warmed = 0
        groups: Dict[tuple, dict] = {}
        for srv in self.servers:
            for ckey, blk, validate, fkey in srv.hot_block_entries(
                    wall, self.horizon_s):
                dev = srv._device_cached_block(ckey, blk)
                hft, hfp, sft, sfp = fkey
                gkey = (validate, srv.partition_version, hft, sft,
                        next_bucket(len(hfp)), next_bucket(len(sfp)))
                groups.setdefault(gkey, {}).setdefault(fkey, []).append(
                    (srv, ckey, dev))
        for (validate, pv, *_rest), flavors in groups.items():
            if len(flavors) == 1:
                (fkey, entries), = flavors.items()
                blocks = [((srv, ckey), dev, srv.pidx)
                          for srv, ckey, dev in entries]
                for (srv, ckey), keep in stacked_block_eval(
                        blocks, validate, pv, filter_key=fkey):
                    srv.store_mask_for(ckey, validate, fkey, keep,
                                       computed_pv=pv)
                    warmed += 1
            else:
                # no serving batch to hand the masks to: store only
                _eval_cross_partition_multi(
                    {fkey: [(srv, _NO_STATE, ckey, dev)
                            for srv, ckey, dev in entries]
                     for fkey, entries in flavors.items()}, validate, pv)
                warmed += sum(len(e) for e in flavors.values())
        return warmed


class _NoStateType:
    """Placeholder state of the prefresher's multi-flavour evaluations
    (no serving batch to hand masks back to): swallows cached_keep
    writes."""

    def __getitem__(self, k):
        return {}


_NO_STATE = _NoStateType()
