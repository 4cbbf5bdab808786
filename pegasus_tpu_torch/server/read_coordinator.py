"""Node-level cross-partition point-read coordination.

The port's copy of pegasus_tpu/server/read_coordinator.py, the
point-read twin of scan_coordinator: a node hosting many partitions
receives one flush of concurrent get / ttl / multi_get(sort_keys) /
batch_get requests, plans each partition's batch (per-generation
location cache, one sidecar probe of the flush's disk-bound keys,
vectorized block probes), then serves the whole flush's value gathers
through one page.build_page call per value-header width.

Point predicates are a crc compare and a TTL compare per key, so nothing
here runs on the device; what batching buys is host-side: one clock
read per flush, bloom and perfect-hash pruning and location of every
(key x table) pair in one native call each, the node row cache, and one
native gather per block for co-located keys. Each partition's finish
runs with its tenant bound, so its capacity units debit that tenant
(server/tenancy.py).
"""

from __future__ import annotations

from typing import List, Tuple

from pegasus_tpu_torch.base.value_schema import epoch_now, header_length
from pegasus_tpu_torch.server import tenancy
from pegasus_tpu_torch.server.page import build_page
from pegasus_tpu_torch.utils.errors import ErrorCode, PegasusError
from pegasus_tpu_torch.utils.tracing import annotate


def is_point_read(op: str, args) -> bool:
    """Ops the batched point path serves; everything else (ranged
    multi_get, scans) keeps its own path. Defensive against malformed
    args: a shape this returns True for never makes plan_get_batch raise
    anything but ValueError."""
    if op in ("get", "ttl"):
        return isinstance(args, (bytes, bytearray))
    if op == "batch_get":
        return isinstance(getattr(args, "keys", None), (list, tuple))
    if op == "multi_get":
        return bool(getattr(args, "hash_key", b"")) \
            and bool(getattr(args, "sort_keys", ()))
    return False


def point_read_multi(servers_and_ops: List[Tuple[object, list]],
                     now=None, deadline=None, clock=None,
                     tenants=None) -> List[list]:
    """[(PartitionServer, [(op, args, partition_hash)])] -> [[result]].

    Results equal the solo handlers'. One build_page call assembles every
    partition's L1 value gathers per value-header width.

    `deadline`/`clock`: the flush's end-to-end deadline on the serving
    node's clock, checked between the per-partition planning passes and
    again before the cross-partition gather; past it the flush raises
    ERR_TIMEOUT instead of finishing work its requesters abandoned.

    `tenants`: one tenant tag a partition's ops (None: untenanted); each
    state's finish runs with its tenant bound, so its capacity units
    debit that tenant (server/tenancy.py). The phases annotate the
    active trace span: coord_plan, coord_gather, coord_finish."""

    def _check_deadline() -> None:
        if deadline is not None and clock is not None \
                and clock() > deadline:
            raise PegasusError(ErrorCode.ERR_TIMEOUT,
                               "point-read flush deadline exceeded")

    if now is None:
        now = epoch_now()
    states = []
    for server, ops in servers_and_ops:
        _check_deadline()
        states.append((server, server.plan_get_batch(ops, now=now)))
    _check_deadline()
    annotate("coord_plan")

    # cross-partition native assembly: group by value-header width (the
    # only per-partition parameter of the gather), concatenate chunks
    groups: dict = {}
    for server, state in states:
        chunks = server.point_chunks(state)
        if not chunks:
            state["_page"] = (None, 0)
            continue
        hdr = header_length(server.data_version)
        groups.setdefault(hdr, []).append((state, chunks))
    for hdr, grp in groups.items():
        all_chunks = []
        base = 0
        for state, chunks in grp:
            state["_page_base"] = base
            all_chunks.extend(chunks)
            base += state["chunk_rows"]
        pg, _size, _last = build_page(all_chunks, hdr)
        for state, _chunks in grp:
            state["_page"] = (pg, state.pop("_page_base"))

    annotate("coord_gather")

    out = []
    if tenants is None:
        tenants = [None] * len(states)
    for (server, state), tenant in zip(states, tenants):
        pg, base = state.pop("_page", (None, 0))
        with tenancy.bind(tenant):
            out.append(server.finish_get_batch(state, pg, base))
    annotate("coord_finish")
    return out
