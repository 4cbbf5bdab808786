"""Columnar response-page assembly: counterpart of pegasus_tpu/server/page.py.

Given the surviving rows of each planned block (static mask AND host TTL
mask, already applied), pack every survivor's key and user data into
one ScanPage with native calls (native/packer.cpp) instead of a
per-record Python loop building KeyValue objects:

- `serve_batch`: a whole flush of fast-path requests in ONE native call
  (pegasus_scan_serve_batch), the batched scan path's assembly;
- `build_page`: one page from explicit row takes (pegasus_gather_page),
  the numpy re-serve of a request whose arena overflowed.

Parity role: src/server/pegasus_server_impl.cpp:2434-2489
(append_key_value_for_multi_get / validate_key_value_for_scan), the
reference's per-record response append in C++. `_gather_python` is the
plain twin of the native gather, for the tests; the serving path always
runs the native library, which builds or raises.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import numpy as np

from pegasus_tpu_torch import native
from pegasus_tpu_torch.server.types import ScanPage

_scratch_tls = threading.local()

# native serve_batch calls, the requests they served and those they
# handed back (arena overflow); "numpy" counts the fast-path requests a
# server then re-served with numpy, and "overlay_rows" the memtable and
# L0 rows its overlay merge put into pages
# (partition_server.finish_scan_batch)
SERVE_STATS = {"calls": 0, "served": 0, "overflow": 0, "numpy": 0,
               "overlay_rows": 0}


def _scratch(name: str, size: int, dtype, alloc=np.empty):
    """Grow-only per-thread scratch array + cached base pointer.

    The assembly arenas are consumed within one serve_batch call (pages
    are cut out by copy), so reusing them across flushes avoids an
    mmap/page-fault round per flush for the multi-MB value arena, and
    caching `.ctypes.data` (a ~µs property) with the buffer trims the
    per-call ctypes overhead. `alloc` fills the buffer at (re)allocation
    (np.arange for the identity block table)."""
    pool = getattr(_scratch_tls, "pool", None)
    if pool is None:
        pool = _scratch_tls.pool = {}
    hit = pool.get(name)
    if hit is None or hit[0].size < size:
        arr = alloc(int(size * 3 // 2) + 64, dtype=dtype)
        hit = pool[name] = (arr, arr.ctypes.data)
    return hit


def block_native_ptrs(blk):
    """Cached static pointer row for one Block: (keys, key_len, voffs,
    heap, ets, width, heap array). `.ctypes.data` costs ~a µs per access,
    so the serving path resolves each block's pointers once per block
    lifetime, not once per request."""
    nat = blk._nat
    if nat is None:
        heap = blk.value_heap
        if not isinstance(heap, np.ndarray):
            heap = np.frombuffer(heap, dtype=np.uint8)
        nat = (blk.keys.ctypes.data, blk.key_len.ctypes.data,
               blk.value_offs.ctypes.data,
               heap.ctypes.data if heap.size else 0,
               blk.expire_ts.ctypes.data, blk.keys.shape[1], heap)
        blk._nat = nat
    return nat


def probe_nat(blk):
    """Cached point-probe entry table for one Block: the contiguous key
    matrix, an int64 key-length column, and the memcmp-ordered void view
    the batched searchsorted probes run over, resolved once per block
    lifetime."""
    nat = blk._probe
    if nat is None:
        km = np.ascontiguousarray(blk.keys)
        vt = np.dtype((np.void, km.shape[1]))
        nat = (km, np.asarray(blk.key_len, dtype=np.int64),
               km.view(vt).ravel())
        blk._probe = nat
    return nat


def probe_rows(blk, probe_keys) -> np.ndarray:
    """int64[P] row indices of exact-match probe keys in `blk` (-1 =
    absent): one vectorized searchsorted over the cached probe table
    instead of P Python bisects."""
    from pegasus_tpu_torch.ops.predicates import point_probe_rows

    km, kl, bv = probe_nat(blk)
    return point_probe_rows(km, kl, probe_keys, block_void=bv)


def plan_geometry(plan):
    """(total_rows, value-heap span upper bound, max key width) of a
    plan: the native assembly's arena sizing. Computed once per cached
    plan (partition_server.plan_scan_batch)."""
    total_rows = 0
    span = 0
    max_w = 2
    for _ckey, blk, lo, hi in plan:
        total_rows += hi - lo
        vo = blk.value_offs
        span += int(vo[hi]) - int(vo[lo])
        if blk.keys.shape[1] > max_w:
            max_w = blk.keys.shape[1]
    return total_rows, span, max_w


def plan_nat(plan):
    """Per-plan native entry table, cached with the plan: the pointer
    rows (keys, width, key_len, value_offs, heap, expire_ts) of every
    entry as one uint64[6, n], int64 lo/hi bounds, the ckey tuple and the
    int64 widths. Plans are pure over the immutable run set, so these
    arrays are too."""
    n = len(plan)
    ptr6 = np.empty((6, n), dtype=np.uint64)
    lo_arr = np.empty(n, dtype=np.int64)
    hi_arr = np.empty(n, dtype=np.int64)
    ckeys = []
    for j, (ckey, blk, lo, hi) in enumerate(plan):
        kp, lp, vp, hp, ep, w, _heap = block_native_ptrs(blk)
        ptr6[0, j] = kp
        ptr6[1, j] = w
        ptr6[2, j] = lp
        ptr6[3, j] = vp
        ptr6[4, j] = hp
        ptr6[5, j] = ep
        lo_arr[j] = lo
        hi_arr[j] = hi
        ckeys.append(ckey)
    return ptr6, lo_arr, hi_arr, tuple(ckeys), ptr6[1].astype(np.int64)


def serve_batch(req_windows, byte_cap: int, hdr: int):
    """Whole-batch assembly in ONE native call.

    req_windows: per fast-path request (plan, want, no_value, want_ets,
    live_masks, geom, nat, live_ptrs) as prepare_serve builds them: plan
    is [(ckey, Block, lo, hi)] in key order, live_masks maps ckey ->
    bool[count] (that request's static keep AND host TTL, per window,
    because filter flavours sharing a block carry different masks), geom
    is plan_geometry(plan), nat is plan_nat(plan) and live_ptrs maps ckey
    -> the live mask's base pointer. Every per-window quantity comes
    cached (geom and nat with the plan, live_ptrs with the second's live
    masks), so the bookkeeping is array math over the flush.

    Packs every request's surviving rows into shared arenas with
    packer.cpp pegasus_scan_serve_batch, the C++ twin of the reference's
    per-record serving loop (src/server/pegasus_server_impl.cpp:643),
    then cuts per-request ScanPages out of the arenas.

    Returns [(page, size, last_key, truncated) | None] per request (None:
    the arena filled, the caller re-serves that request with numpy), or
    None for the whole flush when its arenas would pass 4 GiB.
    """
    if not req_windows:
        return None
    fn = native.scan_serve_fn()
    want_ets = any(w[3] for w in req_windows)
    n_reqs = len(req_windows)
    nats = [w[6] for w in req_windows]
    geoms = np.array([w[5] for w in req_windows], dtype=np.int64)
    wants_in = np.fromiter((w[1] for w in req_windows),
                           dtype=np.int64, count=n_reqs)
    no_vals = np.fromiter((bool(w[2]) for w in req_windows),
                          dtype=np.bool_, count=n_reqs)
    counts = np.fromiter((len(n[3]) for n in nats),
                         dtype=np.int64, count=n_reqs)
    entry_start = np.zeros(n_reqs + 1, dtype=np.int64)
    np.cumsum(counts, out=entry_start[1:])
    e = int(entry_start[-1])
    entry_mask = np.fromiter(
        (w[7][ck] for w in req_windows for ck in w[6][3]),
        dtype=np.uint64, count=e)
    wants = np.minimum(wants_in, geoms[:, 0])
    rows_total = int(wants.sum())
    row_base = np.zeros(n_reqs, dtype=np.int64)
    np.cumsum(wants[:-1], out=row_base[1:])
    row_base += np.arange(n_reqs)  # +r: offset windows are count+1
    key_cap = int((wants * geoms[:, 2]).sum())
    val_cap = int(np.where(
        no_vals, 0,
        np.minimum(byte_cap + (64 << 10), geoms[:, 1])).sum())
    no_values = no_vals.astype(np.uint8)
    if key_cap >= 1 << 32 or val_cap >= 1 << 32:
        # running arena offsets are uint32: a flush whose combined spans
        # pass 4 GiB is served request by request instead of wrapping
        return None
    if n_reqs == 1:
        ptr6, entry_lo, entry_hi = nats[0][:3]
        widths = nats[0][4]
    else:
        ptr6 = np.concatenate([n[0] for n in nats], axis=1)
        entry_lo = np.concatenate([n[1] for n in nats])
        entry_hi = np.concatenate([n[2] for n in nats])
        widths = np.concatenate([n[4] for n in nats])
    # grow-only arenas + outputs (the C call writes every cell the result
    # loop reads, so nothing is zeroed); entry_block is a cached arange
    # prefix (the per-entry block table is the identity)
    _entry_block, eb_ptr = _scratch("entry_block", e, np.int64,
                                    alloc=np.arange)
    key_blob, kb_ptr = _scratch("key_blob", max(1, key_cap), np.uint8)
    val_blob, vb_ptr = _scratch("val_blob", max(1, val_cap), np.uint8)
    n_offs = rows_total + n_reqs + 1
    key_offs, ko_ptr = _scratch("key_offs", n_offs, np.uint32)
    val_offs, vo_ptr = _scratch("val_offs", n_offs, np.uint32)
    if want_ets:
        ets_arena, ets_ptr = _scratch("ets", max(1, rows_total),
                                      np.uint32)
    else:
        ets_arena, ets_ptr = None, None
    out_count, oc_ptr = _scratch("out_count", n_reqs, np.int64)
    out_bytes, ob_ptr = _scratch("out_bytes", n_reqs, np.int64)
    out_state, os_ptr = _scratch("out_state", n_reqs, np.int32)
    fn(ptr6[0].ctypes.data, widths.ctypes.data, ptr6[2].ctypes.data,
       entry_mask.ctypes.data, ptr6[3].ctypes.data, ptr6[4].ctypes.data,
       ptr6[5].ctypes.data, n_reqs, entry_start.ctypes.data,
       eb_ptr, entry_lo.ctypes.data,
       entry_hi.ctypes.data, wants.ctypes.data, no_values.ctypes.data,
       byte_cap, hdr, kb_ptr, key_cap,
       vb_ptr, val_cap, ko_ptr,
       vo_ptr, row_base.ctypes.data,
       ets_ptr,
       oc_ptr, ob_ptr, os_ptr)
    SERVE_STATS["calls"] += 1

    results = []
    for r in range(n_reqs):
        state = int(out_state[r])
        if state == 3:
            results.append(None)  # arena full: re-served with numpy
            SERVE_STATS["overflow"] += 1
            continue
        SERVE_STATS["served"] += 1
        count = int(out_count[r])
        truncated = state == 2
        if count == 0:
            results.append((ScanPage(), 0, None, truncated))
            continue
        base = int(row_base[r])
        ko = key_offs[base:base + count + 1]
        vo = val_offs[base:base + count + 1]
        k0, k1 = int(ko[0]), int(ko[count])
        v0, v1 = int(vo[0]), int(vo[count])
        page = ScanPage(
            key_offs=(ko - np.uint32(k0)).tobytes(),
            key_blob=key_blob[k0:k1].tobytes(),
            val_offs=(vo - np.uint32(v0)).tobytes(),
            val_blob=val_blob[v0:v1].tobytes())
        if req_windows[r][3]:
            page.ets = ets_arena[base - r:base - r + count].astype(
                "<u4").tobytes()
        last_key = key_blob[int(ko[count - 1]):k1].tobytes()
        results.append((page, int(out_bytes[r]), last_key, truncated))
    return results


def build_page(chunks: List[Tuple[object, np.ndarray]], hdr: int,
               no_value: bool = False, want_ets: bool = False,
               ) -> Tuple[ScanPage, int, Optional[bytes]]:
    """Pack survivors into one page with the native gather.

    chunks: [(Block, ascending int64 row indices)] in key order across
    blocks. Returns (page, byte_size, last_key) where byte_size is the
    capacity-unit accounting sum (key bytes + user-data bytes) and
    last_key is the final packed key (resume cursor) or None for an
    empty page.
    """
    chunks = [(blk, take) for blk, take in chunks if len(take)]
    n = sum(len(take) for _b, take in chunks)
    if n == 0:
        return ScanPage(), 0, None

    # upper-bound blob capacities from scalar offset reads (takes are
    # ascending, so a chunk's value bytes fit in [offs[first],
    # offs[last+1])); the gather writes the exact running offsets and
    # the blobs are trimmed afterwards
    key_cap = 0
    val_cap = 0
    for blk, take in chunks:
        key_cap += len(take) * blk.keys.shape[1]
        if not no_value:
            vo = blk.value_offs
            val_cap += int(vo[int(take[-1]) + 1]) - int(vo[int(take[0])])
    if key_cap >= 1 << 32 or val_cap >= 1 << 32:
        # offsets are uint32 (here and in pegasus_gather_page); callers
        # cap batch_size (SCAN_BATCH_CAP) so this only trips on a bug
        raise ValueError(
            f"scan page exceeds 4GiB blob limit "
            f"(keys={key_cap}, values={val_cap}); split the batch")

    key_offs = np.zeros(n + 1, dtype=np.uint32)
    val_offs = np.zeros(n + 1, dtype=np.uint32)
    key_buf = bytearray(key_cap)
    val_buf = bytearray(val_cap)
    kb = np.frombuffer(key_buf, dtype=np.uint8)
    vb = np.frombuffer(val_buf, dtype=np.uint8) if val_cap else None

    fn = native.gather_page_fn()
    pos = 0
    for blk, take in chunks:
        m = len(take)
        take = np.ascontiguousarray(take, dtype=np.int64)
        heap = blk.value_heap
        if not isinstance(heap, np.ndarray):
            heap = np.frombuffer(heap, dtype=np.uint8)
        fn(blk.keys.ctypes.data, blk.keys.shape[1],
           blk.key_len.ctypes.data, blk.value_offs.ctypes.data,
           heap.ctypes.data if heap.size else None,
           take.ctypes.data, m, hdr,
           kb.ctypes.data, key_offs[pos:].ctypes.data,
           (vb.ctypes.data if not no_value and vb is not None
            else None),
           val_offs[pos:].ctypes.data)
        pos += m

    key_total = int(key_offs[n])
    val_total = int(val_offs[n])
    last_i = int(key_offs[n - 1])
    page = ScanPage(
        key_offs=key_offs.tobytes(), key_blob=bytes(key_buf[:key_total]),
        val_offs=val_offs.tobytes(), val_blob=bytes(val_buf[:val_total]))
    if want_ets:
        page.ets = np.concatenate(
            [np.asarray(blk.expire_ts)[take]
             for blk, take in chunks]).astype("<u4").tobytes()
    return page, key_total + val_total, bytes(key_buf[last_i:key_total])


def _gather_python(blk, take, hdr, no_value, kb, key_offs, vb, val_offs,
                   pos) -> None:
    """Plain twin of pegasus_gather_page, for the tests."""
    kpos = int(key_offs[pos])
    vpos = int(val_offs[pos])
    vo = blk.value_offs
    heap = blk.value_heap
    for j, row in enumerate(take):
        row = int(row)
        kl = int(blk.key_len[row])
        kb[kpos:kpos + kl] = blk.keys[row, :kl]
        kpos += kl
        key_offs[pos + j + 1] = kpos
        v0, v1 = int(vo[row]), int(vo[row + 1])
        vl = max(0, v1 - v0 - hdr)
        if not no_value:
            if vl:
                if not isinstance(heap, np.ndarray):
                    heap = np.frombuffer(heap, dtype=np.uint8)
                vb[vpos:vpos + vl] = heap[v0 + hdr:v1]
            vpos += vl
        val_offs[pos + j + 1] = vpos
