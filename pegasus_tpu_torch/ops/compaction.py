"""Compaction filter: TTL + default-TTL rewrite + user rules + stale-split
drop.

Parity: KeyWithTTLCompactionFilter::Filter
(src/server/key_ttl_compaction_filter.h:55-121), as the JAX package's
ops/compaction.py evaluates it:
1. default_ttl != 0 and record has no TTL -> rewrite expire_ts to
   now + default_ttl (uint32 arithmetic, wrapping at 2^32).
2. user-specified compaction operations may delete / update TTL
   (ops/compaction_rules.py).
3. drop iff expired(now) after the rewrite, OR the key is stale post-split
   data: validate_hash and the key's hash does not map to `pidx`
   (check_if_stale_split_data, :114-121 — partition_version < 0 means
   KEEP here, the opposite of the scan path's reject).

Three shapes, each with the JAX package's contract:
- `compaction_filter_block`: the merge path's per-batch filter (steps 1
  and 3), with the key hash from the block's precomputed `hash_lo`;
- `make_compaction_eval(operations).eval_block`: the bulk path's program
  for one ruleset (all three steps), fed by `compaction_eval_submit` in
  chunks of up to COMPACT_CHUNK_ROWS rows and read back by
  `compaction_eval_drain`; `encoded_drop_mask` is its host twin for
  compressed blocks when no ruleset touches key bytes;
- `mesh_compact_step`: the bulk filter over a table's resident [P, B]
  image (parallel/mesh_resident.py) in one launch, with a per-slot gate
  on the stale-split term, its results in one buffer
  (`mesh_compact_buffer`) that a round copies home once.

On a CUDA device both launch the hand-written compaction-filter kernel
(ops/fused_compaction.py); on the CPU they run the plain torch version
(`eval_block_plain`), which chip_smoke.py holds the kernel against on the
card. The evaluation device is the caller's (the engine's): the JAX
package's placement by TPU-link round trip (`choose_eval_device`,
`rules_workload`) is not carried over.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Tuple

import numpy as np
import torch

from pegasus_tpu_torch.ops import fused_compaction, result_buffer
from pegasus_tpu_torch.ops.compaction_rules import apply_rules_ops
from pegasus_tpu_torch.ops.device_crc import key_hash_device
from pegasus_tpu_torch.ops.fused_compaction import ops_key as _ops_key
from pegasus_tpu_torch.ops.predicates import pack_mask, ttl_expired
from pegasus_tpu_torch.ops.record_block import u32

_M32 = 0xFFFFFFFF


def to_bits32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns of an int64 tensor of uint32 values."""
    return torch.where(t >= (1 << 31), t - (1 << 32), t).to(torch.int32)


def compaction_filter_block(hash_lo: torch.Tensor, expire_ts: torch.Tensor,
                            valid: torch.Tensor, now: int, default_ttl: int,
                            pidx: int, partition_version: int,
                            validate_hash: bool
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (drop: bool[B], new_expire_ts: int64[B] of uint32 values).

    `partition_version` must be >= 0 when validate_hash is set (callers
    gate the pv<0 / pidx>pv cases to keep, as check_if_stale_split_data
    does). On a CUDA block the compaction-filter kernel evaluates it."""
    if valid.device.type == "cuda":
        drop, ets = fused_compaction.compaction_filter(
            None, None, expire_ts, valid, hash_lo, pidx, (), now,
            default_ttl, partition_version, validate_hash=validate_hash,
            expire=True, want_ets=True, pack=False)
        return drop, u32(ets)
    return compaction_filter_block_plain(hash_lo, expire_ts, valid, now,
                                         default_ttl, pidx,
                                         partition_version, validate_hash)


def compaction_filter_block_plain(hash_lo, expire_ts, valid, now: int,
                                  default_ttl: int, pidx: int,
                                  partition_version: int,
                                  validate_hash: bool):
    """Plain torch version of compaction_filter_block, on any device."""
    now &= _M32
    default_ttl &= _M32
    expire_ts = u32(expire_ts)
    if default_ttl:
        new_ets = torch.where(expire_ts == 0, (now + default_ttl) & _M32,
                              expire_ts)
    else:
        new_ets = expire_ts
    expired = ttl_expired(new_ets, now)
    if validate_hash:
        stale = (u32(hash_lo) & (partition_version & _M32)) != (pidx & _M32)
    else:
        stale = torch.zeros_like(valid)
    return (expired | stale) & valid, new_ets


# ---- bulk block-level compaction (the GB/s path) -----------------------
#
# The bulk path evaluates whole columnar blocks, stacked across blocks
# into chunks of up to COMPACT_CHUNK_ROWS rows, one launch a chunk, and
# rewrites surviving rows with vectorized numpy gathers
# (storage/lsm.bulk_compact_rewrite).

_EVAL_CACHE: "OrderedDict[tuple, object]" = OrderedDict()
_EVAL_CACHE_CAP = 32
# the filter stages of concurrent compactions look rulesets up together
_EVAL_LOCK = threading.Lock()


def _key_hash_lo(keys: torch.Tensor, key_len: torch.Tensor,
                 hashkey_len: torch.Tensor) -> torch.Tensor:
    """int32[B] lo lane of pegasus_key_hash from the key rows
    (ops/device_crc.key_hash_device: crc64 of the hashkey region, of the
    sortkey region when the hashkey is empty), for chunks whose blocks
    carry no hash_lo column; the plain version of the kernel's own key
    hash (no bulk caller reaches it: bulk_compact_eligible requires the
    column)."""
    return key_hash_device(keys, key_len, hashkey_len)[1]


def eval_block_plain(operations, keys, key_len, hashkey_len, expire_ts,
                     valid, hash_lo, now: int, default_ttl: int, pidx,
                     partition_version: int, validate_hash: bool,
                     use_hash_lo: bool, want_ets: bool = True,
                     pack: bool = False, slot_allowed=None):
    """Plain torch version of eval_block, on any device: (drop,) or
    (drop, ets2) with drop bool[B] (uint8[ceil(B / 8)] with `pack`) and
    ets2 int32[B] of uint32 bits. `slot_allowed` (uint8 or bool[P], B =
    P * S rows) gates the stale-split term per slot of S rows, as the
    kernel's slot-gate instance does (mesh_compact_step); a `pidx` tensor
    is then int32[P], one owner a slot."""
    now &= _M32
    default_ttl &= _M32
    ets0 = u32(expire_ts)
    ets1 = (torch.where(ets0 == 0, (now + default_ttl) & _M32, ets0)
            if default_ttl else ets0)
    if operations:
        rule_drop, ets2 = apply_rules_ops(operations, keys, key_len,
                                          hashkey_len, ets1, valid, now)
    else:
        rule_drop = torch.zeros_like(valid)
        ets2 = ets1
    expired = ttl_expired(ets2, now)
    if validate_hash:
        lo = u32(hash_lo if use_hash_lo
                 else _key_hash_lo(keys, key_len, hashkey_len))
        owner = (u32(pidx) if isinstance(pidx, torch.Tensor)
                 else int(pidx) & _M32)
        if slot_allowed is not None:
            rows = valid.shape[0] // slot_allowed.shape[0]
            if isinstance(pidx, torch.Tensor):
                owner = owner.repeat_interleave(rows)
        stale = (lo & (partition_version & _M32)) != owner
        if slot_allowed is not None:
            stale = stale & slot_allowed.to(torch.bool).repeat_interleave(
                rows)
    else:
        stale = torch.zeros_like(valid)
    drop = ((expired | stale) & valid) | rule_drop
    if pack:
        drop = pack_mask(drop)
    return (drop, to_bits32(ets2)) if want_ets else (drop,)


def make_compaction_eval(operations=None):
    """The (drop, new_ets) program for one (optional) parsed ruleset,
    cached by the ruleset's CONTENT and bounded.

    `operations` is the tuple from compile_rules(...).operations. The
    returned `eval_block(keys, key_len, hashkey_len, expire_ts, valid,
    hash_lo, now, default_ttl, pidx, partition_version, validate_hash,
    use_hash_lo, want_ets=True, pack=False)` takes tensors of one device
    (the uint32 columns as int32 bit patterns, `pidx` an int or an int32
    column, hashkey_len the keys' big-endian u16 prefix) and launches the
    compaction-filter kernel on CUDA, the plain version on the CPU.
    Validation without `use_hash_lo` hashes the keys (the kernel on
    CUDA, `_key_hash_lo` in the plain version)."""
    key = _ops_key(operations)
    with _EVAL_LOCK:
        cached = _EVAL_CACHE.get(key)
        if cached is not None:
            _EVAL_CACHE.move_to_end(key)
            return cached
    ops = tuple(operations or ())

    def eval_block(keys, key_len, hashkey_len, expire_ts, valid, hash_lo,
                   now, default_ttl, pidx, partition_version,
                   validate_hash: bool, use_hash_lo: bool,
                   want_ets: bool = True, pack: bool = False):
        if keys.device.type != "cuda":
            return eval_block_plain(ops, keys, key_len, hashkey_len,
                                    expire_ts, valid, hash_lo, now,
                                    default_ttl, pidx, partition_version,
                                    validate_hash, use_hash_lo,
                                    want_ets=want_ets, pack=pack)
        # without use_hash_lo the kernel hashes the keys itself
        drop, ets = fused_compaction.compaction_filter(
            keys, key_len, expire_ts, valid,
            hash_lo if use_hash_lo else None, pidx, ops,
            now, default_ttl, partition_version, validate_hash=validate_hash,
            expire=True, want_ets=want_ets, pack=pack)
        return (drop, ets) if want_ets else (drop,)

    with _EVAL_LOCK:
        _EVAL_CACHE[key] = eval_block
        while len(_EVAL_CACHE) > _EVAL_CACHE_CAP:
            _EVAL_CACHE.popitem(last=False)
    return eval_block


def encoded_drop_mask(enc, now: int, default_ttl: int, pidx: int,
                      partition_version: int, validate_hash: bool,
                      want_ets: bool = True):
    """(drop bool[n], new_ets|None) for one ENCODED block — the host
    twin of eval_block for rulesets that touch no key bytes (no user
    rules): the TTL + default-TTL rewrite reads the raw `expire_ts`
    column and the stale-split check reads the raw `hash_lo` column, so a
    compressed block's drop mask costs no key decode, no value-heap
    inflate and no device launch. Semantics match eval_block exactly
    (valid is all-True for SST-origin blocks, as compaction_eval_submit
    stamps it)."""
    ets = np.asarray(enc.expire_ts)
    if default_ttl:
        new_ets = np.where(ets == 0,
                           np.uint32((now + default_ttl) & _M32), ets)
    else:
        new_ets = ets
    now32 = np.uint32(now & _M32)
    drop = (new_ets > 0) & (new_ets <= now32)
    if validate_hash:
        pv = np.uint32(max(partition_version, 0) & _M32)
        drop = drop | ((np.asarray(enc.hash_lo) & pv)
                       != np.uint32(pidx & _M32))
    return drop, (new_ets if want_ets else None)


def mesh_compact_layout(p: int, b: int, want_ets: bool) -> tuple:
    """The parts of a compaction round's result buffer over a [p, b]
    image: the packed drop mask uint8[p, b / 8], then ets2 uint32[p, b]
    with `want_ets`."""
    parts = (("u8", (p, b // 8)),)
    return parts + ((("u32", (p, b)),) if want_ets else ())


def mesh_compact_buffer(keys, key_len, hashkey_len, expire_ts, present,
                        hash_lo, pidx, allowed, now: int, default_ttl: int,
                        partition_version: int, *, operations=None,
                        validate_hash: bool = False,
                        want_ets: bool = True) -> torch.Tensor:
    """The bulk filter over a table's resident [P, B] image, or one
    shard's tile of it (parallel/mesh_resident.py), in one launch on the
    tensors' device, into one result buffer
    (parts `mesh_compact_layout(P, B, want_ets)`): eval_block's order
    (default-TTL rewrite -> user rules -> expiry + stale-split) over the
    image flattened to P * B rows with each slot's pidx read once a
    slot, `present` as `valid` (every real SST row, tombstones included:
    the write stage drops those by their flags), the resident `hash_lo`,
    and the stale-split term gated per slot by `allowed` (pidx <=
    partition_version: check_if_stale_split_data keeps the rows of a
    partition above the version). As pegasus_tpu/ops/compaction.py:178.

    keys uint8[P, B, K]; key_len, hashkey_len, expire_ts, hash_lo
    int32[P, B] (uint32 bits); present bool[P, B]; pidx int32[P];
    allowed bool or uint8[P]; B a power of two >= 8. On CUDA the
    compaction kernel: its TTL pass (no ruleset, validating) is
    slot_gate_kernel, everything else compaction_filter_kernel's
    slot-gate instance; on the CPU eval_block_plain with the same
    gate."""
    p, b = expire_ts.shape
    k = keys.shape[-1]
    pv = max(int(partition_version), 0) & _M32
    ops = tuple(operations or ())
    layout = mesh_compact_layout(p, b, want_ets)
    buf = result_buffer.empty(layout, keys.device)
    drop, *ets = (v.reshape(-1) for v in result_buffer.views(buf, layout))
    ets = ets[0] if want_ets else None
    flat = (keys.reshape(p * b, k), key_len.reshape(p * b),
            expire_ts.reshape(p * b), present.reshape(p * b))
    if keys.device.type == "cuda" and validate_hash and not ops:
        fused_compaction.slot_gate_filter(
            flat[2], flat[3], hash_lo.reshape(p * b), pidx,
            allowed.to(torch.uint8), now, default_ttl, pv, drop, ets)
    elif keys.device.type != "cuda":
        got = eval_block_plain(
            ops, flat[0], flat[1], hashkey_len.reshape(p * b), flat[2],
            flat[3], hash_lo.reshape(p * b), now, default_ttl, pidx,
            pv, validate_hash, True, want_ets=want_ets, pack=True,
            slot_allowed=allowed if validate_hash else None)
        drop.copy_(got[0])
        if want_ets:
            ets.copy_(got[1])
    else:
        fused_compaction.compaction_filter(
            flat[0], flat[1], flat[2], flat[3],
            hash_lo.reshape(p * b) if validate_hash else None,
            pidx if validate_hash else 0,
            ops, now, default_ttl, pv, validate_hash=validate_hash,
            expire=True, want_ets=want_ets, pack=True,
            slot_allowed=(allowed.to(torch.uint8) if validate_hash
                          else None),
            out=(drop, ets))
    return buf


def mesh_compact_step(keys, key_len, hashkey_len, expire_ts, present,
                      hash_lo, pidx, allowed, now: int, default_ttl: int,
                      partition_version: int, *, operations=None,
                      validate_hash: bool = False, want_ets: bool = True):
    """`mesh_compact_buffer`'s views: (packed drop uint8[P, B/8], ets2
    int32[P, B]) or (packed drop,) without `want_ets`."""
    p, b = expire_ts.shape
    return result_buffer.views(
        mesh_compact_buffer(keys, key_len, hashkey_len, expire_ts, present,
                            hash_lo, pidx, allowed, now, default_ttl,
                            partition_version, operations=operations,
                            validate_hash=validate_hash, want_ets=want_ets),
        mesh_compact_layout(p, b, want_ets))


COMPACT_CHUNK_ROWS = 1 << 18  # 256k records per stacked launch


def _row_bucket(n: int) -> int:
    """Power-of-two row capacity of a stacked chunk (bounds the distinct
    shapes, as the reference bounds its compilations). A ROW count, not
    a key width: no 64k ceiling (chunking already bounds it at
    COMPACT_CHUNK_ROWS plus one block)."""
    w = 4096
    while w < n:
        w <<= 1
    return w


def stack_chunk(chunk, rows: int, validate_hash: bool):
    """(columns, spans, use_hash_lo) of one chunk [(tag, block, pidx)] of
    one key width holding `rows` records, as eval_block takes them:
    keys uint8[cap, K], key_len, hashkey_len (from the big-endian u16
    key prefix), expire_ts, valid, hash_lo and a per-row pidx column,
    the uint32 columns as int32 bit patterns, zero-padded to
    cap = _row_bucket(rows); spans [(tag, first row, count)]."""
    width = int(chunk[0][1].keys.shape[1])
    cap = _row_bucket(rows)
    keys = np.zeros((cap, width), dtype=np.uint8)
    key_len = np.zeros(cap, dtype=np.int32)
    ets = np.zeros(cap, dtype=np.uint32)
    valid = np.zeros(cap, dtype=bool)
    pidx_col = np.zeros(cap, dtype=np.uint32)
    hash_lo = np.zeros(cap, dtype=np.uint32)
    use_lo = validate_hash and all(
        b.hash_lo is not None for _t, b, _p in chunk)
    pos = 0
    spans = []
    for tag, blk, pidx in chunk:
        n = blk.count
        keys[pos:pos + n, :blk.keys.shape[1]] = blk.keys
        key_len[pos:pos + n] = blk.key_len
        ets[pos:pos + n] = blk.expire_ts
        valid[pos:pos + n] = True
        pidx_col[pos:pos + n] = pidx
        if use_lo:
            hash_lo[pos:pos + n] = blk.hash_lo
        spans.append((tag, pos, n))
        pos += n
    hkl = ((key_len > 0)
           * ((keys[:, 0].astype(np.int32) << 8)
              | keys[:, 1].astype(np.int32))).astype(np.int32)
    return ((keys, key_len, hkl, ets.view(np.int32), valid,
             hash_lo.view(np.int32), pidx_col.view(np.int32)),
            spans, use_lo)


class _Submitted:
    """One chunk in flight: its blocks' spans, capacity, the results (on
    the host once `event` has completed) and the event recorded after
    the launch and the copies back."""

    __slots__ = ("spans", "cap", "drop", "ets", "event")

    def __init__(self, spans, cap, drop, ets, event) -> None:
        self.spans = spans
        self.cap = cap
        self.drop = drop
        self.ets = ets
        self.event = event


def compaction_eval_submit(blocks, now, default_ttl, partition_version,
                           validate_hash: bool, operations=None,
                           device=None, want_ets: bool = True):
    """Phase 1: launch the compaction-filter evaluations WITHOUT waiting.

    `blocks`: [(tag, host_block, pidx)] — host_block is a columnar SST
    Block (storage/sstable.py), `pidx` the owning partition. Blocks are
    concatenated on the host into chunks of up to COMPACT_CHUNK_ROWS
    records per key width (one transfer set a chunk), each with a per-row
    pidx column and hashkey_len from the big-endian u16 key prefix, and
    evaluated on `device` (the CPU when None). On CUDA each chunk's
    packed drop mask (and ets2 when `want_ets`) is copied back to pinned
    host memory asynchronously and a CUDA event is recorded after the
    copies; nothing here waits. Returns an opaque list for
    compaction_eval_drain."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    eval_block = make_compaction_eval(operations)

    buckets: dict = {}
    for tag, blk, pidx in blocks:
        buckets.setdefault(int(blk.keys.shape[1]), []).append(
            (tag, blk, pidx))

    submitted = []
    for group in buckets.values():
        off = 0
        while off < len(group):
            chunk = []
            rows = 0
            while off < len(group):
                n_blk = group[off][1].count
                if chunk and rows + n_blk > COMPACT_CHUNK_ROWS:
                    break  # close the chunk at the row target
                chunk.append(group[off])
                rows += n_blk
                off += 1
            cols, spans, use_lo = stack_chunk(chunk, rows, validate_hash)
            cols = [torch.from_numpy(a).to(dev, non_blocking=True)
                    for a in cols]
            keys, key_len, hkl, ets, valid, hash_lo, pidx_col = cols
            out = eval_block(
                keys, key_len, hkl, ets, valid, hash_lo, now, default_ttl,
                pidx_col, max(partition_version, 0), validate_hash, use_lo,
                want_ets=want_ets, pack=True)
            drop = out[0]
            new_ets = out[1] if want_ets else None
            event = None
            if dev.type == "cuda":
                drop = drop.to("cpu", non_blocking=True)
                if want_ets:
                    new_ets = new_ets.to("cpu", non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            submitted.append(_Submitted(spans, keys.shape[0], drop, new_ets,
                                        event))
    return submitted


def compaction_eval_drain(submitted, want_ets: bool = True):
    """Phase 2: wait for each chunk's event (nothing else) and yield
    (tag, drop[:n], new_ets[:n] | None) per block, on the host."""
    for s in submitted:
        if s.event is not None:
            s.event.synchronize()
        drop_all = np.unpackbits(s.drop.numpy(), count=s.cap).astype(bool)
        ets_all = (s.ets.numpy().view(np.uint32) if want_ets else None)
        for tag, pos, n in s.spans:
            yield (tag, drop_all[pos:pos + n],
                   ets_all[pos:pos + n] if want_ets else None)


def compaction_eval_stacked(blocks, now, default_ttl, partition_version,
                            validate_hash: bool, operations=None,
                            device=None, want_ets: bool = True):
    """Submit + drain in one call (the non-pipelined form; the engine's
    windowed compactor overlaps a window's drain/rewrite with the next
    window's submit)."""
    yield from compaction_eval_drain(
        compaction_eval_submit(blocks, now, default_ttl,
                               partition_version, validate_hash,
                               operations=operations, device=device,
                               want_ets=want_ets),
        want_ets=want_ets)
