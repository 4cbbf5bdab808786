"""The arithmetic of the resident round's two redesigned kernels, rehearsed
on the CPU against their plain versions, bit for bit.

numpy models of csrc/mesh_step.cu's `mesh_step_kernel` and
csrc/compaction_filter.cu's `slot_gate_kernel` follow each kernel's lane
layout: a warp's tile of 256 rows (one mask byte a lane); the epilogue's
expire_ts read by the owning lane, a cluster's warps striding over a
slot's tiles two at a time, the lanes' sum read 512 bytes an instruction
with the live bit shuffled from its owner; the slot gate's expire_ts and
hash_lo loaded 16 bytes a lane (rows 128 i + 4 lane .. + 3 in
instruction i) with their nibbles shuffled to the owning lane, and its
per-slot or per-block pidx and allowed; bools packed by the multiply in
`pack_bools`. They are held against
`fused_mesh.mesh_step_plain` and `compaction.eval_block_plain` at the
shapes of chip_smoke.py's (f) checks, cut in rows.
"""

import numpy as np
import pytest
import torch

from pegasus_tpu_torch.ops.compaction import eval_block_plain
from pegasus_tpu_torch.ops.fused_mesh import mesh_step_plain

U64 = np.uint64


def pack_bools(b8: np.ndarray) -> int:
    """8 bool bytes, row m in byte m -> one byte, row m at bit 7 - m."""
    x = int(np.frombuffer(np.ascontiguousarray(b8, np.uint8).tobytes(),
                          "<u8")[0])
    return ((x * 0x8040201008040201) & 0xFFFFFFFFFFFFFFFF) >> 56


def nibble(bits4) -> int:
    """4 row bits, the first at bit 3."""
    return sum(int(v) << (3 - q) for q, v in enumerate(bits4))


def to_owner(nibs: list) -> list:
    """The owner's byte from the two shuffles of the loaders' nibbles."""
    out = []
    for lane in range(32):
        hi = nibs[(2 * lane) & 31]
        lo = nibs[(2 * lane + 1) & 31]
        out.append(((hi & 0xF) << 4) | (lo & 0xF) if lane < 16
                   else (hi & 0xF0) | (lo >> 4))
    return out


def chunk(col: np.ndarray, r: int, n: int) -> np.ndarray:
    """4 rows from `r` (a 16-byte load), zeros past `n`."""
    return col[r:r + 4] if r < n else np.zeros(4, col.dtype)


WARPS, TILES, MAX_CLUSTER = 16, 2, 8   # csrc/mesh_step.cu


def slot_tiles(nb: int):
    """The tiles of a slot of `nb` mask bytes in the order the cluster's
    warps take them: warp w of rank r from tile (r * WARPS + w) * TILES,
    TILES at a time, striding by the cluster's warps."""
    tiles = -(-nb // 32)
    need = -(-tiles // (WARPS * TILES))
    blocks = min(MAX_CLUSTER, need)
    for rank in range(blocks):
        for w in range(WARPS):
            t0 = (rank * WARPS + w) * TILES
            while t0 < tiles:
                yield from range(t0, t0 + TILES)
                t0 += blocks * WARPS * TILES


def model_mesh_step(packed, allowed, ets, present, extra, lanes, now,
                    with_sum):
    p_n, nb = packed.shape
    b = nb * 8
    out = np.zeros_like(packed)
    counts = np.zeros((p_n, 3), np.int64)
    sums = np.zeros((p_n, 4), np.uint64)
    for p in range(p_n):
        seen = list(slot_tiles(nb))
        assert sorted(t for t in seen if t * 32 < nb) == \
            list(range(-(-nb // 32)))
        for t in seen:
            tr = t * 256
            alive = []
            for lane in range(32):
                r = tr + 8 * lane
                alive.append(nibble((chunk(ets[p], r, b) == 0)
                                    | (chunk(ets[p], r, b) > now)) << 4
                             | nibble((chunk(ets[p], r + 4, b) == 0)
                                      | (chunk(ets[p], r + 4, b) > now)))
            live = []
            for lane in range(32):
                j = t * 32 + lane
                if j >= nb:
                    live.append(0)
                    continue
                gated = int(packed[p, j]) if allowed[p] else 0
                out[p, j] = gated
                cons = gated & alive[lane]
                lv = cons if extra is None else \
                    cons & pack_bools(extra[p, 8 * j:8 * j + 8])
                live.append(lv)
                counts[p] += (bin(lv).count("1"), bin(cons).count("1"),
                              bin(pack_bools(present[p, 8 * j:8 * j + 8])
                                  & ~alive[lane] & 0xFF).count("1"))
            if with_sum:
                for m in range(8):
                    for lane in range(32):
                        r = tr + 32 * m + lane
                        bit = (live[4 * m + (lane >> 3)]
                               >> (7 - (lane & 7))) & 1
                        if r < b and bit:
                            sums[p] += lanes[p, r].astype(np.uint64)
    return out, counts.astype(np.int32), \
        (sums & U64(0xFFFFFFFF)).astype(np.uint32)


@pytest.mark.parametrize("pc,b", [(1, 8), (5, 8), (2, 1024), (3, 4096)])
@pytest.mark.parametrize("with_sum", [False, True])
@pytest.mark.parametrize("extra_on", [False, True])
def test_mesh_step_model_matches_plain(pc, b, with_sum, extra_on):
    rng = np.random.default_rng(pc * 7 + b + with_sum * 2 + extra_on)
    now = 300_000_000
    packed = rng.integers(0, 256, (pc, b // 8), dtype=np.uint8)
    allowed = (rng.random(pc) < 0.8).astype(np.uint8)
    ets = rng.choice(np.array([0, 1, now - 1, now, now + 1, 0x80000010,
                               0xFFFFFFFF], np.uint32), (pc, b))
    present = np.arange(b)[None, :] < rng.integers(0, b + 1, (pc, 1))
    extra = rng.random((pc, b)) < 0.6 if extra_on else None
    lanes = rng.integers(0, 1 << 32, (pc, b, 4),
                         dtype=np.uint64).astype(np.uint32)
    got = model_mesh_step(packed, allowed, ets, present, extra, lanes, now,
                          with_sum)
    want = mesh_step_plain(
        torch.from_numpy(packed), torch.from_numpy(allowed),
        torch.from_numpy(ets.view(np.int32)), torch.from_numpy(present),
        None if extra is None else torch.from_numpy(extra),
        torch.from_numpy(lanes.view(np.int32)), now, with_sum)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    np.testing.assert_array_equal(got[2], want[2].numpy().view(np.uint32))


@pytest.mark.parametrize("b,cluster", [(8, 1), (1024, 1), (4096, 1),
                                       (16384, 2), (65536, 8)])
def test_cluster_takes_each_tile_once(b, cluster):
    """chip_smoke.py's (f) shapes give clusters of 1, 2 and 8 blocks a
    slot, and their warps take every tile of the slot exactly once."""
    nb = b // 8
    tiles = -(-nb // 32)
    assert min(MAX_CLUSTER, -(-tiles // (WARPS * TILES))) == cluster
    seen = [t for t in slot_tiles(nb) if t < tiles]
    assert sorted(seen) == list(range(tiles))


def model_slot_gate(ets, valid, hash_lo, pidx, allowed, slot_shift, now,
                    ttl, pv):
    n = ets.shape[0]
    drop = np.zeros(n // 8, np.uint8)
    ets2 = np.zeros(n, np.uint32)
    for block in range(-(-n // 2048)):
        first = block * 2048
        for warp in range(8):
            tr = first + warp * 256
            nibs = []
            for lane in range(32):
                nib = 0
                for half, r in enumerate((tr + 4 * lane,
                                          tr + 4 * lane + 128)):
                    if slot_shift >= 11:   # the block lies in one slot
                        s = first >> slot_shift
                    else:
                        s = (r if r < n else 0) >> slot_shift
                    e = chunk(ets, r, n).astype(np.uint64)
                    if ttl:
                        e = np.where(e == 0, (now + ttl) & 0xFFFFFFFF, e)
                    h = chunk(hash_lo, r, n)
                    bits = [((x > 0) & (x <= now))
                            | (bool(allowed[s]) & ((int(y) & pv)
                                                   != int(pidx[s])))
                            for x, y in zip(e, h)]
                    nib |= nibble(bits) << (4 * half)
                    if r < n:
                        ets2[r:r + 4] = e
                nibs.append(nib)
            gone = to_owner(nibs)
            for lane in range(32):
                j = (tr >> 3) + lane
                if j * 8 < n:
                    drop[j] = gone[lane] & pack_bools(valid[8 * j:8 * j + 8])
    return drop, ets2


@pytest.mark.parametrize("pc,b", [(1, 8), (5, 8), (3, 1024), (2, 4096)])
@pytest.mark.parametrize("ttl", [0, 600])
def test_slot_gate_model_matches_plain(pc, b, ttl):
    rng = np.random.default_rng(pc * 11 + b + ttl)
    pv = 47
    rows = pc * b
    pidx = rng.permutation(64)[:pc].astype(np.uint32)
    noise = rng.integers(0, 1 << 32, rows, dtype=np.uint64)
    hash_lo = np.where(rng.random(rows) < 0.9,
                       (noise & ~U64(63)) | np.repeat(pidx, b).astype(U64),
                       noise).astype(np.uint32)
    ets = rng.choice(np.array([0, 0, 4900, 5000, 5100], np.uint32), rows)
    valid = (np.arange(b)[None, :]
             < rng.integers(0, b + 1, (pc, 1))).reshape(-1)
    allowed = (pidx <= pv).astype(np.uint8)
    got = model_slot_gate(ets, valid, hash_lo, pidx, allowed,
                          b.bit_length() - 1, 5000, ttl, pv)
    want = eval_block_plain(
        (), None, None, None, torch.from_numpy(ets.view(np.int32)),
        torch.from_numpy(valid), torch.from_numpy(hash_lo.view(np.int32)),
        5000, ttl, torch.from_numpy(pidx.view(np.int32)), pv, True, True,
        want_ets=True, pack=True, slot_allowed=torch.from_numpy(allowed))
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy().view(np.uint32))
