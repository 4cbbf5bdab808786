"""The port's partition mesh and the resident round's two launches against
the JAX package, exact.

- `make_mesh`: the JAX rules over torch devices (a (dp, sp) shape over
  eight host devices, dp that does not divide raises, one device
  degrades with a warning; without CUDA and without devices it raises);
- `sharded_scan_step` against the JAX one over the same seeded
  partition blocks, at P in {1, 3, 8} and K in {32, 64}, with and
  without validation (partition_version at, below and under 0) and a
  sortkey filter: keep masks, totals and per-partition counts equal
  (tests/test_parallel.py's counts and foreign-data rejection too);
- the resident round (the scan kernel's static mask over the flattened
  image, then `fused_mesh.mesh_step_plain`) against the JAX package's
  `_mesh_step` on seeded [P, B, K] images, at P in {1, 3, 8} and K in
  {32, 64}, validation off and on with pv < 0, a pv that gates slots
  out and one that keeps all, key filters, a value-filter mask, and the
  four value lanes' sums: packed mask, counts and lane sums equal; with
  no value filter, `extra=None` gives what an all-ones mask gives;
- `mesh_step_plain` wraps the lanes' sums mod 2^32 as XLA's uint32 sum;
- `mesh_step_buffer`'s one result buffer, cut by `result_layout` on the
  torch and the numpy side, holds the plain outputs (odd P and B = 8
  included, where the mask part is padded to 16 bytes).
"""

import numpy as np
import pytest
import torch

from pegasus_tpu.base.key_schema import generate_key, key_hash
from pegasus_tpu.ops.predicates import FilterSpec as JFilterSpec
from pegasus_tpu.ops.record_block import build_record_block as j_build
from pegasus_tpu.parallel import make_mesh as j_make_mesh
from pegasus_tpu.parallel import sharded_scan_step as j_sharded
from pegasus_tpu.parallel.mesh_resident import _mesh_step, _pattern_operands
from pegasus_tpu.parallel.partition_mesh import stack_blocks as j_stack
from pegasus_tpu_torch.ops import result_buffer
from pegasus_tpu_torch.ops.fused_mesh import (
    mesh_step,
    mesh_step_buffer,
    mesh_step_plain,
    result_layout,
)
from pegasus_tpu_torch.ops.fused_scan import scan_table
from pegasus_tpu_torch.ops.predicates import (
    FT_MATCH_ANYWHERE,
    FT_MATCH_POSTFIX,
    FT_MATCH_PREFIX,
    FT_NO_FILTER,
    FilterSpec,
)
from pegasus_tpu_torch.ops.record_block import RecordBlock
from pegasus_tpu_torch.ops.record_block import build_record_block as t_build
from pegasus_tpu_torch.parallel import make_mesh, sharded_scan_step
from pegasus_tpu_torch.parallel.partition_mesh import (
    partition_allowed,
    stack_blocks,
)

CPU = torch.device("cpu")
NOW = 100


def partition_keys(pc, per_part, expired_every=4, seed=0):
    """Per partition: keys that hash to it (a few foreign ones when
    `seed`), and their expire_ts (every `expired_every`-th long
    expired)."""
    rng = np.random.default_rng(seed)
    out = []
    for p in range(pc):
        keys, ets = [], []
        i = 0
        n = 0
        while n < per_part:
            hk = b"user_%d" % i
            i += 1
            own = key_hash(generate_key(hk, b"")) % pc == p
            if not own and not (seed and rng.random() < 0.05):
                continue
            keys.append(generate_key(hk, b"sk_%03d" % n))
            ets.append(1 if n % expired_every == 0 else 0)
            n += 1
        out.append((keys, ets))
    return out


def both_blocks(parts, width):
    jb = [j_build(k, e, capacity=len(k), key_width=width) for k, e in parts]
    tb = [t_build(k, e, capacity=len(k), key_width=width, device="cpu")
          for k, e in parts]
    return jb, tb


def test_mesh_shapes():
    pm = make_mesh(devices=[CPU] * 8)
    assert (pm.dp, pm.sp) == (8, 1)
    pm = make_mesh(dp=4, devices=[CPU] * 8)
    assert (pm.dp, pm.sp) == (4, 2)
    with pytest.raises(ValueError):
        make_mesh(dp=3, devices=[CPU] * 8)
    with pytest.warns(RuntimeWarning, match="single-device host"):
        pm = make_mesh(dp=8, devices=[CPU])
    assert (pm.dp, pm.sp) == (1, 1) and pm.device == CPU
    if not torch.cuda.is_available():
        # the card by default: the CPU only when the caller names it
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()


def test_sharded_scan_step_counts():
    pc, per_part = 8, 64
    parts = partition_keys(pc, per_part)
    want_keep = sum(e.count(0) for _k, e in parts)
    want_expired = sum(e.count(1) for _k, e in parts)
    _jb, tb = both_blocks(parts, 32)
    keep, total_kept, total_expired, per_kept = sharded_scan_step(
        make_mesh(dp=4, devices=[CPU] * 8), stack_blocks(tb), now=NOW)
    assert int(total_kept) == want_keep
    assert int(total_expired) == want_expired
    assert int(per_kept.sum()) == want_keep
    assert tuple(keep.shape) == (pc, per_part)


def test_sharded_scan_validates_partition_ownership():
    pc, per_part = 8, 32
    parts = partition_keys(pc, per_part, expired_every=10**9)
    _jb, tb = both_blocks(parts, 32)
    tb[0], tb[1] = tb[1], tb[0]  # their records become foreign
    _keep, total, _exp, per_kept = sharded_scan_step(
        make_mesh(devices=[CPU]), stack_blocks(tb, list(range(pc))),
        now=NOW, validate_hash=True, partition_version=pc - 1)
    counts = per_kept.numpy()
    assert counts[0] == 0 and counts[1] == 0
    assert int(total) == int(counts[2:].sum())


@pytest.mark.parametrize("pc", [1, 3, 8])
@pytest.mark.parametrize("width", [32, 64])
@pytest.mark.parametrize("validate,pv", [(False, -1), (True, -1),
                                         (True, 1), (True, 7)])
@pytest.mark.parametrize("sort", [None, (FT_MATCH_PREFIX, b"sk_00"),
                                  (FT_MATCH_ANYWHERE, b"1")])
def test_sharded_scan_step_matches_jax(pc, width, validate, pv, sort):
    parts = partition_keys(pc, 40, seed=3)
    jb, tb = both_blocks(parts, width)
    pidx = list(range(pc))[::-1]  # slots not in pidx order
    jsort = JFilterSpec.make(*sort) if sort else None
    tsort = FilterSpec.make(*sort) if sort else None
    jout = j_sharded(j_make_mesh(dp=1), j_stack(jb, pidx), now=NOW,
                     sort_filter=jsort, partition_version=pv,
                     validate_hash=validate)
    tout = sharded_scan_step(make_mesh(devices=[CPU]),
                             stack_blocks(tb, pidx), now=NOW,
                             sort_filter=tsort, partition_version=pv,
                             validate_hash=validate)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    for t, j in zip(tout[1:], jout[1:]):
        np.testing.assert_array_equal(np.asarray(t.numpy(), np.int64),
                                      np.asarray(j, np.int64))


def image(rng, pc, b, k, now):
    """A seeded [P, B, K] resident image, numpy: rows present up to a
    per-slot count, keys with a valid u16 hashkey prefix (a few
    malformed), TTLs around `now`, hash_lo whose low bits match the
    slot's pidx for most rows, value lanes of uint16 values, a
    value-filter mask."""
    keys = np.zeros((pc, b, k), np.uint8)
    key_len = np.zeros((pc, b), np.int32)
    ets = np.zeros((pc, b), np.uint32)
    present = np.zeros((pc, b), bool)
    hash_lo = np.zeros((pc, b), np.uint32)
    pidx = rng.permutation(pc).astype(np.uint32)
    alphabet = np.frombuffer(b"ab12", np.uint8)
    for s in range(pc):
        n = int(rng.integers(0, b + 1)) if s else b
        present[s, :n] = True
        for r in range(n):
            hk = int(rng.integers(0, 6))
            sk = int(rng.integers(0, k - 2 - hk + 1))
            keys[s, r, 0] = hk >> 8
            keys[s, r, 1] = hk & 0xFF
            keys[s, r, 2:2 + hk + sk] = rng.choice(alphabet, hk + sk)
            key_len[s, r] = 2 + hk + sk
            if rng.random() < 0.05:
                key_len[s, r] = int(rng.integers(0, 2))  # malformed
        ets[s, :n] = rng.choice(
            np.array([0, 1, now - 1, now, now + 1, 0xFFFFFFFF], np.uint32),
            n)
        own = rng.random(n) < 0.8
        noise = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        hash_lo[s, :n] = np.where(own, (noise & ~np.uint32(7)) | pidx[s],
                                  noise)
    hkl = (keys[..., 0].astype(np.int32) << 8) | keys[..., 1]
    valid = present & (key_len >= 2)
    hkl = np.where(key_len >= 2, hkl, 0).astype(np.int32)
    lanes = rng.integers(0, 1 << 16, (pc, b, 4)).astype(np.uint32)
    extra = rng.random((pc, b)) < 0.7
    return keys, key_len, hkl, ets, valid, present, hash_lo, pidx, lanes, \
        extra


def port_round(img, validate, pv, hf, sf, now, with_sum, extra_on):
    """The resident round as mesh_resident._run_program launches it."""
    keys, key_len, hkl, ets, valid, present, hash_lo, pidx, lanes, extra = img
    pc, b, k = keys.shape

    def t(a, dtype=None):
        a = np.ascontiguousarray(a)
        return torch.from_numpy(a.view(dtype) if dtype else a)

    flat = RecordBlock(t(keys.reshape(pc * b, k)),
                       t(key_len.reshape(pc * b)), t(hkl.reshape(pc * b)),
                       t(ets.reshape(pc * b), np.int32),
                       t(valid.reshape(pc * b)),
                       t(hash_lo.reshape(pc * b), np.int32))
    pidx_rows = t(pidx, np.int32).repeat_interleave(b)
    static = scan_table([flat], [pidx_rows], FilterSpec.make(*hf),
                        FilterSpec.make(*sf), validate, max(pv, 0) & 0xFFFFFFFF)
    allowed = torch.from_numpy(
        partition_allowed(pidx, validate, pv).astype(np.uint8))
    ext = t(extra) if extra_on else torch.ones((pc, b), dtype=torch.bool)
    # the wrapper takes the plain version for CPU tensors
    out = mesh_step(static.view(pc, b // 8), allowed, t(ets, np.int32),
                    t(present), ext, t(lanes, np.int32), now, with_sum)
    plain = mesh_step_plain(static.view(pc, b // 8), allowed,
                            t(ets, np.int32), t(present), ext,
                            t(lanes, np.int32), now, with_sum)
    for a, c in zip(out, plain):
        assert torch.equal(a, c)
    if not extra_on:
        # the all-ones instance, which reads no mask
        bare = mesh_step(static.view(pc, b // 8), allowed, t(ets, np.int32),
                         t(present), None, t(lanes, np.int32), now, with_sum)
        for a, c in zip(bare, out):
            assert torch.equal(a, c)
    return (out[0].numpy(), out[1].numpy(),
            out[2].numpy().view(np.uint32))


def jax_round(img, validate, pv, hf, sf, now, with_sum, extra_on):
    keys, key_len, hkl, ets, valid, present, hash_lo, pidx, lanes, extra = img
    hpat, hlen = _pattern_operands(hf[1])
    spat, slen = _pattern_operands(sf[1])
    allowed = partition_allowed(pidx, validate, pv)
    ext = extra if extra_on else np.ones_like(extra)
    out = _mesh_step(keys, key_len, hkl, ets, valid, present, lanes,
                     hash_lo, hpat, hlen, spat, slen, pidx,
                     np.uint32(max(pv, 0) & 0xFFFFFFFF), allowed,
                     np.uint32(now), ext, hash_filter_type=hf[0],
                     sort_filter_type=sf[0], validate_hash=validate,
                     with_sum=with_sum)
    return tuple(np.asarray(o) for o in out)


@pytest.mark.parametrize("pc", [1, 3, 8])
@pytest.mark.parametrize("width", [32, 64])
@pytest.mark.parametrize("validate,pv", [(False, -1), (True, -1),
                                         (True, 2), (True, 7)])
def test_resident_round_matches_mesh_step(pc, width, validate, pv):
    rng = np.random.default_rng(pc * 100 + width + pv)
    b = 64
    img = image(rng, pc, b, width, NOW)
    cases = (((FT_NO_FILTER, b""), (FT_NO_FILTER, b""), True, True),
             ((FT_MATCH_PREFIX, b"a"), (FT_NO_FILTER, b""), False, True),
             ((FT_NO_FILTER, b""), (FT_MATCH_POSTFIX, b"1"), True, False),
             ((FT_MATCH_ANYWHERE, b"b"), (FT_MATCH_ANYWHERE, b"2a"), True,
              True))
    for hf, sf, with_sum, extra_on in cases:
        got = port_round(img, validate, pv, hf, sf, NOW, with_sum,
                         extra_on)
        want = jax_round(img, validate, pv, hf, sf, NOW, with_sum,
                         extra_on)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])


def test_mesh_step_plain_lane_sums_wrap():
    """Lane sums wrap mod 2^32 (sums of full uint32 lanes, past what the
    uint16 lanes of a resident image reach)."""
    pc, b = 2, 16
    packed = torch.full((pc, b // 8), 0xFF, dtype=torch.uint8)
    allowed = torch.tensor([1, 0], dtype=torch.uint8)
    ets = torch.zeros((pc, b), dtype=torch.int32)
    ones = torch.ones((pc, b), dtype=torch.bool)
    lanes = torch.full((pc, b, 4), -1, dtype=torch.int32)  # 0xFFFFFFFF
    gated, counts, sums = mesh_step_plain(packed, allowed, ets, ones, ones,
                                          lanes, NOW, True)
    assert gated[1].tolist() == [0, 0]
    assert counts.tolist() == [[b, b, 0], [0, 0, 0]]
    want = (b * 0xFFFFFFFF) & 0xFFFFFFFF
    assert (sums.numpy().view(np.uint32)[0] == want).all()
    assert (sums[1] == 0).all()


@pytest.mark.parametrize("pc,b", [(1, 8), (5, 8), (3, 64), (7, 1024)])
@pytest.mark.parametrize("with_sum", [False, True])
@pytest.mark.parametrize("extra_on", [False, True])
def test_result_buffer_views_equal_plain(pc, b, with_sum, extra_on):
    rng = np.random.default_rng(pc * 1000 + b + 2 * with_sum + extra_on)
    packed = torch.from_numpy(rng.integers(0, 256, (pc, b // 8),
                                           dtype=np.uint8))
    allowed = torch.from_numpy((rng.random(pc) < 0.7).astype(np.uint8))
    ets = torch.from_numpy(rng.choice(np.array(
        [0, NOW - 1, NOW, NOW + 1, 0xFFFFFFFF], np.uint32),
        (pc, b)).view(np.int32))
    present = torch.from_numpy(rng.random((pc, b)) < 0.9)
    extra = torch.from_numpy(rng.random((pc, b)) < 0.5) if extra_on \
        else None
    lanes = torch.from_numpy(rng.integers(0, 1 << 32, (pc, b, 4),
                                          dtype=np.uint64).astype(
        np.uint32).view(np.int32))
    want = mesh_step_plain(packed, allowed, ets, present, extra, lanes, NOW,
                           with_sum)
    buf = mesh_step_buffer(packed, allowed, ets, present, extra, lanes, NOW,
                           with_sum)
    layout = result_layout(pc, b)
    assert buf.dtype == torch.uint8 and buf.dim() == 1
    assert buf.numel() == result_buffer.nbytes(layout) == \
        -(-pc * b // 8 // 16) * 16 + -(-12 * pc // 16) * 16 + 16 * pc
    for got, w in zip(result_buffer.views(buf, layout), want):
        assert torch.equal(got, w)
    host = result_buffer.home(buf)
    mask, counts, sums = result_buffer.views(host, layout)
    np.testing.assert_array_equal(mask, want[0].numpy())
    np.testing.assert_array_equal(counts, want[1].numpy())
    assert sums.dtype == np.uint32
    np.testing.assert_array_equal(sums, want[2].numpy().view(np.uint32))
