"""The port's plain scan predicate against the JAX package, exact.

Seeded blocks (chip_smoke.random_block_columns: empty hashkeys, padding,
short and malformed rows, expire_ts past 2^31) go through
- JAX scan_block_predicate (all four masks) and static_block_predicate
  (pack False and True) vs the port's on the CPU;
- the Pallas kernel fused_scan_block(interpret=True) vs the port's
  fused_scan_block;
- JAX compaction_filter_block vs the port's.
Every output is an integer or boolean mask, so the tolerance is exact.
"""

import numpy as np
import pytest
import torch

from chip_smoke import predicate_cases, random_block_columns
from pegasus_tpu.ops import compaction as jcomp
from pegasus_tpu.ops import predicates as jp
from pegasus_tpu.ops.pallas_scan import fused_scan_block as j_fused
from pegasus_tpu.ops.record_block import block_from_columns as j_from_columns
from pegasus_tpu.ops.record_block import build_record_block as j_build
from pegasus_tpu_torch import convert
from pegasus_tpu_torch.ops import compaction as tcomp
from pegasus_tpu_torch.ops import fused_scan
from pegasus_tpu_torch.ops import predicates as tp
from pegasus_tpu_torch.ops.record_block import build_record_block

PV = 7
NOWS = (300_000_000, 0x80000010)


def _blocks(seed, b, k):
    """(JAX block with hash_lo, port block on the CPU, hash_lo)."""
    rng = np.random.default_rng(seed)
    keys, key_len, ets, hash_lo = random_block_columns(rng, b, k)
    jblock = j_from_columns(keys, key_len, ets, hash_lo=hash_lo)
    return jblock, convert.record_block(jblock, "cpu"), hash_lo, rng


def _pidx_modes(rng, hash_lo):
    col = np.where(rng.random(hash_lo.size) < 0.5, hash_lo & PV,
                   rng.integers(0, PV + 1, hash_lo.size)).astype(np.uint32)
    return [(False, 0, 0), (True, 3, 3),
            (True, col, torch.from_numpy(col.astype(np.int32))),
            (True, PV + 1, PV + 1)]  # pidx > pv: the reject-all gate


def _check_block(jblock, tblock, rng, hash_lo, cases):
    for hft, hpat, sft, spat in cases:
        jh, js = jp.FilterSpec.make(hft, hpat), jp.FilterSpec.make(sft, spat)
        th = convert.filter_spec(hft, hpat, "cpu")
        ts = convert.filter_spec(sft, spat, "cpu")
        for validate, jpidx, tpidx in _pidx_modes(rng, hash_lo):
            for pack in (False, True):
                want = np.asarray(jp.static_block_predicate(
                    jblock, jh, js, validate, jpidx, PV, pack=pack))
                got = tp.static_block_predicate(
                    tblock, th, ts, validate, tpidx, PV, pack=pack)
                np.testing.assert_array_equal(got.numpy(), want)
            for now in NOWS:
                want = jp.scan_block_predicate(jblock, now, jh, js, validate,
                                               jpidx, PV)
                got = tp.scan_block_predicate(tblock, now, th, ts, validate,
                                              tpidx, PV)
                for name in tp.ScanMasks._fields:
                    np.testing.assert_array_equal(
                        getattr(got, name).numpy(),
                        np.asarray(getattr(want, name)), err_msg=name)


@pytest.mark.parametrize("hft", range(4))
@pytest.mark.parametrize("sft", range(4))
def test_block_predicates_match_jax(hft, sft):
    jblock, tblock, hash_lo, rng = _blocks(10 * hft + sft, 128, 32)
    cases = [c for c in predicate_cases(rng, 32)
             if c[0] == hft and c[2] == sft]
    assert len(cases) == 3  # short, empty and over-long patterns
    _check_block(jblock, tblock, rng, hash_lo, cases)


@pytest.mark.parametrize("hft,sft", [(0, 1), (1, 2), (2, 3), (3, 0)])
def test_block_predicates_match_jax_k64(hft, sft):
    jblock, tblock, hash_lo, rng = _blocks(100 + hft, 128, 64)
    cases = [c for c in predicate_cases(rng, 64)
             if c[0] == hft and c[2] == sft]
    _check_block(jblock, tblock, rng, hash_lo, cases)


def test_negative_partition_version_rejects_all():
    jblock, tblock, _h, _rng = _blocks(7, 64, 32)
    want = jp.scan_block_predicate(jblock, NOWS[0], validate_hash=True,
                                   pidx=0, partition_version=-1)
    got = tp.scan_block_predicate(tblock, NOWS[0], validate_hash=True,
                                  pidx=0, partition_version=-1)
    for name in tp.ScanMasks._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert not got.keep.any()
    packed = tp.static_block_predicate(tblock, validate_hash=True,
                                       pidx=0, partition_version=-1,
                                       pack=True)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jp.static_block_predicate(
            jblock, validate_hash=True, pidx=0, partition_version=-1,
            pack=True)))


def test_hash_lo_matches_device_hash_of_jax():
    """A JAX block without hash_lo hashes its keys on the device
    (key_hash_device); the port's block carries the same lo lane."""
    rng = np.random.default_rng(11)
    keys = [bytes([0, n]) + rng.choice(np.frombuffer(b"ab", np.uint8),
                                       n + int(rng.integers(0, 5))).tobytes()
            for n in rng.integers(0, 12, 96)]
    ets = rng.integers(0, 2, 96) * 300_000_000
    jblock = j_build(keys, ets)
    tblock = build_record_block(keys, ets)
    for name in tblock._fields:
        got = getattr(tblock, name).numpy()
        if name in ("expire_ts", "hash_lo"):  # uint32 bits carried as int32
            got = got.view(np.uint32)
        np.testing.assert_array_equal(got, np.asarray(getattr(jblock, name)),
                                      err_msg=name)
    assert torch.equal(convert.record_block(
        jblock._replace(hash_lo=None), "cpu").hash_lo, tblock.hash_lo)
    for pidx in range(PV + 1):
        want = jp.scan_block_predicate(jblock._replace(hash_lo=None),
                                       NOWS[0], validate_hash=True,
                                       pidx=pidx, partition_version=PV)
        got = tp.scan_block_predicate(tblock, NOWS[0], validate_hash=True,
                                      pidx=pidx, partition_version=PV)
        np.testing.assert_array_equal(got.keep.numpy(),
                                      np.asarray(want.keep))


@pytest.mark.parametrize("sft", range(4))
def test_fused_scan_block_matches_pallas_interpret(sft):
    jblock, tblock, hash_lo, rng = _blocks(200 + sft, 128, 32)
    pat = b"ab"
    js, ts = jp.FilterSpec.make(sft, pat), convert.filter_spec(sft, pat,
                                                               "cpu")
    # the Pallas kernel carries `now` as an int32 scalar
    for validate, pidx in ((False, 0), (True, 5), (True, PV + 1)):
        for now in (NOWS[0], 0x7FFFFFF0):
            want = j_fused(jblock, now, sort_filter=js, pidx=pidx,
                           partition_version=PV, validate_hash=validate,
                           interpret=True)
            got = fused_scan.fused_scan_block(
                tblock, now, sort_filter=ts, pidx=pidx,
                partition_version=PV, validate_hash=validate)
            np.testing.assert_array_equal(got[0].numpy(), want[0])
            np.testing.assert_array_equal(got[1].numpy(), want[1])


@pytest.mark.parametrize("default_ttl", [0, 3600])
@pytest.mark.parametrize("validate", [False, True])
def test_compaction_filter_matches_jax(default_ttl, validate):
    rng = np.random.default_rng(17)
    keys = [b"\x00\x04" + rng.integers(97, 101, 4 + int(n),
                                        dtype=np.uint8).tobytes()
            for n in rng.integers(0, 8, 200)]
    keys += [b"\x00\x00" + b"sortonly%d" % i for i in range(20)]
    ets = rng.choice(np.array([0, 100, 299_999_999, 300_000_000,
                               300_000_001, 0x90000000], np.uint64), 220)
    jblock = j_build(keys, ets)
    tblock = build_record_block(keys, ets)
    for now in NOWS:
        want_drop, want_ets = jcomp.compaction_filter_block(
            jblock.keys, jblock.key_len, jblock.hashkey_len,
            jblock.expire_ts, jblock.valid,
            np.uint32(now), np.uint32(default_ttl), np.uint32(3),
            np.uint32(PV), validate)
        drop, new_ets = tcomp.compaction_filter_block(
            tblock.hash_lo, tblock.expire_ts, tblock.valid, now,
            default_ttl, 3, PV, validate)
        np.testing.assert_array_equal(drop.numpy(), np.asarray(want_drop))
        np.testing.assert_array_equal(new_ets.numpy(),
                                      np.asarray(want_ets))


def test_match_filter_edges():
    """Empty pattern matches all; regions shorter than the pattern never
    match; PREFIX/POSTFIX clip indices; ANYWHERE reads zeros past K."""
    keys = np.zeros((6, 32), np.uint8)
    keys[:, :6] = np.frombuffer(b"abcabc", np.uint8)
    keys[5, 31] = ord("z")
    start = np.array([0, 0, -3, 30, 3, 31], np.int32)
    length = np.array([6, 2, 9, 5, 3, 4], np.int32)
    for ft in range(4):
        for pat in (b"", b"abc", b"c", b"z\x00", b"bcabcabcabc"):
            want = np.asarray(jp.match_filter(
                keys, start, length, jp.FilterSpec.make(ft, pat).pattern,
                np.int32(len(pat)), ft))
            got = tp.match_filter(
                torch.from_numpy(keys), torch.from_numpy(start),
                torch.from_numpy(length),
                convert.filter_spec(ft, pat, "cpu").pattern, len(pat), ft)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{ft} {pat!r}")


def test_host_helpers_match_jax():
    rng = np.random.default_rng(23)
    for ft in range(4):
        for data, pat in ((b"abcab", b"ab"), (b"abc", b""), (b"", b"a"),
                          (b"xyz", b"xyz"), (b"ab", b"abc")):
            assert (tp.host_match_filter(data, ft, pat)
                    == jp.host_match_filter(data, ft, pat))
    ets = rng.choice(np.array([0, 5, 10, 11, 0xFFFFFFFF], np.uint32), 50)
    for now in (0, 10, 0xFFFFFFFE):
        np.testing.assert_array_equal(tp.host_alive_mask(ets, now),
                                      jp.host_alive_mask(ets, now))
    mask = rng.random(37) < 0.5
    packed = tp.pack_mask(torch.from_numpy(mask))
    np.testing.assert_array_equal(packed.numpy(), np.packbits(mask))
    np.testing.assert_array_equal(tp.unpack_masks(packed, 37),
                                  jp.unpack_masks(np.packbits(mask), 37))


def test_cpu_block_never_launches_the_kernel():
    _jb, tblock, _h, _rng = _blocks(3, 64, 32)
    before = dict(fused_scan.LAUNCHES)
    tp.scan_block_predicate(tblock, NOWS[0], validate_hash=True, pidx=1,
                            partition_version=PV)
    tp.static_block_predicate(tblock)
    assert fused_scan.LAUNCHES == before
