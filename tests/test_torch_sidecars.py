"""The port's SST sidecars and point probes against the JAX package.

- bloom filters: the same bits for the same hashes and bits-per-key, the
  same vectorized and scalar answers, and `MultiProbe` (native) equal to
  its scalar twin and to the JAX package's;
- perfect-hash indexes: the same index bytes from the port's native
  build, its `_build_once_py` twin and the JAX package's build, for the
  same seed; the same locations from the scalar, vectorized and native
  multi-index probes; a fingerprint collision reads as absent through
  `phash_verify_rows`; `phash_force_fail` leaves no index;
- `bloom_key_hashes` on both sides of its 16-key threshold,
  `point_probe_rows` on both sides of its 4-key threshold with
  trailing-zero twins, `host_key_hash_lo`, and the native region filter
  against its scalar twin.
"""

import numpy as np
import pytest

from pegasus_tpu.ops import predicates as jpred
from pegasus_tpu.storage import bloom as jbloom
from pegasus_tpu.storage import phash as jphash
from pegasus_tpu.utils.flags import FLAGS as JFLAGS
from pegasus_tpu_torch.base.crc import crc64, crc64_batch, crc64_rows
from pegasus_tpu_torch.base.key_schema import generate_key
from pegasus_tpu_torch.ops import predicates as tpred
from pegasus_tpu_torch.storage import bloom as tbloom
from pegasus_tpu_torch.storage import phash as tphash
from pegasus_tpu_torch.utils.flags import FLAGS as TFLAGS


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    return sorted({generate_key(b"user%06d" % int(rng.integers(0, 10 ** 6)),
                                b"s%02d" % int(rng.integers(0, 10)))
                   for _ in range(n)})


def _hashes(keys):
    return np.array([crc64(k) for k in keys], dtype=np.uint64)


@pytest.mark.parametrize("n,bits", [(1, 10), (300, 10), (5000, 4),
                                    (5000, 16)])
def test_bloom_filter_bytes_and_probes(n, bits):
    keys = _keys(n)
    h = _hashes(keys)
    tb, jb = tbloom.BloomFilter.build(h, bits), \
        jbloom.BloomFilter.build(h, bits)
    assert tb.to_bytes() == jb.to_bytes() and (tb.m, tb.k) == (jb.m, jb.k)
    probe = _hashes(keys[::3] + [k + b"x" for k in keys[:400]])
    assert np.array_equal(tb.may_contain_hashes(probe),
                          jb.may_contain_hashes(probe))
    assert tb.may_contain_hashes(h).all()
    assert np.array_equal(tpred.bloom_probe_rows(tb, probe),
                          jpred.bloom_probe_rows(jb, probe))
    assert tpred.bloom_probe_rows(None, probe).all()
    assert [tb.may_contain_hash(int(x)) for x in probe] == \
        [jb.may_contain_hash(int(x)) for x in probe]
    back = tbloom.BloomFilter.from_bytes(tb.to_bytes(), tb.m, tb.k)
    assert back.to_bytes() == tb.to_bytes()
    assert tbloom.BloomFilter.from_bytes(tb.to_bytes()[:-1], tb.m,
                                         tb.k) is None


def test_bloom_multi_probe_matches_scalar_and_jax():
    sets = [_keys(n, seed) for n, seed in ((50, 1), (700, 2), (3000, 3))]
    filters = [(tbloom.BloomFilter.build(_hashes(s), 10),
                jbloom.BloomFilter.build(_hashes(s), 10)) for s in sets]
    tm = tbloom.MultiProbe([f for f, _ in filters])
    jm = jbloom.MultiProbe([f for _, f in filters])
    probe = _hashes(sets[0][:20] + sets[2][::50] + [b"absent%d" % i
                                                    for i in range(200)])
    assert tm.probe(probe) == tm.probe_plain(probe) == jm.probe(probe)


@pytest.mark.parametrize("n,block", [(1, 1024), (700, 64), (4096, 1024),
                                     (20000, 1024)])
def test_phash_index_bytes_native_python_and_jax(n, block):
    keys = _keys(n, seed=n)
    h = _hashes(keys)
    counts = [block] * (len(keys) // block)
    if len(keys) % block:
        counts.append(len(keys) % block)
    ti = tphash.PHashIndex.build(h, counts)
    ji = jphash.PHashIndex.build(h, counts)
    assert ti is not None and ti.to_bytes() == ji.to_bytes()
    assert ti.meta() == ji.meta()
    starts = np.concatenate([[0], np.cumsum(counts)])
    locs = np.concatenate([(b << ti.slot_bits) + np.arange(c)
                           for b, c in enumerate(counts)]).astype(np.uint32)
    assert int(starts[-1]) == len(keys)
    py = tphash._build_once_py(np.ascontiguousarray(h), locs, ti.seed,
                               ti.ts, ti.nb)
    assert py is not None
    assert py[0].tobytes() + py[1].tobytes() == ti.to_bytes()
    # every key locates to its own (block, slot)
    got = ti.probe_hashes(h)
    assert np.array_equal(got, locs)
    assert [ti.lookup_hash(int(x)) for x in h[:200]] == \
        [int(x) for x in locs[:200]]
    back = tphash.PHashIndex.from_bytes(ti.to_bytes(), ti.meta())
    assert np.array_equal(back.probe_hashes(h), locs)


def test_phash_multi_probe_and_fingerprint_collisions():
    sets = [_keys(n, seed) for n, seed in ((100, 4), (2000, 5))]
    idx = []
    for s in sets:
        counts = [1024] * (len(s) // 1024) + ([len(s) % 1024]
                                               if len(s) % 1024 else [])
        idx.append((tphash.PHashIndex.build(_hashes(s), counts),
                    jphash.PHashIndex.build(_hashes(s), counts)))
    tp = tphash.PHashMultiProbe([t for t, _ in idx])
    jp = jphash.PHashMultiProbe([j for _, j in idx])
    absent = [b"\x00\x08absent%02d" % i for i in range(20000)]
    probe = _hashes(sets[0][:30] + sets[1][::40] + absent)
    tl, tmask = tp.probe(probe)
    pl, pmask = tp.probe_plain(probe)
    jl, jmask = jp.probe(probe)
    assert tmask == pmask == jmask
    assert list(tl) == list(pl) == list(jl)
    # absent keys that still land on an occupied slot with a matching
    # fingerprint: located, then rejected by the row compare
    ix = idx[1][0]
    absent_h = _hashes(absent)
    located = np.flatnonzero(ix.probe_hashes(absent_h)
                             != np.uint32(tphash.ABSENT))
    assert located.size > 0
    keys = sets[1]
    width = 32
    mat = np.zeros((len(keys), width), dtype=np.uint8)
    klen = np.array([len(k) for k in keys], dtype=np.int32)
    for i, k in enumerate(keys):
        mat[i, :len(k)] = np.frombuffer(k, dtype=np.uint8)
    for sel in (located[:3], located[:40]):  # both sides of p <= 4
        locs = ix.probe_hashes(absent_h[sel])
        rows = np.array([(loc >> ix.slot_bits) * 1024
                         + (loc & ((1 << ix.slot_bits) - 1))
                         for loc in locs.tolist()], dtype=np.int64)
        probes = [absent[i] for i in sel]
        got = tpred.phash_verify_rows(mat, klen, rows, probes)
        assert not got.any()
        assert np.array_equal(got, jpred.phash_verify_rows(mat, klen, rows,
                                                           probes))
        # the rows' own keys verify
        own = [keys[r] for r in rows.tolist()]
        assert tpred.phash_verify_rows(mat, klen, rows, own).all()


def test_phash_force_fail_leaves_no_index():
    saved = [(reg, reg.get("pegasus.server", "phash_force_fail"))
             for reg in (TFLAGS, JFLAGS)]
    try:
        for reg, _v in saved:
            reg.set("pegasus.server", "phash_force_fail", True, force=True)
        h = _hashes(_keys(100))
        assert tphash.PHashIndex.build(h, [len(h)]) is None
        assert jphash.PHashIndex.build(h, [len(h)]) is None
    finally:
        for reg, v in saved:
            reg.set("pegasus.server", "phash_force_fail", v, force=True)


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 200])
def test_bloom_key_hashes_both_sides_of_the_threshold(n):
    keys = _keys(n, seed=n) + [b"", b"\x00"][:min(n, 2)]
    got = tpred.bloom_key_hashes(keys)
    assert np.array_equal(got, jpred.bloom_key_hashes(keys))
    assert np.array_equal(got, _hashes(keys))
    if keys:
        width = max(1, max(len(k) for k in keys))
        mat, lens = tpred.pad_probe_keys(keys, width)
        assert np.array_equal(crc64_rows(mat, lens),
                              crc64_batch(mat, lens))


def _twin_block():
    """A sorted block whose keys include trailing-zero twins (`t`,
    `t\\x00`, `t\\x00\\x00` pad to one row)."""
    keys = sorted({generate_key(b"hk%03d" % h, sk)
                   for h in range(40)
                   for sk in (b"a", b"t", b"t\x00", b"t\x00\x00", b"z")})
    width = 16
    mat = np.zeros((len(keys), width), dtype=np.uint8)
    klen = np.array([len(k) for k in keys], dtype=np.int32)
    for i, k in enumerate(keys):
        mat[i, :len(k)] = np.frombuffer(k, dtype=np.uint8)
    return keys, mat, klen


@pytest.mark.parametrize("p", [1, 4, 5, 60])
def test_point_probe_rows_with_trailing_zero_twins(p):
    keys, mat, klen = _twin_block()
    rng = np.random.default_rng(p)
    probes = []
    for i in range(p):
        k = keys[int(rng.integers(0, len(keys)))]
        probes.append(k if i % 3 else k + b"\x00" * int(rng.integers(1, 3)))
    probes.append(b"\x00" * 20)  # wider than the block: absent
    got = tpred.point_probe_rows(mat, klen, probes)
    assert np.array_equal(got, jpred.point_probe_rows(mat, klen, probes))
    for k, r in zip(probes, got.tolist()):
        assert (r >= 0) == (k in keys)
        if r >= 0:
            assert keys[r] == k


def test_host_key_hash_lo_matches_jax():
    hks = [b"user%04d" % i for i in range(50)] + [b"", b""]
    sks = [b"s%02d" % (i % 10) for i in range(52)]
    assert np.array_equal(tpred.host_key_hash_lo(hks, sks),
                          jpred.host_key_hash_lo(hks, sks))
    assert np.array_equal(tpred.host_key_hash_lo(hks),
                          jpred.host_key_hash_lo(hks))


@pytest.mark.parametrize("ftype", [1, 2, 3])
def test_region_filter_native_matches_scalar_and_jax(ftype):
    rng = np.random.default_rng(ftype)
    regions = [bytes(rng.integers(48, 52, int(rng.integers(0, 9)),
                                  dtype=np.uint8)) for _ in range(300)]
    heap = np.frombuffer(b"".join(regions), dtype=np.uint8)
    offs = np.concatenate([[0], np.cumsum([len(r) for r in regions])])
    for pattern in (b"0", b"12", b"301", b""):
        got = tpred._region_filter_host(heap, offs, ftype, pattern)
        assert np.array_equal(
            got, tpred.region_filter_plain(heap, offs, ftype, pattern))
        assert np.array_equal(
            got, jpred._region_filter_host(heap, offs, ftype, pattern))
