"""The port's stacked evaluation and table predicate against the JAX package.

Seeded blocks (chip_smoke.random_block_columns: empty hashkeys, padding,
short and malformed rows, expire_ts past 2^31) built with the JAX
package's block_from_columns and carried into the port by convert.py go
through
- `stacked_block_eval` of both packages (tables of 1, 3, 8, 16 and 17
  blocks, capacities that are and are not multiples of 8, a scalar pidx
  per block including one past the partition version, validation on and
  off, pv = -1, every pair of filter types, K in {32, 64});
- the port's plain table function against `scan_status_plain` block by
  block, and its packed form against the JAX static_block_predicate's
  `jnp.packbits` output.
Every output is an integer or boolean mask, so the tolerance is exact.
"""

import numpy as np
import pytest
import torch

from chip_smoke import predicate_cases, random_block_columns
from pegasus_tpu.ops import predicates as jp
from pegasus_tpu.ops.record_block import block_from_columns as j_from_columns
from pegasus_tpu.server import scan_coordinator as jsc
from pegasus_tpu.server.workload import DRIFT as JDRIFT
from pegasus_tpu_torch import convert
from pegasus_tpu_torch.ops import fused_scan
from pegasus_tpu_torch.ops import predicates as tp
from pegasus_tpu_torch.server import scan_coordinator as tsc

PV = 7


@pytest.fixture(autouse=True)
def _reset_jax_drift():
    """The JAX stacked_block_eval audits every wave against its TPU cost
    model in a process-wide drift gauge; on the CPU its compiles read as
    ~300x drift, which would fire the JAX health rule in later tests."""
    yield
    JDRIFT.reset()


def _blocks(rng, caps, k):
    """[(tag, JAX block, port block on the CPU, pidx)] for the capacities
    `caps`; pidx is drawn from 0..PV + 1 (PV + 1: past the partition
    version, the split gate's case)."""
    out = []
    for i, cap in enumerate(caps):
        keys, key_len, ets, hash_lo = random_block_columns(rng, cap, k)
        jblock = j_from_columns(keys, key_len, ets, hash_lo=hash_lo)
        out.append((("blk", i), jblock, convert.record_block(jblock, "cpu"),
                    int(rng.integers(0, PV + 2))))
    return out


def _eval_both(blocks, validate, pv, filter_key):
    want = dict(jsc.stacked_block_eval(
        [(tag, jb, pidx) for tag, jb, _tb, pidx in blocks], validate, pv,
        filter_key=filter_key))
    got = dict(tsc.stacked_block_eval(
        [(tag, tb, pidx) for tag, _jb, tb, pidx in blocks], validate, pv,
        filter_key=filter_key))
    assert set(got) == set(want)
    for tag, _jb, tb, _p in blocks:
        assert got[tag].dtype == bool and got[tag].shape == (tb.capacity,)
        np.testing.assert_array_equal(got[tag], want[tag], err_msg=str(tag))


@pytest.mark.parametrize("hft", range(4))
@pytest.mark.parametrize("sft", range(4))
def test_stacked_eval_matches_jax_every_filter_pair(hft, sft):
    rng = np.random.default_rng(300 + 4 * hft + sft)
    # 17 blocks of one capacity: a table of 16 and one block alone
    blocks = _blocks(rng, [64] * 17, 32)
    for f in predicate_cases(rng, 32):
        if f[0] != hft or f[2] != sft:
            continue
        for validate in (False, True):
            _eval_both(blocks, validate, PV, f)


@pytest.mark.parametrize("n_blocks", [1, 3, 8, 16, 17])
@pytest.mark.parametrize("k", [32, 64])
def test_stacked_eval_matches_jax_table_sizes(n_blocks, k):
    rng = np.random.default_rng(400 + n_blocks + k)
    # two capacities (the second not a multiple of 8) bucket apart
    caps = [64 if i % 3 else 37 for i in range(n_blocks)]
    blocks = _blocks(rng, caps, k)
    filters = [None, (jp.FT_MATCH_PREFIX, b"a", jp.FT_MATCH_ANYWHERE, b"cd"),
               (jp.FT_MATCH_POSTFIX, b"b", jp.FT_MATCH_PREFIX, b"")]
    for f in filters:
        for validate, pv in ((False, PV), (True, PV), (True, -1)):
            _eval_both(blocks, validate, pv, f)


def test_stacked_eval_of_nothing_yields_nothing():
    assert list(tsc.stacked_block_eval([], True, PV)) == []


@pytest.mark.parametrize("k", [32, 64])
def test_plain_table_matches_blocks_and_jax_packbits(k):
    rng = np.random.default_rng(500 + k)
    blocks = _blocks(rng, [1, 37, 64, 100, 0, 13], k)
    tblocks = [tb for _t, _jb, tb, _p in blocks]
    col = torch.from_numpy(rng.integers(0, PV + 1, 100).astype(np.int32))
    # a per-record pidx column on one block, scalars elsewhere (at most
    # PV: the table function leaves the split gate to its callers)
    pidxs = [col if tb.capacity == 100 else int(rng.integers(0, PV + 1))
             for tb in tblocks]
    for hft, hp, sft, sp in predicate_cases(rng, k):
        th = convert.filter_spec(hft, hp, "cpu")
        ts = convert.filter_spec(sft, sp, "cpu")
        for validate in (False, True):
            for now in (None, 300_000_000, 0x80000010):
                got = fused_scan.scan_table(tblocks, pidxs, th, ts, validate,
                                            PV, now)
                parts = []
                for tb, pidx in zip(tblocks, pidxs):
                    status = fused_scan.scan_status_plain(
                        tb, th, ts, validate, pidx, PV, now)
                    parts.append(status if now is not None else
                                 tp.pack_mask(status
                                              == fused_scan.STATUS_KEEP))
                assert torch.equal(got, torch.cat(parts))
    # the packed form block by block against jnp.packbits (each block
    # shape compiles a JAX program, so a few filters suffice here; the
    # stacked tests above cover every filter pair)
    jpidxs = [p.numpy().astype(np.uint32) if isinstance(p, torch.Tensor)
              else p for p in pidxs]
    for hft, hp, sft, sp in ((0, b"", 0, b""), (2, b"ab", 1, b"c")):
        th = convert.filter_spec(hft, hp, "cpu")
        ts = convert.filter_spec(sft, sp, "cpu")
        jh, js = jp.FilterSpec.make(hft, hp), jp.FilterSpec.make(sft, sp)
        got = fused_scan.scan_table(tblocks, pidxs, th, ts, True, PV)
        offset = 0
        for (_t, jb, tb, _p), jpidx in zip(blocks, jpidxs):
            nbytes = -(-tb.capacity // 8)
            want = np.asarray(jp.static_block_predicate(
                jb, jh, js, True, jpidx, PV, pack=True))
            np.testing.assert_array_equal(
                got[offset:offset + nbytes].numpy(), want)
            offset += nbytes
        assert offset == got.numel()
