"""The port's multi-flavour static predicate against the JAX package.

`multi_static_block_predicate` (K filter flavours of one filter type
pair over one block, one packed mask row a flavour) goes through both
packages on seeded blocks (chip_smoke.random_block_columns: empty
hashkeys, padding, short and malformed rows) built with the JAX
package's block_from_columns and carried into the port by convert.py:
every pair of filter types at key width 32 and a diagonal of pairs at
64 and 256, short and long patterns within one pad width, validation
off, a scalar pidx, a pidx column, and the split gate (pv = -1, pidx
past pv). The port's table form (several blocks in one call, each with
its own pidx and no gate) is held against the JAX function block by
block. Masks are booleans, so the tolerance is exact.
"""

import numpy as np
import pytest
import torch

from chip_smoke import random_block_columns, random_pattern
from pegasus_tpu.ops import predicates as jp
from pegasus_tpu.ops.record_block import block_from_columns as j_from_columns
from pegasus_tpu_torch import convert
from pegasus_tpu_torch.ops import predicates as tp
from pegasus_tpu_torch.ops.record_block import next_bucket

PV = 7
CAP = 200


def _block(rng, k):
    keys, key_len, ets, hash_lo = random_block_columns(rng, CAP, k)
    jblock = j_from_columns(keys, key_len, ets, hash_lo=hash_lo)
    return jblock, convert.record_block(jblock, "cpu"), hash_lo


def _flavors(rng, hft, sft, n, lo, hi):
    """n flavours of one type pair, pattern lengths in lo..hi (one pad
    width: the JAX program stacks the patterns)."""
    pats = [(random_pattern(rng, int(rng.integers(lo, hi + 1))),
             random_pattern(rng, int(rng.integers(lo, hi + 1))))
            for _ in range(n)]
    assert len({next_bucket(len(p)) for pair in pats for p in pair}) == 1
    return ([(jp.FilterSpec.make(hft, h), jp.FilterSpec.make(sft, s))
             for h, s in pats],
            [(tp.FilterSpec.make(hft, h), tp.FilterSpec.make(sft, s))
             for h, s in pats])


def _check(jblock, tblock, jf, tf, validate, pidx, pv):
    want = jp.multi_static_block_predicate(jblock, jf, validate, pidx, pv)
    tpidx = (torch.from_numpy(pidx.astype(np.int32))
             if isinstance(pidx, np.ndarray) else pidx)
    got = tp.multi_static_block_predicate(tblock, tf, validate, tpidx, pv)
    assert got.shape == want.shape == (len(jf), CAP)
    np.testing.assert_array_equal(got, want)
    return got


PAIRS = [(h, s) for h in range(4) for s in range(4)]


@pytest.mark.parametrize("k, hft, sft",
                         [(32, h, s) for h, s in PAIRS]
                         + [(k, h, h) for k in (64, 256) for h in range(4)])
def test_multi_predicate_matches_jax(k, hft, sft):
    rng = np.random.default_rng(700 + k + 4 * hft + sft)
    jblock, tblock, hash_lo = _block(rng, k)
    column = np.where(rng.random(CAP) < 0.5, hash_lo & PV,
                      rng.integers(0, PV + 1, CAP)).astype(np.uint32)
    # short patterns (empty ones match everything) and, past width 32,
    # ones about as long as a row, each set within one pad width (every
    # set and validation mode is one JAX compile, hence the diagonal)
    sets = [(3, 0, 4)] + ([(5, k // 2 + 1, k)] if k > 32 else [])
    for n, lo, hi in sets:
        jf, tf = _flavors(rng, hft, sft, n, lo, hi)
        _check(jblock, tblock, jf, tf, False, 0, PV)
        _check(jblock, tblock, jf, tf, True, column, PV)
        for pidx, pv in ((3, -1), (PV + 1, PV)):
            # the split gate: every row all-zero, nothing evaluated
            gated = _check(jblock, tblock, jf, tf, True, pidx, pv)
            assert not gated.any()
        if k > 32:
            _check(jblock, tblock, jf, tf, True, 3, PV)


def test_table_form_matches_jax_block_by_block():
    rng = np.random.default_rng(790)
    blocks = [_block(rng, 32) for _ in range(3)]
    jf, tf = _flavors(rng, jp.FT_MATCH_PREFIX, jp.FT_MATCH_POSTFIX, 4, 0, 3)
    pidxs = [3, 5, PV + 1]  # no gate in a table, even past pv
    packed = tp.multi_static_block_predicate_submit(
        [tb for _jb, tb, _h in blocks], tf, True, pidxs, PV)
    assert packed.shape == (4, 3 * CAP // 8)
    for i, ((jblock, _tb, _h), pidx) in enumerate(zip(blocks, pidxs)):
        want = jp.multi_static_block_predicate(
            jblock, jf, True, np.full(CAP, pidx, dtype=np.uint32), PV)
        got = tp.unpack_masks(packed[:, i * CAP // 8:(i + 1) * CAP // 8],
                              CAP)
        np.testing.assert_array_equal(got, want, err_msg=str(i))


def test_flavours_of_two_type_pairs_are_refused():
    rng = np.random.default_rng(791)
    _jb, tblock, _h = _block(rng, 32)
    flavors = [(tp.FilterSpec.none(), tp.FilterSpec.make(2, b"a")),
               (tp.FilterSpec.none(), tp.FilterSpec.make(3, b"a"))]
    with pytest.raises(ValueError, match="type pair"):
        tp.multi_static_block_predicate(tblock, flavors, False, 0, PV)
