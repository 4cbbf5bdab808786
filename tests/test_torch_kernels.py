"""The scan-predicate kernel against its plain torch version, on the card.

A small-size repeat of chip_smoke.py's phase-3 checks, on a machine
with a card:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(`--noconftest`: the suite's conftest imports JAX, which the card's
machine need not have.) Every test skips where torch sees no CUDA device.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    NOWS,
    check_tables,
    check_tables_multi,
    device_block,
    predicate_cases,
    random_block_columns,
    serving_block_columns,
)
from pegasus_tpu_torch.ops import fused_scan
from pegasus_tpu_torch.ops.predicates import (
    FT_MATCH_ANYWHERE,
    FT_MATCH_PREFIX,
    FilterSpec,
    multi_static_block_predicate_submit,
    scan_block_predicate,
    static_block_predicate,
)
from pegasus_tpu_torch.ops.record_block import RecordBlock, block_from_columns
from pegasus_tpu_torch.server.scan_coordinator import stacked_block_eval

pytestmark = pytest.mark.cuda

SMALL_COUNTS = (100, 0, 33, 257, 8, 1, 64, 77, 255, 256, 13, 300, 7, 40,
                129, 500)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _block(rng, n, k, device):
    return device_block(random_block_columns(rng, n, k), device)


def test_kernel_matches_plain_on_every_case(card):
    out = check_tables(card, widths=(32, 256), counts=SMALL_COUNTS)
    cases = len(list(predicate_cases(np.random.default_rng(0), 32)))
    assert out["compared"] == 2 * cases * 2 * len(NOWS) * 4
    assert out["max_abs_err"] == 0


def test_block_predicates_launch_the_kernel(card):
    rng = np.random.default_rng(5)
    cpu_block = _block(rng, 509, 32, "cpu")
    dev_block = RecordBlock(*(t.to(card) for t in cpu_block))
    sf_cpu = FilterSpec.make(FT_MATCH_ANYWHERE, b"ab", "cpu")
    sf_dev = FilterSpec.make(FT_MATCH_ANYWHERE, b"ab", card)
    before = dict(fused_scan.LAUNCHES)
    for pack in (False, True):
        got = static_block_predicate(dev_block, sort_filter=sf_dev,
                                     validate_hash=True, pidx=3,
                                     partition_version=7, pack=pack)
        want = static_block_predicate(cpu_block, sort_filter=sf_cpu,
                                      validate_hash=True, pidx=3,
                                      partition_version=7, pack=pack)
        assert torch.equal(got.cpu(), want)
    got = scan_block_predicate(dev_block, 300_000_000, sort_filter=sf_dev,
                               validate_hash=True, pidx=3,
                               partition_version=7)
    want = scan_block_predicate(cpu_block, 300_000_000, sort_filter=sf_cpu,
                                validate_hash=True, pidx=3,
                                partition_version=7)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    torch.cuda.synchronize()
    assert fused_scan.LAUNCHES["static"] == before["static"] + 2
    assert fused_scan.LAUNCHES["now"] == before["now"] + 1


def test_stacked_eval_of_a_window_is_one_launch(card):
    rng = np.random.default_rng(9)
    blocks = []
    for i in range(8):
        keys, key_len, ets, hash_lo = serving_block_columns(rng, 1000, 32,
                                                            5, 63)
        cpu = block_from_columns(keys, key_len, ets, hash_lo=hash_lo,
                                 capacity=1024)
        blocks.append((i, cpu, RecordBlock(*(t.to(card) for t in cpu))))
    fk = (FT_MATCH_PREFIX, b"a", FT_MATCH_ANYWHERE, b"bc")
    want = dict(stacked_block_eval([(i, c, 5) for i, c, _d in blocks], True,
                                   63, filter_key=fk))
    before = dict(fused_scan.LAUNCHES)
    got = dict(stacked_block_eval([(i, d, 5) for i, _c, d in blocks], True,
                                  63, filter_key=fk))
    assert fused_scan.LAUNCHES["static"] == before["static"] + 1
    assert fused_scan.LAUNCHES["now"] == before["now"]
    for i, mask in want.items():
        np.testing.assert_array_equal(got[i], mask)


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    rng = np.random.default_rng(6)
    block = _block(rng, 64, 32, card)
    none = FilterSpec.none(card)
    bad = block._replace(expire_ts=block.expire_ts.to(torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        fused_scan.scan_table([bad], [0], none, none, False, 7)
    for pidx in (torch.zeros(64, dtype=torch.int64, device=card),
                 torch.zeros(3, dtype=torch.int32, device=card)):
        with pytest.raises(ValueError, match="pidx"):
            fused_scan.scan_table([block], [pidx], none, none, True, 7)
    with pytest.raises(ValueError, match="key width"):
        fused_scan.scan_table([block, _block(rng, 64, 64, card)], [0, 0],
                              none, none, False, 7)
    narrow = block._replace(keys=torch.zeros((64, 48), dtype=torch.uint8,
                                             device=card))
    with pytest.raises(ValueError, match="power of two"):
        fused_scan.scan_table([narrow], [0], none, none, False, 7)
    with pytest.raises(ValueError, match="blocks"):
        fused_scan.scan_table([block] * 17, [0] * 17, none, none, False, 7)


def test_flavour_axis_matches_plain_on_every_case(card):
    out = check_tables_multi(card, widths=(32, 256), ks=(2, 5),
                             counts=SMALL_COUNTS)
    # per width: 16 type pairs (one flavour count each) x 2 validate x 4
    # tables, and the gated lone block
    assert out["compared"] == 2 * (16 * 2 * 4 + 1)
    assert out["max_abs_err"] == 0


def test_flavour_axis_is_one_launch_a_table(card):
    rng = np.random.default_rng(10)
    cpu = [_block(rng, n, 32, "cpu") for n in (1024, 700, 1024)]
    dev = [RecordBlock(*(t.to(card) for t in b)) for b in cpu]
    pats = (b"a", b"bc", b"", b"d")

    def flavors(device):
        return [(FilterSpec.none(device), FilterSpec.make(3, p, device))
                for p in pats]

    before = dict(fused_scan.LAUNCHES)
    got = multi_static_block_predicate_submit(dev, flavors(card), True,
                                              [5, 3, 5], 7)
    assert fused_scan.LAUNCHES["multi"] == before["multi"] + 1
    want = multi_static_block_predicate_submit(cpu, flavors("cpu"), True,
                                               [5, 3, 5], 7)
    assert got.shape == (4, 128 + 88 + 128)
    assert torch.equal(got.cpu(), want)
    # a lone block under the split gate launches nothing
    gated = multi_static_block_predicate_submit(dev[0], flavors(card), True,
                                                9, 7)
    assert fused_scan.LAUNCHES["multi"] == before["multi"] + 1
    assert gated.shape == (4, 128) and not bool(gated.any())


def test_empty_block_launches_nothing(card):
    block = _block(np.random.default_rng(8), 0, 32, card)
    none = FilterSpec.none(card)
    before = dict(fused_scan.LAUNCHES)
    for now in (None, 5):
        out = fused_scan.scan_table([block, block], [0, 0], none, none,
                                    True, 7, now=now)
        assert out.shape == (0,) and out.is_cuda
    assert fused_scan.LAUNCHES == before
