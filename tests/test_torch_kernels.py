"""The scan-predicate kernel against its plain torch version, on the card.

A small-size repeat of chip_smoke.py's phase 3, for builders with a card:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(`--noconftest`: the suite's conftest imports JAX, which the card's
machine need not have.) Every test skips where torch sees no CUDA device.
"""

import numpy as np
import pytest
import torch

from chip_smoke import kernel_vs_plain, random_block_columns
from pegasus_tpu_torch.ops import fused_scan
from pegasus_tpu_torch.ops.predicates import (
    FT_MATCH_ANYWHERE,
    FilterSpec,
    scan_block_predicate,
    static_block_predicate,
)
from pegasus_tpu_torch.ops.record_block import RecordBlock, _to_block

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _block(rng, n, k, device):
    keys, key_len, ets, hash_lo = random_block_columns(rng, n, k)
    hkl = (keys[:, 0].astype(np.int32) << 8) | keys[:, 1]
    return _to_block(keys, key_len, np.where(key_len >= 2, hkl, 0), ets,
                     key_len >= 2, hash_lo, device)


def test_kernel_matches_plain_on_every_case(card):
    out = kernel_vs_plain(card, [(256, 32, 1), (256, 64, 4)],
                          time_it=False)
    assert out["compared"] == 2 * 48 * 3 * 3
    assert out["max_abs_err"] == 0


def test_block_predicates_launch_the_kernel(card):
    rng = np.random.default_rng(5)
    cpu_block = _block(rng, 512, 32, "cpu")
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


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    rng = np.random.default_rng(6)
    block = _block(rng, 64, 32, card)
    none = FilterSpec.none(card)
    bad = block._replace(expire_ts=block.expire_ts.to(torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        fused_scan.scan_status(bad, none, none, False, 0, 7)
    with pytest.raises(ValueError, match="pidx"):
        fused_scan.scan_status(block, none, none, True,
                               torch.zeros(64, dtype=torch.int64,
                                           device=card), 7)
    with pytest.raises(ValueError, match="pidx"):
        fused_scan.scan_status(block, none, none, True,
                               torch.zeros(3, dtype=torch.int32,
                                           device=card), 7)


def test_empty_block_launches_nothing(card):
    block = _block(np.random.default_rng(8), 0, 32, card)
    none = FilterSpec.none(card)
    before = dict(fused_scan.LAUNCHES)
    out = fused_scan.scan_status(block, none, none, True, 0, 7, now=5)
    assert out.shape == (0,) and out.is_cuda
    assert fused_scan.LAUNCHES == before
