"""The resident image sharded over several cards, and the wrappers'
per-device launches, on the card.

- the sharded round (parallel/mesh_resident.MeshServing._run_program:
  the scan kernel's static launch and the epilogue on every shard) and
  the sharded compaction round (the slot gate and the gated rules pass
  on every shard) over a mesh of every card of the host, against the
  same image on one card: packed masks, counts, lane sums, drop masks
  and rewritten TTLs bit-equal, and every card launched;
- a staged scan launch at K = 256 with a sortkey pattern (dynamic
  shared memory past the default, so the kernel is opted in a device)
  on the second card after one on the first, with the first card
  current: both equal the plain version.

`random_slabs` builds the seeded partitions both these tests and
tests/test_torch_mesh_shards.py stage. This file imports no JAX; run it
on a host with two cards or more (every test skips under two):

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_cards.py
"""

import numpy as np
import pytest
import torch

from pegasus_tpu_torch.ops import fused_compaction, fused_mesh, fused_scan
from pegasus_tpu_torch.ops.compaction_rules import compile_rules
from pegasus_tpu_torch.ops.predicates import (
    FT_MATCH_ANYWHERE,
    FT_MATCH_POSTFIX,
    FT_MATCH_PREFIX,
    FT_NO_FILTER,
    FilterSpec,
)
from pegasus_tpu_torch.ops.record_block import RecordBlock
from pegasus_tpu_torch.parallel.mesh_resident import (
    MESH_SERVING,
    _build_stack,
    _Slab,
)
from pegasus_tpu_torch.parallel.partition_mesh import (
    make_mesh,
    partition_allowed,
)

NOW = 5000
RULES = ('[{"op":"delete_key","rules":[{"type":"hashkey_pattern",'
         '"match":"prefix","pattern":"a"}]},'
         '{"op":"update_ttl","update_ttl_type":"from_now","value":1234,'
         '"rules":[{"type":"sortkey_pattern","match":"anywhere",'
         '"pattern":"1"}]}]')
# (filter key, validate, partition_version, with_sum, value filter)
ROUNDS = (((FT_NO_FILTER, b"", FT_NO_FILTER, b""), False, -1, True, None),
          ((FT_MATCH_PREFIX, b"a", FT_NO_FILTER, b""), True, -1, False,
           "keep"),
          ((FT_NO_FILTER, b"", FT_MATCH_POSTFIX, b"1"), True, 2, True,
           "flip"),
          ((FT_MATCH_ANYWHERE, b"b", FT_MATCH_ANYWHERE, b"2a"), True, 7,
           True, "keep"))
# (default_ttl, partition_version, validate, ruleset, want_ets)
COMPACTIONS = ((0, -1, False, None, False), (300, 3, True, None, True),
               (0, 2, True, RULES, True), (0xFFFFFF00, 7, True, RULES,
                                           False))


class ValueMasks:
    """Stands in for a partition server's cached per-block value masks:
    a segment's block is its mask, "flip" inverts it."""

    @staticmethod
    def _value_mask(ckey, blk, vf):
        return ~blk if vf == "flip" else blk


def random_slabs(rng, p: int, b: int, k: int = 32) -> list:
    """[(pidx, _Slab)] of p seeded partitions, slot 0 holding b rows and
    the rest 0..b: keys with a u16 hashkey prefix (a few malformed),
    TTLs around NOW, hash_lo owned by the slot for most rows, uint16
    value lanes, and one to three segments a slab whose value masks
    ValueMasks gives."""
    alphabet = np.frombuffer(b"ab12", np.uint8)
    out = []
    for part in range(p):
        n = b if part == 0 else int(rng.integers(0, b + 1))
        slab = _Slab(ValueMasks, 0, 0)
        slab.n_rows, slab.width = n, k
        slab.keys = np.zeros((n, k), np.uint8)
        slab.key_len = np.zeros(n, np.int32)
        hk = rng.integers(0, 6, n)
        for r in range(n):
            sk = int(rng.integers(0, k - 2 - hk[r] + 1))
            slab.keys[r, 1] = hk[r]
            slab.keys[r, 2:2 + hk[r] + sk] = rng.choice(alphabet, hk[r] + sk)
            slab.key_len[r] = 2 + hk[r] + sk
        slab.key_len[rng.random(n) < 0.05] = 1  # malformed
        slab.valid = slab.key_len >= 2
        slab.hashkey_len = np.where(slab.valid, hk, 0).astype(np.int32)
        slab.expire_ts = rng.choice(np.array(
            [0, 0, 1, NOW - 1, NOW, NOW + 1, 0xFFFFFFFF], np.uint32), n)
        noise = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
            np.uint32)
        slab.hash_lo = np.where(rng.random(n) < 0.8,
                                (noise & ~np.uint32(7)) | np.uint32(part & 7),
                                noise)
        slab.flags = np.zeros(n, np.uint8)
        slab.lanes = rng.integers(0, 1 << 16, (n, 4)).astype(np.uint32)
        cuts = sorted({0, n, *rng.integers(0, n + 1, 2).tolist()})
        slab.segments = [(("seg", part, a), rng.random(z - a) < 0.6, a, z - a)
                         for a, z in zip(cuts, cuts[1:])]
        out.append((part, slab))
    return out


def run_rounds(stack) -> list:
    """Every ROUNDS case's (packed, counts, lane_sums) over `stack`."""
    return [MESH_SERVING._run_program(stack, validate, pv, fkey, NOW, vf,
                                      with_sum)[1]
            for fkey, validate, pv, with_sum, vf in ROUNDS]


def run_compactions(stack, device) -> list:
    """Every COMPACTIONS case's (drop, ets2 | None) over `stack`."""
    out = []
    for default_ttl, pv, validate, rules, want_ets in COMPACTIONS:
        ops = (compile_rules(rules, device=device).operations
               if rules else None)
        params = MESH_SERVING._compact_params(NOW, default_ttl, pv, validate,
                                              ops, want_ets)
        allowed = partition_allowed(stack.pidx_np, validate, params[2])
        out.append(MESH_SERVING._compact_round(stack, allowed, params, ops))
    return out


def assert_same_image_results(one, sharded, p: int) -> None:
    """The sharded stack's results equal the one-shard stack's on the p
    real slots; the slots that pad P to the mesh count nothing."""
    for got, want in zip(sharded["rounds"], one["rounds"]):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[:p], w[:p])
        assert not got[0][p:].any() and not got[1][p:].any()
        assert not got[2][p:].any()
    for (drop, ets), (want_drop, want_ets) in zip(sharded["compactions"],
                                                  one["compactions"]):
        np.testing.assert_array_equal(drop[:p], want_drop[:p])
        if want_ets is None:
            assert ets is None
        else:
            np.testing.assert_array_equal(ets[:p], want_ets[:p])


def image_results(stack, device) -> dict:
    return {"rounds": run_rounds(stack),
            "compactions": run_compactions(stack, device)}


pytestmark = pytest.mark.cuda


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards or more: the launches cross "
                    "cards")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def test_sharded_round_over_cards_equals_one_card(cards):
    rng = np.random.default_rng(17)
    p = 3 * len(cards) + 1  # P pads to the mesh: an empty slot or more
    slabs = random_slabs(rng, p, 1024)
    one = _build_stack(make_mesh(devices=cards[:1]), slabs)
    pmesh = make_mesh()
    assert pmesh.dp == len(cards) and pmesh.sp == 1
    sharded = _build_stack(pmesh, slabs)
    assert {sh.device for sh in sharded.shards} == set(cards)
    want = image_results(one, cards[0])
    for m in (fused_scan, fused_mesh, fused_compaction):
        m.DEVICE_LAUNCHES.clear()
    got = image_results(sharded, cards[0])
    assert_same_image_results(want, got, p)
    for dev in cards:
        i = dev.index
        assert fused_scan.DEVICE_LAUNCHES["static", i] == len(ROUNDS)
        assert fused_mesh.DEVICE_LAUNCHES["mesh_step", i] == len(ROUNDS)
        assert fused_compaction.DEVICE_LAUNCHES["slot_gate", i] == \
            len(COMPACTIONS) - 1  # the one not validating has no gate
    torch.cuda.synchronize()


def test_staged_wide_key_scan_on_the_second_card(cards):
    """K = 256 with a sortkey pattern stages its tile in dynamic shared
    memory past the default: the kernel's opt-in holds a device, and a
    launch on a card that is not current runs under that card."""
    rng = np.random.default_rng(5)
    n, k = 3000, 256
    keys = rng.choice(np.frombuffer(b"ab12", np.uint8), (n, k))
    keys[:, 0] = 0
    keys[:, 1] = 3
    cols = (keys, rng.integers(5, k + 1, n).astype(np.int32),
            np.full(n, 3, np.int32),
            rng.choice(np.array([0, NOW - 1, NOW + 1], np.uint32), n).view(
                np.int32),
            np.ones(n, bool),
            rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
                np.uint32).view(np.int32))
    sort = (FT_MATCH_ANYWHERE, b"ab1")
    want = None
    for dev in (cards[0], cards[1], cards[0]):
        block = RecordBlock(*(torch.from_numpy(np.ascontiguousarray(c)).to(
            dev) for c in cols))
        with torch.cuda.device(cards[0]):
            got = fused_scan.scan_table(
                [block], [1], FilterSpec.none(dev), FilterSpec.make(*sort,
                                                                    dev),
                True, 7, now=NOW)
        plain = fused_scan.scan_table_plain(
            [RecordBlock(*(t.cpu() for t in block))], [1],
            FilterSpec.none(), FilterSpec.make(*sort), True, 7, now=NOW)
        assert torch.equal(got.cpu(), plain)
        want = plain if want is None else want
        assert torch.equal(plain, want)
    torch.cuda.synchronize()
