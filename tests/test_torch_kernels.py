"""The hand-written kernels (the scan predicate, the compaction filter
and its slot-gate instance, the resident round's epilogue) against their
plain torch versions, on the card.

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
    CONFIG4_RULES,
    NOWS,
    _device_columns,
    check_compaction,
    check_key_hash,
    check_tables,
    check_tables_multi,
    compaction_chunk_columns,
    device_block,
    multi_patterns,
    predicate_cases,
    random_block_columns,
    random_pattern,
    serving_block_columns,
)
from pegasus_tpu_torch.ops import compaction as tcomp
from pegasus_tpu_torch.ops import fused_compaction, fused_scan
from pegasus_tpu_torch.ops.compaction_rules import compile_rules
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


def _table(rng, k, card, counts=SMALL_COUNTS, pv=7):
    """SMALL_COUNTS seeded blocks of width k on the card, every other one
    with a pidx column, as chip_smoke.check_tables_multi builds them."""
    blocks, pidxs = [], []
    for i, count in enumerate(counts):
        cols = random_block_columns(rng, count, k)
        blocks.append(device_block(cols, card))
        if i % 2:
            col = np.where(rng.random(count) < 0.5, cols[3] & pv,
                           rng.integers(0, pv + 1, count))
            pidxs.append(torch.from_numpy(col.astype(np.int32)).to(card))
        else:
            pidxs.append(int(rng.integers(0, pv + 1)))
    return blocks, pidxs


def _multi_matches_plain(blocks, pidxs, flavors, validate, pv=7):
    got = fused_scan.scan_table_multi(blocks, pidxs, flavors, validate, pv)
    want = torch.cat([fused_scan.scan_table_multi_plain([b], [p], flavors,
                                                        validate, pv)
                      for b, p in zip(blocks, pidxs)], dim=1)
    assert got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("pair", [(0, 2), (0, 3), (2, 3), (1, 0), (3, 1)])
def test_middle_band_patterns_match_plain(card, pair):
    """Patterns of 5 to 15 bytes (past the sortkey window's 8 and below
    half a row) through the flavour axis, the sortkey window's pairs and
    others, and through the single-flavour table launch."""
    hft, sft = pair
    rng = np.random.default_rng(40 + 4 * hft + sft)
    blocks, pidxs = _table(rng, 32, card)
    flavors = [(FilterSpec.make(hft, random_pattern(rng, n), card),
                FilterSpec.make(sft, random_pattern(rng, n), card))
               for n in range(5, 16)]
    for validate in (False, True):
        _multi_matches_plain(blocks, pidxs, flavors, validate)
        for hf, sf in flavors[::5]:
            got = fused_scan.scan_table(blocks, pidxs, hf, sf, validate, 7)
            want = fused_scan.scan_table_plain(blocks, pidxs, hf, sf,
                                               validate, 7)
            assert torch.equal(got, want)


@pytest.mark.parametrize("k", [64, 256])
@pytest.mark.parametrize("pair", [(0, 3), (2, 1)])
def test_64_flavours_at_wide_keys_match_plain(card, k, pair):
    """64 flavours, one launch, patterns of every band (0 to k bytes)."""
    hft, sft = pair
    rng = np.random.default_rng(k + sft)
    blocks, pidxs = _table(rng, k, card, counts=SMALL_COUNTS[:6])
    flavors = [(FilterSpec.make(hft, hp, card), FilterSpec.make(sft, sp,
                                                                card))
               for hp, sp in zip(multi_patterns(rng, 64, k, "mixed"),
                                 multi_patterns(rng, 64, k, "mixed"))]
    before = fused_scan.LAUNCHES["multi"]
    _multi_matches_plain(blocks, pidxs, flavors, True)
    assert fused_scan.LAUNCHES["multi"] == before + 1


@pytest.mark.parametrize("pair", [(0, 3), (0, 2), (1, 2)])
def test_flavour_axis_mixes_stored_and_hashed_blocks(card, pair):
    """A table whose every other block has no stored hash_lo, validating:
    one launch of the key-hash instance, equal to the plain version."""
    hft, sft = pair
    rng = np.random.default_rng(50 + sft)
    blocks, pidxs = _table(rng, 32, card)
    blocks = [b._replace(hash_lo=None) if i % 2 == 0 else b
              for i, b in enumerate(blocks)]
    flavors = [(FilterSpec.make(hft, hp, card), FilterSpec.make(sft, sp,
                                                                card))
               for hp, sp in zip(multi_patterns(rng, 10, 32, "mixed"),
                                 multi_patterns(rng, 10, 32, "mixed"))]
    before = dict(fused_scan.LAUNCHES)
    _multi_matches_plain(blocks, pidxs, flavors, True)
    assert fused_scan.LAUNCHES["multi"] == before["multi"] + 1
    assert fused_scan.LAUNCHES["keyhash"] == before["keyhash"] + 1


def test_empty_block_launches_nothing(card):
    block = _block(np.random.default_rng(8), 0, 32, card)
    none = FilterSpec.none(card)
    before = dict(fused_scan.LAUNCHES)
    for now in (None, 5):
        out = fused_scan.scan_table([block, block], [0, 0], none, none,
                                    True, 7, now=now)
        assert out.shape == (0,) and out.is_cuda
    assert fused_scan.LAUNCHES == before


def test_key_hash_instance_matches_plain(card):
    """Blocks without a stored hash_lo (every block, every other block)
    through both entries, validation on: the key-hash instance against
    the plain version (ops/device_crc.key_hash_device), bit for bit."""
    out = check_key_hash(card, widths=(32, 256), counts=SMALL_COUNTS)
    assert out["compared"] > 0 and out["max_abs_err"] == 0
    assert out["launches"] > 0


def test_key_hash_instance_only_when_validating(card):
    """A table without a stored hash takes the key-hash instance only
    when it validates ownership; its masks equal those of the stored
    column."""
    rng = np.random.default_rng(31)
    cols = serving_block_columns(rng, 1024, 32, 3, 7)
    stored = device_block(cols, card)
    hashed = stored._replace(hash_lo=None)
    # the stored column of serving_block_columns is random: the key hash
    # of the rows is the truth both must agree on
    from pegasus_tpu_torch.ops.device_crc import key_hash_device

    lo = key_hash_device(stored.keys, stored.key_len, stored.hashkey_len)[1]
    truth = stored._replace(hash_lo=lo.contiguous())
    none = FilterSpec.none(card)
    for validate in (False, True):
        before = fused_scan.LAUNCHES["keyhash"]
        got = fused_scan.scan_table([hashed], [3], none, none, validate, 7)
        want = fused_scan.scan_table([truth], [3], none, none, validate, 7)
        assert torch.equal(got, want)
        assert fused_scan.LAUNCHES["keyhash"] - before == int(validate)


def test_compaction_kernel_matches_plain_on_every_case(card):
    out = check_compaction(card, widths=(32, 256), rows=(777, 1))
    # per width and row count: 2 validate x 2 default_ttl x 4 outputs,
    # 5 rulesets validated without hash_lo, 3 merge-filter cases and 4
    # rules-hook rulesets
    assert out["compared"] == 2 * 2 * (16 + 5 + 3 + 4)
    assert out["max_abs_err"] == 0


def test_compaction_paths_launch_the_kernel(card):
    """The bulk program, the merge path's filter and the rules hook each
    launch the kernel once on CUDA and agree with the CPU."""
    rng = np.random.default_rng(12)
    keys = [b"\x00\x04user" + b"%03d" % i + b"s%d" % (i % 10)
            for i in range(300)]
    ets = rng.choice(np.array([0, 100, 5000, 0x80000005], np.uint64), 300)
    rf_dev = compile_rules(CONFIG4_RULES, device=card)
    rf_cpu = compile_rules(CONFIG4_RULES, device="cpu")
    before = fused_compaction.LAUNCHES["compaction"]
    for a, b in zip(rf_dev(keys, ets, 1000), rf_cpu(keys, ets, 1000)):
        np.testing.assert_array_equal(a, b)
    assert fused_compaction.LAUNCHES["compaction"] == before + 1
    cpu = block_from_columns(np.zeros((64, 32), np.uint8),
                             np.full(64, 5, np.int32),
                             ets[:64].astype(np.uint32),
                             hash_lo=rng.integers(0, 1 << 32, 64,
                                                  dtype=np.uint64).astype(
                                 np.uint32))
    dev = RecordBlock(*(t.to(card) for t in cpu))
    for a, b in zip(tcomp.compaction_filter_block(
            dev.hash_lo, dev.expire_ts, dev.valid, 1000, 77, 1, 3, True),
            tcomp.compaction_filter_block(
            cpu.hash_lo, cpu.expire_ts, cpu.valid, 1000, 77, 1, 3, True)):
        assert torch.equal(a.cpu(), b)
    assert fused_compaction.LAUNCHES["compaction"] == before + 2


def test_compaction_wrapper_refuses_what_the_kernel_does_not_take(card):
    ops = compile_rules(CONFIG4_RULES, device="cpu").operations
    b = 64
    keys = torch.zeros((b, 32), dtype=torch.uint8, device=card)
    i32 = torch.zeros(b, dtype=torch.int32, device=card)
    valid = torch.ones(b, dtype=torch.bool, device=card)
    with pytest.raises(ValueError, match="CUDA"):
        fused_compaction.compaction_filter(
            keys.cpu(), i32.cpu(), i32.cpu(), valid.cpu(), None, 0, ops, 5,
            0, 0, validate_hash=False)
    with pytest.raises(ValueError, match="expire_ts"):
        fused_compaction.compaction_filter(
            keys, i32, i32.to(torch.int64), valid, None, 0, ops, 5, 0, 0,
            validate_hash=False)
    with pytest.raises(ValueError, match="needs the keys"):
        fused_compaction.compaction_filter(
            None, None, i32, valid, None, 0, ops, 5, 0, 0,
            validate_hash=False)
    with pytest.raises(ValueError, match="hash_lo"):
        fused_compaction.compaction_filter(
            None, None, i32, valid, None, 0, (), 5, 0, 0,
            validate_hash=True)
    with pytest.raises(ValueError, match="power of two"):
        fused_compaction.compaction_filter(
            keys[:, :24].contiguous(), i32, i32, valid, None, 0, ops, 5,
            0, 0, validate_hash=False)
    before = fused_compaction.LAUNCHES["compaction"]
    drop, ets = fused_compaction.compaction_filter(
        keys[:0], i32[:0], i32[:0], valid[:0], None, 0, ops, 5, 0, 0,
        validate_hash=False, pack=True)
    assert drop.shape == (0,) and ets.shape == (0,)
    assert fused_compaction.LAUNCHES["compaction"] == before


def _hashless_chunk(rng, b, k, card):
    """A validated chunk's columns on the card and on the CPU."""
    cols = compaction_chunk_columns(rng, b, k)
    return _device_columns(cols, card), _device_columns(
        cols, torch.device("cpu"))


@pytest.mark.parametrize("k", [32, 256])
def test_compaction_kernel_hashes_keys_without_hash_lo(card, k):
    """Validation without a hash_lo column launches the kernel once, which
    hashes the keys, and equals the plain version (which hashes them on
    the host) bit for bit."""
    rng = np.random.default_rng(31)
    ops = compile_rules(CONFIG4_RULES, device="cpu").operations
    dev, cpu = _hashless_chunk(rng, 3001, k, card)
    for operations in ((), ops):
        before = fused_compaction.LAUNCHES["compaction"]
        got = tcomp.make_compaction_eval(operations)(
            *dev[:6], 5000, 0x500, dev[6], 3, True, False, want_ets=True,
            pack=True)
        assert fused_compaction.LAUNCHES["compaction"] == before + 1
        want = tcomp.eval_block_plain(
            operations, *cpu[:6], 5000, 0x500, cpu[6], 3, True, False,
            want_ets=True, pack=True)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("rows", [1 << 19, 1])
def test_compaction_kernel_one_launch_at_any_size(card, rows):
    """One launch covers a chunk far larger than the blocks the card
    holds at once (a block a tile, 2048 tiles, several waves) and a
    chunk of one row, with and without key rows, and agrees with the
    plain version."""
    rng = np.random.default_rng(rows)
    config4 = compile_rules(CONFIG4_RULES, device="cpu").operations
    dev, cpu = _hashless_chunk(rng, rows, 32, card)
    for ops, use_lo in (((), True), ((), False), (config4, True),
                        (config4, False)):
        before = fused_compaction.LAUNCHES["compaction"]
        got = tcomp.make_compaction_eval(ops)(
            *dev[:6], 5000, 0, dev[6], 3, True, use_lo, want_ets=True,
            pack=True)
        torch.cuda.synchronize()
        assert fused_compaction.LAUNCHES["compaction"] == before + 1
        want = tcomp.eval_block_plain(
            ops, *cpu[:6], 5000, 0, cpu[6], 3, True, use_lo, want_ets=True,
            pack=True)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("n", [1, 65, 5000, 20000])
def test_radius_filter_on_card_matches_cpu(card, n):
    """Geo's distance filter (torch ops on the card, no hand-written
    kernel) against its CPU run, within tests/test_torch_geo.py's
    tolerance: 2R·eps + 16·eps·d metres."""
    from pegasus_tpu_torch.ops import geo

    rng = np.random.default_rng(n)
    eps = float(np.finfo(np.float32).eps)
    lats = 40.0 + (rng.random(n) - 0.5) * 0.18
    lngs = -74.0 + (rng.random(n) - 0.5) * 0.24
    valid = rng.random(n) < 0.95
    before = geo.LAUNCHES["radius_filter"]
    rows = geo.ROWS["radius_filter"]
    keep, dist = geo.radius_filter(lats, lngs, 40.01, -73.99, 500.0,
                                   valid=valid, device=card)
    assert geo.LAUNCHES["radius_filter"] == before + 1
    assert geo.ROWS["radius_filter"] == rows + n
    want_keep, want_dist = geo.radius_filter(lats, lngs, 40.01, -73.99,
                                             500.0, valid=valid,
                                             device="cpu")
    tol = 2 * geo.EARTH_RADIUS_M * eps + 16 * eps * want_dist
    assert (np.abs(dist.astype(np.float64) - want_dist) <= tol).all()
    near = np.abs(want_dist - 500.0) <= tol
    assert (keep[~near] == want_keep[~near]).all()


def test_mesh_step_kernel_matches_plain(card):
    """The resident round's epilogue (csrc/mesh_step.cu) at every (f)
    shape of chip_smoke.py phase 10, its four instances (the lanes' sum
    off and on, a value-filter mask or none)."""
    from chip_smoke import check_mesh_step
    from pegasus_tpu_torch.ops import fused_mesh

    before = fused_mesh.LAUNCHES["mesh_step"]
    assert check_mesh_step(card)["compared"] == 80
    assert fused_mesh.LAUNCHES["mesh_step"] == before + 80


def test_slot_gate_instance_matches_plain(card):
    """The compaction kernel's slot gate (mesh_compact_step) against
    eval_block_plain with the same gate, one launch a call: the TTL pass
    through slot_gate_kernel, config #4's rules through
    compaction_filter_kernel."""
    from chip_smoke import check_slot_gate

    before = dict(fused_compaction.LAUNCHES)
    assert check_slot_gate(card)["compared"] == 80
    assert fused_compaction.LAUNCHES["slot_gate"] == before["slot_gate"] + 80
    assert fused_compaction.LAUNCHES["slot_gate_columns"] == \
        before["slot_gate_columns"] + 40
    assert fused_compaction.LAUNCHES["compaction"] == \
        before["compaction"] + 40


def test_stub_scan_multi_launches_the_scan_kernel(card, tmp_path):
    """A port ReplicaStub on the card answers a client_scan_multi over
    compacted partitions: every page equal to the oracle's, through the
    scan kernel's static contract."""
    from chip_smoke import (
        NONE_STORE,
        StubCluster,
        check_cluster_page,
        cluster_layout,
        cluster_load,
        scan_multi_call,
        store_flags,
    )
    from pegasus_tpu_torch.base.key_schema import generate_key
    from pegasus_tpu_torch.base.value_schema import epoch_now

    with store_flags(NONE_STORE):
        ops, oracles = cluster_layout(2000, 4, np.random.default_rng(3))
        c = StubCluster(card, str(tmp_path), 1)
        try:
            app_id = c.meta.create_app("t", 4, 1)
            c.loop.run_until_idle()
            acked, _s = cluster_load(c, app_id, ops)
            assert acked == 20000
            for p in range(4):
                srv = c.replica(c.primary(app_id, p), app_id, p).server
                assert srv.device.type == "cuda"
                srv.manual_compact()
                oracles[p].compacted(srv.engine.lsm.l1_runs)
            items = [(p, generate_key(b"user%08d" % (97 * i), b""),
                      1 + (13 * i) % 100) for i in range(32)
                     for p in (i % 4,)]
            before = fused_scan.LAUNCHES["static"]
            now = epoch_now()
            for (p, start, limit), resp in zip(
                    items, scan_multi_call(c, app_id, items)):
                check_cluster_page(resp, oracles[p], start, limit, now)
            assert fused_scan.LAUNCHES["static"] > before
        finally:
            c.close()
