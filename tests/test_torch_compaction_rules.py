"""User-specified compaction rules: the port against the JAX package, exact.

- every case of tests/test_compaction_rules.py through both packages'
  `compile_rules` hooks (the port's on the CPU), with the same asserted
  values, and the app-env plumbing on a `PartitionServer(device="cpu")`;
- the traps: an empty pattern matches nothing, `ttl_range` and
  FROM_CURRENT wrap as uint32 past 2^32, TIMESTAMP floors at 0, the
  first delete wins over a later update;
- seeded random rulesets through `make_compaction_eval(...).eval_block`
  at pack and want_ets on and off, key widths 32 and 64, a per-row pidx
  column and the stale-split term (hash_lo given and computed), and
  through `compaction_eval_submit` / `compaction_eval_drain` over blocks
  of mixed widths; the JAX ruleset crosses to the port through
  `convert.rules_spec` and keeps its content key.
Every output is a mask or a uint32 column, so the tolerance is exact.
"""

import numpy as np
import pytest
import torch

from pegasus_tpu.base.key_schema import generate_key
from pegasus_tpu.base.value_schema import PEGASUS_EPOCH_BEGIN
from pegasus_tpu.ops import compaction as jcomp
from pegasus_tpu.ops import compaction_rules as jrules
from pegasus_tpu.ops import placement as jplacement
from pegasus_tpu.server.partition_server import PartitionServer as JServer
from pegasus_tpu.server.workload import DRIFT as JDRIFT
from pegasus_tpu.storage import compact_governor as jgov
from pegasus_tpu.utils.flags import FLAGS as JFLAGS
from pegasus_tpu_torch import convert
from pegasus_tpu_torch.ops import compaction as tcomp
from pegasus_tpu_torch.ops import compaction_rules as trules
from pegasus_tpu_torch.ops.fused_compaction import ops_key
from pegasus_tpu_torch.server.partition_server import PartitionServer
from pegasus_tpu_torch.storage import compact_governor as tgov
from pegasus_tpu_torch.utils.flags import FLAGS as TFLAGS

ALPHABET = np.frombuffer(b"abcd", dtype=np.uint8)
PV = 7


def k(h, s):
    return generate_key(h, s)


def both(spec, keys, ets, now):
    """(drop, ets) of both packages' hooks, held equal; the port's."""
    jd, je = jrules.compile_rules(spec)(keys, ets, now=now)
    td, te = trules.compile_rules(spec, device="cpu")(keys, ets, now=now)
    np.testing.assert_array_equal(td, np.asarray(jd))
    np.testing.assert_array_equal(te, np.asarray(je))
    assert te.dtype == np.uint32
    return td, te


@pytest.fixture(autouse=True)
def _reset_process_state():
    """The JAX servers below compact through the JAX package's GOVERNOR,
    placement probe and drift gauge, the port's through its GOVERNOR:
    each is restored after the test."""
    govs = [(g, dict(vars(g))) for g in (jgov.GOVERNOR, tgov.GOVERNOR)]
    yield
    for g, attrs in govs:
        g.__dict__.update(attrs)
    jplacement.reset_probe()
    JDRIFT.reset()


@pytest.fixture
def store_flags():
    """The compaction and store flags the servers below read, restored in
    both registries."""
    names = [("pegasus.storage", "block_codec"),
             ("pegasus.storage", "compact_pipeline"),
             ("pegasus.storage", "compact_pipeline_window")]
    saved = [(reg, s, n, reg.get(s, n)) for reg in (JFLAGS, TFLAGS)
             for s, n in names]
    yield
    for reg, s, n, v in saved:
        reg.set(s, n, v, force=True)


# ---- the cases of tests/test_compaction_rules.py -------------------------


def test_delete_by_hashkey_prefix():
    spec = ('[{"op": "delete_key", "rules": '
            '[{"type": "hashkey_pattern", "match": "prefix", '
            '"pattern": "tmp_"}]}]')
    keys = [k(b"tmp_1", b"s"), k(b"keep", b"s"), k(b"tmp_2", b"x")]
    drop, _ = both(spec, keys, [0, 0, 0], 1000)
    assert list(drop) == [True, False, True]


def test_delete_requires_all_rules_match():
    spec = [{"op": "delete_key", "rules": [
        {"type": "hashkey_pattern", "match": "prefix", "pattern": "u_"},
        {"type": "sortkey_pattern", "match": "postfix", "pattern": "_old"},
    ]}]
    keys = [k(b"u_1", b"a_old"), k(b"u_1", b"a_new"), k(b"x", b"a_old")]
    drop, _ = both(spec, keys, [0, 0, 0], 1000)
    assert list(drop) == [True, False, False]


def test_ttl_range_rule():
    now = 5000
    keys = [k(b"h", b"s%d" % i) for i in range(4)]
    ets = [0, now + 150, now + 50, now + 300]
    drop, _ = both([{"op": "delete_key", "rules": [
        {"type": "ttl_range", "start_ttl": 100, "stop_ttl": 200}]}],
        keys, ets, now)
    assert list(drop) == [False, True, False, False]
    drop0, _ = both([{"op": "delete_key", "rules": [
        {"type": "ttl_range", "start_ttl": 0, "stop_ttl": 0}]}],
        keys, ets, now)
    assert list(drop0) == [True, False, False, False]


def test_update_ttl_ops():
    now = 10_000
    keys = [k(b"h", b"a"), k(b"h", b"b"), k(b"h", b"c")]
    _, ets = both([{"op": "update_ttl", "update_ttl_type": "from_now",
                    "value": 500, "rules": [
                        {"type": "sortkey_pattern", "match": "prefix",
                         "pattern": "a"}]}], keys, [7, 7, 7], now)
    assert list(ets) == [now + 500, 7, 7]
    _, ets2 = both([{"op": "update_ttl", "update_ttl_type": "from_current",
                     "value": 100, "rules": [
                         {"type": "hashkey_pattern", "match": "anywhere",
                          "pattern": "h"}]}], keys, [50, 0, 60], now)
    assert list(ets2) == [150, 0, 160]
    _, ets3 = both([{"op": "update_ttl", "update_ttl_type": "timestamp",
                     "value": PEGASUS_EPOCH_BEGIN + 999, "rules": [
                         {"type": "sortkey_pattern", "match": "prefix",
                          "pattern": "c"}]}], keys, [0, 0, 0], now)
    assert list(ets3) == [0, 0, 999]


def test_operation_order_delete_wins():
    spec = [
        {"op": "delete_key", "rules": [
            {"type": "sortkey_pattern", "match": "prefix", "pattern": "x"}]},
        {"op": "update_ttl", "update_ttl_type": "from_now", "value": 1,
         "rules": [{"type": "sortkey_pattern", "match": "prefix",
                    "pattern": "x"}]},
    ]
    drop, ets = both(spec, [k(b"h", b"x1")], [0], 100)
    assert bool(drop[0]) and ets[0] == 0  # deleted, not re-stamped


def test_empty_pattern_matches_nothing():
    # the trap: the scan path's empty pattern matches everything
    for match in ("anywhere", "prefix", "postfix"):
        for kind in ("hashkey_pattern", "sortkey_pattern"):
            drop, _ = both([{"op": "delete_key", "rules": [
                {"type": kind, "match": match, "pattern": ""}]}],
                [k(b"h", b"s"), k(b"", b"")], [0, 0], 100)
            assert not drop.any()


def test_ops_evaluate_against_original_ttl():
    now = 1000
    drop, ets = both([
        {"op": "update_ttl", "update_ttl_type": "from_now", "value": 100,
         "rules": [{"type": "hashkey_pattern", "match": "prefix",
                    "pattern": "h"}]},
        {"op": "delete_key", "rules": [
            {"type": "ttl_range", "start_ttl": 50, "stop_ttl": 200}]},
    ], [k(b"h", b"s")], [0], now)
    assert not bool(drop[0])
    assert int(ets[0]) == now + 100


def test_bad_rule_specs_rejected():
    for parse in (jrules.parse_rules, trules.parse_rules):
        with pytest.raises(ValueError):
            parse('[{"op": "delete_key", "rules": []}]')
        with pytest.raises(ValueError):
            parse('[{"op": "explode", "rules": [{"type": "ttl_range", '
                  '"start_ttl": 0, "stop_ttl": 0}]}]')
        with pytest.raises(ValueError):
            parse('[{"op": "delete_key", "rules": [{"type": "nope"}]}]')


# ---- the uint32 traps ------------------------------------------------------


def test_ttl_range_and_from_current_wrap_past_2_32():
    """now + start/stop and ets + value wrap at 2^32 in both packages."""
    now = 0xFFFFFF00
    keys = [k(b"h", b"s%d" % i) for i in range(5)]
    ets = [0x10, 0x100, 0xFFFFFFF0, 0x20, 5]
    drop, _ = both([{"op": "delete_key", "rules": [
        {"type": "ttl_range", "start_ttl": 0x100, "stop_ttl": 0x300}]}],
        keys, ets, now)
    # [now + 0x100, now + 0x300] wraps to [0, 0x200]
    assert list(drop) == [True, True, False, True, True]
    _, ets2 = both([{"op": "update_ttl", "update_ttl_type": "from_current",
                     "value": 0x20, "rules": [
                         {"type": "hashkey_pattern", "match": "prefix",
                          "pattern": "h"}]}], keys, ets, now)
    assert list(ets2) == [0x30, 0x120, 0x10, 0x40, 0x25]
    _, ets3 = both([{"op": "update_ttl", "update_ttl_type": "from_now",
                     "value": 0x200, "rules": [
                         {"type": "hashkey_pattern", "match": "prefix",
                          "pattern": "h"}]}], keys, ets, now)
    assert list(ets3) == [0x100] * 5


def test_timestamp_before_the_epoch_floors_at_zero():
    _, ets = both([{"op": "update_ttl", "update_ttl_type": "timestamp",
                    "value": PEGASUS_EPOCH_BEGIN - 5, "rules": [
                        {"type": "hashkey_pattern", "match": "anywhere",
                         "pattern": "h"}]}], [k(b"h", b"s")], [77], 10)
    assert list(ets) == [0]


# ---- random rulesets through the bulk program ------------------------------


def random_spec(rng) -> list:
    """A ruleset of 1..4 operations of 1..3 rules: every rule kind and
    match type, empty and over-long patterns, ttl ranges near 2^32, all
    three update types."""
    spec = []
    for _ in range(int(rng.integers(1, 5))):
        rules = []
        for _ in range(int(rng.integers(1, 4))):
            kind = str(rng.choice(["hashkey_pattern", "sortkey_pattern",
                                   "ttl_range"]))
            if kind == "ttl_range":
                start = int(rng.choice([0, 10, 200, 0xFFFFFF00]))
                stop = start + int(rng.choice([0, 50, 1000, 0x80]))
                rules.append({"type": kind, "start_ttl": start,
                              "stop_ttl": min(stop, 0xFFFFFFFF)})
            else:
                n = int(rng.choice([0, 1, 1, 2, 3, 40]))
                rules.append({"type": kind, "match": str(rng.choice(
                    ["anywhere", "prefix", "postfix"])),
                    "pattern": rng.choice(ALPHABET, n).tobytes().decode()})
        if rng.random() < 0.5:
            spec.append({"op": "delete_key", "rules": rules})
        else:
            utot = str(rng.choice(["from_now", "from_current",
                                   "timestamp"]))
            value = (PEGASUS_EPOCH_BEGIN + int(rng.integers(0, 1 << 20))
                     if utot == "timestamp"
                     else int(rng.choice([1, 300, 0xFFFFFF00])))
            spec.append({"op": "update_ttl", "update_ttl_type": utot,
                         "value": value, "rules": rules})
    return spec


def random_chunk(rng, b: int, k: int):
    """numpy chunk columns as compaction_eval_submit stacks them: keys
    over a 4-letter alphabet with empty hashkeys, malformed headers and
    padding rows, hashkey_len from the big-endian prefix, expire_ts
    around `now` and past 2^31, a pidx column across a split."""
    keys = np.zeros((b, k), dtype=np.uint8)
    key_len = np.zeros(b, dtype=np.int32)
    valid = np.zeros(b, dtype=bool)
    for i in range(b):
        if rng.random() < 0.05:
            continue  # padding
        n = int(rng.integers(2, k + 1))
        hkl = int(rng.integers(0, n - 1))
        if rng.random() < 0.05:
            hkl = n + int(rng.integers(0, 40))  # malformed header
        keys[i, 0], keys[i, 1] = hkl >> 8, hkl & 0xFF
        keys[i, 2:n] = rng.choice(ALPHABET, n - 2)
        key_len[i] = n
        valid[i] = True
    hkl = ((key_len > 0) * ((keys[:, 0].astype(np.int32) << 8)
                            | keys[:, 1])).astype(np.int32)
    ets = rng.choice(np.array([0, 0, 100, 5000, 5100, 5300, 0x7FFFFFFF,
                               0x80000005, 0xFFFFFF10], np.uint32), b)
    hash_lo = rng.integers(0, 1 << 32, b, dtype=np.uint64).astype(np.uint32)
    pidx = rng.integers(0, 4, b).astype(np.uint32)
    return keys, key_len, hkl, ets, valid, hash_lo, pidx


def _t(a, dtype=None):
    a = np.ascontiguousarray(a)
    if dtype is not None:
        a = a.view(dtype)
    return torch.from_numpy(a)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_rulesets_through_eval_block(seed):
    rng = np.random.default_rng(seed)
    j_ops = jrules.compile_rules(random_spec(rng)).operations
    t_ops = trules.parse_rules(convert.rules_spec(j_ops))
    assert ops_key(t_ops) == jcomp._ops_key(j_ops)
    j_eval = jcomp.make_compaction_eval(j_ops)
    t_eval = tcomp.make_compaction_eval(t_ops)
    assert tcomp.make_compaction_eval(trules.parse_rules(
        convert.rules_spec(j_ops))) is t_eval  # content-keyed cache
    now = 5000
    for width, (pack, want_ets), (validate, use_lo), dttl in (
            (32, (False, True), (True, True), 0),
            (64, (True, False), (True, False), 250),
            (32, (True, True), (False, False), 0xFFFFF000)):
        keys, key_len, hkl, ets, valid, hash_lo, pidx = random_chunk(
            rng, 600, width)
        want = j_eval(keys, key_len, hkl, ets, valid, hash_lo,
                      np.uint32(now), np.uint32(dttl), pidx, np.uint32(3),
                      validate, use_lo, want_ets=want_ets, pack=pack)
        got = t_eval(_t(keys), _t(key_len), _t(hkl), _t(ets, np.int32),
                     _t(valid), _t(hash_lo, np.int32), now, dttl,
                     _t(pidx, np.int32), 3, validate, use_lo,
                     want_ets=want_ets, pack=pack)
        assert len(got) == len(want) == (2 if want_ets else 1)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        if want_ets:
            np.testing.assert_array_equal(
                got[1].numpy().view(np.uint32), np.asarray(want[1]))


@pytest.mark.parametrize("width", [32, 256])
def test_validation_without_hash_lo_matches_jax(width):
    """Validation of a chunk without a hash_lo column: the plain version
    hashes the keys on the host (crc64 of the hashkey region, of the
    sortkey region where the hashkey is empty, bytes past K reading the
    last one), the JAX program on its device (key_hash_device); the
    chunks hold empty and non-empty hashkeys and malformed headers."""
    rng = np.random.default_rng(width)
    j_ops = jrules.compile_rules(random_spec(rng)).operations
    t_ops = trules.parse_rules(convert.rules_spec(j_ops))
    keys, key_len, hkl, ets, valid, hash_lo, pidx = random_chunk(
        rng, 700, width)
    assert (hkl[valid] == 0).any() and (hkl[valid] > 0).any()
    for ops_j, ops_t, pv in ((None, None, 3), (j_ops, t_ops, 1)):
        want = jcomp.make_compaction_eval(ops_j)(
            keys, key_len, hkl, ets, valid, hash_lo, np.uint32(5000),
            np.uint32(0), pidx, np.uint32(pv), True, False, want_ets=True,
            pack=False)
        got = tcomp.eval_block_plain(
            ops_t, _t(keys), _t(key_len), _t(hkl), _t(ets, np.int32),
            _t(valid), _t(hash_lo, np.int32), 5000, 0, _t(pidx, np.int32),
            pv, True, False, want_ets=True, pack=False)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy().view(np.uint32),
                                      np.asarray(want[1]))
        # the key hash decided the split term, not the (random) column
        from_column = tcomp.eval_block_plain(
            ops_t, _t(keys), _t(key_len), _t(hkl), _t(ets, np.int32),
            _t(valid), _t(hash_lo, np.int32), 5000, 0, _t(pidx, np.int32),
            pv, True, True, want_ets=False, pack=False)
        assert not np.array_equal(from_column[0].numpy(), got[0].numpy())


class _Blk:
    """The fields compaction_eval_submit reads of an SST block."""

    def __init__(self, keys, key_len, ets, hash_lo):
        self.keys, self.key_len = keys, key_len
        self.expire_ts, self.hash_lo = ets, hash_lo

    @property
    def count(self):
        return self.keys.shape[0]


def test_submit_and_drain_match_jax_over_mixed_widths():
    rng = np.random.default_rng(9)
    j_ops = jrules.compile_rules(random_spec(rng)).operations
    t_ops = trules.parse_rules(convert.rules_spec(j_ops))
    blocks = []
    for i, (n, w) in enumerate(((300, 32), (17, 64), (1000, 32), (5, 64),
                                (250, 32))):
        keys, key_len, _h, ets, valid, hash_lo, _p = random_chunk(rng, n, w)
        keys, key_len = keys[valid], key_len[valid]
        blocks.append((i, _Blk(keys, key_len, ets[valid], hash_lo[valid]),
                       i % 4))
    for ops_j, ops_t, dttl in ((j_ops, t_ops, 0), (None, None, 100)):
        want = list(jcomp.compaction_eval_stacked(
            blocks, 5000, dttl, PV, True, operations=ops_j, want_ets=True))
        got = list(tcomp.compaction_eval_stacked(
            blocks, 5000, dttl, PV, True, operations=ops_t, device="cpu",
            want_ets=True))
        assert [g[0] for g in got] == [w[0] for w in want]
        for (_t1, d1, e1), (_t2, d2, e2) in zip(got, want):
            np.testing.assert_array_equal(d1, np.asarray(d2))
            np.testing.assert_array_equal(e1, np.asarray(e2))


def test_compaction_filter_block_pv_zero_matches_jax():
    """The merge path's filter with validate_hash at partition_version 0
    (every pidx but 0 stale), default-TTL wrap, expire_ts past 2^31."""
    from pegasus_tpu.ops.record_block import build_record_block as j_build
    from pegasus_tpu_torch.ops.record_block import build_record_block

    rng = np.random.default_rng(5)
    keys = [b"\x00\x03" + rng.choice(ALPHABET, 3 + int(n)).tobytes()
            for n in rng.integers(0, 6, 150)]
    keys += [b"\x00\x00sortonly%d" % i for i in range(10)]
    ets = rng.choice(np.array([0, 100, 0x80000005, 0xFFFFFF00], np.uint64),
                     len(keys))
    jb, tb = j_build(keys, ets), build_record_block(keys, ets)
    for pidx in (0, 1):
        for dttl in (0, 0x200):
            want = jcomp.compaction_filter_block(
                jb.keys, jb.key_len, jb.hashkey_len, jb.expire_ts, jb.valid,
                np.uint32(0xFFFFFF80), np.uint32(dttl), np.uint32(pidx),
                np.uint32(0), True)
            got = tcomp.compaction_filter_block(
                tb.hash_lo, tb.expire_ts, tb.valid, 0xFFFFFF80, dttl, pidx,
                0, True)
            np.testing.assert_array_equal(got[0].numpy(),
                                          np.asarray(want[0]))
            np.testing.assert_array_equal(got[1].numpy(),
                                          np.asarray(want[1]))


# ---- app-envs on the server ------------------------------------------------


def _servers(tmp_path):
    return (JServer(str(tmp_path / "j"), app_id=9001),
            PartitionServer(str(tmp_path / "t"), device="cpu"))


def test_server_compaction_with_env_rules(tmp_path, store_flags):
    env = {"user_specified_compaction":
           '[{"op": "delete_key", "rules": '
           '[{"type": "hashkey_pattern", "match": "prefix", '
           '"pattern": "logs"}]}]'}
    j, t = _servers(tmp_path)
    try:
        for s in (j, t):
            for i in range(10):
                s.on_put(k(b"logs", b"day%02d" % i), b"v")
                s.on_put(k(b"data", b"day%02d" % i), b"v")
            s.update_app_envs(env)
            s.manual_compact()
        assert j.on_sortkey_count(b"logs")[1] == 0
        for hk, want in ((b"logs", 0), (b"data", 10)):
            got = [key for key, *_ in t.engine.iterate()
                   if key[2:2 + len(hk)] == hk]
            assert len(got) == want
        assert t._compaction_rules.operations
        # a full env set without the key resets the rules
        t.update_app_envs({}, full_set=True)
        assert t._compaction_rules is None and t.app_envs == {}
    finally:
        j.close()
        t.close()


def test_server_default_ttl_env(tmp_path, store_flags):
    j, t = _servers(tmp_path)
    try:
        for s in (j, t):
            s.on_put(k(b"h", b"s"), b"v")
            s.update_app_envs({"default_ttl": "100"})
            s.manual_compact()
        err, ttl = j.on_ttl(k(b"h", b"s"))
        assert err == 0 and 0 < ttl <= 100
        (_key, _value, ets), = list(t.engine.iterate())
        from pegasus_tpu_torch.base.value_schema import epoch_now
        assert 0 < ets - epoch_now() <= 100
        # the value header carries the rewritten TTL too
        assert int.from_bytes(_value[:4], "big") == ets
    finally:
        j.close()
        t.close()


def test_envs_validate_before_applying(tmp_path):
    t = PartitionServer(str(tmp_path / "t"), device="cpu")
    try:
        t.update_app_envs({"default_ttl": "50"})
        with pytest.raises(ValueError):
            t.update_app_envs({"default_ttl": "60",
                               "user_specified_compaction": "[{bad json"})
        assert t._default_ttl == 50  # nothing of the bad set applied
        # the request gates apply: a denied write is TryAgain
        t.update_app_envs({"replica.deny_client_request": "reject*write"})
        assert t.app_envs["replica.deny_client_request"] == "reject*write"
        assert t.on_put(k(b"h", b"s"), b"v") == 13
        with pytest.raises(ValueError):
            t.update_app_envs({"rocksdb.usage_scenario": "nope"})
    finally:
        t.close()
