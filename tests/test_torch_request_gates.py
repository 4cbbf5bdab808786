"""Request gates, throttles, the usage scenario and the pushdown kill
switch: the port's PartitionServer(device="cpu") against the JAX
package's, exact.

Both servers hold the same seeded records (store flags `block_codec =
none`, no bloom, no phash, set and restored in both registries). Every
handler the port has (put, remove, multi_put, get, multi_get, the
batched point reads get / ttl / multi_get / batch_get, get_scanner,
scan, get_scanner_batch and the node's scan_multi) must give the JAX
package's status under `replica.deny_client_request` = all / read /
write, under an exhausted reject-mode throttle, and after a `full_set`
that drops the keys. The token buckets' clock is frozen in both
packages (no test sleeps or reads the wall clock), so a bucket refills
only when a test says so.
"""

import dataclasses

import numpy as np
import pytest

from pegasus_tpu.base.key_schema import generate_key, key_hash_parts
from pegasus_tpu.ops import placement as jplacement
from pegasus_tpu.ops.pushdown import PushdownSpec as JSpec
from pegasus_tpu.server import scan_coordinator as jsc
from pegasus_tpu.server import types as jtypes
from pegasus_tpu.server.partition_server import PartitionServer as JServer
from pegasus_tpu.server.workload import DRIFT as JDRIFT
from pegasus_tpu.storage import compact_governor as jgov
from pegasus_tpu.utils import token_bucket as jtb
from pegasus_tpu.utils.flags import FLAGS as JFLAGS
from pegasus_tpu_torch.ops.pushdown import PushdownSpec as TSpec
from pegasus_tpu_torch.server import scan_coordinator as tsc
from pegasus_tpu_torch.server import types as ttypes
from pegasus_tpu_torch.server.partition_server import PartitionServer
from pegasus_tpu_torch.storage import compact_governor as tgov
from pegasus_tpu_torch.utils import token_bucket as ttb
from pegasus_tpu_torch.utils.flags import FLAGS as TFLAGS
from pegasus_tpu_torch.utils.errors import StorageStatus

STORE_FLAGS = (("pegasus.storage", "block_codec", "none"),
               ("pegasus.server", "bloom_bits_per_key", 0),
               ("pegasus.server", "phash_index", False),
               ("pegasus.server", "scan_pushdown_enabled", True))
PARTITION_COUNT = 4
PIDX = 1
# an app id no other test uses: the JAX server registers process-wide
# metric entities under it
APP_ID = 9006
OK = int(StorageStatus.OK)
TRY_AGAIN = int(StorageStatus.TRY_AGAIN)
HASHKEYS = [h for h in (b"gate%04d" % i for i in range(200))
            if key_hash_parts(h) % PARTITION_COUNT == PIDX][:24]
SORTKEYS = [b"s%02d" % i for i in range(6)]


class _FrozenTime:
    """Stands in for the token-bucket modules' `time`: the clock stays at
    0, so buckets neither refill nor read the wall clock."""

    @staticmethod
    def monotonic() -> float:
        return 0.0


def _set_flags(values, registries=(JFLAGS, TFLAGS)):
    for section, name, value in values:
        for reg in registries:
            reg.set(section, name, value, force=True)


@pytest.fixture
def servers(tmp_path, monkeypatch):
    """(JAX server, port server) over the same records; every flag a test
    sets in either registry, the GOVERNORs, the JAX placement probe and
    drift gauge are restored after it."""
    for mod in (jtb, ttb):
        monkeypatch.setattr(mod, "time", _FrozenTime)
    saved = [[(s, n, reg.get(s, n)) for s, n, _v in STORE_FLAGS]
             for reg in (JFLAGS, TFLAGS)]
    govs = [(g, dict(vars(g))) for g in (jgov.GOVERNOR, tgov.GOVERNOR)]
    _set_flags(STORE_FLAGS)
    pair = (JServer(str(tmp_path / "jax"), app_id=APP_ID, pidx=PIDX,
                    partition_count=PARTITION_COUNT),
            PartitionServer(str(tmp_path / "torch"), app_id=APP_ID,
                            pidx=PIDX, partition_count=PARTITION_COUNT,
                            device="cpu"))
    rng = np.random.default_rng(6)
    for hk in HASHKEYS:
        for sk in SORTKEYS:
            value = b"v%d-" % int(rng.integers(0, 1000)) + hk + sk
            for s in pair:
                assert s.on_put(generate_key(hk, sk), value) == OK
    yield pair
    for s in pair:
        s.close()
    _set_flags(saved[0], (JFLAGS,))
    _set_flags(saved[1], (TFLAGS,))
    for g, attrs in govs:
        g.__dict__.update(attrs)
    jplacement.reset_probe()
    JDRIFT.reset()


def _mod(s):
    return jtypes if isinstance(s, JServer) else ttypes


def _scan_req(s, **kw):
    return _mod(s).GetScannerRequest(
        start_key=generate_key(HASHKEYS[0], b""), batch_size=5,
        validate_partition_hash=True, **kw)


def _open_scanner(s) -> int:
    """A scan context to page on (opened before a gate is set)."""
    resp = s.on_get_scanner(_scan_req(s))
    assert resp.error == OK and resp.context_id >= 0
    return resp.context_id


def _statuses(s, ctx: int, now: int) -> dict:
    """The status each handler gives, in one fixed order."""
    mod = _mod(s)
    hk, sk = HASHKEYS[2], SORTKEYS[1]
    key = generate_key(hk, sk)
    multi = mod.MultiGetRequest(hash_key=hk, sort_keys=SORTKEYS[:3])
    batch = mod.BatchGetRequest(keys=[mod.FullKey(hk, sk),
                                      mod.FullKey(HASHKEYS[3], sk)])
    point = s.on_point_read_batch([("get", key, None), ("ttl", key, None),
                                   ("multi_get", multi, None),
                                   ("batch_get", batch, None)])
    coord = (jsc if mod is jtypes else tsc).scan_multi(
        [(s, [_scan_req(s), _scan_req(s)])], now)[0]
    return {
        "put": s.on_put(generate_key(hk, b"new"), b"w"),
        "remove": s.on_remove(generate_key(HASHKEYS[4], SORTKEYS[5])),
        "multi_put": s.on_multi_put(mod.MultiPutRequest(
            hk, [mod.KeyValue(b"mp", b"w")], 0)),
        "get": s.on_get(key)[0],
        "multi_get": s.on_multi_get(multi).error,
        "point_get": point[0][0],
        "point_ttl": point[1][0],
        "point_multi_get": point[2].error,
        "point_batch_get": point[3].error,
        "get_scanner": s.on_get_scanner(_scan_req(s)).error,
        "scan": s.on_scan(ctx).error,
        "get_scanner_batch": [r.error for r in s.on_get_scanner_batch(
            [_scan_req(s), _scan_req(s)])],
        "scan_multi": [r.error for r in coord],
    }


WRITES = ("put", "remove", "multi_put")


def _expected(denied: str) -> dict:
    """Statuses when `denied` ("", "all", "read" or "write") is refused."""
    out = {}
    for name in ("put", "remove", "multi_put", "get", "multi_get",
                 "point_get", "point_ttl", "point_multi_get",
                 "point_batch_get", "get_scanner", "scan",
                 "get_scanner_batch", "scan_multi"):
        kind = "write" if name in WRITES else "read"
        st = TRY_AGAIN if denied in ("all", kind) else OK
        out[name] = [st, st] if name in ("get_scanner_batch",
                                         "scan_multi") else st
    return out


@pytest.mark.parametrize("deny", ["all", "read", "write"])
def test_deny_client_request_matches_jax(servers, deny):
    from pegasus_tpu_torch.base.value_schema import epoch_now

    now = epoch_now()
    ctxs = [_open_scanner(s) for s in servers]
    for s in servers:
        # the value after the last `*` names what is denied
        s.update_app_envs({"replica.deny_client_request": f"reject*{deny}"})
    got = [_statuses(s, c, now) for s, c in zip(servers, ctxs)]
    assert got[1] == got[0] == _expected(deny)
    # a full set without the key lifts the gate in both
    for s in servers:
        s.update_app_envs({"default_ttl": "0"}, full_set=True)
    ctxs = [_open_scanner(s) for s in servers]
    assert servers[1]._deny_client == ""
    got = [_statuses(s, c, now) for s, c in zip(servers, ctxs)]
    assert got[1] == got[0] == _expected("")


def _drain(bucket) -> None:
    while bucket.try_consume():
        pass


@pytest.mark.parametrize("kind", ["read", "write"])
def test_exhausted_reject_throttle_matches_jax(servers, kind):
    from pegasus_tpu_torch.base.value_schema import epoch_now

    now = epoch_now()
    env = f"replica.{kind}_throttling"
    ctxs = [_open_scanner(s) for s in servers]
    for s in servers:
        s.update_app_envs({env: "5*reject*100"})
        _delay, reject = getattr(s, f"_{kind}_throttle")
        assert _delay is None and reject is not None
        _drain(reject)
    got = [_statuses(s, c, now) for s, c in zip(servers, ctxs)]
    assert got[1] == got[0] == _expected(kind)
    # a full set without the key drops the throttle in both
    for s in servers:
        s.update_app_envs({}, full_set=True)
    ctxs = [_open_scanner(s) for s in servers]
    assert servers[1]._read_throttle is None
    assert servers[1]._write_throttle is None
    got = [_statuses(s, c, now) for s, c in zip(servers, ctxs)]
    assert got[1] == got[0] == _expected("")


def test_throttle_budget_is_spent_alike(servers):
    """A reject-mode read budget of 3: a scan batch on a compacted store
    pays one token (its plan's gate), then two gets are served and the
    rest refused; a delay-mode write budget serves within it."""
    key = generate_key(HASHKEYS[1], SORTKEYS[0])
    seqs = []
    for s in servers:
        s.manual_compact()
        s.update_app_envs({"replica.read_throttling": "3*reject*100",
                           "replica.write_throttling": "50*delay*100"})
        seq = [s.on_put(generate_key(HASHKEYS[1], b"d%d" % i), b"w")
               for i in range(10)]
        seq.append([r.error for r in s.on_get_scanner_batch(
            [_scan_req(s) for _ in range(4)])])
        seq += [s.on_get(key) for _ in range(4)]
        seqs.append(seq)
    assert seqs[1] == seqs[0]
    assert seqs[1][10] == [OK] * 4
    assert [g[0] for g in seqs[1][11:]] == [OK, OK, TRY_AGAIN, TRY_AGAIN]


@pytest.mark.parametrize("env", [
    {"replica.write_throttling": "abc*reject*100"},
    {"replica.read_throttling": "1K*reject*100,xyz"},
    {"replica.deny_client_request": "reject*all",
     "replica.read_throttling": "*reject"}])
def test_malformed_throttle_raises_before_anything_applies(servers, env):
    for s in servers:
        with pytest.raises(ValueError):
            s.update_app_envs(env)
        assert s._deny_client == ""
        assert s._read_throttle is None and s._write_throttle is None
        assert s.on_get(generate_key(HASHKEYS[0], SORTKEYS[0]))[0] == OK
        # the slow-query threshold is applied by both packages, and a
        # refused env set leaves it at its default
        assert s.slow_log.threshold_ms == 20.0


def _triggers(s):
    eng = s.engine
    return (eng.memtable_flush_trigger, eng.auto_compact,
            eng.lsm._l0_trigger)


def test_usage_scenario_matches_jax(servers):
    """The scenario's engine triggers are the JAX package's, and under
    bulk_load a deep L0 waits: flushes pile up without an
    auto-compaction until the scenario returns to normal."""
    for scenario, want in (("prefer_write", (250_000, True, 8)),
                           ("bulk_load", (500_000, False, 8)),
                           ("normal", (100_000, True, 4)),
                           ("bulk_load", (500_000, False, 4))):
        for s in servers:
            s.update_app_envs({"rocksdb.usage_scenario": scenario})
        assert _triggers(servers[1]) == _triggers(servers[0]) == want
    depth = []
    for s in servers:
        # a long bulk load, cut short: a flush every 5 records
        s.engine.memtable_flush_trigger = 5
        for i in range(30):
            assert s.on_put(generate_key(HASHKEYS[5], b"b%02d" % i),
                            b"w") == OK
        depth.append((len(s.engine.lsm.l0), len(s.engine.lsm.l1_runs)))
    assert depth[1] == depth[0]
    assert depth[1][0] >= 4  # past the L0 trigger, not compacted
    depth = []
    for s in servers:
        s.update_app_envs({}, full_set=True)  # back to normal
        assert _triggers(s) == (100_000, True, 4)
        s.engine.memtable_flush_trigger = 5
        for i in range(5):
            assert s.on_put(generate_key(HASHKEYS[6], b"n%02d" % i),
                            b"w") == OK
        depth.append(len(s.engine.lsm.l0))
    assert depth == [0, 0]  # the next flush compacted the deep L0
    for hk in HASHKEYS[4:7]:
        for sk in SORTKEYS + [b"b07", b"n03"]:
            key = generate_key(hk, sk)
            assert servers[1].on_get(key) == servers[0].on_get(key)
    for s in servers:
        with pytest.raises(ValueError):
            s.update_app_envs({"rocksdb.usage_scenario": "nope"})


def _same(jresp, tresp):
    assert [(kv.key, kv.value) for kv in tresp.kvs] == \
        [(kv.key, kv.value) for kv in jresp.kvs]
    for f in dataclasses.fields(tresp):
        if f.name != "kvs":
            assert getattr(tresp, f.name) == getattr(jresp, f.name), f.name


def test_pushdown_kill_switch_matches_jax(servers):
    """With `scan_pushdown_enabled` off in both registries, a request
    carrying a value filter or an aggregate is served without it: the
    same page, pushdown_applied False, no partial."""
    from pegasus_tpu_torch.base.value_schema import epoch_now

    now = epoch_now()
    specs = (dict(value_filter_type=3, value_filter_pattern=b"s01"),
             dict(value_filter_type=2, value_filter_pattern=b"v1",
                  aggregate="count"))
    for enabled in (True, False):
        _set_flags([("pegasus.server", "scan_pushdown_enabled", enabled)])
        for spec in specs:
            j, t = (s.on_get_scanner(_scan_req(
                s, pushdown=(JSpec if s is servers[0] else TSpec)(**spec)))
                for s in servers)
            _same(j, t)
            assert t.pushdown_applied is enabled
            if not enabled:
                jp, tp = (s.on_get_scanner(_scan_req(s)) for s in servers)
                _same(jp, tp)
                assert [kv.value for kv in tp.kvs] == \
                    [kv.value for kv in t.kvs]
        spec = specs[0]
        jb, tb = (s.on_get_scanner_batch([_scan_req(
            s, pushdown=(JSpec if s is servers[0] else TSpec)(**spec))] * 2)
            for s in servers)
        jm, tm = ((jsc if s is servers[0] else tsc).scan_multi([(s, [
            _scan_req(s, pushdown=(JSpec if s is servers[0]
                                   else TSpec)(**spec))])], now)[0]
            for s in servers)
        for j, t in zip(jb + jm, tb + tm):
            _same(j, t)
            assert t.pushdown_applied is enabled
