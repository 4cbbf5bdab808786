"""The atomic and multi-key writes: the port's write service and handlers
against the JAX package's, exact.

- `cas_check_passed` for all 18 check types over absent, empty, text and
  int64-edge values, malformed integers included: the same verdict or the
  same ValueError;
- `translate_incr` / `_check_and_set` / `_check_and_mutate` /
  `_multi_remove` / `_multi_put` on two engines holding the same seeded
  records, with `timestamp_us` and `now` pinned: responses and
  WriteBatchItem bytes exactly equal, request by request (each applied
  to both engines before the next);
- `now + ttl` wraps at 2^32 in the port, as the uint32 expire_ts column
  and the kernels hold it;
- the handlers' gates: under `replica.deny_client_request` and an
  exhausted reject-mode throttle every handler of this slice answers the
  JAX server's status and writes nothing; a stale partition hash is
  refused alike.
"""

import dataclasses

import numpy as np
import pytest

from pegasus_tpu.base.key_schema import generate_key, key_hash_parts
from pegasus_tpu.ops import placement as jplacement
from pegasus_tpu.server import types as jtypes
from pegasus_tpu.server import write_service as jws
from pegasus_tpu.server.partition_server import PartitionServer as JServer
from pegasus_tpu.server.workload import DRIFT as JDRIFT
from pegasus_tpu.storage import engine as jeng
from pegasus_tpu.utils import token_bucket as jtb
from pegasus_tpu_torch.server import types as ttypes
from pegasus_tpu_torch.server import write_service as tws
from pegasus_tpu_torch.server.partition_server import PartitionServer
from pegasus_tpu_torch.storage import engine as teng
from pegasus_tpu_torch.utils import token_bucket as ttb
from pegasus_tpu_torch.utils.errors import ErrorCode, StorageStatus

NOW = 334_000_000
TS_US = 1_788_000_000_123_456
OK = int(StorageStatus.OK)
TRY_AGAIN = int(StorageStatus.TRY_AGAIN)
INT64_MAX = (1 << 63) - 1

VALUES = [None, b"", b"abc", b"abcdef", b"0", b"7", b"-7", b"12",
          b"%d" % INT64_MAX, b"%d" % -(1 << 63), b"%d" % (INT64_MAX + 1),
          b" 5", b"5 ", b"x1", b"\xff", b"+3"]
OPERANDS = [b"", b"a", b"bc", b"abc", b"abd", b"7", b"-8", b"12",
            b"%d" % INT64_MAX, b"%d" % -(1 << 63), b"1x", b" 7"]


def _verdict(fn, ct, operand, value):
    try:
        return fn(ct, operand, value)
    except ValueError:
        return "ValueError"


@pytest.mark.parametrize("ct", list(range(18)))
def test_cas_check_passed_matches_jax(ct):
    assert [t.name for t in ttypes.CasCheckType] == \
        [t.name for t in jtypes.CasCheckType]
    for value in VALUES:
        for operand in OPERANDS:
            assert (_verdict(tws.cas_check_passed, ct, operand, value)
                    == _verdict(jws.cas_check_passed, ct, operand, value)), \
                (ct, operand, value)
    assert _verdict(tws.cas_check_passed, 18, b"", b"") == "ValueError"


HASHKEYS = [b"hk%02d" % i for i in range(12)]
SORTKEYS = [b"s%d" % i for i in range(6)]


def _seed_items(rng):
    """(key, user_data, expire_ts) rows: integers, text, empty values,
    int64 edges and malformed integers; a quarter expired at NOW, a
    quarter with a TTL still running, the rest without one."""
    rows = []
    for hk in HASHKEYS:
        for sk in SORTKEYS:
            if rng.random() < 0.2:
                continue
            value = VALUES[1 + int(rng.integers(0, len(VALUES) - 1))]
            r = rng.random()
            ets = NOW - 5 if r < 0.25 else NOW + 500 if r < 0.5 else 0
            rows.append((generate_key(hk, sk), value, ets))
    return rows


@pytest.fixture
def services(tmp_path):
    """(JAX WriteService, port WriteService) over engines holding the
    same seeded records."""
    jsvc = jws.WriteService(jeng.StorageEngine(
        str(tmp_path / "j"), values_carry_expire_header=True))
    tsvc = tws.WriteService(teng.StorageEngine(
        str(tmp_path / "t"), values_carry_expire_header=True,
        device="cpu"))
    rows = _seed_items(np.random.default_rng(5))
    for svc in (jsvc, tsvc):
        svc.apply_items(svc.translate_put_run(rows, TS_US), 1)
    yield jsvc, tsvc
    for svc in (jsvc, tsvc):
        svc.engine.close()


def _norm(x):
    """Responses and WriteBatchItems of either package as plain tuples."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            _norm(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return tuple(_norm(v) for v in x)
    return x


def _random_request(kind, mod, rng):
    hk = HASHKEYS[int(rng.integers(0, len(HASHKEYS)))]

    def sk():
        return SORTKEYS[int(rng.integers(0, len(SORTKEYS)))]

    def ttl():
        return int(rng.choice([0, 0, 60, -1, 5000]))

    if kind == "incr":
        inc = int(rng.choice([1, -3, 100, INT64_MAX, -INT64_MAX, 0]))
        return mod.IncrRequest(generate_key(hk, sk()), inc, ttl())
    ct = int(rng.integers(0, 18))
    operand = OPERANDS[int(rng.integers(0, len(OPERANDS)))]
    if kind == "check_and_set":
        csk = sk()
        ssk = sk()
        return mod.CheckAndSetRequest(
            hk, csk, ct, operand, set_diff_sort_key=ssk != csk,
            set_sort_key=ssk, set_value=b"set-%d" % rng.integers(0, 99),
            set_expire_ts_seconds=max(0, ttl()),
            return_check_value=bool(rng.random() < 0.7))
    if kind == "check_and_mutate":
        muts = []
        for _ in range(int(rng.integers(0, 5))):
            op = int(rng.integers(0, 2))
            muts.append(mod.Mutate(op, sk(), b"m-%d" % rng.integers(0, 99),
                                   max(0, ttl())))
        return mod.CheckAndMutateRequest(
            hk, sk(), ct, operand, mutate_list=muts,
            return_check_value=bool(rng.random() < 0.7))
    if kind == "multi_remove":
        n = int(rng.integers(0, 4))
        return mod.MultiRemoveRequest(hk, [sk() for _ in range(n)])
    n = int(rng.integers(0, 4))
    return mod.MultiPutRequest(
        hk, [mod.KeyValue(sk(), b"mp-%d" % i) for i in range(n)], ttl())


def _translate(svc, kind, req, now):
    if kind == "multi_remove":
        return svc.translate_multi_remove(req)
    return getattr(svc, f"translate_{kind}")(req, TS_US, now)


@pytest.mark.parametrize("kind", ["incr", "check_and_set",
                                  "check_and_mutate", "multi_remove",
                                  "multi_put"])
def test_translate_matches_jax(services, kind):
    rng_j, rng_t = np.random.default_rng(11), np.random.default_rng(11)
    decree = 1
    oks = 0
    for i in range(150):
        # the clock moves on, so TTLs set here expire later in the run
        now = NOW + 40 * i
        jout = _translate(services[0], kind, _random_request(
            kind, jtypes, rng_j), now)
        tout = _translate(services[1], kind, _random_request(
            kind, ttypes, rng_t), now)
        assert _norm(tout) == _norm(jout), i
        items = jout[-1]
        oks += bool(items)
        decree += 1
        services[0].apply_items(items, decree)
        services[1].apply_items(tout[-1], decree)
    assert oks > 20
    assert ([_norm(r) for r in services[1].engine.iterate()]
            == [_norm(r) for r in services[0].engine.iterate()])


@pytest.mark.parametrize("order", ["put_then_delete", "delete_then_put"])
def test_mutate_list_order_last_op_wins(services, order):
    """One batch in list order: the last op on a sort key wins."""
    got = []
    for svc, mod in zip(services, (jtypes, ttypes)):
        put = mod.Mutate(mod.MutateOperation.MO_PUT, b"s1", b"new", 30)
        delete = mod.Mutate(mod.MutateOperation.MO_DELETE, b"s1")
        muts = [put, delete] if order == "put_then_delete" else [delete, put]
        req = mod.CheckAndMutateRequest(
            HASHKEYS[0], b"s9", int(mod.CasCheckType.CT_NO_CHECK),
            mutate_list=muts)
        resp, items = svc.translate_check_and_mutate(req, TS_US, NOW)
        svc.apply_items(items, 2)
        got.append((_norm(resp), _norm(items),
                    svc.engine.get(generate_key(HASHKEYS[0], b"s1"))))
    assert got[1] == got[0]
    assert (got[1][2] is None) == (order == "put_then_delete")


def test_ttl_past_2_32_wraps(services):
    """`now + ttl` past 2^32 wraps as the uint32 column holds it (the
    JAX write path packs it unmasked and raises; parity cases stay
    below 2^32)."""
    svc = services[1]
    now = 0xFFFFFF00
    resp, items = svc.translate_incr(
        ttypes.IncrRequest(generate_key(b"w", b"s"), 1, 0x200), TS_US, now)
    assert resp.error == OK and items[0].expire_ts == 0x100
    resp, items = svc.translate_check_and_set(ttypes.CheckAndSetRequest(
        b"w", b"s", 0, set_value=b"v", set_expire_ts_seconds=0x200),
        TS_US, now)
    assert items[0].expire_ts == 0x100
    resp, items = svc.translate_check_and_mutate(
        ttypes.CheckAndMutateRequest(b"w", b"s", 0, mutate_list=[
            ttypes.Mutate(0, b"s", b"v", 0x200)]), TS_US, now)
    assert items[0].expire_ts == 0x100


# ---- the handlers' gates ---------------------------------------------------

PARTITION_COUNT = 4
PIDX = 2
# an app id no other test uses: the JAX server registers process-wide
# metric entities under it
APP_ID = 9007
OWNED = [h for h in (b"own%03d" % i for i in range(100))
         if key_hash_parts(h) % PARTITION_COUNT == PIDX][:6]
STALE = [h for h in (b"own%03d" % i for i in range(100))
         if key_hash_parts(h) % PARTITION_COUNT != PIDX][:2]


class _FrozenTime:
    """The token-bucket and write-service modules' `time`: the buckets'
    clock stays at 0 and every timetag is TS_US."""

    @staticmethod
    def monotonic() -> float:
        return 0.0

    @staticmethod
    def time() -> float:
        return TS_US / 1e6


@pytest.fixture
def servers(tmp_path, monkeypatch):
    for mod in (jtb, ttb, jws, tws):
        monkeypatch.setattr(mod, "time", _FrozenTime)
    pair = (JServer(str(tmp_path / "jax"), app_id=APP_ID, pidx=PIDX,
                    partition_count=PARTITION_COUNT),
            PartitionServer(str(tmp_path / "torch"), app_id=APP_ID,
                            pidx=PIDX, partition_count=PARTITION_COUNT,
                            device="cpu"))
    for hk in OWNED:
        for sk in SORTKEYS[:3]:
            for s in pair:
                assert s.on_put(generate_key(hk, sk), b"10") == OK
    yield pair
    for s in pair:
        s.close()
    jplacement.reset_probe()
    JDRIFT.reset()


def _writes(s, hk, ph):
    mod = jtypes if isinstance(s, JServer) else ttypes
    return {
        "multi_remove": s.on_multi_remove(
            mod.MultiRemoveRequest(hk, [SORTKEYS[0]]), partition_hash=ph),
        "incr": s.on_incr(mod.IncrRequest(generate_key(hk, SORTKEYS[1]), 5),
                          partition_hash=ph).error,
        "check_and_set": s.on_check_and_set(mod.CheckAndSetRequest(
            hk, SORTKEYS[1], int(mod.CasCheckType.CT_VALUE_EXIST), b"",
            set_value=b"x"), partition_hash=ph).error,
        "check_and_mutate": s.on_check_and_mutate(mod.CheckAndMutateRequest(
            hk, SORTKEYS[2], int(mod.CasCheckType.CT_NO_CHECK), b"",
            mutate_list=[mod.Mutate(int(mod.MutateOperation.MO_PUT),
                                    b"m", b"y")]),
            partition_hash=ph).error,
    }


def _reads(s, hk):
    mod = jtypes if isinstance(s, JServer) else ttypes
    return {
        "ttl": s.on_ttl(generate_key(hk, SORTKEYS[1]))[0],
        "batch_get": s.on_batch_get(mod.BatchGetRequest(
            [mod.FullKey(hk, SORTKEYS[1])])).error,
        "sortkey_count": s.on_sortkey_count(hk)[0],
    }


def _state(s):
    return (s.engine.last_committed_decree,
            [_norm(r) for r in s.engine.iterate()])


@pytest.mark.parametrize("gate", ["deny_write", "deny_read", "deny_all",
                                  "write_throttle", "read_throttle"])
def test_gates_match_jax_and_write_nothing(servers, gate):
    for s in servers:
        if gate.startswith("deny"):
            s.update_app_envs({"replica.deny_client_request":
                               "reject*" + gate.split("_")[1]})
        else:
            kind = gate.split("_")[0]
            s.update_app_envs({f"replica.{kind}_throttling": "5*reject*100"})
            _delay, reject = getattr(s, f"_{kind}_throttle")
            while reject.try_consume():
                pass
    before = [_state(s) for s in servers]
    hk = OWNED[0]
    got = [(_writes(s, hk, key_hash_parts(hk)), _reads(s, hk))
           for s in servers]
    assert got[1] == got[0]
    writes_denied = gate in ("deny_write", "deny_all", "write_throttle")
    reads_denied = gate in ("deny_read", "deny_all", "read_throttle")
    w, r = got[1]
    assert all(v == (TRY_AGAIN if writes_denied else OK)
               for v in (w["multi_remove"][0], w["incr"],
                         w["check_and_set"], w["check_and_mutate"]))
    assert w["multi_remove"][1] == (0 if writes_denied else 1)
    assert all(v == (TRY_AGAIN if reads_denied else OK)
               for v in r.values())
    after = [_state(s) for s in servers]
    assert after[1] == after[0]
    if writes_denied:
        assert after == before


def test_stale_partition_hash_is_refused_alike(servers):
    before = [_state(s) for s in servers]
    misused = int(ErrorCode.ERR_PARENT_PARTITION_MISUSED)
    for hk in STALE:
        got = [_writes(s, hk, key_hash_parts(hk)) for s in servers]
        assert got[1] == got[0]
        assert got[1]["incr"] == misused
        assert got[1]["multi_remove"] == (misused, 0)
        # a batch_get holding a key this partition does not own
        bg = [s.on_batch_get((jtypes if i == 0 else ttypes).BatchGetRequest(
            [(jtypes if i == 0 else ttypes).FullKey(hk, b"s")])).error
            for i, s in enumerate(servers)]
        assert bg == [misused, misused]
    assert [_state(s) for s in servers] == before
