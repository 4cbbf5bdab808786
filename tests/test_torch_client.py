"""The in-process client: the port's Table and PegasusClient against the
JAX package's, exact.

- a seeded stream of set / get / delete / exist / ttl / incr / multi_set /
  multi_get / multi_get_sortkeys / multi_del / batch_get / sortkey_count /
  check_and_set / check_and_mutate against an 8-partition Table in each
  package, with flushes, compactions and a clock that moves on (TTLs
  expire mid-stream): every response equal;
- the ordered and unordered scanners, with and without a value filter,
  and the pushdown aggregates: rows and results equal;
- a table either package wrote (memtables in the WAL, L0 and L1 runs, a
  split) opens in the other's Table and answers the same;
- Table, and so PegasusClient, serves on the card by default.

Both packages' wall clocks are frozen by replacing the `time` of their
value-schema and write-service modules (epoch_now and the timetags), and
their store flags are set and restored in both registries.
"""

import dataclasses
import time

import numpy as np
import pytest

from pegasus_tpu.base import value_schema as jvs
from pegasus_tpu.client import PegasusClient as JClient
from pegasus_tpu.client import ScanOptions as JOptions
from pegasus_tpu.client import Table as JTable
from pegasus_tpu.ops import placement as jplacement
from pegasus_tpu.server import types as jtypes
from pegasus_tpu.server import write_service as jws
from pegasus_tpu.server.workload import DRIFT as JDRIFT
from pegasus_tpu.storage import compact_governor as jgov
from pegasus_tpu.utils.flags import FLAGS as JFLAGS
from pegasus_tpu_torch.base import value_schema as tvs
from pegasus_tpu_torch.client import PegasusClient, ScanOptions, Table
from pegasus_tpu_torch.server import types as ttypes
from pegasus_tpu_torch.server import write_service as tws
from pegasus_tpu_torch.storage import compact_governor as tgov
from pegasus_tpu_torch.utils.flags import FLAGS as TFLAGS

T0 = 1_790_000_000.25   # unix seconds the frozen clock starts at
STORE_FLAGS = (("pegasus.storage", "block_codec", "dcz2"),
               ("pegasus.server", "bloom_bits_per_key", 10),
               ("pegasus.server", "phash_index", True),
               ("pegasus.server", "rocksdb_max_iteration_count", 1000))
# app ids no other test uses: the JAX servers register process-wide
# metric entities under them
APP_ID = 9107


class Clock:
    """Stands in for a module's `time`: `time()` is frozen at `t`, which
    a test moves on; everything else is the real module's."""

    def __init__(self, t: float) -> None:
        self.t = t

    def time(self) -> float:
        return self.t

    def __getattr__(self, name):
        return getattr(time, name)


def _set_flags(values, registries=(JFLAGS, TFLAGS)):
    for section, name, value in values:
        for reg in registries:
            reg.set(section, name, value, force=True)


@pytest.fixture
def clock(monkeypatch):
    """The frozen clock of both packages; their store flags, GOVERNORs,
    the JAX placement probe and drift gauge are restored after the
    test."""
    clk = Clock(T0)
    for mod in (jvs, tvs, jws, tws):
        monkeypatch.setattr(mod, "time", clk)
    saved = [[(s, n, reg.get(s, n)) for s, n, _v in STORE_FLAGS]
             for reg in (JFLAGS, TFLAGS)]
    govs = [(g, dict(vars(g))) for g in (jgov.GOVERNOR, tgov.GOVERNOR)]
    _set_flags(STORE_FLAGS)
    yield clk
    _set_flags(saved[0], (JFLAGS,))
    _set_flags(saved[1], (TFLAGS,))
    for g, attrs in govs:
        g.__dict__.update(attrs)
    jplacement.reset_probe()
    JDRIFT.reset()


@pytest.fixture
def tables(tmp_path, clock):
    pair = (JTable(str(tmp_path / "j"), app_id=APP_ID, partition_count=8),
            Table(str(tmp_path / "t"), app_id=APP_ID, partition_count=8,
                  device="cpu"))
    yield pair
    for t in pair:
        t.close()


def _norm(x):
    """A response of either package as plain values."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            _norm(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return tuple(_norm(v) for v in x)
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    return x


HASHKEYS = [b"user%04d" % i for i in range(60)]
SORTKEYS = [b"f%02d" % i for i in range(12)]
VALUES = [b"", b"1", b"-12", b"42", b"x" * 30, b"9223372036854775807",
          b"abc", b"payload-%d"]
OPS = ("set", "get", "delete", "exist", "ttl", "incr", "multi_set",
       "multi_get", "multi_get_range", "multi_get_sortkeys", "multi_del",
       "batch_get", "sortkey_count", "check_and_set", "check_and_mutate")


def _one_op(c, mod, op, rng):
    """Runs one seeded op on client `c` (`mod` is its package's types)."""
    hk = HASHKEYS[int(rng.integers(0, len(HASHKEYS)))]

    def sk():
        return SORTKEYS[int(rng.integers(0, len(SORTKEYS)))]

    def val():
        v = VALUES[int(rng.integers(0, len(VALUES)))]
        return v % int(rng.integers(0, 100)) if b"%d" in v else v

    def ttl():
        return int(rng.choice([0, 0, 0, 30, 400, 100_000]))

    if op == "set":
        return c.set(hk, sk(), val(), ttl())
    if op == "get":
        return c.get(hk, sk())
    if op == "delete":
        return c.delete(hk, sk())
    if op == "exist":
        return c.exist(hk, sk())
    if op == "ttl":
        return c.ttl(hk, sk())
    if op == "incr":
        return c.incr(hk, sk(), int(rng.choice([1, -5, 1000])),
                      int(rng.choice([0, 0, 50, -1])))
    if op == "multi_set":
        n = int(rng.integers(0, 5))
        return c.multi_set(hk, {sk(): val() for _ in range(n)}, ttl())
    if op == "multi_get":
        n = int(rng.integers(1, 5))
        return c.multi_get(hk, [sk() for _ in range(n)],
                           no_value=bool(rng.random() < 0.2))
    if op == "multi_get_range":
        a, b = sorted((sk(), sk()))
        return c.multi_get(hk, start_sortkey=a, stop_sortkey=b,
                           max_kv_count=int(rng.choice([-1, 3])),
                           reverse=bool(rng.random() < 0.3))
    if op == "multi_get_sortkeys":
        return c.multi_get_sortkeys(hk)
    if op == "multi_del":
        n = int(rng.integers(0, 4))
        return c.multi_del(hk, [sk() for _ in range(n)])
    if op == "batch_get":
        n = int(rng.integers(1, 8))
        return c.batch_get(
            [(HASHKEYS[int(rng.integers(0, len(HASHKEYS)))], sk())
             for _ in range(n)])
    if op == "sortkey_count":
        return c.sortkey_count(hk)
    ct = int(rng.integers(0, 18))
    operand = VALUES[int(rng.integers(0, 7))]
    if op == "check_and_set":
        return c.check_and_set(hk, sk(), ct, operand, sk(), val(), ttl(),
                               return_check_value=bool(rng.random() < .5))
    muts = [mod.Mutate(int(rng.integers(0, 2)), sk(), val(), ttl())
            for _ in range(int(rng.integers(1, 4)))]
    return c.check_and_mutate(hk, sk(), ct, operand, muts,
                              return_check_value=bool(rng.random() < .5))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_op_stream_matches_jax(tables, clock, seed):
    clients = (JClient(tables[0]), PegasusClient(tables[1]))
    rngs = [np.random.default_rng(seed) for _ in clients]
    counts = dict.fromkeys(OPS, 0)
    for i in range(700):
        op = OPS[int(rngs[0].integers(0, len(OPS)))]
        rngs[1].integers(0, len(OPS))
        got = [_one_op(c, mod, op, rng)
               for c, mod, rng in zip(clients, (jtypes, ttypes), rngs)]
        assert _norm(got[1]) == _norm(got[0]), (i, op)
        counts[op] += 1
        if i % 100 == 99:
            clock.t += 97  # TTLs of 30 s expire, some of 400 s too
            for t in tables:
                t.flush_all()
        if i % 250 == 249:
            for t in tables:
                t.manual_compact_all()
    assert min(counts.values()) > 20
    # the same records underneath, timetags included
    for pj, pt in zip(tables[0].all_partitions(),
                      tables[1].all_partitions()):
        assert list(pt.engine.iterate()) == list(pj.engine.iterate())


def _fill(tables, n=400):
    for t, client in zip(tables, (JClient, PegasusClient)):
        c = client(t)
        for i in range(n):
            hk = b"apple_%03d" % (i % 37) if i % 3 else b"pear_%03d" % i
            c.set(hk, b"s%02d" % (i % 11), b"v%d|%d" % (i, i * 7),
                  ttl_seconds=30 if i % 13 == 0 else 0)


SCAN_CASES = [
    dict(batch_size=7),
    dict(batch_size=50, no_value=True, return_expire_ts=True),
    dict(batch_size=16, hash_key_filter_type=2,
         hash_key_filter_pattern=b"apple"),
    dict(batch_size=9, sort_key_filter_type=3, sort_key_filter_pattern=b"3"),
    dict(batch_size=13, value_filter_type=1, value_filter_pattern=b"|7"),
    dict(batch_size=1000, value_filter_type=2, value_filter_pattern=b"v1"),
]


@pytest.mark.parametrize("case", range(len(SCAN_CASES)))
@pytest.mark.parametrize("split_count", [1, 3])
def test_scanners_match_jax(tables, clock, case, split_count):
    _fill(tables)
    clock.t += 40  # the 30 s TTLs have expired
    tables[0].flush_all()
    tables[1].flush_all()
    kw = SCAN_CASES[case]
    out = []
    for t, opts, client in ((tables[0], JOptions, JClient),
                            (tables[1], ScanOptions, PegasusClient)):
        c = client(t)
        rows = [_drain(sc, kw) for sc in
                c.get_unordered_scanners(split_count, opts(**kw))]
        ordered = list(c.get_scanner(b"apple_005", options=opts(**kw)))
        ranged = list(c.get_scanner(b"apple_006", b"s02", b"s08",
                                    options=opts(**kw)))
        out.append((rows, ordered, ranged))
    assert out[1] == out[0]
    assert sum(len(r) for r in out[1][0]) > 0


def _drain(sc, kw):
    """Rows of a scanner; with expire timestamps, through next_record."""
    if not kw.get("return_expire_ts"):
        return list(sc)
    rows = []
    while True:
        try:
            rows.append(sc.next_record())
        except StopIteration:
            return rows


@pytest.mark.parametrize("kind,k", [("count", 0), ("sum", 0),
                                    ("top_k", 5), ("sample", 4)])
@pytest.mark.parametrize("value_filter", [False, True])
def test_aggregate_matches_jax(tables, clock, kind, k, value_filter):
    _fill(tables)
    tables[0].manual_compact_all()
    tables[1].manual_compact_all()
    kw = dict(batch_size=20)
    if value_filter:
        kw.update(value_filter_type=2, value_filter_pattern=b"v2")
    got = []
    for t, opts, client in ((tables[0], JOptions, JClient),
                            (tables[1], ScanOptions, PegasusClient)):
        c = client(t)
        got.append([sc.aggregate(kind, k=k, seed=3)
                    for sc in c.get_unordered_scanners(2, opts(**kw))]
                   + [c.get_scanner(b"apple_010",
                                    options=opts(**kw)).aggregate(
                                        kind, k=k, seed=3)])
    assert _norm(got[1]) == _norm(got[0])


def _answers(client_cls, t, keys):
    c = client_cls(t)
    gets = [c.get(hk, sk) for hk, sk in keys]
    ttls = [c.ttl(hk, sk) for hk, sk in keys]
    rows = sorted(r for sc in c.get_unordered_scanners(2) for r in sc)
    counts = [c.sortkey_count(hk) for hk, _sk in keys[:20]]
    return gets, ttls, rows, counts


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_table_opens_in_the_other_package(tmp_path, clock, writer, split):
    """A table one package wrote (records in L1 and L0 runs and in the
    WAL, optionally split 4 -> 8) answers the same in the other's
    Table."""
    d = str(tmp_path / "t")
    w = (JTable(d, app_id=APP_ID, partition_count=4) if writer == "jax"
         else Table(d, app_id=APP_ID, partition_count=4, device="cpu"))
    wc = (JClient if writer == "jax" else PegasusClient)(w)
    keys = []
    for i in range(300):
        hk, sk = b"cross%03d" % (i % 70), b"s%d" % (i % 5)
        wc.set(hk, sk, b"val-%d" % i, ttl_seconds=500 if i % 4 == 0 else 0)
        keys.append((hk, sk))
        if i == 120:
            w.manual_compact_all()
        if i == 220:
            w.flush_all()
    if split:
        w.split()
    count = w.partition_count
    w.close()
    jt = JTable(d, app_id=APP_ID, partition_count=count)
    jans = _answers(JClient, jt, keys)
    jt.close()
    tt = Table(d, app_id=APP_ID, partition_count=count, device="cpu")
    tans = _answers(PegasusClient, tt, keys)
    tt.close()
    assert tans == jans
    assert len(tans[2]) == len(set(keys))


def test_entry_points_default_to_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Table(str(tmp_path / "t"), partition_count=2)
    t = Table(str(tmp_path / "c"), partition_count=2, device="cpu")
    assert PegasusClient(t).device == torch.device("cpu")
    t.close()
