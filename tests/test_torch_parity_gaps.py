"""Public surface the port once dropped, against the JAX package, exact.

- `key_schema.hash_key_hash` and `HASH_KEY_LEN_MAX`,
  `value_schema.extract_timestamp_from_timetag` and `DATA_VERSION_MAX`,
  `errors.rocksdb_status`: equal on seeded inputs;
- `LSMStore(l0_compaction_trigger=, l1_run_capacity=)`: a merge
  compaction of 300 records split into L1 runs of 100 and of 50
  (tests/test_storage.py's multi-run case, cut from 700 records), then
  recovery through the manifest and a second compaction, gives the JAX
  package's SST bytes, file names and manifest (its wall-clock
  `manual_compact_finish_time` left out) and the same reads, with the
  store flags at `none` and at dcz2 with sidecars; the auto-compaction
  trigger follows the knob in both;
- `ops/pushdown.aggregate_rows` over seeded rows for every aggregate and
  value-filter type a `PushdownSpec` takes, `Memtable.approximate_bytes`
  after a seeded mix of puts, overwrites and deletes, and
  `sstable.block_crc_enabled` / `block_cache_budget` under their flags'
  settings: equal to the JAX package's.
"""

import json
import os

import numpy as np
import pytest

from pegasus_tpu.base import key_schema as jks
from pegasus_tpu.base import value_schema as jvs
from pegasus_tpu.ops import pushdown as jpd
from pegasus_tpu.storage import lsm as jlsm
from pegasus_tpu.storage import memtable as jmt
from pegasus_tpu.storage import sstable as jsst
from pegasus_tpu.utils import errors as jerrors
from pegasus_tpu.utils.flags import FLAGS as JFLAGS
from pegasus_tpu_torch.base import key_schema as tks
from pegasus_tpu_torch.base import value_schema as tvs
from pegasus_tpu_torch.ops import pushdown as tpd
from pegasus_tpu_torch.storage import lsm as tlsm
from pegasus_tpu_torch.storage import memtable as tmt
from pegasus_tpu_torch.storage import sstable as tsst
from pegasus_tpu_torch.utils import errors as terrors
from pegasus_tpu_torch.utils.flags import FLAGS as TFLAGS

STORE_FLAGS = (("pegasus.storage", "block_codec"),
               ("pegasus.server", "bloom_bits_per_key"),
               ("pegasus.server", "phash_index"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_restored_names_match_jax(seed):
    rng = np.random.default_rng(seed)
    assert tks.HASH_KEY_LEN_MAX == jks.HASH_KEY_LEN_MAX
    assert tvs.DATA_VERSION_MAX == jvs.DATA_VERSION_MAX
    for _ in range(50):
        hk = rng.integers(0, 256, int(rng.integers(0, 40)),
                          dtype=np.uint8).tobytes()
        assert tks.hash_key_hash(hk) == jks.hash_key_hash(hk)
        tag = int(rng.integers(0, 1 << 63, dtype=np.uint64)) \
            | int(rng.integers(0, 2)) << 63
        assert tvs.extract_timestamp_from_timetag(tag) == \
            jvs.extract_timestamp_from_timetag(tag)
        us = int(rng.integers(0, 1 << 56, dtype=np.uint64))
        made = tvs.generate_timetag(us, int(rng.integers(0, 128)),
                                    bool(rng.integers(0, 2)))
        assert tvs.extract_timestamp_from_timetag(made) == us
    for ok in (True, False):
        assert terrors.rocksdb_status(ok) == jerrors.rocksdb_status(ok)


@pytest.fixture(params=[("none", 0, False), ("dcz2", 10, True)],
                ids=["none", "dcz2-sidecars"])
def store_flags(request):
    saved = [(reg, s, n, reg.get(s, n)) for reg in (JFLAGS, TFLAGS)
             for s, n in STORE_FLAGS]
    for (section, name), value in zip(STORE_FLAGS, request.param):
        for reg in (JFLAGS, TFLAGS):
            reg.set(section, name, value, force=True)
    yield request.param
    for reg, s, n, v in saved:
        reg.set(s, n, v, force=True)


def _files(d: str) -> dict:
    """{name: bytes} of the store's SST files, and its manifest parsed
    without the wall-clock compaction time."""
    out = {}
    for root, _dirs, names in os.walk(d):
        for name in names:
            path = os.path.join(root, name)
            rel = os.path.relpath(path, d)
            with open(path, "rb") as f:
                data = f.read()
            if name.endswith(".sst"):
                out[rel] = data
            elif name.startswith("MANIFEST"):
                man = json.loads(data)
                man.pop("manual_compact_finish_time", None)
                out[rel] = man
    return out


def _views(store, keys):
    return (list(store.iterate()),
            list(store.iterate(keys[95], keys[105])),
            [store.get(k) for k in keys[::37]],
            [(t.first_key, t.last_key) for t in store.l1_runs])


@pytest.mark.parametrize("cap", [100, 50])
def test_multi_run_l1_compaction_matches_jax(tmp_path, store_flags, cap):
    n = 300
    keys = [b"k%05d" % i for i in range(n)]
    dirs = (str(tmp_path / "j"), str(tmp_path / "t"))
    mods = (jlsm, tlsm)
    stores = [m.LSMStore(d, l1_run_capacity=cap)
              for m, d in zip(mods, dirs)]
    for lo, hi in ((0, n // 2), (n // 2, n)):
        for s in stores:
            for i in range(lo, hi):
                s.put(keys[i], b"v%d" % i)
            s.flush()
    for s in stores:
        s.compact()
    assert len(stores[0].l1_runs) == len(stores[1].l1_runs) == n // cap
    assert _views(stores[1], keys) == _views(stores[0], keys)
    assert _files(dirs[1]) == _files(dirs[0])
    for s in stores:
        s.close()

    # recovery through the manifest, then a second compaction
    stores = [m.LSMStore(d, l1_run_capacity=cap)
              for m, d in zip(mods, dirs)]
    assert len(stores[1].l1_runs) == n // cap
    for s in stores:
        s.put(keys[200], b"updated")
        s.delete(keys[0])
        s.flush()
        s.compact()
    assert stores[1].get(keys[200]) == (b"updated", 0)
    assert stores[1].get(keys[0]) is None
    assert _views(stores[1], keys) == _views(stores[0], keys)
    assert _files(dirs[1]) == _files(dirs[0])
    for s in stores:
        s.close()


@pytest.mark.parametrize("trigger", [2, 4])
def test_l0_compaction_trigger_matches_jax(tmp_path, trigger):
    stores = [m.LSMStore(str(tmp_path / name), l0_compaction_trigger=trigger)
              for m, name in ((jlsm, "j"), (tlsm, "t"))]
    for i in range(trigger):
        wants = []
        for s in stores:
            s.put(b"k%03d" % i, b"v")
            s.flush()
            wants.append(s.should_compact())
        assert wants[0] == wants[1] == (i + 1 >= trigger)
    for s in stores:
        s.close()


def _rows(rng, n):
    """Seeded (key, user_value) rows; values of 0-12 bytes over a small
    alphabet so the value filters both keep and drop rows."""
    out = []
    for i in range(n):
        key = b"h%03d" % int(rng.integers(0, 40)) + b"\x00s%04d" % i
        value = bytes(rng.choice(list(b"abc\x00\xff"),
                                 size=int(rng.integers(0, 13))))
        out.append((key, value))
    return out


@pytest.mark.parametrize("aggregate", ["count", "sum", "top_k", "sample"])
@pytest.mark.parametrize("filter_type", [0, 1, 2, 3],
                         ids=["none", "anywhere", "prefix", "postfix"])
def test_aggregate_rows_matches_jax(aggregate, filter_type):
    rng = np.random.default_rng(100 + 10 * filter_type + len(aggregate))
    rows = _rows(rng, 400)
    for pattern in (b"", b"a", b"ab", b"\x00c"):
        for k in (1, 7):
            spec = dict(value_filter_type=filter_type,
                        value_filter_pattern=pattern, aggregate=aggregate,
                        k=k if aggregate in ("top_k", "sample") else 0,
                        seed=int(rng.integers(0, 1 << 31)))
            want = jpd.aggregate_rows(jpd.PushdownSpec(**spec), rows)
            got = tpd.aggregate_rows(tpd.PushdownSpec(**spec), rows)
            assert got == want, (spec, got, want)
    with pytest.raises(ValueError):
        tpd.aggregate_rows(tpd.PushdownSpec(), rows)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_memtable_approximate_bytes_matches_jax(seed):
    rng = np.random.default_rng(seed)
    jm, tm = jmt.Memtable(), tmt.Memtable()
    assert tm.approximate_bytes == jm.approximate_bytes == 0
    for _ in range(600):
        key = b"k%03d" % int(rng.integers(0, 120))
        if rng.random() < 0.25:
            jm.delete(key)
            tm.delete(key)
        else:
            value = bytes(int(rng.integers(0, 256))
                          for _ in range(int(rng.integers(0, 20))))
            ets = int(rng.integers(0, 1 << 31))
            jm.put(key, value, ets)
            tm.put(key, value, ets)
        assert tm.approximate_bytes == jm.approximate_bytes
    assert list(tm.items_sorted()) == list(jm.items_sorted())


@pytest.mark.parametrize("crc,budget", [(True, 33_554_432), (False, 1),
                                        (True, 4096), (False, 0)])
def test_block_flag_readers_match_jax(crc, budget):
    names = (("pegasus.storage", "block_crc"),
             ("pegasus.storage", "block_cache_bytes"))
    saved = [(f, f.get(*n)) for f in (JFLAGS, TFLAGS) for n in names]
    try:
        for f in (JFLAGS, TFLAGS):
            f.set("pegasus.storage", "block_crc", crc, force=True)
            f.set("pegasus.storage", "block_cache_bytes", budget,
                  force=True)
        assert tsst.block_crc_enabled() is jsst.block_crc_enabled() is crc
        assert tsst.block_cache_budget() == jsst.block_cache_budget() \
            == budget
    finally:
        for (f, value), n in zip(saved, names * 2):
            f.set(*n, value, force=True)
