"""The columnar scan of one key-ordered chain of runs under a memtable
overlay, held to the heap merge path on the same store.

Both store shapes the columnar overlay scan serves are built at random:
one L0 table (written as a bulk load writes it, tombstones and expired
rows included) under a memtable, and the L1 runs of a compaction under a
memtable. The memtable puts new keys, overwrites and deletes base keys,
deletes keys that are nowhere, and holds expired rows and rows of other
partitions, and both hold malformed keys. Every ranged read is made twice on the same store: through
`_batched_scan` as it dispatches, and through the heap merge, which still
serves reverse reads and every other store shape, with the store's
`base_chain` qualifier switched off. Records, `exhausted`, `resume_key`,
the expired records counted (`abnormal_read_count`), the records
examined and the value filter's pruned count must be equal, over random
ranges, the three filter types, validation on and off, a pushdown value
filter, page limits in records and bytes, small range-read budgets, a
small predicate batch, and the split gate.
"""

from __future__ import annotations

import numpy as np
import pytest

from pegasus_tpu_torch.base.key_schema import generate_key
from pegasus_tpu_torch.base.value_schema import generate_value
from pegasus_tpu_torch.ops.predicates import FilterSpec
from pegasus_tpu_torch.server import partition_server as ps
from pegasus_tpu_torch.server.partition_server import PartitionServer
from pegasus_tpu_torch.server.read_limiter import RangeReadLimiter
from pegasus_tpu_torch.storage.sstable import SSTableWriter
from pegasus_tpu_torch.utils.flags import FLAGS

BLOCK = 16                   # rows a block: many blocks at a small size
T = 1_000_000                # expire_ts of TTL rows lie in [T, T + 100]
NOW = T + 50                 # the reads' `now`: about half of them expired
HASHKEYS = [b"hk%03d" % i for i in range(40)]
SORTKEYS = [b"s%02d" % i for i in range(12)]
FILTERS = [(0, b""), (1, b"1"), (2, b"hk0"), (3, b"2"), (2, b"s0"),
           (3, b"")]
VALUE_FILTERS = [None, (1, b"7"), (2, b"v1"), (3, b"x")]
# keys whose hash-key-length header does not fit them (a 1-byte key, a
# header longer than the body): records the merge path's launch neither
# keeps nor counts expired
MALFORMED = (b"\x00", b"\x00\x09ab")
STORE_FLAGS = (("pegasus.storage", "block_codec", "none"),
               ("pegasus.server", "bloom_bits_per_key", 0),
               ("pegasus.server", "phash_index", False))


@pytest.fixture
def flags():
    keys = [(s, n) for s, n, _v in STORE_FLAGS] + [
        ("pegasus.server", "rocksdb_max_iteration_count")]
    saved = [FLAGS.get(s, n) for s, n in keys]
    for s, n, v in STORE_FLAGS:
        FLAGS.set(s, n, v, force=True)
    yield
    for (s, n), v in zip(keys, saved):
        FLAGS.set(s, n, v, force=True)


def _ets(rng) -> int:
    return 0 if rng.random() < 0.6 else T + int(rng.integers(0, 101))


def _value(rng, tag: bytes, ets: int) -> bytes:
    data = tag + b"-v%d-" % int(rng.integers(0, 100)) + b"x" * int(
        rng.integers(0, 30))
    return generate_value(1, data, ets)


def _keys(rng, share: float) -> list:
    return sorted(generate_key(hk, sk) for hk in HASHKEYS for sk in SORTKEYS
                  if rng.random() < share)


def build_store(tmp_path, shape: str, seed: int) -> PartitionServer:
    """A partition (pidx 1 of 4) holding one L0 table or the L1 runs of
    a compaction, under a memtable of puts, overwrites, deletes and
    expired rows."""
    rng = np.random.default_rng(seed)
    srv = PartitionServer(str(tmp_path / f"{shape}-{seed}"), app_id=9511,
                          pidx=1, partition_count=4, device="cpu")
    lsm = srv.engine.lsm
    lsm._block_capacity = BLOCK
    lsm._l1_run_capacity = 2 * BLOCK + 3
    # a compaction keeps only this partition's keys
    base = sorted(_keys(rng, 0.45 if shape == "l0" else 0.9)
                  + list(MALFORMED))
    if shape == "l0":
        def build(dest, meta):
            w = SSTableWriter(dest, block_capacity=BLOCK, meta=meta)
            for key in base:
                if rng.random() < 0.08:
                    w.add(key, b"", 0, tombstone=True)
                else:
                    ets = _ets(rng)
                    w.add(key, _value(rng, b"base", ets), ets)
            w.finish()
        lsm.ingest(build)
    else:
        for key in base:
            ets = _ets(rng)
            lsm.put(key, _value(rng, b"base", ets), ets)
        srv.manual_compact(now=1)
        assert len(lsm.l1_runs) > 1
    assert lsm.base_chain() is not None
    # the memtable: overwrites and deletes of base keys, new keys,
    # deletes of keys that are nowhere (seed 0 of the L0 shape leaves it
    # empty)
    if not (shape == "l0" and seed == 0):
        for key in _keys(rng, 0.12):
            if rng.random() < 0.25:
                lsm.delete(key)
            else:
                ets = _ets(rng)
                lsm.put(key, _value(rng, b"mem", ets), ets)
        for key, ets in ((b"\x00\x07xy", T + 10), (b"\x01", 0)):
            lsm.put(key, _value(rng, b"mal", ets), ets)
    return srv


def scan(srv, args: dict, merge: bool, monkeypatch):
    """One ranged read: (records, exhausted, resume_key, expired counted,
    records examined, pruned)."""
    before = srv.abnormal_read_count
    limiter = RangeReadLimiter()
    pd_stats: dict = {}
    with monkeypatch.context() as m:
        if merge:
            m.setattr(srv.engine.lsm, "base_chain", lambda: None)
        out = srv._batched_scan(
            args["start"], args["stop"], NOW,
            FilterSpec.make(*args["hash_filter"], srv.device),
            FilterSpec.make(*args["sort_filter"], srv.device),
            args["validate"], limiter, args["max_records"],
            args["max_bytes"], with_values=args["with_values"],
            value_filter=args["value_filter"], pd_stats=pd_stats)
    return (out, srv.abnormal_read_count - before, limiter.iteration_count,
            pd_stats.get("pruned", 0))


def random_args(rng) -> dict:
    keys = [generate_key(hk, sk) for hk in HASHKEYS for sk in SORTKEYS]
    lo, hi = sorted(int(i) for i in rng.integers(0, len(keys), 2))
    return dict(
        start=b"" if rng.random() < 0.2 else keys[lo],
        stop=None if rng.random() < 0.3 else keys[hi] + b"\x00",
        hash_filter=FILTERS[int(rng.integers(0, 4))] if rng.random() < 0.5
        else (0, b""),
        sort_filter=FILTERS[int(rng.integers(0, len(FILTERS)))],
        validate=bool(rng.random() < 0.5),
        max_records=int(rng.choice([-1, 1, 3, 10, 40, 1000])),
        max_bytes=int(rng.choice([-1, -1, 60, 400])),
        with_values=bool(rng.random() < 0.8),
        value_filter=VALUE_FILTERS[int(rng.integers(0, len(VALUE_FILTERS)))])


def compare_random_reads(srv, shape: str, rng, monkeypatch) -> None:
    """60 random ranged reads, each through the dispatch and through the
    heap merge: equal, each dispatched read counted on its path."""
    served = 0
    for _ in range(60):
        args = random_args(rng)
        paths = dict(srv.scan_paths)
        got = scan(srv, args, merge=False, monkeypatch=monkeypatch)
        took = {k: v - paths[k] for k, v in srv.scan_paths.items()}
        want_path = ("columnar_overlay"
                     if len(srv.engine.lsm.memtable) or shape == "l0"
                     else "columnar")
        assert took[want_path] == 1 and sum(took.values()) == 1
        want = scan(srv, args, merge=True, monkeypatch=monkeypatch)
        assert got == want, args
        served += len(got[0][0])
    assert served > 0


@pytest.mark.parametrize("budget", [7, 100, 0])
@pytest.mark.parametrize("batch", [ps.PREDICATE_BATCH, 5])
@pytest.mark.parametrize("shape,seed", [("l0", 0), ("l0", 1), ("l0", 2),
                                        ("l1", 3), ("l1", 4)])
def test_the_overlay_scan_serves_what_the_heap_merge_serves(
        tmp_path, flags, monkeypatch, shape, seed, batch, budget):
    FLAGS.set("pegasus.server", "rocksdb_max_iteration_count", budget,
              force=True)
    monkeypatch.setattr(ps, "PREDICATE_BATCH", batch)
    srv = build_store(tmp_path, shape, seed)
    try:
        compare_random_reads(
            srv, shape, np.random.default_rng(seed * 1000 + batch + budget),
            monkeypatch)
    finally:
        srv.close()


@pytest.mark.parametrize("budget", [7, 100, 0])
@pytest.mark.parametrize("shape,seed", [("l0", 1), ("l1", 4)])
def test_small_overlay_chunks_cut_blocks_without_changing_the_page(
        tmp_path, flags, monkeypatch, shape, seed, budget):
    """Overlay rows pulled two at a time: every block that holds more
    overlay rows is cut after each chunk's last key."""
    FLAGS.set("pegasus.server", "rocksdb_max_iteration_count", budget,
              force=True)
    monkeypatch.setattr(PartitionServer, "OVERLAY_CHUNK", 2)
    srv = build_store(tmp_path, shape, seed)
    try:
        compare_random_reads(srv, shape,
                             np.random.default_rng(seed * 7 + budget),
                             monkeypatch)
    finally:
        srv.close()


def add_large_memtable(srv, layout: str, rows: int = 3000) -> None:
    """`rows` memtable rows over the store: new keys spread over every
    hash key, or dense between two adjacent base keys (inside one
    block); a quarter are deletes, a share expire."""
    rng = np.random.default_rng(rows)
    lsm = srv.engine.lsm
    for i in range(rows):
        if layout == "dense":
            key = generate_key(HASHKEYS[7], b"s05~%05d" % i)
        else:
            key = generate_key(HASHKEYS[i % len(HASHKEYS)],
                               b"s%02d~%04d" % (i % len(SORTKEYS), i))
        if rng.random() < 0.25:
            lsm.delete(key)
        else:
            ets = _ets(rng)
            lsm.put(key, _value(rng, b"mem", ets), ets)


@pytest.mark.parametrize("budget", [100, 0])
@pytest.mark.parametrize("layout", ["spread", "dense"])
def test_a_page_over_a_large_memtable_evaluates_what_it_examines(
        tmp_path, flags, monkeypatch, layout, budget):
    """A table-wide read (stop None) paged over an L0 table under 3,000
    memtable rows: every page equals the heap merge's, and a page pulls
    and evaluates the overlay rows it examines, its tombstones, and at
    most one chunk more, not the memtable to the end of the range."""
    FLAGS.set("pegasus.server", "rocksdb_max_iteration_count", budget,
              force=True)
    srv = build_store(tmp_path, "l0", 1)
    add_large_memtable(srv, layout)
    evaluated = []
    real = srv._overlay_rows

    def counting(overlay, *a):
        rows = real(overlay, *a)
        evaluated.append((len(rows), rows.count(None)))
        return rows

    monkeypatch.setattr(srv, "_overlay_rows", counting)
    try:
        start, pages = b"", 0
        while True:
            args = dict(start=start, stop=None, hash_filter=(0, b""),
                        sort_filter=(0, b""), validate=False,
                        max_records=50, max_bytes=-1, with_values=True,
                        value_filter=None)
            evaluated.clear()
            got = scan(srv, args, merge=False, monkeypatch=monkeypatch)
            rows = sum(n for n, _t in evaluated)
            tombstones = sum(t for _n, t in evaluated)
            assert rows - tombstones <= got[2] + srv.OVERLAY_CHUNK
            assert got == scan(srv, args, merge=True,
                               monkeypatch=monkeypatch)
            pages += 1
            (_records, exhausted, resume_key) = got[0]
            if exhausted:
                break
            start = resume_key
        assert pages > 5
    finally:
        srv.close()


@pytest.mark.parametrize("shape,seed", [("l0", 1), ("l1", 3)])
def test_the_split_gate_keeps_nothing_and_counts_the_expired(
        tmp_path, flags, monkeypatch, shape, seed):
    FLAGS.set("pegasus.server", "rocksdb_max_iteration_count", 100,
              force=True)
    srv = build_store(tmp_path, shape, seed)
    try:
        srv.partition_version = 0  # pidx 1 > 0: the reject-all gate
        rng = np.random.default_rng(seed)
        expired = 0
        for _ in range(20):
            args = dict(random_args(rng), validate=True)
            got = scan(srv, args, merge=False, monkeypatch=monkeypatch)
            assert got == scan(srv, args, merge=True,
                               monkeypatch=monkeypatch)
            assert got[0][0] == []
            expired += got[1]
        assert expired > 0
    finally:
        srv.close()


def test_the_store_shape_picks_the_path(tmp_path, flags):
    """Two L0 tables, L0 over L1 and reverse reads take the heap merge;
    one L0 table and the L1 runs take the columnar scan."""
    srv = build_store(tmp_path, "l0", 1)
    lsm = srv.engine.lsm
    try:
        def paths_of(reverse=False) -> dict:
            before = dict(srv.scan_paths)
            srv._batched_scan(b"", None, NOW, FilterSpec.none(srv.device),
                              FilterSpec.none(srv.device), False,
                              RangeReadLimiter(), -1, -1, reverse=reverse)
            return {k: v - before[k] for k, v in srv.scan_paths.items()
                    if v != before[k]}

        assert paths_of() == {"columnar_overlay": 1}
        assert paths_of(reverse=True) == {"merge": 1}
        srv.engine.flush()                        # two L0 tables
        assert len(lsm.l0) == 2 and lsm.base_chain() is None
        assert paths_of() == {"merge": 1}
        srv.manual_compact(now=1)                 # the L1 runs alone
        assert paths_of() == {"columnar": 1}
        lsm.put(generate_key(b"hk001", b"new"), generate_value(1, b"n", 0))
        assert paths_of() == {"columnar_overlay": 1}
        srv.engine.flush()                        # L0 over L1
        assert lsm.l0 and lsm.l1_runs and lsm.base_chain() is None
        assert paths_of() == {"merge": 1}
    finally:
        srv.close()


def test_a_compaction_drops_the_l0_tables_cached_blocks(tmp_path, flags):
    """An L0 table's blocks enter the mask and device-block caches under
    (table path, block offset); the compaction publish that retires the
    table drops them."""
    srv = build_store(tmp_path, "l0", 2)
    try:
        l0_path = srv.engine.lsm.l0[0].path
        srv._batched_scan(b"", None, NOW, FilterSpec.none(srv.device),
                          FilterSpec.none(srv.device), False,
                          RangeReadLimiter(), -1, -1)
        cached = [k for k in srv._mask_cache if k[0][0] == l0_path]
        assert cached
        assert any(k[0] == l0_path for k in srv._device_block_cache)
        srv.manual_compact(now=1)
        assert not any(k[0][0] == l0_path for k in srv._mask_cache)
        assert not any(k[0] == l0_path for k in srv._device_block_cache)
    finally:
        srv.close()


def test_an_l0_tables_blocks_fit_the_mask_cache(tmp_path, flags,
                                                monkeypatch):
    """An L0 table of more blocks than the mask cache's floor keeps the
    static mask of every block: a second table-wide pass evaluates
    none."""
    srv = PartitionServer(str(tmp_path / "wide"), app_id=9511, pidx=1,
                          partition_count=4, device="cpu")
    srv._mask_cache_cap = 16
    keys = sorted(generate_key(hk, sk) for hk in HASHKEYS
                  for sk in SORTKEYS)

    def build(dest, meta):
        w = SSTableWriter(dest, block_capacity=1, meta=meta)
        for key in keys:
            w.add(key, generate_value(1, b"v", 0), 0)
        w.finish()

    srv.engine.lsm.ingest(build)
    n_blocks = len(srv.engine.lsm.l0[0].blocks)
    evaluated = []
    real = ps.stacked_block_eval

    def counting(blocks, *a, **kw):
        evaluated.append(len(blocks))
        return real(blocks, *a, **kw)

    monkeypatch.setattr(ps, "stacked_block_eval", counting)
    try:
        assert n_blocks > 256 + srv._mask_cache_cap
        assert srv._effective_mask_cap() >= n_blocks
        none = FilterSpec.none(srv.device)
        for _ in range(2):
            evaluated.clear()
            records, exhausted, _resume = srv._batched_scan(
                b"", None, NOW, none, none, False, RangeReadLimiter(),
                -1, -1)
            assert exhausted and len(records) == len(keys)
        assert evaluated == []
    finally:
        srv.close()
