"""Partition split on the port's Table, held to the JAX package's.

- the Table cases of tests/test_split.py (every one but the onebox
  shell's) on the port: data kept, stale halves hidden from scans and
  dropped by the next compaction, reopen from disk, power-of-two
  counts only, envs and data version inherited, writes after a split
  routed to the children, row/plan caches dropped at the count flip,
  concurrent writes not lost;
- a 4 -> 8 split with TTL rows and app envs, driven identically on a JAX
  and a port Table: the unordered scanners, the batched `scan_multi`
  path and every partition's `sortkey_count` answer row for row the
  same before and after the split; `manual_compact_all` after it leaves
  every partition's SST files byte-identical to the JAX package's (both
  clocks frozen, so the L1 index's compaction time stamp agrees too);
- a split that fails midway rolls back: no child left open or on disk,
  the table still answers, and a retry succeeds.
"""

import hashlib
import os
import threading
import time

import pytest

from pegasus_tpu.base import value_schema as jvs
from pegasus_tpu.client import PegasusClient as JClient
from pegasus_tpu.client import Table as JTable
from pegasus_tpu.ops import placement as jplacement
from pegasus_tpu.server import types as jtypes
from pegasus_tpu.server import write_service as jws
from pegasus_tpu.server.workload import DRIFT as JDRIFT
from pegasus_tpu.utils.flags import FLAGS as JFLAGS
from pegasus_tpu_torch.base import value_schema as tvs
from pegasus_tpu_torch.base.key_schema import generate_key, partition_index
from pegasus_tpu_torch.client import PegasusClient, ScanOptions, Table
from pegasus_tpu_torch.server import types as ttypes
from pegasus_tpu_torch.server import write_service as tws
from pegasus_tpu_torch.server.row_cache import ROW_CACHE
from pegasus_tpu_torch.storage.wal import OP_PUT
from pegasus_tpu_torch.utils.errors import StorageStatus
from pegasus_tpu_torch.utils.flags import FLAGS as TFLAGS

OK = int(StorageStatus.OK)
# app ids no other test uses: the JAX servers register process-wide
# metric entities under them
APP_ID = 9207
STORE_FLAGS = (("pegasus.storage", "block_codec", "dcz2"),
               ("pegasus.server", "bloom_bits_per_key", 10),
               ("pegasus.server", "phash_index", True))


def _table(d, count, **kw):
    return Table(d, partition_count=count, device="cpu", **kw)


@pytest.fixture
def loaded(tmp_path):
    t = _table(str(tmp_path / "t"), 4)
    c = PegasusClient(t)
    data = {}
    for i in range(120):
        hk, sk, v = b"user_%03d" % i, b"s%d" % (i % 3), b"v%d" % i
        c.multi_set(hk, {sk: v})
        data.setdefault(hk, {})[sk] = v
    yield t, c, data
    t.close()


def test_split_preserves_all_data(loaded):
    t, c, data = loaded
    t.split()
    assert t.partition_count == 8
    for hk, kvs in data.items():
        for sk, v in kvs.items():
            assert c.get(hk, sk) == (0, v), (hk, sk)
    assert len({partition_index(hk, 8) for hk in data}) > 4


def test_split_scans_exclude_stale_halves(loaded):
    t, c, data = loaded
    total_before = sum(len(kvs) for kvs in data.values())
    t.split()
    rows = [r for sc in c.get_unordered_scanners(1, ScanOptions(
        batch_size=1000)) for r in sc]
    # every record exactly once despite two physical copies existing
    assert len(rows) == total_before
    assert len({(hk, sk) for hk, sk, _v in rows}) == total_before


def _physical(t, levels=("l0", "l1", "mem")):
    n = 0
    for p in t.all_partitions():
        lsm = p.engine.lsm
        if "l0" in levels:
            n += sum(tbl.total_count for tbl in lsm.l0)
        if "l1" in levels:
            n += sum(tbl.total_count for tbl in lsm.l1_runs)
        if "mem" in levels:
            n += len(lsm.memtable)
    return n


def test_split_compaction_drops_stale_halves(loaded):
    t, c, data = loaded
    t.split()
    total = sum(len(kvs) for kvs in data.values())
    assert _physical(t) >= total
    t.manual_compact_all()
    assert _physical(t, ("l1",)) == total
    for hk, kvs in data.items():
        for sk, v in kvs.items():
            assert c.get(hk, sk) == (0, v)


def test_split_table_reopens_from_disk(tmp_path):
    t = _table(str(tmp_path / "t"), 2)
    c = PegasusClient(t)
    c.set(b"hk", b"s", b"v")
    t.split()
    t.flush_all()
    t.close()
    t2 = _table(str(tmp_path / "t"), 4)
    assert PegasusClient(t2).get(b"hk", b"s") == (0, b"v")
    t2.close()


def test_split_requires_power_of_two(tmp_path):
    t = _table(str(tmp_path / "t"), 3)
    try:
        with pytest.raises(ValueError):
            t.split()
    finally:
        t.close()


def test_split_children_inherit_envs_and_data_version(tmp_path):
    t = _table(str(tmp_path / "t"), 2, data_version=0)
    try:
        c = PegasusClient(t)
        t.update_app_envs({"default_ttl": "500"})
        c.set(b"hk", b"s", b"v0value")
        t.split()
        for p in t.all_partitions():
            assert p.app_envs.get("default_ttl") == "500"
            assert p.data_version == 0
            assert p.device.type == "cpu"
        assert c.get(b"hk", b"s") == (0, b"v0value")
    finally:
        t.close()


def test_writes_after_split_land_in_new_partitions(loaded):
    t, c, _ = loaded
    t.split()
    c.set(b"newbie_42", b"s", b"fresh")
    server = t.partitions[partition_index(b"newbie_42", 8)]
    assert server.on_get(generate_key(b"newbie_42", b"s")) == (0, b"fresh")


def test_flip_drops_row_and_plan_caches_no_stale_parent_row(tmp_path):
    t = _table(str(tmp_path / "t"), 2, app_id=APP_ID + 1)
    try:
        c = PegasusClient(t)
        keys = [b"rc%03d" % i for i in range(40)]
        for hk in keys:
            c.set(hk, b"s", b"v1-" + hk)
        t.flush_all()  # rows must be base-resolved to enter the cache
        for parent in t.all_partitions():
            ops = [("get", generate_key(hk, b"s"), None) for hk in keys
                   if partition_index(hk, 2) == parent.pidx]
            for _ in range(2):  # the repeat gate admits on the 2nd touch
                assert all(r[0] == 0
                           for r in parent.on_point_read_batch(ops))
        parent_gids = {(t.app_id, p) for p in range(2)}
        assert parent_gids & set(ROW_CACHE._gid_index)
        assert any(p._point_cache is not None for p in t.all_partitions())
        t.split()
        assert not parent_gids & set(ROW_CACHE._gid_index)
        for p in t.all_partitions():
            assert p._point_cache is None
            assert p._plan_cache is None
            assert p._live_cache == {}
        for hk in keys:
            c.set(hk, b"s", b"v2-" + hk)
        for hk in keys:
            server = t.partitions[partition_index(hk, 4)]
            res = server.on_point_read_batch(
                [("get", generate_key(hk, b"s"), None)] * 2)
            assert res == [(0, b"v2-" + hk)] * 2, hk
            assert c.get(hk, b"s") == (0, b"v2-" + hk), hk
    finally:
        t.close()


def test_split_concurrent_writes_not_lost(tmp_path):
    """split() fences writes table-wide, so every acked write is either
    in its child's copy or routed by the new count."""
    t = _table(str(tmp_path / "t"), 4)
    c = PegasusClient(t)
    acked = []
    stop = threading.Event()

    def writer():
        i = 0
        while not stop.is_set():
            hk = b"w_%05d" % i
            if c.set(hk, b"sk", b"v%d" % i) == OK:
                acked.append((hk, b"v%d" % i))
            i += 1

    th = threading.Thread(target=writer)
    th.start()
    try:
        t.split()
        t.split()  # 4 -> 8 -> 16 under fire
    finally:
        stop.set()
        th.join()
    assert t.partition_count == 16
    t.flush_all()
    t.manual_compact_all()
    for hk, v in acked:
        assert c.get(hk, b"sk") == (OK, v), hk
    assert acked
    t.close()


def test_failed_split_rolls_back(tmp_path, monkeypatch):
    t = _table(str(tmp_path / "t"), 4)
    c = PegasusClient(t)
    for i in range(80):
        c.set(b"rb%03d" % i, b"s", b"v%d" % i)
    parent = t.partitions[2]
    real = parent.engine.checkpoint
    calls = []

    def failing(dest):
        calls.append(dest)
        raise OSError("disk full")

    monkeypatch.setattr(parent.engine, "checkpoint", failing)
    with pytest.raises(OSError):
        t.split()
    assert calls
    assert t.partition_count == 4 and sorted(t.partitions) == [0, 1, 2, 3]
    assert sorted(os.listdir(str(tmp_path / "t"))) == \
        ["1.0", "1.1", "1.2", "1.3"]
    for p in t.all_partitions():
        assert p.partition_version == 3
    for i in range(80):
        assert c.get(b"rb%03d" % i, b"s") == (OK, b"v%d" % i)
    monkeypatch.setattr(parent.engine, "checkpoint", real)
    t.split()
    assert t.partition_count == 8
    for i in range(80):
        assert c.get(b"rb%03d" % i, b"s") == (OK, b"v%d" % i)
    t.close()


# ---- the split against the JAX package's --------------------------------

class Clock:
    """A module's `time` with `time()` frozen at `t`."""

    def __init__(self, t: float) -> None:
        self.t = t

    def time(self) -> float:
        return self.t

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture
def pair(tmp_path, monkeypatch):
    """(JAX Table, port Table) of 4 partitions, both clocks frozen, the
    store flags set in both registries (restored after)."""
    clk = Clock(1_790_000_000.5)
    for mod in (jvs, tvs, jws, tws):
        monkeypatch.setattr(mod, "time", clk)
    saved = [(reg, s, n, reg.get(s, n)) for reg in (JFLAGS, TFLAGS)
             for s, n, _v in STORE_FLAGS]
    for s, n, v in STORE_FLAGS:
        for reg in (JFLAGS, TFLAGS):
            reg.set(s, n, v, force=True)
    tables = (JTable(str(tmp_path / "j"), app_id=APP_ID, partition_count=4),
              _table(str(tmp_path / "t"), 4, app_id=APP_ID))
    yield tables, clk
    for t in tables:
        t.close()
    for reg, s, n, v in saved:
        reg.set(s, n, v, force=True)
    jplacement.reset_probe()
    JDRIFT.reset()


def _load(tables):
    """The same records through each package's client: 10 sortkeys a
    hashkey, one in 5 with a TTL (some expired by the time of the
    scans), one flush and a compaction among the writes."""
    for t, client in zip(tables, (JClient, PegasusClient)):
        c = client(t)
        for i in range(160):
            hk = b"acct_%04d" % i
            c.multi_set(hk, {b"f%d" % j: b"%d-%d" % (i, j)
                             for j in range(10)},
                        ttl_seconds=[0, 0, 0, 20, 5000][i % 5])
            if i == 60:
                t.manual_compact_all()
            if i == 110:
                t.flush_all()
        t.update_app_envs({"default_ttl": "9000"})


def _views(t, client, mod):
    """The unordered scanners' rows, every partition's full-range batched
    scan page (validating ownership) and each hashkey's sortkey_count."""
    c = client(t)
    rows = [list(sc) for sc in c.get_unordered_scanners(3)]
    reqs = {p: [mod.GetScannerRequest(batch_size=5000,
                                      validate_partition_hash=True)]
            for p in range(t.partition_count)}
    pages = {p: [[(kv.key, kv.value) for kv in r.kvs] for r in resps]
             for p, resps in c.scan_multi(reqs).items()}
    counts = [c.sortkey_count(b"acct_%04d" % i) for i in range(160)]
    return rows, pages, counts


def _sst_digests(t):
    """Per partition: every SST file's and the manifest's name and bytes."""
    out = []
    for p in t.all_partitions():
        sst = os.path.join(p.engine.data_dir, "sst")
        h = hashlib.sha256()
        for name in sorted(os.listdir(sst)):
            if name.endswith(".sst") or name == "MANIFEST.json":
                h.update(name.encode())
                with open(os.path.join(sst, name), "rb") as f:
                    h.update(f.read())
        out.append(h.hexdigest())
    return out


def test_split_4_to_8_matches_jax(pair):
    (jt, tt), clk = pair
    _load((jt, tt))
    clk.t += 60  # the 20 s TTLs expire
    jview = _views(jt, JClient, jtypes)
    tview = _views(tt, PegasusClient, ttypes)
    assert tview == jview
    assert sum(len(r) for r in tview[0]) == 160 * 10 - 32 * 10
    for t in (jt, tt):
        t.split()
    assert [p.partition_version for p in tt.all_partitions()] == [7] * 8
    assert all(p.app_envs["default_ttl"] == "9000"
               for p in tt.all_partitions())
    # both copies of every record are still on disk: the scan kernel's
    # ownership check (here its plain version) hides the stale half
    assert _physical(tt) > 2 * 1000
    jview2 = _views(jt, JClient, jtypes)
    tview2 = _views(tt, PegasusClient, ttypes)
    assert tview2 == jview2
    assert sorted(r for g in tview2[0] for r in g) == \
        sorted(r for g in tview[0] for r in g)
    for t in (jt, tt):
        t.manual_compact_all()
    assert _sst_digests(tt) == _sst_digests(jt)
    assert _physical(tt, ("l1",)) == 160 * 10 - 32 * 10
    assert _views(tt, PegasusClient, ttypes) == \
        _views(jt, JClient, jtypes)


# ---- checkpoint, restore and ingest (the split's copy) ------------------

def _sst_files(d):
    return {name: open(os.path.join(d, name), "rb").read()
            for name in sorted(os.listdir(d))
            if name.endswith(".sst") or name == "MANIFEST.json"}


@pytest.fixture
def engines(tmp_path, monkeypatch):
    """(JAX engine, port engine) on empty stores, both compaction clocks
    pinned and the store flags set alike (restored after)."""
    from pegasus_tpu.storage import engine as jeng
    from pegasus_tpu_torch.storage import engine as teng

    monkeypatch.setattr(jeng, "epoch_now", lambda: 334_000_000)
    monkeypatch.setattr(teng, "epoch_now", lambda: 334_000_000)
    saved = [(reg, s, n, reg.get(s, n)) for reg in (JFLAGS, TFLAGS)
             for s, n, _v in STORE_FLAGS]
    for s, n, v in STORE_FLAGS:
        for reg in (JFLAGS, TFLAGS):
            reg.set(s, n, v, force=True)
    pair = (jeng.StorageEngine(str(tmp_path / "je")),
            teng.StorageEngine(str(tmp_path / "te"), device="cpu"))
    yield pair, (jeng, teng)
    for e in pair:
        e.close()
    for reg, s, n, v in saved:
        reg.set(s, n, v, force=True)


def test_checkpoint_and_restore_match_jax(tmp_path, engines):
    """A multi-run store's checkpoint carries every run and the manifest,
    byte for byte as the JAX package's, and restores with every run."""
    from pegasus_tpu.base.value_schema import generate_value

    (je, te), mods = engines
    for e in (je, te):
        e.lsm._l1_run_capacity = 50
    for e, mod in zip((je, te), mods):
        items = [mod.WriteBatchItem(OP_PUT, b"c%04d" % i,
                                    generate_value(1, b"v%d" % i, 0), 0)
                 for i in range(160)]
        e.write_batch(items, 1)
        e.manual_compact()
        e.write_batch([mod.WriteBatchItem(OP_PUT, b"z", generate_value(
            1, b"tail", 0), 0)], 2)
    assert len(te.lsm.l1_runs) == len(je.lsm.l1_runs) > 1
    ck = [str(tmp_path / "jck"), str(tmp_path / "tck")]
    assert te.checkpoint(ck[1]) == je.checkpoint(ck[0]) == 2
    assert _sst_files(ck[1]) == _sst_files(ck[0])
    restored = [mods[0].StorageEngine.restore_from_checkpoint(
                    ck[0], str(tmp_path / "jr")),
                mods[1].StorageEngine.restore_from_checkpoint(
                    ck[1], str(tmp_path / "tr"), device="cpu")]
    try:
        assert len(restored[1].lsm.l1_runs) == len(je.lsm.l1_runs)
        assert list(restored[1].iterate()) == list(restored[0].iterate())
        assert restored[1].get(b"z") == restored[0].get(b"z")
    finally:
        for e in restored:
            e.close()


def test_ingest_matches_jax(tmp_path, engines):
    """An external SST adopted as the newest L0 run: the memtable is
    flushed first, the ingested run outranks it, the meta carries the
    ingest decree, and a stale decree is refused; the store's files are
    the JAX package's, byte for byte."""
    from pegasus_tpu.storage.sstable import SSTableWriter

    (je, te), mods = engines
    key = generate_key(b"h", b"s")
    ext = str(tmp_path / "ext.sst")
    w = SSTableWriter(ext)
    w.add(key, b"\x00\x00\x00\x00ingested")
    w.add(generate_key(b"earlier", b"s"), b"\x00\x00\x00\x00kept")
    w.finish()
    for e, mod in zip((je, te), mods):
        e.write_batch([mod.WriteBatchItem(OP_PUT, key,
                                          b"\x00\x00\x00\x00memv")],
                      decree=1)
        e.ingest_sst_file(ext, decree=2)
        assert e.get(key)[0] == b"\x00\x00\x00\x00ingested"
        assert (e.last_committed_decree, e.last_flushed_decree) == (2, 2)
        with pytest.raises(ValueError):
            e.ingest_sst_file(ext, decree=2)
    assert _sst_files(os.path.join(te.data_dir, "sst")) == \
        _sst_files(os.path.join(je.data_dir, "sst"))
    te.close()
    again = mods[1].StorageEngine(te.data_dir, device="cpu")
    try:
        assert again.last_flushed_decree == 2
        assert again.get(generate_key(b"earlier", b"s")) is not None
        assert again.get(key)[0] == b"\x00\x00\x00\x00ingested"
    finally:
        again.close()
