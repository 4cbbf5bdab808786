"""The port's cold backup and bulk load (server/backup.py,
server/bulk_load.py) against the JAX package's, exact, on the CPU.

- the cases of tests/test_bulk_load.py and the backup cases of
  tests/test_backup_duplication.py (block service, backup / restore,
  history GC, the scheduler), run on the port (`load_spec`: the JAX
  package's test text with its imports rewritten and every engine,
  table and restore asking for the CPU);
- under frozen clocks (both packages' `value_schema` and
  `write_service`), the same writes backed up by both packages leave
  byte-equal block-service trees: SST files, manifests, each
  partition's meta.json, the MD5 sidecars and backup_metadata.json;
- restoring a tree gives the same SST digests and answers in both
  packages, a tree written by the JAX package restored by the port
  included;
- SSTGenerator on the same records stages byte-equal SSTs and
  BULK_LOAD_INFO, and BulkLoader ingests them into both packages'
  tables with the same digests and counts.
"""

import hashlib
import json
import os
import time

import pytest

from pegasus_tpu.base import value_schema as jvs
from pegasus_tpu.client import Table as JTable
from pegasus_tpu.server import backup as jbackup
from pegasus_tpu.server import bulk_load as jbulk
from pegasus_tpu.server import write_service as jws
from pegasus_tpu.server.partition_server import PartitionServer as JServer
from pegasus_tpu.storage import block_service as jbs
from pegasus_tpu.storage import engine as jeng
from pegasus_tpu_torch.base import value_schema as tvs
from pegasus_tpu_torch.base.key_schema import generate_key
from pegasus_tpu_torch.client import Table as TTable
from pegasus_tpu_torch.server import backup as tbackup
from pegasus_tpu_torch.server import bulk_load as tbulk
from pegasus_tpu_torch.server import write_service as tws
from pegasus_tpu_torch.server.partition_server import PartitionServer \
    as TServer
from pegasus_tpu_torch.storage import block_service as tbs
from pegasus_tpu_torch.storage import engine as teng
from pegasus_tpu_torch.storage.wal import OP_DEL, OP_PUT
from torch_mesh_helpers import Clock, T0, load_spec, restore_process_state

SPEC_BULK = load_spec("test_bulk_load.py", globals(), "bulk_load_spec")
SPEC_BACKUP = load_spec(
    "test_backup_duplication.py", globals(), "backup_spec",
    keep=lambda name: "duplication" not in name
    and name != "test_restarted_primary_timestamps_stay_monotonic")

PKGS = {
    "jax": dict(eng=jeng, backup=jbackup, bulk=jbulk, bs=jbs, Table=JTable,
                Server=JServer, kw={}),
    "port": dict(eng=teng, backup=tbackup, bulk=tbulk, bs=tbs, Table=TTable,
                 Server=TServer, kw={"device": "cpu"}),
}


@pytest.fixture(autouse=True)
def _isolated():
    with restore_process_state():
        yield


@pytest.fixture
def frozen(monkeypatch):
    clk = Clock(T0)
    for mod in (jvs, tvs, jws, tws):
        monkeypatch.setattr(mod, "time", clk)
    return clk


def tree(root) -> dict:
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def sst_digests(sst_dir) -> dict:
    out = {}
    for name in sorted(os.listdir(sst_dir)):
        if name.endswith(".sst") or name == "MANIFEST.json":
            with open(os.path.join(sst_dir, name), "rb") as f:
                out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def items(eng_mod, n: int, now: int) -> list:
    """Puts with and without a TTL, overwrites and deletes."""
    from pegasus_tpu_torch.base.value_schema import generate_value

    out = []
    for i in range(n):
        ets = now + 3600 if i % 7 == 0 else (now - 5 if i % 11 == 0 else 0)
        out.append(eng_mod.WriteBatchItem(
            OP_PUT, generate_key(b"h%03d" % (i % 37), b"s%03d" % i),
            generate_value(1, b"v%d" % i, ets), ets))
    for i in range(0, n, 9):
        out.append(eng_mod.WriteBatchItem(
            OP_DEL, generate_key(b"h%03d" % (i % 37), b"s%03d" % i)))
    return out


def write_partition(pkg: str, root, mode: str):
    """One partition in `mode`: "flushed" (an engine, two batches),
    "compacted" (the same, manual_compact after), "server" (a
    PartitionServer's puts and removes, with TTLs). Returns (backup
    argument dict, closer)."""
    p = PKGS[pkg]
    now = tvs.epoch_now()
    if mode == "server":
        srv = p["Server"](str(root), app_id=3, pidx=1, partition_count=4,
                          **p["kw"])
        for i in range(300):
            srv.on_put(generate_key(b"u%02d" % (i % 29), b"s%03d" % i),
                       b"value-%d" % i, 600 if i % 5 == 0 else 0)
        for i in range(0, 300, 13):
            srv.on_remove(generate_key(b"u%02d" % (i % 29), b"s%03d" % i))
        return {"engine": srv.engine, "server": srv}, srv.close
    eng = p["eng"].StorageEngine(str(root), **p["kw"])
    batch = items(p["eng"], 400, now)
    eng.write_batch(batch[:250], decree=1)
    eng.write_batch(batch[250:], decree=2)
    if mode == "compacted":
        eng.manual_compact()
    return {"engine": eng}, eng.close


@pytest.mark.parametrize("mode", ["flushed", "compacted", "server"])
def test_backup_trees_are_byte_equal(tmp_path, frozen, mode):
    trees = []
    for pkg in ("jax", "port"):
        p = PKGS[pkg]
        arg, close = write_partition(pkg, tmp_path / pkg / "data", mode)
        try:
            be = p["backup"].BackupEngine(
                p["bs"].LocalBlockService(str(tmp_path / pkg / "bs")),
                "daily")
            decree = be.backup_partition(backup_id=100, app_id=3, pidx=1,
                                         **arg)
            be.finish_backup(100, 3, "t", 4)
            assert be.list_backups() == [100]
        finally:
            close()
        trees.append((decree, tree(tmp_path / pkg / "bs")))
    assert trees[0][0] == trees[1][0] > 0
    assert trees[0][1].keys() == trees[1][1].keys()
    for name in trees[0][1]:
        assert trees[0][1][name] == trees[1][1][name], name
    meta = json.loads(trees[1][1]["daily/100/3/1/meta.json"])
    assert meta["files"] and meta["decree"] == trees[1][0]
    assert any(n.endswith(".sst") for n in meta["files"])
    assert json.loads(trees[1][1]["daily/100/backup_metadata.json"])[
        "complete"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_restore_gives_equal_digests(tmp_path, frozen, writer):
    """One package's backup tree restored by both: the same SST files and
    manifest, the same decree, the same answers; then a write continues
    after the restored watermark in both."""
    p = PKGS[writer]
    arg, close = write_partition(writer, tmp_path / "src", "compacted")
    root = tmp_path / "bs"
    try:
        be = p["backup"].BackupEngine(p["bs"].LocalBlockService(str(root)),
                                      "daily")
        be.backup_partition(backup_id=7, app_id=3, pidx=1, **arg)
        be.finish_backup(7, 3, "t", 4)
    finally:
        close()
    out = []
    for pkg in ("jax", "port"):
        q = PKGS[pkg]
        be = q["backup"].BackupEngine(q["bs"].LocalBlockService(str(root)),
                                      "daily")
        dest = tmp_path / f"restored-{pkg}"
        eng = be.restore_partition(7, 3, 1, str(dest), **q["kw"])
        try:
            reads = [eng.get(generate_key(b"h%03d" % (i % 37), b"s%03d" % i))
                     for i in range(400)]
            decree = eng.last_committed_decree
            eng.write_batch([q["eng"].WriteBatchItem(
                OP_PUT, generate_key(b"new", b"k"), b"\x00" * 13, 0)],
                decree=decree + 1)
            got = eng.get(generate_key(b"new", b"k"))
        finally:
            eng.close()
        out.append((sst_digests(dest / "sst"), decree,
                    [None if r is None else (bytes(r[0]), r[1])
                     for r in reads], got is not None))
    assert out[0] == out[1]
    assert out[1][1] == 2 and out[1][3]
    assert sum(r is not None for r in out[1][2]) > 200


def records(n: int, now: int) -> list:
    """(hash_key, sort_key, value, expire_ts), duplicates (the last wins),
    empty hashkeys and TTLs included."""
    out = []
    for i in range(n):
        hk = b"" if i % 17 == 0 else b"user%04d" % (i % 211)
        out.append((hk, b"s%03d" % (i % 13), b"field0=%064d" % i,
                    now + 60 if i % 10 == 3 else 0))
    return out


@pytest.mark.parametrize("partitions,data_version", [(8, 1), (3, 1),
                                                     (4, 0)])
def test_sst_generator_stages_byte_equal_trees(tmp_path, frozen,
                                               partitions, data_version):
    recs = records(2500, tvs.epoch_now())
    trees, counts = [], []
    for pkg in ("jax", "port"):
        p = PKGS[pkg]
        root = tmp_path / pkg
        counts.append(p["bulk"].SSTGenerator(
            p["bs"].LocalBlockService(str(root)), "imports", partitions,
            data_version=data_version).generate(recs))
        trees.append(tree(root))
    assert counts[0] == counts[1]
    assert sum(counts[1].values()) < len(recs)   # duplicates collapsed
    assert trees[0] == trees[1]
    info = json.loads(trees[1][f"imports/{tbulk.BULK_LOAD_INFO}"])
    assert info == {"app_name": "imports", "partition_count": partitions,
                    "data_version": data_version}
    assert sum(n.endswith(tbulk.BULK_LOAD_FILE) for n in trees[1]) == len(
        counts[1])


def test_bulk_loader_ingests_the_same_into_both_tables(tmp_path, frozen):
    """A JAX-staged tree loaded by both packages' BulkLoader into a table
    holding earlier writes: the same records ingested, the same SST
    digests in every partition, the same reads."""
    recs = records(1500, tvs.epoch_now())
    root = tmp_path / "staged"
    jbulk.SSTGenerator(jbs.LocalBlockService(str(root)), "imports",
                       4).generate(recs)
    out = []
    for pkg in ("jax", "port"):
        p = PKGS[pkg]
        t = p["Table"](str(tmp_path / pkg), app_name="imports",
                       partition_count=4, **p["kw"])
        try:
            from pegasus_tpu_torch.base.key_schema import partition_index

            for i in range(40):
                hk = b"user%04d" % i
                srv = t.partitions[partition_index(hk, 4, b"early")]
                srv.on_put(generate_key(hk, b"early"), b"e%d" % i)
            n = p["bulk"].BulkLoader(p["bs"].LocalBlockService(
                str(root))).load_into(t)
            digests = [sst_digests(os.path.join(str(tmp_path / pkg),
                                                name, "sst"))
                       for name in sorted(os.listdir(tmp_path / pkg))
                       if os.path.isdir(os.path.join(str(tmp_path / pkg),
                                                     name, "sst"))]
            reads = [t.partitions[partition_index(hk, 4, sk)].on_get(
                generate_key(hk, sk)) for hk, sk, _v, _e in recs[:300]]
            out.append((n, digests, reads))
        finally:
            t.close()
    assert out[0][0] == out[1][0] > 0
    assert out[0][1] == out[1][1] and len(out[1][1]) == 4
    assert out[0][2] == out[1][2]


def test_clock_is_frozen_in_both_packages(frozen):
    """The fixture's clock reaches both packages' epoch."""
    assert jvs.epoch_now() == tvs.epoch_now()
    frozen.t += 10
    assert jvs.epoch_now() == tvs.epoch_now()
    assert abs(time.time() - T0) > 1


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_duplicate_ingest_ack_is_dropped(tmp_path, pkg):
    """A re-ack of a partition no longer in flight (an ingested primary
    answers every re-sent trigger_ingest) leaves the port's bulk load as
    it was and sends nothing; the JAX meta drives its window again and
    re-sends a trigger to every partition in flight, which is what lets
    re-acks multiply on a meta that lags behind its inbox (ROADMAP §3).
    Both loads still complete."""
    from pegasus_tpu.tools.cluster import SimCluster as JCluster
    from pegasus_tpu_torch.tools.cluster import SimCluster as TCluster

    Cluster, bulk, kw = ((JCluster, jbulk, {}) if pkg == "jax" else
                         (TCluster, tbulk, {"device": "cpu"}))
    bs = (jbs if pkg == "jax" else tbs).LocalBlockService(
        str(tmp_path / "stage"))
    c = Cluster(str(tmp_path / "c"), n_nodes=3, **kw)
    try:
        app_id = c.create_table("t", partition_count=4, replica_count=3)
        bulk.SSTGenerator(bs, "t", 4).generate(
            [(b"k%02d" % i, b"s", b"v%d" % i, 0) for i in range(40)])
        svc = c.meta.bulk_load
        svc.start_bulk_load("t", str(tmp_path / "stage"))
        assert svc._loads[app_id]["inflight"] == [0, 1]
        sent = []
        send = c.meta.net.send
        c.meta.net.send = lambda src, dst, mt, p, *a, **k: (
            sent.append(mt), send(src, dst, mt, p, *a, **k))
        before = json.dumps(svc._loads, sort_keys=True)
        svc.on_ingest_done({"gpid": (app_id, 3), "err": 0})
        c.meta.net.send = send
        if pkg == "port":
            assert sent == []
            assert json.dumps(svc._loads, sort_keys=True) == before
        else:
            assert sent == ["trigger_ingest", "trigger_ingest"]
        for _ in range(20):
            c.step()
            if svc.bulk_load_status("t")["complete"]:
                break
        assert svc.bulk_load_status("t")["complete"]
        assert c.client("t").get(b"k07", b"s") == (0, b"v7")
    finally:
        c.close()
