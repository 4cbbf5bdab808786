"""The port's SimCluster and ClusterClient (tools/cluster.py,
client/cluster_client.py) and the meta's backup, bulk-load and
duplication services against the JAX package's, exact, on the CPU.

- the cases of tests/test_cluster_client.py, tests/test_meta_operations.py,
  tests/test_meta_admin.py, tests/test_cross_cluster_dup.py (all but its
  onebox case, which needs the onebox of slice 6(c)) and
  tests/test_remote_block_service.py, run on the port (`load_spec`: the
  JAX package's test text with its imports rewritten and every
  SimCluster, table and engine asking for the CPU);
- a differential run: a JAX SimCluster and a port SimCluster, each under
  `SimLoop(seed)`, play one script through the ClusterClient API (solo,
  multi and atomic writes, reads, TTLs, batch_get, scan_multi, scanners,
  pushdown aggregates), then the meta's bulk load (staged by each
  package's SSTGenerator, paused and restarted), a backup to a
  BlobServer through remote:// and a restore into a new table, a policy
  and the admin verbs, and a duplication to a second cluster on the
  same loop; after every step the partition configs, the meta storage
  (with the run's directory masked) and every reply are equal, scan
  pages as wire frames.

Both metas' storage is seeded with a dropped table at app 9120, so the
tables are 9121 and up and no JAX test's app entities move. Both
packages' wall clocks are frozen (value_schema, write_service and the
backup service's backup ids).
"""

import json
import os

import pytest

from pegasus_tpu.base import value_schema as jvs
from pegasus_tpu.meta import backup_service as jbksvc
from pegasus_tpu.rpc import message as jmsg
from pegasus_tpu.server import bulk_load as jbulk
from pegasus_tpu.server import types as jtypes
from pegasus_tpu.server import write_service as jws
from pegasus_tpu.storage import blob_server as jblob
from pegasus_tpu.storage import block_service as jbs
from pegasus_tpu.tools.cluster import SimCluster as JCluster
from pegasus_tpu_torch.base import value_schema as tvs
from pegasus_tpu_torch.meta import backup_service as tbksvc
from pegasus_tpu_torch.rpc import message as tmsg
from pegasus_tpu_torch.server import bulk_load as tbulk
from pegasus_tpu_torch.server import types as ttypes
from pegasus_tpu_torch.server import write_service as tws
from pegasus_tpu_torch.storage import blob_server as tblob
from pegasus_tpu_torch.storage import block_service as tbs
from pegasus_tpu_torch.tools.cluster import SimCluster as TCluster
from torch_mesh_helpers import Clock, T0, load_spec, restore_process_state

SPEC = (load_spec("test_cluster_client.py", globals(), "client_spec")
        + load_spec("test_meta_operations.py", globals(), "meta_ops_spec")
        + load_spec("test_meta_admin.py", globals(), "meta_admin_spec")
        + load_spec("test_cross_cluster_dup.py", globals(), "xdup_spec",
                    keep=lambda name: "onebox" not in name)
        + load_spec("test_remote_block_service.py", globals(),
                    "remote_spec"))

SEED_APP = 9120

PKGS = {
    "jax": dict(Cluster=JCluster, types=jtypes, msg=jmsg, bulk=jbulk,
                bs=jbs, blob=jblob, kw={}),
    "port": dict(Cluster=TCluster, types=ttypes, msg=tmsg, bulk=tbulk,
                 bs=tbs, blob=tblob, kw={"device": "cpu"}),
}


@pytest.fixture(autouse=True)
def _isolated():
    with restore_process_state():
        yield


@pytest.fixture
def frozen(monkeypatch):
    clk = Clock(T0)
    for mod in (jvs, tvs, jws, tws, jbksvc, tbksvc):
        monkeypatch.setattr(mod, "time", clk)
    return clk


def test_specs_run_on_the_port():
    """Every spec case above was taken, and its module imports the port
    only."""
    assert len(SPEC) == 9 + 15 + 12 + 11 + 2
    for name in SPEC:
        fn = globals()[name]
        mods = {v.__name__ for v in fn.__globals__.values()
                if type(v).__name__ == "module"}
        assert not any(m == "pegasus_tpu" or m.startswith("pegasus_tpu.")
                       for m in mods), (name, mods)


def seed_meta_storage(meta_dir: str) -> None:
    os.makedirs(meta_dir, exist_ok=True)
    with open(os.path.join(meta_dir, "meta.json"), "w") as f:
        json.dump({f"/apps/{SEED_APP}": {
            "app_id": SEED_APP, "app_name": "__seed", "partition_count": 0,
            "status": "dropped", "envs": {}, "max_replica_count": 3}}, f)


class Recorder:
    """The configs, the meta storage (the run's directory and the blob
    server's port masked) and the replies after each step."""

    def __init__(self, p, clusters, root, port_box):
        self.p = p
        self.clusters = clusters
        self.root = str(root)
        self.port_box = port_box
        self.steps = []

    def wire(self, obj) -> bytes:
        return self.p["msg"].encode_message("a", "b", "t", obj)

    def norm(self, value):
        if isinstance(value, (list, tuple)):
            return type(value)(self.norm(v) for v in value)
        if isinstance(value, dict):
            return {k: self.norm(v) for k, v in value.items()}
        if type(value).__module__.endswith("server.types"):
            return self.wire(value)
        return value

    def mask(self, text: str) -> str:
        text = text.replace(self.root, "<root>")
        if self.port_box:
            text = text.replace(f":{self.port_box[0]}", ":<port>")
        return text

    def step(self, name: str, *replies) -> None:
        state = []
        for c in self.clusters:
            meta = c.meta
            cfgs = []
            for app_id in sorted(meta.state.apps):
                app = meta.state.apps[app_id]
                cfgs.append((app_id, app.app_name, app.status,
                             [meta.state.get_partition(app_id, i).to_json()
                              for i in range(app.partition_count)]))
            state.append((cfgs, self.mask(json.dumps(meta.storage._tree,
                                                     sort_keys=True))))
        self.steps.append((name, c.loop.now, state,
                           self.mask(repr(self.norm(list(replies))))))


def scan_requests(types, n: int) -> dict:
    from pegasus_tpu_torch.base.key_schema import generate_key

    out = {}
    for i in range(n):
        out.setdefault(i % 4, []).append(types.GetScannerRequest(
            start_key=generate_key(b"u%03d" % (7 * i % 60), b""),
            batch_size=1 + (13 * i) % 30, validate_partition_hash=True,
            one_page=True))
    return out


def run_until(c, done, rounds=60, other=None) -> int:
    for n in range(rounds):
        if done():
            return n
        c.step()
        if other is not None:
            other.step(advance=False)
    raise AssertionError("not done")


def cluster_script(pkg: str, root, seed: int) -> list:
    p = PKGS[pkg]
    seed_meta_storage(str(root / "A" / "meta"))
    seed_meta_storage(str(root / "B" / "b-meta"))
    a = p["Cluster"](str(root / "A"), n_nodes=3, seed=seed, **p["kw"])
    b = p["Cluster"](str(root / "B"), n_nodes=3, name_prefix="b-",
                     loop=a.loop, net=a.net, cluster_id=2, **p["kw"])
    blob = p["blob"].BlobServer(str(root / "blobs"), host="127.0.0.1",
                                port=0)
    port_box = [blob.port]
    rec = Recorder(p, (a, b), root, port_box)
    try:
        app = a.create_table("t", partition_count=4, replica_count=3)
        assert app == SEED_APP + 1
        cl = a.client("t")
        acks = [cl.set(b"u%03d" % i, b"s%d" % (i % 3), b"v%d" % i,
                       ttl_seconds=600 if i % 5 == 0 else 0)
                for i in range(60)]
        acks += [cl.multi_set(b"mh", {b"a": b"1", b"b": b"2", b"c": b"3"}),
                 cl.delete(b"u001", b"s1"), cl.multi_del(b"mh", [b"c"]),
                 cl.incr(b"cnt", b"c", 5), cl.incr(b"cnt", b"c", -2),
                 cl.check_and_set(b"mh", b"a", 4, b"1", b"b", b"22")]
        rec.step("writes", acks)
        reads = [cl.get(b"u%03d" % i, b"s%d" % (i % 3)) for i in range(60)]
        reads += [cl.multi_get(b"mh"), cl.sortkey_count(b"mh"),
                  cl.ttl(b"u005", b"s2"), cl.exist(b"u001", b"s1"),
                  cl.batch_get([(b"u%03d" % i, b"s%d" % (i % 3))
                                for i in range(0, 60, 4)]),
                  cl.multi_get_sortkeys(b"mh")]
        rec.step("reads", reads)
        scans = cl.scan_multi(scan_requests(p["types"], 24))
        sc = cl.get_scanner(b"mh")
        rows = []
        while True:
            r = sc.next_record()
            if r is None or r[0] != 0:
                break
            rows.append(r)
        sc.close()
        scanners = cl.get_unordered_scanners(3)
        agg = [s.count() for s in scanners]
        rec.step("scans", scans, rows, agg)

        # bulk load, staged by this package's generator
        stage = str(root / "stage")
        recs = [(b"b%04d" % i, b"s%d" % (i % 4), b"bulk%d" % i, 0)
                for i in range(400)]
        counts = p["bulk"].SSTGenerator(p["bs"].LocalBlockService(stage),
                                        "imp", 4).generate(recs)
        a.create_table("imp", partition_count=4, replica_count=3)
        bl = a.meta.bulk_load
        bl.start_bulk_load("imp", stage)
        bl.pause_bulk_load("imp")
        paused = bl.bulk_load_status("imp")
        a.step()
        bl.restart_bulk_load("imp")
        run_until(a, lambda: bl.bulk_load_status("imp")["complete"])
        ci = a.client("imp")
        got = [ci.get(hk, sk) for hk, sk, _v, _e in recs[::9]]
        rec.step("bulk_load", counts, paused, bl.bulk_load_status("imp"),
                 got)

        # backup through remote://, a policy, then a restore
        broot = f"{blob.url}/bk"
        bk = a.meta.backup
        bk.add_policy("daily", ["t"], broot, 86400, 2)
        policies = bk.list_policies()
        backup_id = bk.start_backup("t", broot, backup_id=4242)
        run_until(a, lambda: bk.backup_status(backup_id)["complete"])
        rid = bk.create_app_from_backup("r", broot, "manual", backup_id)
        run_until(a, lambda: not a.meta.pending_restores)
        a.step()
        cr = a.client("r")
        rreads = [cr.get(b"u%03d" % i, b"s%d" % (i % 3)) for i in range(60)]
        rscans = cr.scan_multi(scan_requests(p["types"], 24))
        rec.step("backup_restore", policies, bk.query_policy("daily"),
                 bk.backup_status(backup_id), rid, rreads, rscans)

        # duplication to the second cluster
        b.create_table("t", partition_count=4, replica_count=3)
        dupid = a.meta.duplication.add_duplication("t", "b-meta", "t")
        for i in range(30):
            cl.set(b"d%03d" % i, b"s", b"dup%d" % i)
        cl.delete(b"u002", b"s2")

        def confirmed() -> bool:
            prog = a.meta.duplication._dups[dupid]["progress"]
            want = [a.stubs[a.meta.state.get_partition(app, i).primary]
                    .get_replica((app, i)).last_committed_decree
                    for i in range(4)]
            return [prog[str(i)] for i in range(4)] == want

        run_until(a, confirmed, other=b)
        cb = b.client("t")
        dreads = [cb.get(b"d%03d" % i, b"s") for i in range(30)]
        dreads.append(cb.get(b"u002", b"s2"))
        rec.step("duplication", a.meta.duplication.list_all(),
                 a.meta.duplication.query_duplication("t"), dreads)
        return rec.steps
    finally:
        blob.close()
        b.close()
        a.close()


@pytest.mark.parametrize("seed", [2, 7])
def test_cluster_matches_jax(tmp_path, frozen, seed):
    jrec = cluster_script("jax", tmp_path / "jax", seed)
    trec = cluster_script("port", tmp_path / "port", seed)
    assert [s[0] for s in jrec] == [s[0] for s in trec]
    for x, y in zip(jrec, trec):
        assert x[1] == y[1], x[0]
        assert x[2] == y[2], x[0]
        assert x[3] == y[3], x[0]
    steps = {s[0]: s for s in trec}
    assert "[0, 0, 0" in steps["writes"][3]
    assert "b'dup29'" in steps["duplication"][3]


def test_chip_smoke_phase13_runs_on_the_cpu():
    """chip_smoke.py's phase 13 at a small size on the CPU: a bulk load
    through the meta's verb (every page of the scans before the
    compaction and the survivors after it against the oracle), a backup
    through remote:// and a restore with byte-equal probe pages, a
    duplication confirmed on every partition with byte-equal pages."""
    import torch

    import chip_smoke as cs

    with cs.store_flags(cs.NONE_STORE):
        out = cs.run_services(torch.device("cpu"), n_hashkeys=1200,
                              n_scans=160, n_dup_ops=600)
    assert out["bulk"]["records"] == 12000
    assert 0 < out["bulk"]["live"] < 12000
    assert out["dup"]["shipped"] == 600 and out["dup"]["envelopes"] > 0
    assert out["backup"]["restore_s"] > 0
