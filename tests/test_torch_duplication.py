"""The port's duplication (server/duplication.py,
replica/duplication_cluster.py) against the JAX package's, exact, on the
CPU.

- the duplication cases of tests/test_backup_duplication.py, run on the
  port (`load_spec`);
- `TableShipper` + `ReplicaDuplicator`: the same mutations (puts with
  TTLs, multi_put, removes, a multi_remove, overwrites) on a master
  replica of each package, shipped round by round to a follower Table
  of each package: the same rounds' counts, confirmed decrees and
  progress, and followers with equal SST digests and reads;
- `ClusterDuplicator`: two SimClusters of each package on one
  `SimLoop(seed)` each (the master cluster id 1, the follower 2, "b-"
  names), `add_duplication`, writes through the master's ClusterClient
  and timer rounds until the follower confirmed: every `dup_apply_batch`
  envelope (compression mode, payload bytes, lengths, decrees) is
  byte-equal across the packages, in the same order, and so are the
  follower's answers and the masters' duplication storage.

Both packages' clocks are frozen (value_schema and write_service); the
replicas' clocks are the loop's.
"""

import hashlib
import os

import pytest

from pegasus_tpu.base import value_schema as jvs
from pegasus_tpu.client import Table as JTable
from pegasus_tpu.replica.mutation import WriteOp as JWriteOp
from pegasus_tpu.replica.replica import Replica as JReplica
from pegasus_tpu.replica.replica import ReplicaConfig as JConfig
from pegasus_tpu.runtime import SimLoop as JLoop
from pegasus_tpu.runtime import SimNetwork as JNet
from pegasus_tpu.server import duplication as jdup
from pegasus_tpu.server import types as jtypes
from pegasus_tpu.server import write_service as jws
from pegasus_tpu.storage import block_codec as jcodec
from pegasus_tpu.tools.cluster import SimCluster as JCluster
from pegasus_tpu_torch.base import value_schema as tvs
from pegasus_tpu_torch.base.key_schema import generate_key
from pegasus_tpu_torch.client import Table as TTable
from pegasus_tpu_torch.replica.mutation import WriteOp as TWriteOp
from pegasus_tpu_torch.replica.replica import Replica as TReplica
from pegasus_tpu_torch.replica.replica import ReplicaConfig as TConfig
from pegasus_tpu_torch.rpc.codec import (
    OP_MULTI_PUT,
    OP_MULTI_REMOVE,
    OP_PUT,
    OP_REMOVE,
)
from pegasus_tpu_torch.runtime import SimLoop as TLoop
from pegasus_tpu_torch.runtime import SimNetwork as TNet
from pegasus_tpu_torch.server import duplication as tdup
from pegasus_tpu_torch.server import types as ttypes
from pegasus_tpu_torch.server import write_service as tws
from pegasus_tpu_torch.storage import block_codec as tcodec
from pegasus_tpu_torch.tools.cluster import SimCluster as TCluster
from torch_mesh_helpers import Clock, T0, load_spec, restore_process_state

SPEC_DUP = load_spec(
    "test_backup_duplication.py", globals(), "dup_spec",
    keep=lambda name: "duplication" in name
    or name == "test_restarted_primary_timestamps_stay_monotonic")

PKGS = {
    "jax": dict(Replica=JReplica, Config=JConfig, WriteOp=JWriteOp,
                Loop=JLoop, Net=JNet, dup=jdup, types=jtypes, Table=JTable,
                Cluster=JCluster, kw={}),
    "port": dict(Replica=TReplica, Config=TConfig, WriteOp=TWriteOp,
                 Loop=TLoop, Net=TNet, dup=tdup, types=ttypes, Table=TTable,
                 Cluster=TCluster, kw={"device": "cpu"}),
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


def test_payload_codec_is_byte_equal():
    """deflate_payload / inflate_payload: the same mode and bytes for an
    incompressible and a compressible payload, each inflated by the
    other package."""
    rnd = hashlib.sha256(b"seed").digest() * 64
    for data in (rnd[:1500], b"field0=" * 4000, b""):
        jm, jb = jcodec.deflate_payload(data)
        tm, tb = tcodec.deflate_payload(data)
        assert (jm, bytes(jb)) == (tm, bytes(tb))
        assert tcodec.inflate_payload(jm, jb, len(data)) == data
        assert jcodec.inflate_payload(tm, tb, len(data)) == data
    assert tcodec.PAYLOAD_RAW == jcodec.PAYLOAD_RAW
    with pytest.raises(ValueError):
        tcodec.inflate_payload(9, b"", 0)


def mutations(p) -> list:
    """One list of client writes a round."""
    t = p["types"]
    w = p["WriteOp"]
    k = generate_key
    r1 = [[w(OP_PUT, (k(b"user_%d" % i, b"s"), b"v%d" % i,
                      0 if i % 3 else 90))] for i in range(12)]
    r2 = [[w(OP_MULTI_PUT, t.MultiPutRequest(
        b"cart", [t.KeyValue(b"a", b"1"), t.KeyValue(b"b", b"2"),
                  t.KeyValue(b"c", b"3")]))],
          [w(OP_REMOVE, (k(b"user_3", b"s"),))],
          [w(OP_PUT, (k(b"user_4", b"s"), b"overwritten", 0))]]
    r3 = [[w(OP_MULTI_REMOVE, t.MultiRemoveRequest(b"cart", [b"b"]))],
          [w(OP_PUT, (k(b"", b"empty-hk"), b"e", 0))]]
    return [r1, r2, r3]


def sst_state(table) -> list:
    out = []
    for srv in table.all_partitions():
        srv.engine.flush()
        d = os.path.join(srv.engine.data_dir, "sst")
        out.append({n: hashlib.sha256(open(os.path.join(d, n), "rb")
                                      .read()).hexdigest()
                    for n in sorted(os.listdir(d)) if n.endswith(".sst")})
    return out


def test_table_shipper_leaves_equal_followers(tmp_path, frozen):
    out = []
    for pkg in ("jax", "port"):
        p = PKGS[pkg]
        loop = p["Loop"](seed=5)
        net = p["Net"](loop)
        master = p["Replica"]("m1", str(tmp_path / pkg / "m1"), net,
                              clock=lambda: T0 + loop.now, **p["kw"])
        net.register("m1", master.on_message)
        master.assign_config(p["Config"](1, "m1", []))
        follower = p["Table"](str(tmp_path / pkg / "f"), partition_count=4,
                              **p["kw"])
        progress = []
        dup = p["dup"].ReplicaDuplicator(
            master, p["dup"].TableShipper(follower, source_cluster_id=1),
            on_progress=lambda d, c: progress.append((d, c)))
        rounds = []
        try:
            for batch in mutations(p):
                for ops in batch:
                    master.client_write(ops)
                loop.run_until_idle()
                loop.run_for(0.5)
                rounds.append((dup.sync_round(), dup.confirmed_decree))
            rounds.append((dup.sync_round(), dup.confirmed_decree))
            reads = [srv.on_get(generate_key(hk, sk))
                     for hk, sk in [(b"user_%d" % i, b"s") for i in range(12)]
                     + [(b"cart", b"a"), (b"cart", b"b"), (b"cart", b"c"),
                        (b"", b"empty-hk")]
                     for srv in follower.all_partitions()]
            out.append((rounds, progress, reads, sst_state(follower)))
        finally:
            master.close()
            follower.close()
    assert out[0] == out[1]
    assert out[1][0][-1] == (0, 17)


def two_clusters(p, tmp_path, seed):
    loop = p["Loop"](seed=seed)
    net = p["Net"](loop)
    kw = p["kw"]
    a = p["Cluster"](str(tmp_path / "A"), n_nodes=2, name_prefix="a-",
                     loop=loop, net=net, cluster_id=1, **kw)
    b = p["Cluster"](str(tmp_path / "B"), n_nodes=2, name_prefix="b-",
                     loop=loop, net=net, cluster_id=2, **kw)
    return a, b


def envelope_run(pkg: str, tmp_path, seed: int) -> dict:
    p = PKGS[pkg]
    a, b = two_clusters(p, tmp_path / pkg, seed)
    sent = []
    send = a.net.send

    def spy(src, dst, mt, payload, *args, **kw):
        if mt == "dup_apply_batch":
            sent.append((src, dst, payload["gpid"], payload["blob_mode"],
                         bytes(payload["ops_blob"]), payload["raw_len"],
                         payload["n_ops"], payload.get("max_decree")))
        return send(src, dst, mt, payload, *args, **kw)

    a.net.send = spy
    try:
        for _ in range(2):
            a.step()
            b.step(advance=False)
        a.create_table("t", partition_count=2, replica_count=2)
        b.create_table("t", partition_count=2, replica_count=2)
        dupid = a.meta.duplication.add_duplication("t", "b-meta", "t")
        ca = a.client("t")
        acks = []
        for rnd in range(3):
            for i in range(25):
                acks.append(ca.set(b"k%03d" % i, b"s",
                                   b"field0=%064d" % (rnd * 100 + i)))
            acks.append(ca.multi_set(b"mh%d" % rnd,
                                     {b"a": b"1", b"b": b"2" * 300}))
            acks.append(ca.delete(b"k%03d" % rnd, b"s"))
            a.step()
            b.step(advance=False)
        for _ in range(8):
            a.step()
            b.step(advance=False)
        cb = b.client("t")
        reads = [cb.get(b"k%03d" % i, b"s") for i in range(25)]
        reads += [cb.multi_get(b"mh%d" % r) for r in range(3)]
        progress = dict(a.meta.duplication._dups[dupid]["progress"])
        return {"acks": acks, "envelopes": sent, "reads": reads,
                "progress": progress, "now": a.loop.now}
    finally:
        a.net.send = send
        a.close()
        b.close()


@pytest.mark.parametrize("seed", [3, 11])
def test_cluster_duplicator_envelopes_are_byte_equal(tmp_path, frozen, seed):
    j = envelope_run("jax", tmp_path, seed)
    t = envelope_run("port", tmp_path, seed)
    assert len(j["envelopes"]) == len(t["envelopes"]) > 0
    for x, y in zip(j["envelopes"], t["envelopes"]):
        assert x == y
    assert j == t
    assert all(a == 0 for a in t["acks"])
    assert t["reads"][2][0] == 1   # deleted in the last round
    assert t["reads"][5] == (0, b"field0=%064d" % 205)
    modes = {e[3] for e in t["envelopes"]}
    assert modes & {tcodec.PAYLOAD_ZLIB, tcodec.PAYLOAD_ZSTD}
