"""The port's meta service and replica stub (meta/, replica/stub.py) on
the CPU, and against the JAX package's, exact.

- the twelve cases of tests/test_meta.py, run on a port cluster whose
  stubs serve with `device="cpu"`;
- a differential run: a JAX cluster and a port cluster, each under
  `SimLoop(seed)`, play one script (create a table of 4 partitions x 3
  replicas on 4 nodes; solo and batched writes, solo and batched reads
  and batched scans over the network; a silenced node and the meta's
  cure, drop and recall, a meta restart); at every step the partition configs, the meta storage and
  every reply's wire bytes are equal;
- the backup, bulk-load and duplication services against the JAX
  package's: a meta store in which a JAX meta's service left state at
  each of its 7 storage keys loads in the port to the same state; each
  of 7 admin verbs gives the JAX meta's reply, storage and block-service
  tree; each of the stub's 5 service messages leaves the same replica
  state, decrees and replies; an empty-state meta ticks the same
  storage as the JAX meta's;
- the stub serves on the card unless told otherwise.

Both packages' metas have their storage seeded with a dropped table at
app id 9120, so every table these tests create is app 9121 or above and
no JAX test's app entities move. Both packages' wall clocks are frozen
(the `time` of value_schema and write_service); each stub's clock is the
SimLoop's. The metric entities and span rings a test creates are
removed after it in both packages, and both packages' TENANTS clocks,
GOVERNORs and DRIFT monitors are put back.
"""

import copy
import dataclasses
import json
import os
import time

import pytest
import torch

from pegasus_tpu.base import value_schema as jvs
from pegasus_tpu.meta import MetaService as JMeta
from pegasus_tpu.replica.stub import ReplicaStub as JStub
from pegasus_tpu.rpc import message as jmsg
from pegasus_tpu.runtime import SimLoop as JLoop
from pegasus_tpu.runtime import SimNetwork as JNet
from pegasus_tpu.server import types as jtypes
from pegasus_tpu.server import write_service as jws
from pegasus_tpu.server.tenancy import TENANTS as JTENANTS
from pegasus_tpu.server.workload import DRIFT as JDRIFT
from pegasus_tpu.storage.compact_governor import GOVERNOR as JGOVERNOR
from pegasus_tpu.utils import metrics as jmetrics
from pegasus_tpu.utils import tracing as jtracing
from pegasus_tpu_torch.base import value_schema as tvs
from pegasus_tpu_torch.base.key_schema import generate_key, key_hash_parts
from pegasus_tpu_torch.meta import MetaService
from pegasus_tpu_torch.meta.failure_detector import worker_lease_valid
from pegasus_tpu_torch.replica.mutation import WriteOp
from pegasus_tpu_torch.replica.replica import PartitionStatus
from pegasus_tpu_torch.replica.stub import ReplicaStub
from pegasus_tpu_torch.rpc import message as tmsg
from pegasus_tpu_torch.rpc.codec import OP_PUT, OP_REMOVE
from pegasus_tpu_torch.runtime import SimLoop, SimNetwork
from pegasus_tpu_torch.server import types as ttypes
from pegasus_tpu_torch.server import write_service as tws
from pegasus_tpu_torch.server.tenancy import TENANTS as TTENANTS
from pegasus_tpu_torch.server.workload import DRIFT as TDRIFT
from pegasus_tpu_torch.storage.compact_governor import GOVERNOR as TGOVERNOR
from pegasus_tpu_torch.utils import metrics as tmetrics
from pegasus_tpu_torch.utils import tracing as ttracing
from pegasus_tpu_torch.utils.errors import PegasusError

T0 = 1_790_000_000.25   # unix seconds the frozen clocks start at
CLOCK_BASE = 1_700_000_000
SEED_APP = 9120          # the dropped table every meta's storage starts with


@pytest.fixture(autouse=True)
def isolated_state():
    """Remove the metric entities a test created from both registries,
    and the span rings it created (a ring keeps its node's "tracing"
    counters); put both TENANTS clocks, both GOVERNORs and both cost-model
    DRIFT monitors back (a batched scan notes a drift sample)."""
    regs = (jmetrics.METRICS, tmetrics.METRICS)
    before = [set(reg._entities) for reg in regs]
    rings = [set(t._rings) for t in (jtracing, ttracing)]
    clocks = [t._clock for t in (JTENANTS, TTENANTS)]
    govs = [{k: v for k, v in g.__dict__.items() if k != "_lock"}
            for g in (JGOVERNOR, TGOVERNOR)]
    drifts = [(d, copy.deepcopy(d._classes), d._gauge.value())
              for d in (JDRIFT, TDRIFT)]
    yield
    for reg, keys in zip(regs, before):
        with reg._lock:
            for key in set(reg._entities) - keys:
                del reg._entities[key]
    for tracing, nodes in zip((jtracing, ttracing), rings):
        for node in set(tracing._rings) - nodes:
            tracing.drop_ring(node)
    for tenants, clock in zip((JTENANTS, TTENANTS), clocks):
        tenants.set_clock(clock)
    for gov, saved in zip((JGOVERNOR, TGOVERNOR), govs):
        gov.__dict__.update(saved)
    for drift, classes, gauge in drifts:
        with drift._lock:
            drift._classes = classes
            drift._gauge.set(gauge)


class Clock:
    """Stands in for a module's `time`: `time()` is frozen at `t`."""

    def __init__(self, t: float) -> None:
        self.t = t

    def time(self) -> float:
        return self.t

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture
def frozen(monkeypatch):
    clk = Clock(T0)
    for mod in (jvs, tvs, jws, tws):
        monkeypatch.setattr(mod, "time", clk)
    return clk


def seed_meta_storage(meta_dir: str) -> None:
    """A dropped table at SEED_APP: `ServerState.next_app_id` is
    max(apps) + 1, so the first table created is SEED_APP + 1."""
    os.makedirs(meta_dir, exist_ok=True)
    with open(os.path.join(meta_dir, "meta.json"), "w") as f:
        json.dump({f"/apps/{SEED_APP}": {
            "app_id": SEED_APP, "app_name": "__seed", "partition_count": 0,
            "status": "dropped", "envs": {}, "max_replica_count": 3}}, f)


@dataclasses.dataclass
class Pkg:
    name: str
    Meta: type
    Stub: type
    Loop: type
    Net: type
    types: object
    msg: object

    def stub(self, name, path, net, clock):
        kw = {} if self.name == "jax" else {"device": "cpu"}
        return self.Stub(name, str(path), net, clock=clock, **kw)

    def wire(self, obj) -> bytes:
        return self.msg.encode_message("a", "b", "t", obj)


JAX = Pkg("jax", JMeta, JStub, JLoop, JNet, jtypes, jmsg)
PORT = Pkg("port", MetaService, ReplicaStub, SimLoop, SimNetwork, ttypes,
           tmsg)


class ClusterHarness:
    """tests/test_meta.py's harness over either package: one meta, N
    stubs, one SimLoop and SimNetwork."""

    def __init__(self, tmp_path, n_nodes=4, seed=0, pkg=PORT):
        self.pkg = pkg
        self.tmp_path = tmp_path
        self.loop = pkg.Loop(seed=seed)
        self.net = pkg.Net(self.loop)
        seed_meta_storage(str(tmp_path / "meta"))
        self.meta = pkg.Meta("meta", str(tmp_path / "meta"), self.net,
                             lambda: self.loop.now)
        self.stubs = {}
        for i in range(n_nodes):
            self.add_stub(f"node{i}")
        self.run_beacons()

    def stub_clock(self):
        return CLOCK_BASE + self.loop.now

    def add_stub(self, name):
        stub = self.pkg.stub(name, self.tmp_path / name, self.net,
                             self.stub_clock)
        stub.meta_addr = "meta"
        self.stubs[name] = stub
        return stub

    def run_beacons(self, rounds=2, interval=3.0, skip=None):
        """Advance virtual time with everyone (but `skip`) beaconing."""
        for _ in range(rounds):
            for name, stub in self.stubs.items():
                if name != skip:
                    stub.send_beacon()
            self.loop.run_for(interval)
            self.meta.tick()
        self.loop.run_until_idle()

    def silence(self, node, rounds=5, interval=3.0):
        """Advance time with `node` NOT beaconing (crash simulation)."""
        self.run_beacons(rounds, interval, skip=node)

    def primary_replica(self, app_id, pidx):
        pc = self.meta.state.get_partition(app_id, pidx)
        return self.stubs[pc.primary].get_replica((app_id, pidx))

    def write(self, app_id, pidx, hk, sk, value):
        r = self.primary_replica(app_id, pidx)
        r.client_write([WriteOp(OP_PUT, (generate_key(hk, sk), value, 0))])
        self.loop.run_until_idle()

    def read_everywhere(self, app_id, pidx, hk, sk):
        pc = self.meta.state.get_partition(app_id, pidx)
        self.primary_replica(app_id, pidx).broadcast_group_check()
        self.loop.run_until_idle()
        out = {}
        for node in pc.members():
            r = self.stubs[node].get_replica((app_id, pidx))
            out[node] = r.server.on_get(generate_key(hk, sk))
        return out

    def close(self):
        for s in self.stubs.values():
            s.close()


@pytest.fixture
def cluster(tmp_path):
    c = ClusterHarness(tmp_path)
    yield c
    c.close()


# ---- the cases of tests/test_meta.py ---------------------------------------


def test_fd_tracks_liveness(cluster):
    assert sorted(cluster.meta.fd.alive_workers()) == [
        "node0", "node1", "node2", "node3"]
    cluster.silence("node2")
    assert not cluster.meta.fd.is_alive("node2")
    assert cluster.meta.fd.is_alive("node0")
    # lease < grace: the worker self-fences before meta declares death
    assert not worker_lease_valid(last_ack=0.0, now=9.5)
    assert worker_lease_valid(last_ack=0.0, now=8.0)


def test_create_app_places_replicas(cluster):
    app_id = cluster.meta.create_app("temp", partition_count=4,
                                     replica_count=3)
    assert app_id == SEED_APP + 1
    cluster.loop.run_until_idle()
    for pidx in range(4):
        pc = cluster.meta.state.get_partition(app_id, pidx)
        assert pc.primary and len(pc.secondaries) == 2
        prim = cluster.stubs[pc.primary].get_replica((app_id, pidx))
        assert prim.status == PartitionStatus.PRIMARY
        for s in pc.secondaries:
            assert cluster.stubs[s].get_replica(
                (app_id, pidx)).status == PartitionStatus.SECONDARY
    # duplicate name rejected
    with pytest.raises(PegasusError):
        cluster.meta.create_app("temp", 4)
    # end-to-end write through the placed group
    cluster.write(app_id, 0, b"hk", b"sk", b"v1")
    reads = cluster.read_everywhere(app_id, 0, b"hk", b"sk")
    assert all(v == (0, b"v1") for v in reads.values())


def test_primary_failover_cure(cluster):
    app_id = cluster.meta.create_app("t", partition_count=2,
                                     replica_count=3)
    cluster.loop.run_until_idle()
    cluster.write(app_id, 0, b"hk", b"sk", b"before")
    pc0 = cluster.meta.state.get_partition(app_id, 0)
    dead = pc0.primary
    cluster.net.partition(dead)
    cluster.silence(dead)
    pc1 = cluster.meta.state.get_partition(app_id, 0)
    assert pc1.primary != dead and pc1.ballot > pc0.ballot
    assert dead not in pc1.members()
    # new primary serves reads and writes
    cluster.write(app_id, 0, b"hk", b"sk2", b"after")
    reads = cluster.read_everywhere(app_id, 0, b"hk", b"sk2")
    assert all(v == (0, b"after") for v in reads.values())
    assert cluster.primary_replica(app_id, 0).server.on_get(
        generate_key(b"hk", b"sk")) == (0, b"before")


def test_guardian_restores_replication_level(cluster):
    app_id = cluster.meta.create_app("t", partition_count=1,
                                     replica_count=3)
    cluster.loop.run_until_idle()
    for i in range(5):
        cluster.write(app_id, 0, b"hk", b"s%d" % i, b"v%d" % i)
    pc = cluster.meta.state.get_partition(app_id, 0)
    dead = pc.secondaries[0]
    cluster.net.partition(dead)
    cluster.silence(dead)
    pc2 = cluster.meta.state.get_partition(app_id, 0)
    assert dead not in pc2.members()
    # guardian pass adds the spare node as learner; learn completes and
    # the partition is back at 3 replicas
    cluster.run_beacons(rounds=3)
    pc3 = cluster.meta.state.get_partition(app_id, 0)
    assert len(pc3.members()) == 3
    newcomer = [n for n in pc3.members() if n not in pc.members()][0]
    r = cluster.stubs[newcomer].get_replica((app_id, 0))
    assert r.status == PartitionStatus.SECONDARY
    cluster.primary_replica(app_id, 0).broadcast_group_check()
    cluster.loop.run_until_idle()
    assert r.server.on_get(generate_key(b"hk", b"s3")) == (0, b"v3")


def test_drop_and_recall(cluster):
    app_id = cluster.meta.create_app("t", partition_count=2,
                                     replica_count=2)
    cluster.loop.run_until_idle()
    cluster.write(app_id, 0, b"hk", b"sk", b"keepme")
    cluster.meta.drop_app("t")
    cluster.loop.run_until_idle()
    assert cluster.meta.state.find_app("t") is None
    with pytest.raises(PegasusError):
        cluster.meta.query_config("t")
    # replicas deactivated
    pc = cluster.meta.state.get_partition(app_id, 0)
    assert pc.primary == ""
    # recall resurrects with data intact
    rid = cluster.meta.recall_app("t")
    cluster.loop.run_until_idle()
    assert rid == app_id
    reads = cluster.read_everywhere(app_id, 0, b"hk", b"sk")
    assert any(v == (0, b"keepme") for v in reads.values())


def test_query_config_and_envs(cluster):
    cluster.meta.create_app("t", partition_count=4, replica_count=2,
                            envs={"default_ttl": "500"})
    cluster.loop.run_until_idle()
    app_id, pc_count, configs = cluster.meta.query_config("t")
    assert pc_count == 4 and len(configs) == 4
    assert all(c.primary for c in configs)
    # envs propagated to the hosting replicas
    pc = configs[0]
    r = cluster.stubs[pc.primary].get_replica((app_id, 0))
    assert r.server.app_envs.get("default_ttl") == "500"
    # update propagates too
    cluster.meta.update_app_envs(
        "t", {"replica.deny_client_request": "reject*write"})
    cluster.loop.run_until_idle()
    assert r.server._deny_client == "write"


def test_lease_fencing_blocks_stale_primary_reads(cluster):
    # a partitioned old primary must self-fence (lease < grace) instead
    # of serving stale reads through the client path
    app_id = cluster.meta.create_app("t", partition_count=1,
                                     replica_count=3)
    cluster.loop.run_until_idle()
    cluster.write(app_id, 0, b"hk", b"sk", b"v")
    pc = cluster.meta.state.get_partition(app_id, 0)
    old_primary = pc.primary
    replies = []
    cluster.net.register("client", lambda src, mt, p: replies.append(p))

    # healthy primary serves the read
    cluster.net.send("client", old_primary, "client_read",
                     {"gpid": (app_id, 0), "rid": 1, "op": "get",
                      "args": generate_key(b"hk", b"sk")})
    cluster.loop.run_until_idle()
    assert replies[-1]["err"] == 0 and replies[-1]["result"] == (0, b"v")

    # partition the primary; its lease lapses while meta cures
    cluster.net.partition(old_primary)
    cluster.silence(old_primary)
    cluster.net.heal(old_primary)  # network back, but lease expired
    cluster.net.send("client", old_primary, "client_read",
                     {"gpid": (app_id, 0), "rid": 2, "op": "get",
                      "args": generate_key(b"hk", b"sk")})
    cluster.loop.run_until_idle()
    assert replies[-1]["rid"] == 2 and replies[-1]["err"] != 0

    # the cured primary serves through the same path
    pc2 = cluster.meta.state.get_partition(app_id, 0)
    assert pc2.primary != old_primary
    cluster.net.send("client", pc2.primary, "client_read",
                     {"gpid": (app_id, 0), "rid": 3, "op": "get",
                      "args": generate_key(b"hk", b"sk")})
    cluster.loop.run_until_idle()
    assert replies[-1]["err"] == 0 and replies[-1]["result"] == (0, b"v")


def test_client_write_path_over_network(cluster):
    app_id = cluster.meta.create_app("t", partition_count=1,
                                     replica_count=2)
    cluster.loop.run_until_idle()
    pc = cluster.meta.state.get_partition(app_id, 0)
    replies = []
    cluster.net.register("client", lambda src, mt, p: replies.append(p))
    cluster.net.send("client", pc.primary, "client_write", {
        "gpid": (app_id, 0), "rid": 7,
        "ops": [(OP_PUT, (generate_key(b"hk", b"sk"), b"netv", 0))]})
    cluster.loop.run_until_idle()
    assert replies and replies[-1]["rid"] == 7 and replies[-1]["err"] == 0
    # a secondary refuses client writes
    cluster.net.send("client", pc.secondaries[0], "client_write", {
        "gpid": (app_id, 0), "rid": 8,
        "ops": [(OP_PUT, (generate_key(b"hk", b"x"), b"y", 0))]})
    cluster.loop.run_until_idle()
    assert replies[-1]["rid"] == 8 and replies[-1]["err"] != 0


def test_stub_restart_recovers_partition_count(tmp_path):
    c = ClusterHarness(tmp_path)
    try:
        app_id = c.meta.create_app("t", partition_count=8, replica_count=2)
        c.loop.run_until_idle()
        pc = c.meta.state.get_partition(app_id, 3)
        node = pc.primary
        r = c.stubs[node].get_replica((app_id, 3))
        assert r.server.partition_count == 8
        c.stubs[node].close()
        # reboot the node: the boot scan must restore the real count
        stub2 = ReplicaStub(node, str(tmp_path / node), c.net,
                            clock=c.stub_clock, device="cpu")
        c.stubs[node] = stub2
        r2 = stub2.get_replica((app_id, 3))
        assert r2.server.partition_count == 8
        assert r2.server.validate_partition_hash
    finally:
        c.close()


def test_recall_rejected_when_name_reused(cluster):
    cluster.meta.create_app("t", partition_count=1, replica_count=2)
    cluster.loop.run_until_idle()
    cluster.meta.drop_app("t")
    cluster.meta.create_app("t", partition_count=1, replica_count=2)
    cluster.loop.run_until_idle()
    with pytest.raises(PegasusError):
        cluster.meta.recall_app("t")


def test_desired_replica_count_survives_small_cluster(tmp_path):
    # create with only 2 nodes alive; when more join, the guardian tops up
    c = ClusterHarness(tmp_path, n_nodes=2)
    try:
        app_id = c.meta.create_app("t", partition_count=1, replica_count=3)
        c.loop.run_until_idle()
        assert len(c.meta.state.get_partition(app_id, 0).members()) == 2
        assert c.meta.state.apps[app_id].max_replica_count == 3
        # a third node joins
        c.add_stub("node9")
        c.run_beacons(rounds=4)
        pc = c.meta.state.get_partition(app_id, 0)
        assert len(pc.members()) == 3 and "node9" in pc.members()
    finally:
        c.close()


def test_meta_state_persists_across_restart(tmp_path):
    c = ClusterHarness(tmp_path)
    try:
        app_id = c.meta.create_app("t", partition_count=2, replica_count=2)
        c.loop.run_until_idle()
        pc_before = c.meta.state.get_partition(app_id, 0)
        # meta restarts from its storage file
        meta2 = MetaService("meta2", str(tmp_path / "meta"), c.net,
                            lambda: c.loop.now)
        assert meta2.state.apps[app_id].app_name == "t"
        pc_after = meta2.state.get_partition(app_id, 0)
        assert pc_after.to_json() == pc_before.to_json()
    finally:
        c.close()


# ---- the differential run: a JAX cluster and a port cluster ----------------


def _client(c):
    """A `client` endpoint on the cluster's network; its replies land
    in the list returned."""
    replies = []
    c.net.register("client", lambda src, mt, p: replies.append((mt, p)))
    return replies


def _configs(c, app_id):
    return [(pc.ballot, pc.primary, list(pc.secondaries))
            for pc in (c.meta.state.get_partition(app_id, p)
                       for p in range(c.meta.state.apps[app_id]
                                      .partition_count))]


def _storage(c):
    return json.dumps(c.meta.storage._tree, sort_keys=True)


def _seeded_writes(rng_seed, n):
    """`n` client writes (puts, some with a TTL, and removes) as
    (hashkey, ops)."""
    import numpy as np

    rng = np.random.default_rng(rng_seed)
    now = int(T0) - jvs.PEGASUS_EPOCH_BEGIN
    out = []
    for i in range(n):
        hk = b"u%03d" % int(rng.integers(0, 40))
        kind = int(rng.integers(0, 4))
        if kind == 0:
            ops = [(OP_PUT, (generate_key(hk, b"s%d" % j),
                             b"v%d-%d" % (i, j) * int(rng.integers(1, 30)),
                             int(rng.choice([0, 0, now + 900]))))
                   for j in range(int(rng.integers(1, 5)))]
        elif kind == 1:
            ops = [(OP_REMOVE, (generate_key(hk, b"s1"),))]
        else:
            ops = [(OP_PUT, (generate_key(hk, b"s%d" % int(
                rng.integers(0, 6))), b"w%d" % i, 0))]
        out.append((hk, ops))
    return out


def _script(pkg, root, seed):
    """The differential script on one package; returns what every step
    recorded."""
    c = ClusterHarness(root, seed=seed, pkg=pkg)
    rec = []
    rid = [0]
    try:
        replies = _client(c)

        def step(name, app_id):
            c.loop.run_until_idle()
            got = [(mt, p.get("err"), pkg.wire(p)) for mt, p in replies]
            replies.clear()
            rec.append((name, _storage(c), _configs(c, app_id), got))

        def send(node, msg_type, payload):
            rid[0] += 1
            payload = dict(payload, rid=rid[0])
            c.net.send("client", node, msg_type, payload)

        def writes(app_id, rng_seed, n):
            for hk, ops in _seeded_writes(rng_seed, n):
                ph = key_hash_parts(hk)
                pidx = ph % 4
                pc = c.meta.state.get_partition(app_id, pidx)
                send(pc.primary, "client_write", {
                    "gpid": (app_id, pidx), "ops": ops,
                    "partition_hash": ph})
                c.loop.run_until_idle()
            # then one client_write_batch a node over the partitions it
            # leads: two writes a partition, one of them a batch of puts
            by_node = {}
            for hk, ops in _seeded_writes(rng_seed + 100, 16):
                ph = key_hash_parts(hk)
                pc = c.meta.state.get_partition(app_id, ph % 4)
                by_node.setdefault(pc.primary, {}).setdefault(
                    (app_id, ph % 4), []).append((ops, ph, None))
            for node, groups in sorted(by_node.items()):
                send(node, "client_write_batch",
                     {"groups": sorted(groups.items())})
                c.loop.run_until_idle()
            for pidx in range(4):
                c.primary_replica(app_id, pidx).broadcast_group_check()

        def reads(app_id):
            for pidx in range(4):
                pc = c.meta.state.get_partition(app_id, pidx)
                for hk in (b"u001", b"u007", b"u023"):
                    send(pc.primary, "client_read", {
                        "gpid": (app_id, pidx), "op": "get",
                        "args": generate_key(hk, b"s1")})
                send(pc.primary, "client_read", {
                    "gpid": (app_id, pidx), "op": "multi_get",
                    "args": pkg.types.MultiGetRequest(b"u007")})
            # one client_scan_multi a node, over the partitions it leads
            by_node = {}
            for pidx in range(4):
                pc = c.meta.state.get_partition(app_id, pidx)
                by_node.setdefault(pc.primary, []).append((
                    (app_id, pidx), [
                        pkg.types.GetScannerRequest(
                            start_key=b"", batch_size=n, one_page=True,
                            validate_partition_hash=True)
                        for n in (5, 40, 1000)]))
            for node, groups in sorted(by_node.items()):
                send(node, "client_scan_multi", {"groups": groups})
            # one client_read_batch a node: point gets, with and without
            # the routing hash
            by_node = {}
            for i in range(12):
                hk = b"u%03d" % (3 * i)
                ph = key_hash_parts(hk)
                pc = c.meta.state.get_partition(app_id, ph % 4)
                by_node.setdefault(pc.primary, {}).setdefault(
                    (app_id, ph % 4), []).append(
                        ("get", generate_key(hk, b"s%d" % (i % 6)),
                         ph if i % 2 else None))
            for node, groups in sorted(by_node.items()):
                send(node, "client_read_batch",
                     {"groups": sorted(groups.items())})

        c.meta.create_app("diff", partition_count=4, replica_count=3)
        app_id = SEED_APP + 1
        step("create", app_id)
        writes(app_id, 21, 60)
        step("writes", app_id)
        reads(app_id)
        step("reads", app_id)
        # silence the primary of partition 0; the meta cures
        dead = c.meta.state.get_partition(app_id, 0).primary
        c.net.partition(dead)
        c.silence(dead)
        step("silenced", app_id)
        c.run_beacons(rounds=4, skip=dead)
        step("cured", app_id)
        writes(app_id, 22, 20)
        reads(app_id)
        step("after-cure", app_id)
        # config sync: the live nodes report, the meta answers
        for name, stub in sorted(c.stubs.items()):
            if name != dead:
                stub.config_sync()
        step("config-sync", app_id)
        c.meta.drop_app("diff")
        step("dropped", app_id)
        c.meta.recall_app("diff")
        step("recalled", app_id)
        c.run_beacons(rounds=2, skip=dead)
        reads(app_id)
        step("recalled-reads", app_id)
        # the meta restarts from its storage
        c.meta = pkg.Meta("meta", str(root / "meta"), c.net,
                          lambda: c.loop.now)
        step("meta-restart", app_id)
        c.run_beacons(rounds=3, skip=dead)
        writes(app_id, 23, 10)
        reads(app_id)
        step("restarted-serving", app_id)
        rec.append(("delivered", c.net.delivered, c.net.dropped))
        return rec
    finally:
        c.close()


@pytest.mark.parametrize("seed", [3, 8])
def test_cluster_matches_jax(tmp_path, frozen, seed):
    jrec = _script(JAX, tmp_path / "jax", seed)
    trec = _script(PORT, tmp_path / "port", seed)
    assert len(jrec) == len(trec)
    for a, b in zip(jrec, trec):
        assert a == b, a[0]
    steps = {r[0]: r for r in trec}
    # the run really cured: a new primary at a higher ballot, back at
    # three replicas, and every reply of the last step served
    created, cured = steps["create"][2], steps["cured"][2]
    assert cured[0][0] > created[0][0] and cured[0][1] != created[0][1]
    assert all(len(pc[2]) == 2 for pc in cured)
    for name in ("writes", "reads", "after-cure", "restarted-serving"):
        got = steps[name][3]
        assert got and all(err == 0 for _mt, err, _w in got), name


# ---- the backup, bulk-load and duplication services against the JAX ones ---


def test_empty_meta_ticks_the_same_storage(tmp_path):
    """A meta with no table ticks its services (backup, bulk load and
    duplication included) and writes the storage the JAX meta writes."""
    out = []
    for pkg in (JAX, PORT):
        loop = pkg.Loop(seed=1)
        net = pkg.Net(loop)
        d = tmp_path / pkg.name
        seed_meta_storage(str(d))
        meta = pkg.Meta("meta", str(d), net, lambda: loop.now)
        for _ in range(5):
            loop.run_for(3.0)
            meta.tick()
        meta.set_meta_level("lively")
        for _ in range(12):
            loop.run_for(3.0)
            meta.tick()
        assert meta.pending_restores == {}
        out.append((json.dumps(meta.storage._tree, sort_keys=True),
                    (d / "meta.json").read_text()))
    assert out[0] == out[1]


@pytest.fixture
def frozen_backup_ids(monkeypatch):
    """Both backup services' `time`, and both packages' value clocks,
    frozen: backup ids and timetags agree."""
    from pegasus_tpu.meta import backup_service as jbk
    from pegasus_tpu_torch.meta import backup_service as tbk

    clk = Clock(T0)
    for mod in (jvs, tvs, jws, tws, jbk, tbk):
        monkeypatch.setattr(mod, "time", clk)
    return clk


def _stage_bulk(root, app_name: str, partitions: int) -> None:
    """A JAX-staged bulk load of `partitions` for `app_name` at `root`."""
    from pegasus_tpu.server.bulk_load import SSTGenerator
    from pegasus_tpu.storage.block_service import LocalBlockService

    SSTGenerator(LocalBlockService(str(root)), app_name,
                 partitions).generate(
        [(b"b%03d" % i, b"s", b"bulk%d" % i, 0) for i in range(60)])


def _tree(root) -> dict:
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _write_service_state(c, key: str, root) -> None:
    """Drive the JAX meta's service until `key` holds state."""
    app_id = c.meta.create_app("t", partition_count=2, replica_count=2)
    c.loop.run_until_idle()
    c.write(app_id, 0, b"hk", b"sk", b"v")
    if key == "/backup/policies":
        c.meta.backup.add_policy("p", ["t"], str(root), 600, 2)
    elif key == "/backup/inflight":
        c.net.partition(c.meta.state.get_partition(app_id, 1).primary)
        c.meta.backup.start_backup("t", str(root), backup_id=77)
        c.loop.run_until_idle()
    elif key == "/backup/completed":
        c.meta.backup.start_backup("t", str(root), backup_id=78)
        c.run_beacons(2)
    elif key == "/bulk_load/inflight":
        _stage_bulk(root, "t", 2)
        c.meta.bulk_load.start_bulk_load("t", str(root))
        c.meta.bulk_load.pause_bulk_load("t")
    elif key == "/bulk_load/failed":
        _stage_bulk(root, "t", 2)
        c.meta.bulk_load.start_bulk_load("t", str(root))
        c.meta.bulk_load.cancel_bulk_load("t")
    elif key == "/duplication/dups":
        c.meta.duplication.add_duplication("t", "m2", "t")
    elif key == "/duplication/failover":
        c.meta.duplication.add_duplication("t", "m2", "t")
        c.meta.duplication.start_failover("t")
    assert c.meta.storage.get(key), key


def _service_state(meta) -> dict:
    bk, bl, dup = meta.backup, meta.bulk_load, meta.duplication
    return json.loads(json.dumps({
        "policies": bk._policies, "inflight": bk._inflight,
        "completed": bk._completed, "loads": bl._loads,
        "failed": bl._failed, "dups": dup._dups,
        "failover": dup._failover, "next_dupid": dup._next_dupid,
        "pending_restores": sorted(map(list, meta.pending_restores))},
        sort_keys=True, default=str))


@pytest.mark.parametrize("key", [
    "/backup/policies", "/backup/inflight", "/backup/completed",
    "/bulk_load/inflight", "/bulk_load/failed", "/duplication/dups",
    "/duplication/failover"])
def test_service_state_written_by_jax_loads_in_port(tmp_path,
                                                    frozen_backup_ids, key):
    """A meta store in which the JAX meta's service left state at `key`
    loads in a port meta (and in a fresh JAX meta) to the same service
    state, and a leader tick of each writes the same storage."""
    c = ClusterHarness(tmp_path, n_nodes=3, pkg=JAX)
    try:
        _write_service_state(c, key, tmp_path / "root")
    finally:
        c.close()
    saved = (tmp_path / "meta" / "meta.json").read_text()
    out = []
    for pkg in (JAX, PORT):
        (tmp_path / "meta" / "meta.json").write_text(saved)
        loop = pkg.Loop(seed=4)
        meta = pkg.Meta("meta", str(tmp_path / "meta"), pkg.Net(loop),
                        lambda: loop.now)
        state = _service_state(meta)
        meta.tick()
        loop.run_until_idle()
        out.append((state, json.dumps(meta.storage._tree, sort_keys=True)))
    assert out[0] == out[1]
    assert any(out[1][0][k] for k in ("policies", "inflight", "completed",
                                      "loads", "failed", "dups",
                                      "failover"))


SERVICE_VERBS = [
    ("start_backup", {"app_name": "t", "root": "<root>"}),
    ("add_backup_policy", {"name": "p", "app_names": ["t"],
                           "root": "<root>"}),
    ("restore_app", {"new_name": "r", "root": "<root>", "backup_id": 91}),
    ("start_bulk_load", {"app_name": "t", "root": "<root>"}),
    ("bulk_load_status", {"app_name": "t"}),
    ("add_dup", {"app_name": "t", "follower_meta": "m2",
                 "follower_app": "t"}),
    ("list_dups", {}),
]


def _verb_run(pkg, path, cmd, args) -> tuple:
    root = path / "root"
    c = ClusterHarness(path, n_nodes=3, pkg=pkg)
    try:
        app_id = c.meta.create_app("t", partition_count=2, replica_count=2)
        c.loop.run_until_idle()
        for i in range(6):
            c.write(app_id, i % 2, b"hk%d" % i, b"sk", b"v%d" % i)
        if cmd == "restore_app":
            c.meta.backup.start_backup("t", str(root), backup_id=91)
            c.run_beacons(2)
        if cmd in ("start_bulk_load", "bulk_load_status"):
            _stage_bulk(root, "t", 2)
        if cmd == "bulk_load_status":
            c.meta.bulk_load.start_bulk_load("t", str(root))
        if cmd == "list_dups":
            c.meta.duplication.add_duplication("t", "m2", "t")
        replies = _client(c)
        args = json.loads(json.dumps(args).replace("<root>", str(root)))
        c.net.send("client", "meta", "admin",
                   {"rid": 1, "cmd": cmd, "args": args})
        c.loop.run_until_idle()
        c.run_beacons(3)
        reads = [c.read_everywhere(app_id, i % 2, b"hk%d" % i, b"sk")
                 for i in range(6)]
        if cmd == "restore_app":
            rid = c.meta.state.find_app("r").app_id
            reads.append([c.primary_replica(rid, i % 2).server.on_get(
                generate_key(b"hk%d" % i, b"sk")) for i in range(6)])
        text = json.dumps([replies, _storage(c), reads], default=repr)
        return text.replace(str(path), "<path>"), _tree(root)
    finally:
        c.close()


@pytest.mark.parametrize("cmd,args", SERVICE_VERBS,
                         ids=[v[0] for v in SERVICE_VERBS])
def test_service_verbs_match_jax(tmp_path, frozen_backup_ids, cmd, args):
    """Each admin verb of the three services, over the network, on a JAX
    cluster and a port cluster: the same reply, meta storage, block
    service tree and reads."""
    j = _verb_run(JAX, tmp_path / "jax", cmd, args)
    t = _verb_run(PORT, tmp_path / "port", cmd, args)
    assert j[0] == t[0]
    assert j[1] == t[1]
    assert '"err": 0' in t[0]


def _dup_envelope(pkg, app_id: int) -> dict:
    """A dup_apply_batch payload of two shipped puts and a remove, as the
    package's ClusterDuplicator builds it."""
    import struct

    from pegasus_tpu_torch.base.value_schema import generate_timetag

    if pkg is JAX:
        from pegasus_tpu.rpc.codec import (
            OP_DUP_PUT,
            OP_DUP_REMOVE,
            encode_write,
        )
        from pegasus_tpu.storage.block_codec import deflate_payload
    else:
        from pegasus_tpu_torch.rpc.codec import (
            OP_DUP_PUT,
            OP_DUP_REMOVE,
            encode_write,
        )
        from pegasus_tpu_torch.storage.block_codec import deflate_payload
    tag = generate_timetag(int(T0 * 1e6) + 5_000_000, 2, False)
    ops = [(OP_DUP_PUT, (generate_key(b"hk", b"dup%d" % i), b"d" * 40,
                         0, tag + i)) for i in range(2)]
    ops.append((OP_DUP_REMOVE, (generate_key(b"hk", b"sk"), tag + 2)))
    blob = b"".join(struct.pack("<I", len(e)) + e
                    for e in (encode_write(o, r) for o, r in ops))
    mode, stored = deflate_payload(blob)
    return {"rid": 1, "dupid": 1, "blob_mode": mode, "ops_blob": stored,
            "raw_len": len(blob), "n_ops": len(ops), "max_decree": 3}


STUB_MESSAGES = [
    ("backup_partition", {"backup_id": 1, "policy": "manual",
                          "root": "<root>"}),
    ("restore_partition", {"backup_id": 1, "policy": "manual",
                           "root": "<root>"}),
    ("trigger_ingest", {"root": "<root>", "src_app": "t", "load_id": 3}),
    ("dup_add", {"dupid": 1, "follower_meta": "m2", "follower_app": "t"}),
    ("dup_apply_batch", None),
]


def _stub_run(pkg, path, msg_type, payload) -> tuple:
    root = path / "root"
    c = ClusterHarness(path, n_nodes=3, pkg=pkg)
    try:
        app_id = c.meta.create_app("t", partition_count=1, replica_count=2)
        c.loop.run_until_idle()
        for i in range(4):
            c.write(app_id, 0, b"hk", b"sk%d" % i, b"v%d" % i)
        c.write(app_id, 0, b"hk", b"sk", b"v")
        pc = c.meta.state.get_partition(app_id, 0)
        stub = c.stubs[pc.primary]
        r = stub.get_replica((app_id, 0))
        replies = _client(c)
        if msg_type == "restore_partition":
            # a backup of this very partition, then the restore into it
            c.net.send("client", pc.primary, "backup_partition", {
                "gpid": (app_id, 0), "backup_id": 1, "policy": "manual",
                "root": str(root)})
            c.loop.run_until_idle()
            c.write(app_id, 0, b"hk", b"late", b"after-backup")
            r.restoring = True
            payload = dict(payload, src_app_id=app_id)
        if msg_type == "trigger_ingest":
            _stage_bulk(root, "t", 1)
        if payload is None:
            payload = _dup_envelope(pkg, app_id)
        payload = json.loads(json.dumps(
            payload, default=lambda b: b.hex()).replace("<root>", str(root))) \
            if msg_type != "dup_apply_batch" else payload
        c.net.send("client", pc.primary, msg_type,
                   dict(payload, gpid=(app_id, 0)))
        c.loop.run_until_idle()
        c.run_beacons(2)
        state = {
            "committed": [c.stubs[n].get_replica((app_id, 0))
                          .last_committed_decree for n in pc.members()],
            "restoring": getattr(r, "restoring", None),
            "sessions": sorted(map(repr, stub._dup_sessions)),
            "inflight": (sorted(stub._backup_inflight),
                         sorted(stub._ingest_inflight)),
            "reads": [r.server.on_get(generate_key(b"hk", sk)) for sk in
                      (b"sk", b"sk0", b"sk3", b"late", b"dup0", b"dup1",
                       b"b000")],
            "bulk": [r.server.on_get(generate_key(b"b%03d" % i, b"s"))
                     for i in range(0, 60, 7)],
        }
        text = json.dumps([replies, state], default=repr)
        return text.replace(str(path), "<path>"), _tree(root)
    finally:
        c.close()


@pytest.mark.parametrize("msg_type,payload", STUB_MESSAGES,
                         ids=[m[0] for m in STUB_MESSAGES])
def test_stub_service_messages_match_jax(tmp_path, frozen_backup_ids,
                                         msg_type, payload):
    """Each of the stub's backup, restore, ingest and duplication
    messages on a JAX cluster and a port cluster: the same replies,
    decrees on every member, sessions, reads and block-service tree."""
    j = _stub_run(JAX, tmp_path / "jax", msg_type, payload)
    t = _stub_run(PORT, tmp_path / "port", msg_type, payload)
    assert j[0] == t[0]
    assert j[1] == t[1]


# ---- the port's own contracts ---------------------------------------------


def test_stub_serves_on_the_card_by_default(tmp_path, monkeypatch):
    """`device=None` means the card: without CUDA the stub raises before
    it opens anything; `device="cpu"` puts every replica on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    loop = SimLoop(seed=0)
    net = SimNetwork(loop)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ReplicaStub("n0", str(tmp_path / "n0"), net)
    c = ClusterHarness(tmp_path / "c", n_nodes=2)
    try:
        app_id = c.meta.create_app("t", partition_count=2, replica_count=2)
        c.loop.run_until_idle()
        for stub in c.stubs.values():
            assert stub.device == torch.device("cpu")
            for pidx in range(2):
                srv = stub.get_replica((app_id, pidx)).server
                assert srv.device == torch.device("cpu")
                assert srv.engine.device == torch.device("cpu")
        # the stub threads its clock into the range-read budget
        srv = c.primary_replica(app_id, 0).server
        assert srv.clock_ns() == int(c.stub_clock() * 1e9)
        info = c.stubs["node0"].commands.call("server.info", [])
        import pegasus_tpu_torch

        assert info["version"] == pegasus_tpu_torch.__version__
    finally:
        c.close()


def test_stub_timers_and_verbs_run_on_the_port(cluster):
    """The stub's timers as a cluster step fires them (beacons, group
    checks, config sync, the duplication, split, transfer, scrub and
    health timers), then the node's remote-command verbs and the meta's
    admin verbs over the network: every one answers OK."""
    from pegasus_tpu_torch.utils import health as thealth

    app_id = cluster.meta.create_app("t", partition_count=4,
                                     replica_count=3)
    cluster.loop.run_until_idle()
    replies = _client(cluster)
    for i in range(40):
        hk = b"h%02d" % i
        ph = key_hash_parts(hk)
        pc = cluster.meta.state.get_partition(app_id, ph % 4)
        cluster.net.send("client", pc.primary, "client_write", {
            "gpid": (app_id, ph % 4), "rid": i, "partition_hash": ph,
            "ops": [(OP_PUT, (generate_key(hk, b"s"), b"v%d" % i, 0))]})
        cluster.loop.run_until_idle()
    assert all(p["err"] == 0 for _mt, p in replies)
    try:
        for _ in range(4):
            for stub in cluster.stubs.values():
                stub.send_beacon()
                for r in stub.replicas.values():
                    if r.status == PartitionStatus.PRIMARY:
                        r.broadcast_group_check()
                stub.config_sync()
                stub.dup_tick()
                stub.split_tick()
                stub.transfer_tick()
                stub.scrub_tick()
                stub.health_tick()
            cluster.loop.run_for(12.0)
            cluster.meta.tick()
        cluster.loop.run_until_idle()
        replies.clear()
        verbs = [("server.info", []), ("replica.info", []),
                 ("health.status", []), ("health.events", ["8"]),
                 ("timeseries-dump", ["replica"]), ("fs.stats", []),
                 ("fs.health", []), ("dup.stats", []),
                 ("workload.stats", []), ("qos.tenants", []),
                 ("replica.scrub", ["status"]), ("replica.disk", []),
                 ("slow-query-dump", []), ("trace-list", []),
                 ("hotkey", ["query", str(app_id), "0", "read"])]
        node = cluster.meta.state.get_partition(app_id, 0).primary
        for rid, (cmd, args) in enumerate(verbs):
            cluster.net.send("client", node, "remote_command",
                             {"rid": rid, "cmd": cmd, "args": args})
        for rid, cmd in enumerate(("cluster_health", "compact_sched",
                                   "hot_partitions", "workload",
                                   "list_apps", "cluster_info",
                                   "ddd_diagnose", "tenant_stats",
                                   "slow_traces", "get_meta_level",
                                   "list_nodes"), start=100):
            cluster.net.send("client", "meta", "admin",
                             {"rid": rid, "cmd": cmd, "args": {}})
        cluster.loop.run_until_idle()
        got = {p["rid"]: p for _mt, p in replies}
        assert len(got) == len(verbs) + 11
        bad = {rid: p["result"] for rid, p in got.items() if p["err"] != 0}
        assert not bad
        info = got[0]["result"]
        assert info["replica_count"] == 3 and info["node"] == node
        assert got[100]["result"]["cluster"] in ("ok", "degraded",
                                                 "critical")
        assert [a["app_name"] for a in got[104]["result"]] == ["t"]
    finally:
        thealth.reset_capture()


def test_chip_smoke_phase12_runs_on_the_cpu():
    """chip_smoke.py's phase 12 at a small size on the CPU: config #2's
    layout through one stub (every page against the oracle), then the
    meta's cure on four stubs (pages byte-equal after it, the restarted
    node's partition count)."""
    import chip_smoke as cs

    cpu = torch.device("cpu")
    with cs.store_flags(cs.NONE_STORE):
        a = cs.run_cluster(cpu, n_hashkeys=1500, n_ops=800)
        b = cs.run_cure(cpu, n_hashkeys=1200, n_probe=64)
    assert a["writes_per_s"] > 0 and a["scans_per_s"] > 0
    assert b["learners"] == 6 and b["cure_sim_s"] > 0
