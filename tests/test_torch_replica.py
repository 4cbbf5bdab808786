"""The port's PacificA replica (replica/, runtime/sim, the write path's
`wal_flush`) on the CPU, and against the JAX package's, exact.

- the cases of tests/test_replica.py and the SimCluster-free cases of
  tests/test_write_coordinator.py, run against the port's replica with
  `device="cpu"`;
- `Replica` serves on the card unless told otherwise, and raises
  without CUDA;
- a differential run: the same seeded writes through a JAX three-replica
  group and a port group, over the same SimLoop seed with delayed,
  duplicated and dropped messages, with and without a group-commit
  window: decrees, acks, plog bytes, engine-WAL bytes, SST digests after
  a flush and a compaction, and every replica's scan responses (as wire
  bytes) equal, also after a failover and after learners caught up by
  log and by checkpoint; and OP_INGEST (bulk load) through the same
  groups, replayed, after a delete, with its staged file gone and as a
  logged mutation applied at a secondary.

Both packages' wall clocks are frozen by replacing the `time` of their
value-schema and write-service modules; each replica's clock is the
SimLoop's. The metric entities a test creates are removed after it, in
both registries, and the flags it sets are restored.
"""

import dataclasses
import hashlib
import json
import os
import shutil
import time

import pytest
import torch

from pegasus_tpu.base import value_schema as jvs
from pegasus_tpu.replica import Replica as JReplica
from pegasus_tpu.replica import ReplicaConfig as JConfig
from pegasus_tpu.replica import WriteFlushWindow as JWindow
from pegasus_tpu.replica import WriteOp as JWriteOp
from pegasus_tpu.rpc import message as jmsg
from pegasus_tpu.runtime import SimLoop as JLoop
from pegasus_tpu.runtime import SimNetwork as JNet
from pegasus_tpu.server import types as jtypes
from pegasus_tpu.server import write_service as jws
from pegasus_tpu.storage import sstable as jsst
from pegasus_tpu.utils import metrics as jmetrics
from pegasus_tpu.utils.flags import FLAGS as JFLAGS
from pegasus_tpu_torch.base import value_schema as tvs
from pegasus_tpu_torch.base.key_schema import generate_key
from pegasus_tpu_torch.replica import (
    Mutation,
    MutationLog,
    PartitionStatus,
    PrepareList,
    Replica,
    ReplicaBusyError,
    ReplicaConfig,
    WriteFlushWindow,
    WriteOp,
)
from pegasus_tpu_torch.replica.prepare_list import (
    COMMIT_ALL_READY,
    COMMIT_TO_DECREE_HARD,
)
from pegasus_tpu_torch.rpc import message as tmsg
from pegasus_tpu_torch.rpc.codec import (
    OP_INCR,
    OP_INGEST,
    OP_MULTI_PUT,
    OP_MULTI_REMOVE,
    OP_PUT,
    OP_REMOVE,
)
from pegasus_tpu_torch.runtime import SimLoop, SimNetwork
from pegasus_tpu_torch.server import types as ttypes
from pegasus_tpu_torch.server import write_service as tws
from pegasus_tpu_torch.server.types import IncrRequest
from pegasus_tpu_torch.storage import sstable as tsst
from pegasus_tpu_torch.storage.framed_log import (
    iter_frames,
    pack_frame,
    scan_valid_end,
)
from pegasus_tpu_torch.utils import metrics as tmetrics
from pegasus_tpu_torch.utils.flags import FLAGS as TFLAGS
from pegasus_tpu_torch.utils.metrics import METRICS

T0 = 1_790_000_000.25   # unix seconds the frozen clocks start at
CLOCK_BASE = 1_700_000_000


@pytest.fixture(autouse=True)
def isolated_state():
    """Remove the metric entities a test created from both registries and
    put `plog_sync_mode` back in both flag registries."""
    regs = (jmetrics.METRICS, tmetrics.METRICS)
    before = [set(reg._entities) for reg in regs]
    modes = [reg.get("pegasus.replica", "plog_sync_mode")
             for reg in (JFLAGS, TFLAGS)]
    yield
    for reg, keys in zip(regs, before):
        with reg._lock:
            for key in set(reg._entities) - keys:
                del reg._entities[key]
    for reg, mode in zip((JFLAGS, TFLAGS), modes):
        reg.set("pegasus.replica", "plog_sync_mode", mode, force=True)


def k(h, s=""):
    return generate_key(h if isinstance(h, bytes) else h.encode(),
                        s if isinstance(s, bytes) else s.encode())


def put_op(hk, sk, value, ets=0):
    return WriteOp(OP_PUT, (k(hk, sk), value, ets))


def new_replica(name, path, net, loop, **kw):
    return Replica(name, str(path), net,
                   clock=lambda: CLOCK_BASE + loop.now, device="cpu", **kw)


class Cluster:
    """Test control plane: wires N port replicas over a SimNetwork and
    plays the meta role (config assignment, learner upgrades)."""

    def __init__(self, tmp_path, names=("r1", "r2", "r3"), seed=0):
        self.loop = SimLoop(seed=seed)
        self.net = SimNetwork(self.loop)
        self.replicas = {}
        for name in names:
            r = new_replica(name, tmp_path / name, self.net, self.loop)
            self.net.register(name, r.on_message)
            self.replicas[name] = r
        self.ballot = 1
        self.config = ReplicaConfig(self.ballot, names[0],
                                    list(names[1:]))
        for r in self.replicas.values():
            r.assign_config(self.config)

    @property
    def primary(self):
        return self.replicas[self.config.primary]

    def add(self, name, tmp_path):
        r = new_replica(name, tmp_path / name, self.net, self.loop)
        self.net.register(name, r.on_message)
        self.replicas[name] = r
        return r

    def reconfigure(self, primary, secondaries):
        self.ballot += 1
        self.config = ReplicaConfig(self.ballot, primary, list(secondaries))
        for r in self.replicas.values():
            r.assign_config(self.config)

    def write(self, ops, callback=None):
        decree = self.primary.client_write(ops, callback)
        self.loop.run_until_idle()
        return decree

    def close(self):
        for r in self.replicas.values():
            r.close()


# ---- the cases of tests/test_replica.py -----------------------------------


def test_mutation_codec_roundtrip():
    mu = Mutation(ballot=3, decree=17, last_committed=16,
                  timestamp_us=123456789,
                  ops=[put_op("h", "s", b"v", 99),
                       WriteOp(OP_REMOVE, (k("h", "x"),)),
                       WriteOp(OP_INCR, IncrRequest(k("h", "c"), 5, -1))])
    mu2 = Mutation.decode(mu.encode())
    assert mu2.ballot == 3 and mu2.decree == 17 and mu2.last_committed == 16
    assert len(mu2.ops) == 3
    assert mu2.ops[0].request == (k("h", "s"), b"v", 99)
    assert mu2.ops[2].request.increment == 5
    assert mu2.ops[2].request.expire_ts_seconds == -1


def test_prepare_list_commit_modes():
    committed = []
    pl = PrepareList(0, 16, committed.append)
    for mu in [Mutation(1, d, d - 1, 0, []) for d in range(1, 5)]:
        pl.prepare(mu)
    pl.mark_ready(2)
    assert pl.commit(2, COMMIT_ALL_READY) == 0  # decree 1 not ready
    pl.mark_ready(1)
    assert pl.commit(1, COMMIT_ALL_READY) == 2  # 1 then 2
    assert pl.last_committed_decree == 2
    assert pl.commit(4, COMMIT_TO_DECREE_HARD) == 2
    pl.prepare(Mutation(1, 7, 4, 0, []))
    with pytest.raises(RuntimeError):
        pl.commit(7, COMMIT_TO_DECREE_HARD)


def test_prepare_list_higher_ballot_wins():
    pl = PrepareList(0, 16, lambda mu: None)
    pl.prepare(Mutation(2, 1, 0, 0, [put_op("h", "a", b"new")]))
    pl.prepare(Mutation(1, 1, 0, 0, [put_op("h", "a", b"old")]))
    assert pl.get_mutation_by_decree(1).ballot == 2


def test_mutation_log_replay_and_gc(tmp_path):
    path = str(tmp_path / "plog" / "m.bin")
    log = MutationLog(path)
    for d in range(1, 6):
        log.append(Mutation(1, d, d - 1, 0, [put_op("h", "s%d" % d, b"v")]))
    log.close()
    log2 = MutationLog(path)
    assert log2.max_decree == 5
    assert [mu.decree for mu in log2.read_range(3)] == [3, 4, 5]
    log2.gc(3)
    assert [mu.decree for mu in log2.read_range(1)] == [4, 5]
    log2.close()


def test_three_replica_commit_flow(tmp_path):
    c = Cluster(tmp_path)
    try:
        results = []
        c.write([put_op("u", "s1", b"v1")], results.append)
        assert results and results[0] == [0]
        assert c.primary.last_committed_decree == 1
        c.write([put_op("u", "s2", b"v2")])
        for name in ("r2", "r3"):
            assert c.replicas[name].last_committed_decree >= 1
        c.primary.broadcast_group_check()
        c.loop.run_until_idle()
        for r in c.replicas.values():
            assert r.last_committed_decree == 2
            assert r.server.on_get(k("u", "s1")) == (0, b"v1")
            assert r.server.on_get(k("u", "s2")) == (0, b"v2")
    finally:
        c.close()


def test_batched_and_atomic_mutations(tmp_path):
    c = Cluster(tmp_path)
    try:
        c.write([put_op("u", "a", b"1"), put_op("u", "b", b"2"),
                 WriteOp(OP_REMOVE, (k("u", "a"),))])
        results = []
        c.write([WriteOp(OP_INCR, IncrRequest(k("u", "cnt"), 42))],
                results.append)
        assert results[0][0].new_value == 42
        c.primary.broadcast_group_check()
        c.loop.run_until_idle()
        for r in c.replicas.values():
            assert r.server.on_get(k("u", "a"))[0] == 1  # removed
            assert r.server.on_get(k("u", "b")) == (0, b"2")
            assert r.server.on_get(k("u", "cnt")) == (0, b"42")
        with pytest.raises(ValueError):
            c.primary.client_write([
                WriteOp(OP_INCR, IncrRequest(k("u", "c"), 1)),
                put_op("u", "d", b"x")])
    finally:
        c.close()


def test_value_bytes_identical_across_replicas(tmp_path):
    c = Cluster(tmp_path)
    try:
        c.write([put_op("u", "s", b"payload")])
        c.primary.broadcast_group_check()
        c.loop.run_until_idle()
        raws = [r.server.engine.get(k("u", "s"))[0]
                for r in c.replicas.values()]
        assert raws[0] == raws[1] == raws[2]
    finally:
        c.close()


def test_failover_promote_secondary(tmp_path):
    c = Cluster(tmp_path)
    try:
        for i in range(5):
            c.write([put_op("u", "s%d" % i, b"v%d" % i)])
        c.primary.broadcast_group_check()
        c.loop.run_until_idle()
        c.net.partition("r1")
        c.reconfigure("r2", ["r3"])
        c.loop.run_until_idle()
        assert c.replicas["r2"].status == PartitionStatus.PRIMARY
        assert c.replicas["r2"].ballot == 2
        c.write([put_op("u", "after", b"failover")])
        c.replicas["r2"].broadcast_group_check()
        c.loop.run_until_idle()
        assert c.replicas["r3"].server.on_get(k("u", "after")) == (
            0, b"failover")
        assert c.replicas["r2"].server.on_get(k("u", "s3")) == (0, b"v3")
    finally:
        c.close()


def test_new_primary_repropose_uncommitted_window(tmp_path):
    c = Cluster(tmp_path)
    try:
        c.net.set_drop(1.0, src="r2", dst="r1")
        c.net.set_drop(1.0, src="r3", dst="r1")
        c.write([put_op("u", "s", b"v")])
        assert c.primary.last_committed_decree == 0  # stuck
        assert c.replicas["r2"].last_prepared_decree() == 1
        c.net.partition("r1")
        c.reconfigure("r2", ["r3"])
        c.loop.run_until_idle()
        assert c.replicas["r2"].last_committed_decree == 1
        assert c.replicas["r2"].server.on_get(k("u", "s")) == (0, b"v")
    finally:
        c.close()


def test_learner_catchup_via_log(tmp_path):
    c = Cluster(tmp_path, names=("r1", "r2"))
    try:
        c.reconfigure("r1", ["r2"])
        for i in range(8):
            c.write([put_op("u", "s%d" % i, b"v%d" % i)])
        r4 = c.add("r4", tmp_path)
        upgraded = []
        c.primary.on_learn_completed = upgraded.append
        c.primary.add_learner("r4")
        c.loop.run_until_idle()
        assert upgraded == ["r4"]
        c.reconfigure("r1", ["r2", "r4"])
        c.write([put_op("u", "after", b"learn")])
        c.primary.broadcast_group_check()
        c.loop.run_until_idle()
        assert r4.status == PartitionStatus.SECONDARY
        assert r4.server.on_get(k("u", "s5")) == (0, b"v5")
        assert r4.server.on_get(k("u", "after")) == (0, b"learn")
    finally:
        c.close()


def test_learner_catchup_via_checkpoint(tmp_path):
    c = Cluster(tmp_path, names=("r1", "r2"))
    try:
        c.reconfigure("r1", ["r2"])
        for i in range(10):
            c.write([put_op("u", "s%02d" % i, b"v%d" % i)])
        c.primary.flush_and_gc_log()
        assert c.primary.log.read_range(1) == []
        for i in range(10, 14):
            c.write([put_op("u", "s%02d" % i, b"v%d" % i)])
        r4 = c.add("r4", tmp_path)
        c.primary.add_learner("r4")
        c.loop.run_until_idle()
        c.reconfigure("r1", ["r2", "r4"])
        c.write([put_op("u", "after", b"ckpt")])
        c.primary.broadcast_group_check()
        c.loop.run_until_idle()
        for i in range(14):
            assert r4.server.on_get(k("u", "s%02d" % i)) == (
                0, b"v%d" % i), i
        assert r4.server.on_get(k("u", "after")) == (0, b"ckpt")
        # the learned checkpoint's engine serves where the group does
        assert r4.server.engine.device == torch.device("cpu")
    finally:
        c.close()


def test_secondary_gap_detected_and_reported(tmp_path):
    c = Cluster(tmp_path)
    try:
        errors = []
        c.primary.on_replication_error = lambda src, d: errors.append(src)
        c.net.set_drop(1.0, src="r1", dst="r3")
        c.write([put_op("u", "s1", b"v1")])
        c.net.set_drop(0.0, src="r1", dst="r3")
        c.write([put_op("u", "s2", b"v2")])
        assert errors == ["r3"]
        c.reconfigure("r1", ["r2"])
        c.loop.run_until_idle()
        assert c.primary.last_committed_decree == 2
    finally:
        c.close()


def test_replica_restart_recovers_from_log(tmp_path):
    c = Cluster(tmp_path, names=("r1", "r2"))
    try:
        c.reconfigure("r1", ["r2"])
        for i in range(6):
            c.write([put_op("u", "s%d" % i, b"v%d" % i)])
        c.primary.broadcast_group_check()
        c.loop.run_until_idle()
        lc = c.replicas["r2"].last_committed_decree
        c.replicas["r2"].close()
        r2 = c.add("r2", tmp_path)
        assert r2.last_committed_decree == lc
        r2.assign_config(c.config)
        c.write([put_op("u", "post", b"restart")])
        c.primary.broadcast_group_check()
        c.loop.run_until_idle()
        assert r2.server.on_get(k("u", "post")) == (0, b"restart")
        assert r2.server.on_get(k("u", "s2")) == (0, b"v2")
    finally:
        c.close()


def test_deposed_primary_cannot_commit_divergent_content(tmp_path):
    c = Cluster(tmp_path)
    try:
        c.write([put_op("u", "s0", b"v0")])
        c.replicas["r2"].assign_config(ReplicaConfig(2, "r2", ["r3"]))
        c.replicas["r3"].assign_config(ReplicaConfig(2, "r2", ["r3"]))
        c.loop.run_until_idle()
        c.replicas["r2"].client_write([put_op("u", "key", b"NEW")])
        c.loop.run_until_idle()
        r1 = c.replicas["r1"]
        before = r1.last_committed_decree
        r1.client_write([put_op("u", "key", b"OLD")])
        c.loop.run_until_idle()
        assert r1.last_committed_decree == before
        c.replicas["r2"].broadcast_group_check()
        c.loop.run_until_idle()
        assert c.replicas["r3"].server.on_get(k("u", "key")) == (0, b"NEW")
    finally:
        c.close()


def test_lost_ack_recovered_by_group_check(tmp_path):
    c = Cluster(tmp_path)
    try:
        c.net.set_drop(1.0, src="r2", dst="r1")
        c.write([put_op("u", "s", b"v")])
        assert c.primary.last_committed_decree == 0  # stuck
        c.net.set_drop(0.0, src="r2", dst="r1")
        c.primary.broadcast_group_check()
        c.loop.run_until_idle()
        assert c.primary.last_committed_decree == 1
    finally:
        c.close()


def test_learner_tolerates_prepare_before_learn_completes(tmp_path):
    c = Cluster(tmp_path, names=("r1", "r2"))
    try:
        c.reconfigure("r1", ["r2"])
        for i in range(4):
            c.write([put_op("u", "s%d" % i, b"v%d" % i)])
        r4 = c.add("r4", tmp_path)
        errors = []
        c.primary.on_replication_error = lambda s, d: errors.append(s)
        c.primary.add_learner("r4")
        c.primary.client_write([put_op("u", "race", b"x")])
        c.loop.run_until_idle()
        assert errors == []
        c.reconfigure("r1", ["r2", "r4"])
        c.write([put_op("u", "final", b"y")])
        c.primary.broadcast_group_check()
        c.loop.run_until_idle()
        assert r4.server.on_get(k("u", "race")) == (0, b"x")
        assert r4.server.on_get(k("u", "s2")) == (0, b"v2")
    finally:
        c.close()


def test_deterministic_schedules_replay_identically(tmp_path):
    def run(seed, path):
        c = Cluster(path, seed=seed)
        try:
            for i in range(5):
                c.write([put_op("u", "s%d" % i, b"v%d" % i)])
            c.primary.broadcast_group_check()
            c.loop.run_until_idle()
            return (c.net.delivered, c.loop.now,
                    [r.last_committed_decree
                     for r in c.replicas.values()])
        finally:
            c.close()

    a = run(42, tmp_path / "a")
    b = run(42, tmp_path / "b")
    assert a == b
    d = run(43, tmp_path / "c")
    assert d[2] == a[2]  # same outcome
    assert d[1] != a[1]  # different schedule timing


def test_write_queue_batches_behind_inflight_window(tmp_path):
    c = Cluster(tmp_path)
    try:
        c.net.set_drop(1.0, src="r3", dst="r1")
        results = []
        for i in range(6):
            c.primary.client_write(
                [put_op("u", "s%d" % i, b"v%d" % i)],
                lambda r, i=i: results.append((i, r)))
        c.loop.run_until_idle()
        assert len(c.primary._pending_acks) == 2
        assert sum(n for n, _cb in c.primary._write_queue) == 4
        assert results == []
        c.net.set_drop(0.0, src="r3", dst="r1")
        c.primary.broadcast_group_check()
        c.loop.run_until_idle()
        c.primary.broadcast_group_check()
        c.loop.run_until_idle()
        assert sorted(i for i, _r in results) == list(range(6))
        for i in range(6):
            err, v = c.primary.server.on_get(
                generate_key(b"u", b"s%d" % i))
            assert (err, v) == (0, b"v%d" % i)
    finally:
        c.close()


# ---- the SimCluster-free cases of tests/test_write_coordinator.py ---------


def mk_mu(decree, ballot=1, ts=None):
    return Mutation(ballot=ballot, decree=decree,
                    last_committed=decree - 1,
                    timestamp_us=ts or (1_000_000 + decree),
                    ops=[WriteOp(OP_PUT,
                                 (k(b"h%d" % decree, b"s"),
                                  b"v%d" % decree, 0))])


def test_framed_log_roundtrip_and_torn_tail():
    payloads = [b"alpha", b"", b"x" * 1000]
    data = b"".join(pack_frame(p) for p in payloads)
    assert [p for p, _e in iter_frames(data)] == payloads
    assert scan_valid_end(data) is None
    torn = data + pack_frame(b"tail")[:-3]
    assert [p for p, _e in iter_frames(torn)] == payloads
    assert scan_valid_end(torn) == len(data)
    corrupt = bytearray(data)
    corrupt[10] ^= 0xFF
    assert [p for p, _e in iter_frames(bytes(corrupt))] == []
    assert scan_valid_end(bytes(corrupt)) == 0


def test_mutation_log_append_batch_matches_solo(tmp_path):
    solo = MutationLog(str(tmp_path / "solo" / "m.bin"))
    batch = MutationLog(str(tmp_path / "batch" / "m.bin"))
    mus = [mk_mu(d) for d in (1, 2, 3)]
    for mu in mus:
        solo.append(mu)
    batch.append_batch(mus)
    solo.close()
    batch.close()
    with open(solo.path, "rb") as f:
        a = f.read()
    with open(batch.path, "rb") as f:
        b = f.read()
    assert a == b
    assert batch.max_decree == 3
    assert [m.decree for m in MutationLog.replay(batch.path)] == [1, 2, 3]


def test_buffered_append_visible_to_readers(tmp_path):
    log = MutationLog(str(tmp_path / "m.bin"))
    log.append(mk_mu(1), flush=False)
    assert [m.decree for m in log.read_range(1)] == [1]
    log.append(mk_mu(2), flush=False)
    tail = log.read_tail(0)
    assert [m.decree for m, _off in tail] == [1, 2]
    log.close()


def test_crash_mid_group_commit_window_loses_only_unacked(tmp_path):
    path = str(tmp_path / "m.bin")
    log = MutationLog(path)
    for d in (1, 2, 3):
        log.append(mk_mu(d), flush=False)
    log.commit_window(sync=True)  # window 1 hardened: acks released
    for d in (4, 5):
        log.append(mk_mu(d), flush=False)  # window 2 never commits
    with open(path, "rb") as f:
        disk = f.read()
    crash = str(tmp_path / "crash.bin")
    with open(crash, "wb") as f:
        f.write(disk + pack_frame(mk_mu(6).encode())[:-4])
    recovered = MutationLog(crash)
    assert [m.decree for m in recovered.replay(crash)] == [1, 2, 3]
    recovered.append(mk_mu(7))
    assert [m.decree for m in recovered.replay(crash)] == [1, 2, 3, 7]
    recovered.close()
    log._f = open(os.devnull, "ab")  # drop the dead buffer for teardown
    log.close()


def single_replica(tmp_path, name="r1"):
    loop = SimLoop(seed=0)
    net = SimNetwork(loop)
    r = new_replica(name, tmp_path / name, net, loop)
    net.register(name, r.on_message)
    return loop, net, r


def test_ack_released_only_after_window_commit(tmp_path):
    loop, net, r = single_replica(tmp_path)
    r.assign_config(ReplicaConfig(1, "r1", []))
    window = WriteFlushWindow(net, "r1",
                              METRICS.entity("write", "test-ack"))
    r.plog_sink = window
    events = []
    orig_commit = r.log.commit_window
    r.log.commit_window = lambda sync=False: (
        events.append("commit"), orig_commit(sync))[1]
    with window:
        r.client_write([WriteOp(OP_PUT, (k(b"h", b"s"), b"v", 0))],
                       lambda res: events.append("ack"))
        events.append("staged")
    assert events == ["staged", "commit", "ack"]
    events.clear()
    r.client_write([WriteOp(OP_PUT, (k(b"h", b"s2"), b"v2", 0))],
                   lambda res: events.append("ack"))
    assert events == ["ack"]
    r.close()


def test_restart_recovers_acked_writes_with_stale_engine_wal(tmp_path):
    loop, net, r = single_replica(tmp_path)
    r.assign_config(ReplicaConfig(1, "r1", []))
    window = WriteFlushWindow(net, "r1",
                              METRICS.entity("write", "test-crash"))
    r.plog_sink = window
    acked = []
    with window:
        for i in range(8):
            r.client_write(
                [WriteOp(OP_PUT, (k(b"h%d" % i, b"s"), b"v%d" % i, 0))],
                lambda res, i=i: acked.append(i))
    assert acked == list(range(8))
    crash_dir = tmp_path / "crash"
    shutil.copytree(tmp_path / "r1", crash_dir)
    r2 = new_replica("r1", crash_dir, net, loop)
    assert r2.server.engine.last_committed_decree < 8
    r2.assign_config(ReplicaConfig(2, "r1", []))
    assert r2.ready_to_serve()
    assert r2.last_committed_decree == 8
    for i in range(8):
        err, v = r2.server.on_get(k(b"h%d" % i, b"s"))
        assert (err, v) == (0, b"v%d" % i)
    r2.close()
    r.close()


def test_write_queue_overload_raises_typed_busy(tmp_path):
    loop, net, r = single_replica(tmp_path)
    r.assign_config(ReplicaConfig(1, "r1", ["ghost1", "ghost2"]))
    for i in range(r.PIPELINE_DEPTH):
        assert r.client_write(
            [WriteOp(OP_PUT, (k(b"h%d" % i, b"s"), b"v", 0))]) > 0
    with pytest.raises(ReplicaBusyError):
        r.client_write([WriteOp(OP_INCR,
                                IncrRequest(k(b"c", b"s"), 1, 0))])
    batch = [WriteOp(OP_PUT, (k(b"q", b"s%03d" % i), b"v", 0))
             for i in range(r.MAX_BATCH_OPS)]
    assert r.client_write(batch) == -1
    with pytest.raises(ReplicaBusyError):
        r.client_write([WriteOp(OP_PUT, (k(b"q2", b"s"), b"v", 0))])
    r.close()


# ---- the port's own contracts ---------------------------------------------


def test_replica_serves_on_the_card_by_default(tmp_path, monkeypatch):
    """`device=None` means the card: without CUDA the replica raises
    before it opens anything; `device="cpu"` serves on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    loop = SimLoop(seed=0)
    net = SimNetwork(loop)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Replica("r1", str(tmp_path / "r1"), net)
    r = Replica("r2", str(tmp_path / "r2"), net, device="cpu")
    assert r.server.device == torch.device("cpu")
    assert r.server.engine.device == torch.device("cpu")
    r.close()


@pytest.mark.parametrize("mode", ["flush", "fsync"])
def test_wal_flush_under_window_matches_jax(tmp_path, mode):
    """One replica alone under a group-commit window applies with
    `wal_flush=False`: the engine WAL's frames ride the IO buffer, so the
    on-disk WAL lags; both packages leave the same bytes on disk, and the
    same bytes after close()."""
    out = []
    for pkg in (JAX, PORT):
        loop = pkg.Loop(seed=0)
        net = pkg.Net(loop)
        rdir = tmp_path / pkg.name
        r = pkg.replica("r1", rdir, net, loop)
        net.register("r1", r.on_message)
        r.assign_config(pkg.Config(1, "r1", []))
        pkg.flags.set("pegasus.replica", "plog_sync_mode", mode, force=True)
        window = pkg.Window(net, "r1", pkg.metrics.entity(
            "write", f"test-walflush-{pkg.name}"))
        r.plog_sink = window
        acks = []
        with window:
            for i in range(6):
                r.client_write([pkg.WriteOp(OP_PUT, (
                    k(b"h%d" % i, b"s"), b"v%d" % i * 30, 0))], acks.append)
        wal = rdir / "app" / "wal.log"
        on_disk = wal.read_bytes()
        plog = (rdir / "plog" / "mlog.bin").read_bytes()
        # outside a window the same writes flush per decree
        r.client_write([pkg.WriteOp(OP_PUT, (k(b"x", b"s"), b"y", 0))])
        after = wal.read_bytes()
        r.close()
        out.append((acks, on_disk, plog, after, wal.read_bytes()))
    assert out[0] == out[1]
    acks, on_disk, _plog, after, closed = out[1]
    assert acks == [[0]] * 6
    assert len(on_disk) < len(closed) and after == closed


@pytest.mark.parametrize("wal_flush", [True, False])
def test_apply_items_wal_flush_matches_jax(tmp_path, wal_flush):
    """`WriteService.apply_items(..., wal_flush=)` down to
    `Wal.append_batch(flush=)`: the same on-disk WAL bytes in both
    packages after every decree, and the same after close()."""
    from pegasus_tpu.storage import engine as jeng
    from pegasus_tpu_torch.storage import engine as teng

    svcs = [jws.WriteService(jeng.StorageEngine(
                str(tmp_path / "j"), values_carry_expire_header=True)),
            tws.WriteService(teng.StorageEngine(
                str(tmp_path / "t"), values_carry_expire_header=True,
                device="cpu"))]
    wals = [tmp_path / d / "wal.log" for d in ("j", "t")]
    for decree in range(1, 9):
        for svc in svcs:
            rows = [(k(b"h%d" % decree, b"s%d" % i), b"v" * (9 * i), 0)
                    for i in range(decree)]
            svc.apply_items(svc.translate_put_run(
                rows, 1_790_000_000_000_000 + decree), decree,
                wal_flush=wal_flush)
        on_disk = [w.read_bytes() for w in wals]
        assert on_disk[0] == on_disk[1], decree
        assert (len(on_disk[1]) > 0) == wal_flush
    for svc in svcs:
        svc.engine.close()
    closed = [w.read_bytes() for w in wals]
    assert closed[0] == closed[1] and len(closed[1]) > 0


# ---- the differential run: a JAX group and a port group -------------------


@dataclasses.dataclass
class Pkg:
    name: str
    Loop: type
    Net: type
    Config: type
    Window: type
    WriteOp: type
    types: object
    msg: object
    flags: object
    metrics: object
    sst: object
    app_id: int

    def replica(self, name, path, net, loop):
        kw = {} if self.name == "jax" else {"device": "cpu"}
        cls = JReplica if self.name == "jax" else Replica
        return cls(name, str(path), net, app_id=self.app_id,
                   clock=lambda: CLOCK_BASE + loop.now, **kw)


# app ids no other test uses: the JAX servers register process-wide
# metric entities under them
JAX = Pkg("jax", JLoop, JNet, JConfig, JWindow, JWriteOp, jtypes, jmsg,
          JFLAGS, jmetrics.METRICS, jsst, 9121)
PORT = Pkg("port", SimLoop, SimNetwork, ReplicaConfig, WriteFlushWindow,
           WriteOp, ttypes, tmsg, TFLAGS, tmetrics.METRICS, tsst, 9121)


class Clock:
    """Stands in for a module's `time`: `time()` is frozen at `t`."""

    def __init__(self, t: float) -> None:
        self.t = t

    def time(self) -> float:
        return self.t

    def __getattr__(self, name):
        return getattr(time, name)


def _seeded_ops(pkg, rng_seed, n, prefix):
    """`n` client writes of the package: batches of puts (some with a
    TTL running, some expired), removes, multi_put / multi_remove and
    incr, drawn from one seed."""
    import numpy as np

    rng = np.random.default_rng(rng_seed)
    t = pkg.types
    now = int(T0) - jvs.PEGASUS_EPOCH_BEGIN
    writes = []
    for i in range(n):
        hk = b"%s%02d" % (prefix, int(rng.integers(0, 12)))
        kind = int(rng.integers(0, 5))
        if kind == 0:
            ops = []
            for j in range(int(rng.integers(1, 6))):
                ets = int(rng.choice([0, 0, now + 1000, now - 10]))
                ops.append(pkg.WriteOp(OP_PUT, (
                    k(hk, b"s%d" % int(rng.integers(0, 9))),
                    b"v%d-%d" % (i, j) * int(rng.integers(1, 40)), ets)))
        elif kind == 1:
            ops = [pkg.WriteOp(OP_REMOVE, (
                k(hk, b"s%d" % int(rng.integers(0, 9))),))]
        elif kind == 2:
            ops = [pkg.WriteOp(OP_MULTI_PUT, t.MultiPutRequest(hk, [
                t.KeyValue(b"m%d" % j, b"mv%d" % i)
                for j in range(int(rng.integers(1, 5)))],
                int(rng.choice([0, 0, 500]))))]
        elif kind == 3:
            ops = [pkg.WriteOp(OP_MULTI_REMOVE, t.MultiRemoveRequest(
                hk, [b"m0", b"s1"]))]
        else:
            ops = [pkg.WriteOp(OP_INCR, t.IncrRequest(
                k(hk, b"cnt"), int(rng.integers(-5, 50)), 0))]
        writes.append(ops)
    return writes


def _wire(pkg, obj):
    return pkg.msg.encode_message("a", "b", "t", obj)


def _sst_digests(pkg, server):
    """sha256 of every SST file of a replica's store: data blocks and
    sidecars byte for byte, the index without the compaction's
    wall-clock finish stamp."""
    sst = os.path.join(server.engine.data_dir, "sst")
    out = {}
    for name in sorted(os.listdir(sst)):
        if not name.endswith(".sst"):
            continue
        data = open(os.path.join(sst, name), "rb").read()
        index_offset, index_size, _crc, magic = pkg.sst.FOOTER.unpack(
            data[-pkg.sst.FOOTER.size:])
        index = json.loads(data[index_offset:index_offset + index_size])
        index["meta"].pop("manual_compact_finish_time", None)
        h = hashlib.sha256(data[:index_offset])
        h.update(json.dumps(index, sort_keys=True).encode() + magic)
        out[name] = h.hexdigest()
    return out


class Group:
    """A three-replica group of one package over its SimLoop, every
    replica with its own group-commit window around each dispatch when
    `windows` (as a replica stub opens one)."""

    def __init__(self, pkg, root, windows):
        self.pkg = pkg
        self.root = root
        self.windows = windows
        self.loop = pkg.Loop(seed=5)
        self.net = pkg.Net(self.loop)
        self.net.set_delay(0.003, src="r1", dst="r3")
        self.net.set_duplicate(0.3, src="r2", dst="r1")
        self.replicas = {}
        self.sinks = {}
        for name in ("r1", "r2", "r3"):
            self.add(name)
        self.ballot = 1
        self.config = pkg.Config(1, "r1", ["r2", "r3"])
        for r in self.replicas.values():
            r.assign_config(self.config)

    def add(self, name):
        pkg = self.pkg
        r = pkg.replica(name, self.root / name, self.net, self.loop)
        self.replicas[name] = r
        if not self.windows:
            self.net.register(name, r.on_message)
            return r
        w = pkg.Window(self.net, name, pkg.metrics.entity(
            "write", f"test-diff-{pkg.name}-{name}"))
        r.plog_sink = w
        self.sinks[name] = w

        def dispatch(src, msg_type, payload, r=r, w=w):
            with w:
                r.on_message(src, msg_type, payload)

        self.net.register(name, dispatch)
        return r

    @property
    def primary(self):
        return self.replicas[self.config.primary]

    def reconfigure(self, primary, secondaries):
        self.ballot += 1
        self.config = self.pkg.Config(self.ballot, primary, list(secondaries))
        for r in self.replicas.values():
            r.assign_config(self.config)
        self.loop.run_until_idle()

    def write(self, ops):
        acks = []
        p = self.primary
        w = self.sinks.get(p.name)
        if w is not None:
            with w:
                decree = p.client_write(ops, acks.append)
        else:
            decree = p.client_write(ops, acks.append)
        self.loop.run_until_idle()
        # acks a lossy link dropped: the group check re-sends the
        # pending prepares until every member has acked
        for _ in range(20):
            if not p._pending_acks:
                break
            self.check()
        return decree, [_wire(self.pkg, a) for a in acks]

    def check(self):
        self.primary.broadcast_group_check()
        self.loop.run_until_idle()

    def state(self):
        """Everything the two packages must agree on, replica by
        replica: decrees, plog bytes, on-disk engine-WAL bytes and the
        whole range scanned as wire bytes."""
        out = {}
        for name, r in sorted(self.replicas.items()):
            if name in self.dead:
                continue
            app = os.path.join(r.data_dir, "app")
            wal = os.path.join(app, "wal.log")
            plog = os.path.join(r.data_dir, "plog", "mlog.bin")
            req = self.pkg.types.GetScannerRequest(
                start_key=b"", batch_size=10_000, one_page=True)
            out[name] = (
                r.last_committed_decree, r.last_prepared_decree(),
                r.server.engine.last_committed_decree,
                open(plog, "rb").read() if os.path.exists(plog) else None,
                open(wal, "rb").read() if os.path.exists(wal) else None,
                _wire(self.pkg, r.server.on_get_scanner(req)))
        return out

    dead = ()

    def close(self):
        for r in self.replicas.values():
            r.close()


def _drive(pkg, root, windows):
    """The differential run on one package: what `_record` captures at
    each step, in order."""
    g = Group(pkg, root, windows)
    rec = []
    try:
        writes = _seeded_ops(pkg, 11, 40, b"u")
        # drop half of r3's acks for a while: the group check recovers
        g.net.set_drop(0.5, src="r3", dst="r1")
        for i, ops in enumerate(writes):
            rec.append(("write", i, g.write(ops)))
            if i % 9 == 8:
                g.check()
        g.net.set_drop(0.0, src="r3", dst="r1")
        g.check()
        g.check()
        rec.append(("commit", g.state()))
        # flush the memtables to SSTs, then a manual compaction each
        for r in g.replicas.values():
            r.flush_and_gc_log()
        rec.append(("flush", {n: _sst_digests(pkg, r.server)
                              for n, r in sorted(g.replicas.items())}))
        for r in g.replicas.values():
            r.server.manual_compact()
        rec.append(("compact", {n: _sst_digests(pkg, r.server)
                                for n, r in sorted(g.replicas.items())},
                    g.state()))
        # failover: r1 dies, r2 is promoted with a higher ballot
        g.net.partition("r1")
        g.dead = ("r1",)
        g.reconfigure("r2", ["r3"])
        for i, ops in enumerate(_seeded_ops(pkg, 12, 12, b"f")):
            rec.append(("failover-write", i, g.write(ops)))
        g.check()
        rec.append(("failover", g.state()))
        # a learner by log: the new primary's plog covers its gap
        g.add("r4")
        done = []
        g.primary.on_learn_completed = done.append
        g.primary.add_learner("r4")
        g.loop.run_until_idle()
        g.reconfigure("r2", ["r3", "r4"])
        rec.append(("learn-log", done, g.write(_seeded_ops(
            pkg, 13, 1, b"l")[0]), g.state()))
        # a learner by checkpoint: the log is GC'd below the flushed decree
        g.primary.flush_and_gc_log()
        for i, ops in enumerate(_seeded_ops(pkg, 14, 4, b"c")):
            rec.append(("ckpt-write", i, g.write(ops)))
        g.add("r5")
        g.primary.add_learner("r5")
        g.loop.run_until_idle()
        g.reconfigure("r2", ["r3", "r4", "r5"])
        rec.append(("learn-ckpt", g.write(_seeded_ops(
            pkg, 15, 1, b"z")[0])))
        g.check()
        state = g.state()
        # the learned checkpoint replaced r5's files: its plog and WAL
        # are its own, the served range is the group's
        rec.append(("learn-ckpt-state", state))
        rec.append(("delivered", g.net.delivered, g.net.dropped))
        return rec, state
    finally:
        g.close()


@pytest.mark.parametrize("windows", [False, True],
                         ids=["no-window", "window"])
def test_replica_group_matches_jax(tmp_path, monkeypatch, windows):
    clk = Clock(T0)
    for mod in (jvs, tvs, jws, tws):
        monkeypatch.setattr(mod, "time", clk)
    jrec, jstate = _drive(JAX, tmp_path / "jax", windows)
    trec, tstate = _drive(PORT, tmp_path / "port", windows)
    assert len(jrec) == len(trec)
    for a, b in zip(jrec, trec):
        assert a == b, a[0]
    # every live replica serves the same range, and the run really
    # replicated, failed over and learned
    scans = {v[-1] for v in tstate.values()}
    assert len(scans) == 1 and set(tstate) == {"r2", "r3", "r4", "r5"}
    decrees = {v[0] for v in tstate.values()}
    assert len(decrees) == 1 and decrees.pop() > 50


def _ingest_drive(pkg, root, stage):
    """A group's OP_INGESTs through the primary's 2PC, then one logged
    at a secondary: what each step leaves."""
    from pegasus_tpu.server.bulk_load import BULK_LOAD_FILE

    g = Group(pkg, root, windows=False)
    rec = []
    try:
        for i, ops in enumerate(_seeded_ops(pkg, 3, 12, b"b")):
            rec.append(("write", i, g.write(ops)))
        ingest = pkg.WriteOp(OP_INGEST, (str(stage), "app", 7))
        rec.append(("ingest", g.write([ingest]), g.state()))
        # a replayed load: re-acked, the decree stamped, nothing re-read
        rec.append(("again", g.write([ingest]), g.state()))
        g.write([pkg.WriteOp(OP_REMOVE, (k(b"bl003", b"s"),))])
        g.write([pkg.WriteOp(OP_INGEST, (str(stage), "app", 7))])
        g.check()
        rec.append(("no-resurrection", g.state()))
        # a load whose staged file vanished still stamps the decree
        os.remove(os.path.join(str(stage), "gone", "0", BULK_LOAD_FILE))
        rec.append(("vanished", g.write([pkg.WriteOp(
            OP_INGEST, (str(stage), "gone", 8))]), g.state()))
        # a logged OP_INGEST applied at a secondary (a log replayed)
        r2 = g.replicas["r2"]
        decree = r2.last_committed_decree + 1
        mu_cls = type(r2.log.read_range(1)[0])
        mu = mu_cls(ballot=g.ballot, decree=decree, last_committed=decree - 1,
                    timestamp_us=1_000_000,
                    ops=[pkg.WriteOp(OP_INGEST, (str(stage), "app", 9))])
        r2._apply_mutation(mu)
        rec.append(("logged", r2.server.engine.last_committed_decree,
                    r2.has_ingested(9), g.state()["r2"]))
        return rec
    finally:
        g.close()


def test_logged_ingest_matches_jax(tmp_path, monkeypatch):
    """OP_INGEST through a JAX three-replica group and a port group: the
    staged SST is ingested at one decree on every member (the memtable
    flushed first); a replayed load re-acks without re-ingesting, so a
    key deleted after the load stays deleted; a load whose staged file
    vanished still stamps its decree; a logged ingest mutation applied
    at a secondary ingests there. Decrees, acks, plog and WAL bytes and
    every replica's scan (wire bytes) equal at each step."""
    from pegasus_tpu.server.bulk_load import SSTGenerator
    from pegasus_tpu.storage.block_service import LocalBlockService

    clk = Clock(T0)
    for mod in (jvs, tvs, jws, tws):
        monkeypatch.setattr(mod, "time", clk)
    stage = tmp_path / "stage"
    for app in ("app", "gone"):
        SSTGenerator(LocalBlockService(str(stage)), app, 1).generate(
            [(b"bl%03d" % i, b"s", b"ingested-%d" % i, 0)
             for i in range(50)])
    jrec = _ingest_drive(JAX, tmp_path / "jax", stage)
    SSTGenerator(LocalBlockService(str(stage)), "gone", 1).generate(
        [(b"bl%03d" % i, b"s", b"ingested-%d" % i, 0) for i in range(50)])
    trec = _ingest_drive(PORT, tmp_path / "port", stage)
    assert len(jrec) == len(trec)
    for a, b in zip(jrec, trec):
        assert a == b, a[0]
    steps = {r[0]: r for r in trec}
    state = steps["no-resurrection"][1]["r1"]
    assert b"bl003" not in state[-1] and b"bl004" in state[-1]
    assert steps["logged"][2] is True
