"""The port's scripted-case runner (runtime/act.py) on the CPU.

- the cases of tests/test_act_cases.py, run on the port (`load_spec`):
  all 46 tests/cases/*.act files on the port's ActRunner, determinism,
  a failing assertion surfacing, and the fault-600 cases at three more
  seeds;
- a differential: a JAX ActRunner and a port ActRunner under one seed
  play the same case step by step, and after every step the simulated
  time, the messages delivered and dropped, every table's partition
  configs and the meta storage (the run's directory masked) are equal.
  The cases: message loss, a primary partitioned away, a bulk load
  across a crash, a backup and restore across a failover, a duplication
  across a failover.

Both metas' storage is seeded with a dropped table at app 9120 (no JAX
test's app entities move), and both packages' wall clocks are frozen
(value_schema, write_service and the backup service's backup ids).

The port drops a duplicate `ingest_done` (a re-ack for a partition no
longer in flight), where the JAX meta drives its bulk-load window again
and so re-sends trigger_ingest (ROADMAP §3). The JAX meta runs
unchanged; a tap counts what those drives add: the messages they send
and every message sent while one of those is handled, as delivered or
dropped, and the meta storage writes they make. The trace holds the
port to the JAX counts less the tap's. The extra messages draw their
network jitter from a stream of their own, so that the shared stream,
and with it the simulated time, stays the port's.
"""

import json
import os

import numpy as np
import pytest

from pegasus_tpu.base import value_schema as jvs
from pegasus_tpu.meta import backup_service as jbksvc
from pegasus_tpu.meta import bulk_load_service as jblsvc
from pegasus_tpu.runtime import act as jact
from pegasus_tpu.runtime import sim as jsim
from pegasus_tpu.server import write_service as jws
from pegasus_tpu_torch.base import value_schema as tvs
from pegasus_tpu_torch.meta import backup_service as tbksvc
from pegasus_tpu_torch.runtime import act as tact
from pegasus_tpu_torch.server import write_service as tws
from torch_mesh_helpers import (
    TESTS_DIR,
    Clock,
    T0,
    load_spec,
    restore_process_state,
)

SPEC = load_spec("test_act_cases.py", globals(), "act_spec")

SEED_APP = 9120
DIFF_CASES = ["case-100-rpc-loss.act", "case-105-partition-primary.act",
              "case-604-bulkload-failover.act",
              "case-602-backup-restore-failover.act",
              "case-601-dup-failover.act"]


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


class ReackTap:
    """What the JAX meta's drives on a duplicate ingest_done add to a
    SimCluster's run: `delivered` and `dropped` messages, and `writes`
    to the meta storage. Observes only, but for the jitter of the
    messages it counts (an rng of their own)."""

    def __init__(self) -> None:
        self.delivered = self.dropped = self.writes = 0
        self._depth = 0
        self._sent: list = []   # keeps each payload, and so its id, alive
        self._ids: set = set()
        self._rng = np.random.default_rng(0)

    def counts(self) -> tuple:
        return self.delivered, self.dropped, self.writes

    def install(self, monkeypatch) -> None:
        tap = self
        done = jblsvc.MetaBulkLoadService.on_ingest_done
        send = jsim.SimNetwork.send
        register = jsim.SimNetwork.register

        def on_ingest_done(svc, payload):
            info = svc._loads.get(tuple(payload["gpid"])[0])
            if (info is None or payload.get("err", 0) != 0
                    or payload["gpid"][1] in info["inflight"]):
                return done(svc, payload)
            seq = svc.meta.storage.seq
            tap._depth += 1
            try:
                return done(svc, payload)
            finally:
                tap._depth -= 1
                tap.writes += svc.meta.storage.seq - seq

        def tapped_send(net, src, dst, msg_type, payload):
            if not tap._depth:
                return send(net, src, dst, msg_type, payload)
            tap._sent.append(payload)
            tap._ids.add(id(payload))
            dropped, rng = net.dropped, net.loop.rng
            net.loop.rng = tap._rng
            try:
                return send(net, src, dst, msg_type, payload)
            finally:
                net.loop.rng = rng
                tap.dropped += net.dropped - dropped

        def tapped_register(net, addr, handler):
            def handle(src, msg_type, payload):
                if id(payload) not in tap._ids:
                    return handler(src, msg_type, payload)
                tap.delivered += 1
                tap._depth += 1
                try:
                    return handler(src, msg_type, payload)
                finally:
                    tap._depth -= 1
            return register(net, addr, handle)

        monkeypatch.setattr(jblsvc.MetaBulkLoadService, "on_ingest_done",
                            on_ingest_done)
        monkeypatch.setattr(jsim.SimNetwork, "send", tapped_send)
        monkeypatch.setattr(jsim.SimNetwork, "register", tapped_register)


def trace(act, root, case: str, seed: int, tap=None) -> list:
    meta_dir = os.path.join(str(root), "meta")
    os.makedirs(meta_dir, exist_ok=True)
    with open(os.path.join(meta_dir, "meta.json"), "w") as f:
        json.dump({f"/apps/{SEED_APP}": {
            "app_id": SEED_APP, "app_name": "__seed", "partition_count": 0,
            "status": "dropped", "envs": {}, "max_replica_count": 3}}, f)
    kw = {} if act is jact else {"device": "cpu"}
    runner = act.ActRunner(str(root), n_nodes=4, seed=seed, **kw)
    with open(os.path.join(TESTS_DIR, "cases", case)) as f:
        steps = act._parse(f.read())
    out = []
    try:
        for lineno, verb, args in steps:
            runner._step(verb, args)
            c = runner.cluster
            meta = c.meta
            cfgs = []
            for app_id in sorted(meta.state.apps):
                app = meta.state.apps[app_id]
                cfgs.append((app_id, app.app_name, app.status,
                             [meta.state.get_partition(app_id, i).to_json()
                              for i in range(app.partition_count)]))
            delivered, dropped, writes = (tap.counts() if tap is not None
                                          else (0, 0, 0))
            tree = dict(meta.storage._tree)
            if "/__meta_seq" in tree:
                tree["/__meta_seq"] -= writes
            storage = json.dumps(tree, sort_keys=True)
            out.append((lineno, verb, c.loop.now,
                        c.net.delivered - delivered, c.net.dropped - dropped,
                        cfgs, storage.replace(str(root), "<root>")))
    finally:
        runner.close()
    return out


@pytest.mark.parametrize("case", DIFF_CASES)
def test_case_trace_matches_jax(tmp_path, frozen, monkeypatch, case):
    tap = ReackTap()
    tap.install(monkeypatch)
    j = trace(jact, tmp_path / "jax", case, seed=7, tap=tap)
    t = trace(tact, tmp_path / "port", case, seed=7)
    assert len(j) == len(t) > 3
    for x, y in zip(j, t):
        assert x == y, f"{case}:{x[0]} {x[1]}"
    # the case created its table past the seeded app
    assert t[-1][5][1][0] == SEED_APP + 1
    # only the bulk load across a crash sees re-acks, and the JAX meta
    # drives again on them
    assert (tap.delivered > 0) == (case == "case-604-bulkload-failover.act")
