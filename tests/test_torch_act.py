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
"""

import json
import os

import pytest

from pegasus_tpu.base import value_schema as jvs
from pegasus_tpu.meta import backup_service as jbksvc
from pegasus_tpu.runtime import act as jact
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


def trace(act, root, case: str, seed: int) -> list:
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
            storage = json.dumps(meta.storage._tree, sort_keys=True)
            out.append((lineno, verb, c.loop.now, c.net.delivered,
                        c.net.dropped, cfgs,
                        storage.replace(str(root), "<root>")))
    finally:
        runner.close()
    return out


@pytest.mark.parametrize("case", DIFF_CASES)
def test_case_trace_matches_jax(tmp_path, frozen, case):
    j = trace(jact, tmp_path / "jax", case, seed=7)
    t = trace(tact, tmp_path / "port", case, seed=7)
    assert len(j) == len(t) > 3
    for x, y in zip(j, t):
        assert x == y, f"{case}:{x[0]} {x[1]}"
    # the case created its table past the seeded app
    assert t[-1][5][1][0] == SEED_APP + 1
