"""The port's load balancer (meta/balancer.py) and meta group election
(meta/election.py) against the JAX package's, exact.

- the balancer cases of tests/test_hotkey_balancer.py, and seeded random
  clusters, give equal move lists in both packages;
- a three-meta group (`MetaService(peers=...)`) with three stubs over one
  SimNetwork elects, replicates a table, loses its leader and re-elects:
  both packages end with the same leader, term, `state_seq`, storage
  and partition configs at every step.

Every meta's storage starts with a dropped table at app id 9120 (the
tables created are 9121 and up); tests/test_torch_meta.py's
`isolated_state` removes the metric entities a test created from both
registries and puts both TENANTS clocks and GOVERNORs back.
"""

import json
import random

import numpy as np
import pytest

from pegasus_tpu.meta import balancer as jbal
from pegasus_tpu.meta.server_state import PartitionConfig as JConfig
from pegasus_tpu_torch.meta import balancer as tbal
from pegasus_tpu_torch.meta.server_state import PartitionConfig as TConfig
from tests.test_torch_meta import (  # noqa: F401  (autouse fixture)
    JAX,
    PORT,
    SEED_APP,
    isolated_state,
    seed_meta_storage,
)


BAL = ((jbal, JConfig), (tbal, TConfig))


def moves(props) -> list:
    return [(p.kind, p.gpid, p.from_node, p.to_node) for p in props]


def on_both(build, propose):
    """`propose(balancer, configs, nodes)` over the configs `build(Config)`
    makes, in both packages; the move lists must be equal."""
    out = []
    for bal, config in BAL:
        configs, nodes = build(config)
        out.append(moves(propose(bal, configs, nodes)))
    assert out[0] == out[1]
    return out[1]


def test_primary_move_proposals():
    nodes = ["n0", "n1", "n2"]
    props = on_both(
        lambda C: ({(1, i): C(1, "n0", ["n1", "n2"]) for i in range(6)},
                   nodes),
        lambda b, c, n: b.propose_primary_moves(c, n))
    assert len(props) == 4  # 6,0,0 -> 2,2,2
    assert all(k == "move_primary" and f == "n0" for k, _g, f, _t in props)
    assert on_both(
        lambda C: ({(1, i): C(1, nodes[i % 3], [nodes[(i + 1) % 3]])
                    for i in range(6)}, nodes),
        lambda b, c, n: b.propose_primary_moves(c, n)) == []


def test_secondary_move_proposals():
    nodes = ["n0", "n1", "n2", "n3"]
    props = on_both(
        lambda C: ({(1, i): C(1, "n0", ["n1", "n2"]) for i in range(4)},
                   nodes),
        lambda b, c, n: b.propose_secondary_moves(c, n))
    assert props and all(k == "copy_secondary" and t == "n3"
                         for k, _g, _f, t in props)


def test_maxflow_routes_multihop_primary_moves():
    nodes = ["A", "B", "C"]

    def build(C):
        return ({(1, 0): C(1, "A", ["B"]), (1, 1): C(1, "A", ["B"]),
                 (1, 2): C(1, "A", ["B"]), (1, 3): C(1, "B", ["C"])}, nodes)

    flow = on_both(build, lambda b, c, n: b.propose_primary_moves_maxflow(
        c, n))
    counts = {"A": 3, "B": 1, "C": 0}
    for _k, _g, f, t in flow:
        counts[f] -= 1
        counts[t] += 1
    assert max(counts.values()) - min(counts.values()) <= 1
    greedy = on_both(build, lambda b, c, n: b.propose_primary_moves(c, n))
    gcounts = {"A": 3, "B": 1, "C": 0}
    for _k, _g, f, t in greedy:
        gcounts[f] -= 1
        gcounts[t] += 1
    assert max(gcounts.values()) - min(gcounts.values()) > 1


def _simulate(seed):
    """tests/test_hotkey_balancer.py's balancer simulator on both
    packages at once: random clusters, proposals applied round after
    round, every proposal legal and the same in both. Returns the final
    per-app primary counts of each trial."""
    rng = random.Random(seed)
    out = []
    for trial in range(10):
        nodes = [f"n{i}" for i in range(rng.randint(3, 6))]
        layout = {}
        for app_id in range(1, rng.randint(2, 4)):
            for pidx in range(rng.choice([4, 8])):
                members = rng.sample(nodes, k=min(3, len(nodes)))
                layout[(app_id, pidx)] = members
        state = [{g: C(1, m[0], m[1:]) for g, m in layout.items()}
                 for _bal, C in BAL]
        for _round in range(20):
            rounds = [moves(bal.propose_app_balanced_moves(cfg, nodes))
                      for (bal, _C), cfg in zip(BAL, state)]
            assert rounds[0] == rounds[1], (trial, _round)
            if not rounds[1]:
                break
            for (_bal, C), cfg in zip(BAL, state):
                for kind, gpid, src, dst in rounds[1]:
                    pc = cfg[gpid]
                    if kind == "move_primary":
                        assert pc.primary == src and dst in pc.secondaries
                        cfg[gpid] = C(pc.ballot + 1, dst,
                                      [s for s in pc.secondaries
                                       if s != dst] + [pc.primary])
                    else:
                        assert src in pc.secondaries
                        assert dst not in pc.members()
                        cfg[gpid] = C(pc.ballot + 1, pc.primary,
                                      [s for s in pc.secondaries
                                       if s != src] + [dst])
        per_app: dict = {}
        for (app_id, _pidx), pc in state[1].items():
            per_app.setdefault(app_id, {n: 0 for n in nodes})
            per_app[app_id][pc.primary] += 1
        out.append(per_app)
    return out


def test_balancer_simulator_property():
    """The JAX case's seed: every app's primary spread settles to at
    most one."""
    for trial, per_app in enumerate(_simulate(42)):
        for app_id, counts in per_app.items():
            assert max(counts.values()) - min(counts.values()) <= 1, (
                trial, app_id, counts)


@pytest.mark.parametrize("seed", [7, 11])
def test_balancer_simulator_rounds_match(seed):
    """Other seeds: the same proposals round after round. (Seed 7 leaves
    one app at a spread of two in both packages after 20 rounds: the
    reference's balancer does not settle every layout.)"""
    assert _simulate(seed)


@pytest.mark.parametrize("seed", range(4))
def test_seeded_layouts_give_equal_moves(seed):
    rng = np.random.default_rng(seed)
    nodes = [f"n{i}" for i in range(int(rng.integers(3, 7)))]
    layout = {}
    for app_id in range(1, 4):
        for pidx in range(int(rng.choice([2, 4, 8, 16]))):
            k = int(rng.integers(1, min(3, len(nodes)) + 1))
            members = [nodes[int(i)] for i in
                       rng.choice(len(nodes), k, replace=False)]
            layout[(app_id, pidx)] = members
    for name in ("propose_primary_moves", "propose_secondary_moves",
                 "propose_primary_moves_maxflow",
                 "propose_app_balanced_moves"):
        on_both(lambda C: ({g: C(1, m[0], m[1:]) for g, m in
                            layout.items()}, nodes),
                lambda b, c, n: getattr(b, name)(c, n))


# ---- the meta group ---------------------------------------------------------


PEERS = ["m0", "m1", "m2"]


def _group(pkg, root, seed):
    loop = pkg.Loop(seed=seed)
    net = pkg.Net(loop)
    metas = []
    for name in PEERS:
        seed_meta_storage(str(root / name))
        metas.append(pkg.Meta(name, str(root / name), net,
                              lambda: loop.now, peers=PEERS))
    stubs = []
    for i in range(3):
        stub = pkg.stub(f"node{i}", root / f"node{i}", net,
                        lambda: 1_700_000_000 + loop.now)
        stub.meta_addrs = list(PEERS)
        stubs.append(stub)
    return loop, net, metas, stubs


def _election_script(pkg, root, seed):
    loop, net, metas, stubs = _group(pkg, root, seed)
    dead: set = set()
    rec = []

    def step(rounds):
        for _ in range(rounds):
            for s in stubs:
                s.send_beacon()
                s.config_sync()
            loop.run_for(3.0)
            for m in metas:
                if m.name not in dead:
                    m.tick()
        loop.run_until_idle()

    def leader():
        live = [m for m in metas if m.election.is_leader
                and m.name not in dead]
        assert len(live) == 1
        return live[0]

    def record(name):
        m = leader()
        rec.append((name, m.name, m.election.term, m.storage.seq,
                    [json.dumps(x.storage._tree, sort_keys=True)
                     for x in metas if x.name not in dead],
                    [(a.app_id, a.app_name, a.status,
                      [m.state.get_partition(a.app_id, p).to_json()
                       for p in range(a.partition_count)])
                     for a in sorted(m.state.apps.values(),
                                     key=lambda a: a.app_id)]))

    try:
        step(6)
        record("elected")
        leader().create_app("g1", partition_count=4, replica_count=3)
        step(2)
        record("replicated")
        old = leader().name
        dead.add(old)
        net.partition(old)
        step(6)
        record("re-elected")
        assert leader().name != old
        leader().create_app("g2", partition_count=2, replica_count=2)
        step(2)
        record("after")
        return rec
    finally:
        for s in stubs:
            s.close()


@pytest.mark.parametrize("seed", [0, 5])
def test_meta_group_reelects_like_jax(tmp_path, seed):
    jrec = _election_script(JAX, tmp_path / "jax", seed)
    trec = _election_script(PORT, tmp_path / "port", seed)
    assert jrec == trec
    # the port re-elected a new leader at a higher term, and every live
    # member holds both tables
    assert trec[2][1] != trec[1][1] and trec[2][2] > trec[1][2]
    apps = {a[1] for a in trec[-1][5]}
    assert {"g1", "g2"} <= apps
    assert min(a[0] for a in trec[-1][5]) == SEED_APP
