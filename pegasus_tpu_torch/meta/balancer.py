"""Load balancer: even out primaries and replicas across nodes.

Parity: src/meta/greedy_load_balancer.h:46 + load_balance_policy /
app_balance_policy / cluster_balance_policy.h:47. The reference computes
primary placements with a ford-fulkerson max-flow and greedy copy moves;
this implementation keeps the same two proposal kinds with a greedy
matcher:

- MOVE_PRIMARY: demote the primary on an overloaded node in favour of an
  existing secondary on an underloaded node (a ballot-bump config
  change — no data movement).
- COPY_SECONDARY: relocate a secondary from an overloaded node to an
  underloaded one (data movement through the learner flow).

Proposals are pure data; MetaService.rebalance applies them.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Tuple

Gpid = Tuple[int, int]


@dataclass
class BalanceProposal:
    kind: str                  # "move_primary" | "copy_secondary"
    gpid: Gpid
    from_node: str
    to_node: str


def _counts(configs: Dict[Gpid, "PartitionConfig"], nodes: List[str]):
    primaries = {n: 0 for n in nodes}
    replicas = {n: 0 for n in nodes}
    for pc in configs.values():
        if pc.primary in primaries:
            primaries[pc.primary] += 1
        for s in [pc.primary] + list(pc.secondaries):
            if s in replicas:
                replicas[s] += 1
    return primaries, replicas


def propose_primary_moves(configs: Dict[Gpid, "PartitionConfig"],
                          nodes: List[str]) -> List[BalanceProposal]:
    """Greedy primary balancing: while the spread exceeds 1, shift one
    primary from the most-loaded node to a least-loaded node that already
    holds a secondary of that partition (zero-copy move)."""
    if not nodes:
        return []
    primaries, _ = _counts(configs, nodes)
    proposals: List[BalanceProposal] = []
    moved = set()
    while True:
        hi = max(primaries, key=lambda n: primaries[n])
        lo = min(primaries, key=lambda n: primaries[n])
        if primaries[hi] - primaries[lo] <= 1:
            break
        candidate = None
        for gpid, pc in sorted(configs.items()):
            if gpid in moved:
                continue
            if pc.primary == hi and lo in pc.secondaries:
                candidate = gpid
                break
        if candidate is None:
            break
        proposals.append(BalanceProposal("move_primary", candidate, hi, lo))
        moved.add(candidate)
        primaries[hi] -= 1
        primaries[lo] += 1
    return proposals


def propose_secondary_moves(configs: Dict[Gpid, "PartitionConfig"],
                            nodes: List[str]) -> List[BalanceProposal]:
    """Greedy replica-count balancing: move a secondary off the most
    replica-loaded node onto the least-loaded node not already hosting
    the partition."""
    if not nodes:
        return []
    _, replicas = _counts(configs, nodes)
    proposals: List[BalanceProposal] = []
    moved = set()
    while True:
        lo = min(replicas, key=lambda n: replicas[n])
        # donor: the most replica-loaded node that actually has a movable
        # secondary for a partition not already on `lo` (the global max
        # may hold only primaries, which don't copy-move)
        candidate = None
        for donor in sorted(replicas, key=lambda n: -replicas[n]):
            if replicas[donor] - replicas[lo] <= 1:
                break
            for gpid, pc in sorted(configs.items()):
                if gpid in moved:
                    continue
                if donor in pc.secondaries and lo not in pc.members():
                    candidate = (gpid, donor)
                    break
            if candidate is not None:
                break
        if candidate is None:
            break
        gpid, donor = candidate
        proposals.append(BalanceProposal("copy_secondary", gpid, donor, lo))
        moved.add(gpid)
        replicas[donor] -= 1
        replicas[lo] += 1
    return proposals


# ---- max-flow primary placement (parity: greedy_load_balancer.h:46 —
# ford-fulkerson primary balancing; meta/test/ford_fulkerson_test.cpp) ----


def _max_flow(n: int, cap: List[List[int]], s: int, t: int) -> List[List[int]]:
    """Edmonds-Karp over an adjacency-matrix network; returns the flow
    matrix."""
    flow = [[0] * n for _ in range(n)]
    while True:
        # BFS for an augmenting path in the residual graph
        parent = [-1] * n
        parent[s] = s
        queue = [s]
        while queue and parent[t] == -1:
            u = queue.pop(0)
            for v in range(n):
                if parent[v] == -1 and cap[u][v] - flow[u][v] > 0:
                    parent[v] = u
                    queue.append(v)
        if parent[t] == -1:
            return flow
        # bottleneck along the path
        path = []
        v = t
        while v != s:
            path.append((parent[v], v))
            v = parent[v]
        bottleneck = min(cap[u][v] - flow[u][v] for u, v in path)
        for u, v in path:
            flow[u][v] += bottleneck
            flow[v][u] -= bottleneck


def propose_primary_moves_maxflow(configs: Dict[Gpid, "PartitionConfig"],
                                  nodes: List[str]
                                  ) -> List[BalanceProposal]:
    """Primary placement as a flow problem: overloaded nodes source
    excess primaries, underloaded nodes sink them, and an edge u->v
    exists per partition whose primary sits on u with a secondary on v
    (a zero-copy move lane). Max flow finds MULTI-HOP schedules the
    greedy matcher cannot — e.g. A's movable primaries reach only B, but
    B's reach C: flow routes A->B->C and both moves ship together.
    """
    if not nodes:
        return []
    primaries, _ = _counts(configs, nodes)
    total = sum(primaries.values())
    n = len(nodes)
    t_lo = total // n
    t_hi = t_lo + (1 if total % n else 0)
    idx = {node: i + 1 for i, node in enumerate(nodes)}  # 0=src, n+1=sink
    size = n + 2
    src, sink = 0, n + 1
    cap = [[0] * size for _ in range(size)]
    # per-lane capacities: partitions whose primary=u have a secondary on v
    lanes: Dict[Tuple[str, str], List[Gpid]] = defaultdict(list)
    for gpid, pc in sorted(configs.items()):
        if pc.primary not in idx:
            continue
        for s in pc.secondaries:
            if s in idx:
                lanes[(pc.primary, s)].append(gpid)
                cap[idx[pc.primary]][idx[s]] += 1
    if max(primaries.values()) - min(primaries.values()) <= 1:
        return []  # balanced; avoid churn between equally-good layouts
    for node in nodes:
        # shed down to the floor, absorb up to the ceiling: with the
        # narrower (above-ceiling / below-floor) bands a layout like
        # [3,3,1] (t_lo=2, t_hi=3) has no sources and a 4-partition app
        # on 5 nodes (t_lo=0) has no sinks — both would stay skewed
        cap[src][idx[node]] = max(0, primaries[node] - t_lo)
        cap[idx[node]][sink] = max(0, t_hi - primaries[node])
    flow = _max_flow(size, cap, src, sink)
    proposals: List[BalanceProposal] = []
    # a partition with secondaries on SEVERAL nodes feeds several lanes
    # but can move only once per round — lanes draw from a shared pool;
    # a lane that runs dry just delivers less flow this round (the next
    # rebalance round finishes the job)
    used: set = set()
    for u in nodes:
        for v in nodes:
            f = flow[idx[u]][idx[v]]
            delivered = 0
            for gpid in lanes[(u, v)]:
                if delivered >= max(0, f):
                    break
                if gpid in used:
                    continue
                used.add(gpid)
                proposals.append(
                    BalanceProposal("move_primary", gpid, u, v))
                delivered += 1
    return proposals


def propose_app_balanced_moves(configs: Dict[Gpid, "PartitionConfig"],
                               nodes: List[str]) -> List[BalanceProposal]:
    """The policy stack (parity: app_balance_policy then
    cluster_balance_policy.h:47): balance each table's primaries with the
    max-flow placement FIRST (per-app skew is what hotspots one table),
    then even out cluster-wide replica counts with greedy copy moves."""
    proposals: List[BalanceProposal] = []
    by_app: Dict[int, Dict[Gpid, "PartitionConfig"]] = defaultdict(dict)
    for gpid, pc in configs.items():
        by_app[gpid[0]][gpid] = pc
    for app_id in sorted(by_app):
        proposals.extend(propose_primary_moves_maxflow(by_app[app_id],
                                                       nodes))
    moved = {p.gpid for p in proposals}
    remaining = {g: pc for g, pc in configs.items() if g not in moved}
    proposals.extend(propose_secondary_moves(remaining, nodes))
    return proposals
