"""SimCluster: an in-process replicated cluster (meta + N replica nodes).

The replicated onebox: one MetaService and N ReplicaStubs wired over the
deterministic SimNetwork (parity: the reference's onebox, run.sh:60-66 —
N meta + M replica processes on one machine — collapsed into one process
with simulated transport; the multi-process deployment swaps SimNetwork
for the TCP transport without touching this wiring).

`step()` advances the cluster exactly like the real timers would: worker
beacons, meta FD check + guardian pass, message delivery. It doubles as
the ClusterClient's pump, so a client blocked on a reply keeps failure
detection and cures moving — a mid-workload failover resolves while the
client retries.

The port's cluster serves on the card: `device=None` is handed to every
ReplicaStub, whose partitions then raise where there is no CUDA; only a
caller that names the CPU (`device="cpu"`, as the tests do) gets the
plain torch path. The argument places the computation and changes no
answer.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from pegasus_tpu_torch.client.cluster_client import ClusterClient
from pegasus_tpu_torch.meta.meta_service import MetaService
from pegasus_tpu_torch.replica.stub import ReplicaStub
from pegasus_tpu_torch.runtime.sim import SimLoop, SimNetwork


class SimCluster:
    def __init__(self, data_dir: str, n_nodes: int = 3, seed: int = 0,
                 beacon_interval: float = 3.0, n_meta: int = 1,
                 auth_secret: Optional[str] = None,
                 name_prefix: str = "", loop: Optional[SimLoop] = None,
                 net: Optional[SimNetwork] = None,
                 cluster_id: int = 1, device=None) -> None:
        """`name_prefix`/`loop`/`net`/`cluster_id`: the two-cluster
        geo-replication shape — build BOTH clusters over ONE shared
        loop+network (prefixes keep their node names apart, distinct
        cluster ids keep their timetags and the duplication
        origin-echo filter honest), then fault the inter-cluster links
        like a WAN. Step the second cluster with `advance=False` so a
        pair of steps advances shared time once, not twice. `device`:
        where every node's partitions serve (None is the card)."""
        self.data_dir = data_dir
        self.device = device
        self.name_prefix = name_prefix
        self.cluster_id = cluster_id
        self.loop = loop if loop is not None else SimLoop(seed=seed)
        self.net = net if net is not None else SimNetwork(self.loop)
        self.beacon_interval = beacon_interval
        clock = lambda: self.loop.now  # noqa: E731
        if n_meta <= 1:
            self.metas = [MetaService(
                f"{name_prefix}meta",
                os.path.join(data_dir, f"{name_prefix}meta"),
                self.net, clock)]
        else:
            group = [f"{name_prefix}meta{i}" for i in range(n_meta)]
            self.metas = [MetaService(
                name, os.path.join(data_dir, name), self.net, clock,
                peers=group) for name in group]
            # deterministic initial leader: meta0 wins the first election
            self.metas[0].election._start_election()
            self.loop.run_until_idle()
        self.auth_secret = auth_secret
        self.stubs: Dict[str, ReplicaStub] = {}
        self._dead: set = set()
        self._last_step_time = 0.0
        # wall-anchored clock so value timetags / TTL math are realistic
        # while FD timing stays on deterministic sim time
        self._epoch = 1_700_000_000
        # distributed-tracing rings live on the SIM clock: span
        # timelines (and the slow-trace threshold) must see injected
        # virtual delays, not the microseconds of wall time a sim
        # schedule actually burns
        from pegasus_tpu_torch.utils import tracing

        self._trace_clock = lambda: self._epoch + self.loop.now
        self._trace_rings: List[str] = []
        for m in self.metas:
            tracing.ring_for(m.name, clock=self._trace_clock)
            self._trace_rings.append(m.name)
        for i in range(n_nodes):
            self.add_node(f"{name_prefix}node{i}")
        # settle: everyone beacons, FD learns the membership
        self.step(rounds=2)

    # ---- membership ----------------------------------------------------

    def add_node(self, name: str) -> ReplicaStub:
        from pegasus_tpu_torch.utils import tracing

        tracing.ring_for(name, clock=self._trace_clock)
        self._trace_rings.append(name)
        stub = ReplicaStub(
            name, os.path.join(self.data_dir, name), self.net,
            clock=lambda: self._epoch + self.loop.now,
            sim_clock=lambda: self.loop.now,
            cluster_id=self.cluster_id, device=self.device)
        stub.meta_addrs = [m.name for m in self.metas]
        stub.meta_addr = self.metas[0].name
        stub.auth_secret = self.auth_secret
        self.stubs[name] = stub
        return stub

    def kill(self, name: str) -> None:
        """Crash a node: partition it and stop its beacons (parity:
        kill -9 in the kill_test harness)."""
        self._dead.add(name)
        self.net.partition(name)

    def revive(self, name: str) -> None:
        self._dead.discard(name)
        self.net.heal(name)

    # ---- time ----------------------------------------------------------

    def step(self, rounds: int = 1, advance: bool = True) -> None:
        """One beacon interval per round: beacons from alive nodes, message
        delivery, meta FD + guardian tick. `advance=False` fires this
        cluster's timers and drains delivery WITHOUT advancing the
        shared loop a beacon interval — the second cluster of a
        two-cluster topology steps this way so paired steps move shared
        time once."""
        from pegasus_tpu_torch.replica.replica import PartitionStatus

        for _ in range(rounds):
            for name, stub in self.stubs.items():
                if name not in self._dead:
                    stub.send_beacon()
                    # group-check timer: advances secondaries' commit
                    # points (piggy-backed last_committed) and re-sends
                    # lost prepares (parity: replica_check.cpp:212)
                    for r in stub.replicas.values():
                        if r.status == PartitionStatus.PRIMARY:
                            r.broadcast_group_check()
                    # config-sync timer (parity: replica_stub.cpp:944
                    # query_configuration_by_node): pull reconciliation
                    # re-delivers config changes whose one-shot proposal
                    # was LOST — without it a dropped promotion wedges
                    # the partition until manual intervention
                    stub.config_sync()
                    stub.dup_tick()
                    stub.split_tick()
                    stub.transfer_tick()
                    # background scrub timer: latent at-rest corruption
                    # on non-serving replicas is detected here
                    stub.scrub_tick()
                    # flight-recorder timer: drain metrics into the
                    # node's rings + one watchdog pass (coalesced to
                    # the recorder cadence internally)
                    stub.health_tick()
            if advance:
                self.loop.run_for(self.beacon_interval)
            else:
                self.loop.run_until_idle()
            for m in self.metas:
                if m.name not in self._dead:
                    m.tick()
        self._last_step_time = self.loop.now
        self.loop.run_until_idle()

    def pump(self) -> None:
        """ClusterClient wait-callback: drain messages; if the client is
        still blocked (caller loops), advance a beacon interval so FD/
        guardian progress can unblock it. Heavy traffic ALSO advances sim
        time (per-message delays), so the timer round must fire whenever
        a beacon interval of sim time has passed — otherwise a long write
        burst starves beacons and every worker's lease lapses."""
        if (self.loop.run_until_idle() == 0
                or self.loop.now - self._last_step_time
                > self.beacon_interval):
            self.step()

    # ---- DDL + clients -------------------------------------------------

    @property
    def meta(self) -> MetaService:
        """The current leader meta (single-meta: the only one)."""
        for m in self.metas:
            if m.election.is_leader and m.name not in self._dead:
                return m
        alive = [m for m in self.metas if m.name not in self._dead]
        if not alive:
            raise RuntimeError("no live meta")
        # no elected leader yet: return a live member so callers get a
        # VISIBLE not-enough-members/forwarded behavior, never a dead one
        return alive[0]

    def create_table(self, app_name: str, partition_count: int = 8,
                     replica_count: int = 3,
                     envs: Optional[Dict[str, str]] = None) -> int:
        app_id = self.meta.create_app(app_name, partition_count,
                                      replica_count, envs)
        self.loop.run_until_idle()
        return app_id

    def client(self, app_name: str, name: Optional[str] = None,
               user: str = "admin",
               tenant: Optional[str] = None) -> ClusterClient:
        auth = None
        if self.auth_secret:
            from pegasus_tpu_torch.security.auth import make_credentials

            auth = make_credentials(user, self.auth_secret)
        # deadline timebase = the stubs' wall-anchored clock; backoff
        # "sleep" advances VIRTUAL time (delivering due messages), so
        # retry pacing shapes the schedule without wall-clock cost
        import zlib

        # per-client FIXED backoff seed (name-derived, not hash() —
        # that's salted per interpreter): sim schedules replay exactly,
        # while two sim clients still draw distinct jitter streams
        # (real clients default to per-process entropy instead)
        cname = name or f"{self.name_prefix}client-{app_name}"
        from pegasus_tpu_torch.utils import tracing

        tracing.ring_for(cname, clock=self._trace_clock)
        self._trace_rings.append(cname)
        c = ClusterClient(self.net, cname,
                          [m.name for m in self.metas],
                          app_name, pump=self.pump, auth=auth,
                          clock=lambda: self._epoch + self.loop.now,
                          sleep=lambda s: self.loop.run_for(s),
                          backoff_seed=zlib.crc32(cname.encode()),
                          tenant=tenant)
        return c

    def primaries(self, app_id: int) -> List[str]:
        app = self.meta.state.apps[app_id]
        return [self.meta.state.get_partition(app_id, p).primary
                for p in range(app.partition_count)]

    def close(self) -> None:
        from pegasus_tpu_torch.utils import tracing

        for stub in self.stubs.values():
            stub.close()
        # drop the rings this cluster registered: their clock closures
        # pin the whole dead cluster, and stale spans must not leak
        # into a later cluster reusing the same node names
        for name in self._trace_rings:
            tracing.drop_ring(name)
