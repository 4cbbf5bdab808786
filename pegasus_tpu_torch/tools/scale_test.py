"""Scale soak: elasticity under multi-tenant load and chaos.

The ROADMAP "million-user scale scenario" proof artifact: a
multi-process onebox hosting HUNDREDS of partitions across several
tenant tables, hammered by a seeded multi-tenant zipfian workload with
per-tenant capacity-unit QoS (throttle envs on the background tenants),
while the DataVerifier invariant — zero acked-write loss — is checked
continuously and chaos (process kills, pauses, disk faults) fires. The
run is DRIVEN THROUGH the two elasticity actions the closed loop
performs: one online partition split of the hottest tenant and one
cluster rebalance, both while the load and the chaos keep running.

Report: per-tenant write/read counts, verifier violations (must be
empty), split + rebalance completion, and the elasticity/fence/
quarantine counters that show each machinery actually engaged.

`--topology wan` swaps in the geo-replication soak instead: TWO
oneboxes (cluster A duplicating every tenant table to cluster B across
a delayed+lossy FaultPlan link with a mid-run full blackout), kill
chaos alternating across both clusters, ending in the controlled
failover drill — fence A (typed retryable ERR_DUP_FENCED), drain
confirmed decrees, flip B writable — after which the DataVerifier
ledger replays every write A ever acked against B.

CLI:
    python -m pegasus_tpu_torch.tools.scale_test --dir D --tenants 4 \
        --partitions 32 --duration 60 [--chaos kill] [--disk-faults] \
        [--topology wan]
"""

from __future__ import annotations

import json
import os
import random
import sys
import time
from typing import List, Optional

from pegasus_tpu_torch.tools.kill_test import DataVerifier, Killer
from pegasus_tpu_torch.utils.errors import PegasusError


def zipf_weights(n_keys: int, skew: float) -> List[float]:
    """Rank weights 1/rank^skew — compute once per (n_keys, skew)."""
    return [1.0 / ((rank + 1) ** skew) for rank in range(n_keys)]


def zipf_keys(rng: random.Random, n_keys: int, skew: float,
              count: int, weights: Optional[List[float]] = None
              ) -> List[bytes]:
    """`count` hashkeys drawn zipfian (rank-weighted 1/rank^skew) from a
    tenant's key population — the many-users-few-whales shape."""
    if weights is None:
        weights = zipf_weights(n_keys, skew)
    return [b"user_%06d" % i
            for i in rng.choices(range(n_keys), weights=weights, k=count)]


class TenantWorkload:
    """One tenant: a table, a client, a seeded zipfian stream, and the
    acked-write ledger the final durability check replays."""

    def __init__(self, name: str, client, rng: random.Random,
                 n_keys: int = 2000, skew: float = 1.2,
                 monotonic_ledger: bool = False) -> None:
        self.name = name
        self.client = client
        self.rng = rng
        self.n_keys = n_keys
        self.skew = skew
        self._weights = zipf_weights(n_keys, skew)
        read_consistency = None
        if monotonic_ledger:
            # the ledger reads fan out to lease-holding secondaries —
            # the monotonic-reads invariant is checked against follower
            # serving under the same chaos as the durability ledger
            from pegasus_tpu_torch.client.cluster_client import MONOTONIC

            read_consistency = MONOTONIC
        self.verifier = DataVerifier(client, rng,
                                     monotonic_ledger=monotonic_ledger,
                                     read_consistency=read_consistency)
        self.reads_ok = 0
        self.read_errors = 0

    def step(self) -> None:
        # sequenced verifier write + history re-read (the invariant),
        # plus the monotonic-reads ledger when enabled
        self.verifier.step()
        # plus zipfian reads/writes shaping the per-partition heat the
        # elasticity signals are computed from
        for hk in zipf_keys(self.rng, self.n_keys, self.skew, 4,
                            self._weights):
            try:
                if self.rng.random() < 0.5:
                    self.client.set(hk, b"s", b"payload-%s" % hk)
                else:
                    self.client.get(hk, b"s")
                    self.reads_ok += 1
            except PegasusError:
                self.read_errors += 1  # chaos window; durability is
                # checked by the verifier ledger, not this stream


def _wait_split_done(admin, table: str, deadline_s: float) -> bool:
    t_end = time.monotonic() + deadline_s
    while time.monotonic() < t_end:
        try:
            st = admin.call("split_status", app_name=table)
            if not st.get("splitting"):
                return True
        except PegasusError:
            pass
        time.sleep(0.5)
    return False


def run_scale_test(directory: str, n_tenants: int = 4,
                   partitions: int = 32, duration_s: float = 60.0,
                   n_replica: int = 3, seed: int = 0,
                   chaos_mode: Optional[str] = "kill",
                   kill_every_s: float = 15.0,
                   disk_faults: bool = False,
                   op_timeout_ms: float = 30_000,
                   device: Optional[str] = None) -> dict:
    """Assumes the onebox in `directory` is NOT yet started; boots it,
    runs the soak, tears it down. Total partitions = n_tenants *
    partitions * 2 after the split of tenant 0 (>= 128 with the
    defaults + split)."""
    from pegasus_tpu_torch.tools import onebox_cluster as ob

    dfp = None
    if disk_faults:
        # light seeded read bit-flips: the verify-on-read →
        # quarantine → re-learn loop must repair under the soak load
        dfp = {"seed": seed + 7,
               "points": {"vfs::read": "0.02%return(bit_flip)"}}
    ob.start(directory, n_replica=n_replica, disk_fault_plan=dfp,
             device=device)
    rng = random.Random(seed)
    admin = ob.OneboxAdmin(directory)
    report: dict = {"tenants": {}, "violations": []}
    try:
        # ---- topology: tenant tables, premium first ------------------
        _wait_cluster(admin, n_replica)
        tenants: List[TenantWorkload] = []
        # server-side tenant QoS topology: premium half gets weight 4
        # and an effectively-unmetered CU budget; background half gets
        # weight 1 and a tight CU rate, so the weighted-fair dispatcher
        # and the CU buckets both have something to arbitrate
        qos_decl = ",".join(
            f"tenant{t}:4:1000000" if t < n_tenants // 2
            else f"tenant{t}:1:4000"
            for t in range(n_tenants))
        for t in range(n_tenants):
            table = f"tenant{t}"
            # tenant identity default rides the table envs (clients
            # that don't pass an explicit tag adopt it on config fetch)
            envs = {"qos.tenants": qos_decl,
                    "qos.default_tenant": table}
            if t >= n_tenants // 2:
                # per-tenant capacity-unit QoS: background tenants get a
                # write throttle so a noisy neighbor cannot starve the
                # premium half's capacity (reject mode -> TryAgain,
                # surfaced in write_rejected, never a violation)
                envs["replica.write_throttling"] = "200*reject*10"
            _create_table_retry(admin, table, partitions,
                                min(3, n_replica), envs=envs)
            client = ob.connect(table, directory,
                                op_timeout_ms=op_timeout_ms,
                                tenant=table)
            tenants.append(TenantWorkload(
                table, client, random.Random(seed * 1000 + t),
                monotonic_ledger=True))
        killer = (Killer(directory, rng, mode=chaos_mode, admin=admin)
                  if chaos_mode else None)

        # ---- the soak: load + chaos + one split + one rebalance ------
        t_end = time.monotonic() + duration_s
        split_at = time.monotonic() + duration_s * 0.25
        rebalance_at = time.monotonic() + duration_s * 0.6
        next_kill = time.monotonic() + kill_every_s
        next_restart = None
        split_started = split_done = False
        rebalance_proposals = None
        while time.monotonic() < t_end:
            for tw in tenants:
                tw.step()
            now = time.monotonic()
            if killer and next_restart is not None and now >= next_restart:
                killer.restart_down()
                next_restart = None
            if killer and now >= next_kill and killer.down is None:
                killer.kill_one()
                next_restart = now + kill_every_s / 2
                next_kill = now + kill_every_s
            if not split_started and now >= split_at:
                # the elasticity act: split tenant0 ONLINE, under load
                # and chaos (retry past a mid-failover meta/primary)
                try:
                    admin.call("start_partition_split",
                               app_name="tenant0")
                    split_started = True
                except PegasusError as e:
                    report.setdefault("split_refusals", []).append(str(e))
                    split_at = now + 3.0  # guarded off; retry shortly
            if split_started and not split_done:
                try:
                    st = admin.call("split_status", app_name="tenant0",
                                    timeout=6)
                    split_done = not st.get("splitting")
                except PegasusError:
                    pass
            if rebalance_proposals is None and now >= rebalance_at:
                try:
                    rebalance_proposals = admin.call("rebalance")
                except PegasusError:
                    rebalance_at = now + 3.0
        if killer:
            killer.restart_down()
        if split_started and not split_done:
            split_done = _wait_split_done(admin, "tenant0", 60.0)

        # ---- the invariant: every acked write of every tenant --------
        for tw in tenants:
            tw.verifier.final_check(deadline_s=120.0)
            report["tenants"][tw.name] = {
                "writes_acked": tw.verifier.write_ok,
                "writes_rejected": tw.verifier.write_rejected,
                "reads_ok": tw.reads_ok,
                "read_errors": tw.read_errors,
                "ledger_reads": tw.verifier.ledger_reads,
            }
            report["violations"].extend(
                f"{tw.name}: {v}" for v in tw.verifier.violations)
        report["split_started"] = split_started
        report["split_done"] = split_done
        report["rebalance_proposals"] = rebalance_proposals
        report["kills"] = killer.kills if killer else 0
        try:
            report["hot_partitions"] = admin.call("hot_partitions",
                                                  timeout=6)
        except PegasusError:
            report["hot_partitions"] = None
        # server-side tenant QoS roll-up (meta folds the per-node
        # config_sync tenant reports): CU totals, shed/overbudget
        # counts, and any brownout verdicts from the soak
        try:
            report["tenant_qos"] = admin.call("tenant_stats", timeout=6)
        except PegasusError:
            report["tenant_qos"] = None
        # machinery counters: fences/quarantines prove the guards fired
        fence = quarantine = 0
        for n, c in admin.cfg["nodes"].items():
            if c["role"] != "replica":
                continue
            try:
                for ent in admin.remote_command(n, "metrics",
                                                ["storage"]):
                    m = ent.get("metrics", {})
                    fence += m.get("split_fence_reject_count",
                                   {}).get("value", 0)
                    quarantine += m.get("replica_quarantine_count",
                                        {}).get("value", 0)
            except PegasusError:
                pass
        report["split_fence_rejects"] = fence
        report["quarantines"] = quarantine
        report["partition_total"] = sum(
            a["partition_count"] for a in admin.call("list_apps"))
    finally:
        admin.close()
        ob.stop(directory)
    return report


def _wait_cluster(admin, n_replica: float, deadline_s: float = 120.0
                  ) -> None:
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        try:
            if len(admin.call("list_nodes", timeout=6)) == n_replica:
                return
        except PegasusError:
            pass
        time.sleep(0.5)
    raise RuntimeError("cluster never came up")


def _create_table_retry(admin, table: str, partitions: int,
                        replica_count: int, deadline_s: float = 90.0,
                        envs=None) -> None:
    deadline = time.monotonic() + deadline_s
    while True:
        try:
            admin.create_table(table, partition_count=partitions,
                               replica_count=replica_count, envs=envs)
            return
        except PegasusError as e:
            if "APP_EXIST" in str(e):
                return
            if time.monotonic() > deadline:
                raise
            time.sleep(1)


def run_wan_test(directory: str, n_tenants: int = 2,
                 partitions: int = 4, duration_s: float = 60.0,
                 n_replica: int = 2, seed: int = 0,
                 kill_every_s: float = 15.0,
                 wan_delay_s: float = 0.05, wan_drop: float = 0.1,
                 blackout_s: float = 5.0,
                 op_timeout_ms: float = 8_000,
                 device: Optional[str] = None) -> dict:
    """Two-cluster geo-replication soak ending in the failover drill.

    Cluster A (`a-` prefix, cluster id 1) duplicates every tenant table
    to cluster B (`b-` prefix, cluster id 2). The inter-cluster link is
    WAN-shaped by a seeded FaultPlan on A's nodes (delay + drop on every
    A→B pair) plus a mid-run FULL link blackout toggled live through the
    `fault.set` remote verb; Killer kill chaos fires on BOTH clusters
    the whole run. At ~70% the controlled failover drill runs per table:
    fence A (writes get retryable ERR_DUP_FENCED), drain every
    partition to confirmed == last_committed, flip B writable — then
    the DataVerifier ledger replays EVERY write A ever acked against B.
    Zero violations is the acceptance invariant."""
    from pegasus_tpu_torch.tools import onebox_cluster as ob

    da = os.path.join(directory, "A")
    db = os.path.join(directory, "B")
    rng = random.Random(seed)
    report: dict = {"topology": "wan", "tenants": {}, "violations": []}
    ob.start(db, n_replica=n_replica, name_prefix="b-", cluster_id=2,
             device=device)
    try:
        admin_b = ob.OneboxAdmin(db)
        _wait_cluster(admin_b, n_replica)
        with open(os.path.join(db, "cluster.json")) as f:
            bnodes = {n: (c["host"], c["port"])
                      for n, c in json.load(f)["nodes"].items()}
        # WAN shape: every A→B link pays delay + seeded loss (replies
        # ride the inbound TCP sessions back, so the fault charge is
        # sender-side once per link — the FaultPlan contract)
        a_fault = {
            "seed": seed + 11,
            "delay": [{"extra_s": wan_delay_s, "dst": bn}
                      for bn in bnodes],
            "drop": [{"prob": wan_drop, "dst": bn} for bn in bnodes],
        }
        ob.start(da, n_replica=n_replica, name_prefix="a-",
                 extra_peers=bnodes, fault_plan=a_fault, cluster_id=1,
                 device=device)
        try:
            admin_a = ob.OneboxAdmin(da)
            _wait_cluster(admin_a, n_replica)
            rc = min(3, n_replica)
            tenants: List[TenantWorkload] = []
            tables = [f"tenant{t}" for t in range(n_tenants)]
            for t, table in enumerate(tables):
                _create_table_retry(admin_b, table, partitions, rc)
                _create_table_retry(admin_a, table, partitions, rc)
                client = ob.connect(table, da,
                                    op_timeout_ms=op_timeout_ms,
                                    tenant=table)
                tenants.append(TenantWorkload(
                    table, client, random.Random(seed * 1000 + t),
                    n_keys=500))
                admin_a.call("add_dup", app_name=table,
                             follower_meta="b-meta", follower_app=table,
                             timeout=30)
            a_replicas = [n for n, c in admin_a.cfg["nodes"].items()
                          if c["role"] == "replica"]
            killer_a = Killer(da, rng, mode="kill", admin=admin_a)
            killer_b = Killer(db, random.Random(seed + 1), mode="kill",
                              admin=admin_b)

            def set_link_drop(prob: float) -> None:
                for n in a_replicas:
                    for bn in bnodes:
                        try:
                            admin_a.remote_command(
                                n, "fault.set",
                                ["drop", str(prob), "", bn])
                        except PegasusError:
                            pass  # node mid-kill; the link heals with it

            t_end = time.monotonic() + duration_s
            blackout_at = time.monotonic() + duration_s * 0.4
            drill_at = time.monotonic() + duration_s * 0.7
            next_kill = time.monotonic() + kill_every_s
            restarts = {}  # killer -> restart deadline
            blackout_done = False
            side = 0
            while time.monotonic() < min(t_end, drill_at):
                for tw in tenants:
                    tw.step()
                now = time.monotonic()
                for killer, at in list(restarts.items()):
                    if now >= at:
                        killer.restart_down()
                        restarts.pop(killer)
                if now >= next_kill:
                    # alternate chaos between the two clusters
                    killer = (killer_a, killer_b)[side % 2]
                    side += 1
                    if killer.down is None:
                        killer.kill_one()
                        restarts[killer] = now + kill_every_s / 2
                    next_kill = now + kill_every_s
                if not blackout_done and now >= blackout_at:
                    # full inter-cluster partition: shipping must stall
                    # (re-drives only), then converge after the heal
                    set_link_drop(1.0)
                    time.sleep(blackout_s)
                    set_link_drop(0.0)  # heal to delay-only
                    blackout_done = True
            for killer in (killer_a, killer_b):
                killer.restart_down()
            report["blackout_done"] = blackout_done
            report["kills_a"] = killer_a.kills
            report["kills_b"] = killer_b.kills

            # ---- the drill: fence → drain → flip, per table ----------
            drill_status: dict = {}
            for table in tables:
                deadline = time.monotonic() + 60
                while True:
                    try:
                        admin_a.call("dup_failover", app_name=table,
                                     timeout=15)
                        break
                    except PegasusError as e:
                        if time.monotonic() > deadline:
                            raise
                        drill_status.setdefault(
                            "start_retries", []).append(str(e))
                        time.sleep(1)
            # writes during the drain must surface the typed fence,
            # never an ack that could be stranded on A
            fence_seen = 0
            deadline = time.monotonic() + 180
            while time.monotonic() < deadline:
                done = 0
                for table in tables:
                    try:
                        st = admin_a.call("dup_failover_status",
                                          app_name=table, timeout=10)
                        drill_status[table] = st
                        done += st["phase"] == "done"
                    except PegasusError:
                        pass
                if done == len(tables):
                    break
                time.sleep(1)
            report["drill"] = drill_status
            report["drill_done"] = all(
                drill_status.get(t, {}).get("phase") == "done"
                for t in tables)
            try:
                report["dup_stats"] = admin_a.call("dup_stats",
                                                   timeout=10)
            except PegasusError:
                report["dup_stats"] = None
            for n in a_replicas:
                try:
                    for ent in admin_a.remote_command(n, "metrics",
                                                      ["storage"]):
                        fence_seen += ent.get("metrics", {}).get(
                            "dup_fence_reject_count", {}).get("value", 0)
                except PegasusError:
                    pass
            report["fence_rejects"] = fence_seen

            # ---- the invariant: every write A acked reads back on B --
            for tw in tenants:
                b_client = ob.connect(tw.name, db,
                                      op_timeout_ms=op_timeout_ms,
                                      tenant=tw.name)
                tw.verifier.client = b_client
                tw.verifier.final_check(deadline_s=180.0)
                report["tenants"][tw.name] = {
                    "writes_acked": tw.verifier.write_ok,
                    "writes_rejected": tw.verifier.write_rejected,
                    "reads_ok": tw.reads_ok,
                    "read_errors": tw.read_errors,
                }
                report["violations"].extend(
                    f"{tw.name}: {v}" for v in tw.verifier.violations)
        finally:
            try:
                admin_a.close()
            except Exception:  # noqa: BLE001 - teardown best-effort
                pass
            ob.stop(da)
    finally:
        try:
            admin_b.close()
        except Exception:  # noqa: BLE001 - teardown best-effort
            pass
        ob.stop(db)
    return report


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True)
    ap.add_argument("--topology", choices=["single", "wan"],
                    default="single",
                    help="wan: two clusters, A geo-replicating to B "
                         "across a faulted link, ending in the "
                         "controlled failover drill")
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--partitions", type=int, default=32)
    ap.add_argument("--nodes", type=int, default=3)
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chaos", choices=["kill", "pause", "corrupt", "none"],
                    default="kill")
    ap.add_argument("--disk-faults", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where the replica processes serve: the card "
                         "(default) or cpu")
    args = ap.parse_args()
    if args.topology == "wan":
        report = run_wan_test(
            args.dir, n_tenants=args.tenants,
            partitions=args.partitions, duration_s=args.duration,
            n_replica=args.nodes, seed=args.seed, device=args.device)
    else:
        report = run_scale_test(
            args.dir, n_tenants=args.tenants, partitions=args.partitions,
            duration_s=args.duration, n_replica=args.nodes, seed=args.seed,
            chaos_mode=None if args.chaos == "none" else args.chaos,
            disk_faults=args.disk_faults, device=args.device)
    print(json.dumps(report, indent=1, default=str))
    sys.exit(1 if report["violations"] else 0)


if __name__ == "__main__":
    main()
