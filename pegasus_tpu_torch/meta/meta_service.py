"""MetaService: leader control plane — DDL, FD, partition guardian.

Parity: src/meta/meta_service.{h,cpp} (admin RPC surface :480-571),
server_state.cpp:1161 (create_app), partition_guardian.h:41 (cures), and
meta_server_failure_detector.h:64 (worker liveness). Single-meta here;
leader election over a distributed lock slots in front of this class the
way the reference elects via ZK (meta_service.cpp:393) — followers
forward to the leader.

Guardian cures mirror the reference's proposal types:
- dead primary  -> promote an alive secondary (ballot+1)
- dead secondary-> remove it (ballot+1)
- under-replicated -> tell the primary to add a learner on a spare node;
  on learn completion, upgrade the learner to secondary (ballot+1).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

from pegasus_tpu_torch.meta.failure_detector import FailureDetector
from pegasus_tpu_torch.meta.meta_storage import MetaStorage
from pegasus_tpu_torch.meta.server_state import (
    AS_AVAILABLE,
    AS_DROPPED,
    AppState,
    PartitionConfig,
    ServerState,
)
from pegasus_tpu_torch.utils.errors import ErrorCode, PegasusError

Gpid = Tuple[int, int]


class MetaService:
    def __init__(self, name: str, data_dir: str, net,
                 clock: Callable[[], float],
                 peers: Optional[List[str]] = None) -> None:
        """`peers`: the full meta group (including this node) for
        leader-elected multi-meta deployments; None/singleton = the
        single-meta mode every existing caller gets."""
        from pegasus_tpu_torch.meta.election import (
            MetaElection,
            ReplicatedMetaStorage,
        )

        self.name = name
        self.net = net
        self.clock = clock
        self.storage = ReplicatedMetaStorage(os.path.join(data_dir,
                                                          "meta.json"))
        self.state = ServerState(self.storage)
        self.election = MetaElection(self, list(peers or [name]),
                                     self.storage)
        self.fd = FailureDetector(on_worker_dead=self._on_node_dead)
        # latest stored-replica report per node (config_sync payloads):
        # the `recover` verb rebuilds lost app state from these — the
        # replicas are the recovery source of truth (parity: shell
        # `recover` from replica list, commands.h:209)
        self._stored_reports: Dict[str, list] = {}
        # latest tail-kept slow-trace summary per node (rides the same
        # config_sync report): `shell traces --slow` reads the whole
        # cluster's kept roots with ONE meta admin call
        self._trace_reports: Dict[str, dict] = {}
        # latest per-tenant QoS snapshot per node (same channel): the
        # shell's `tenants` verb and the collector's `_tenants` row
        # read the cluster-folded view with ONE admin call
        self._tenant_reports: Dict[str, dict] = {}
        # latest per-partition workload shape digest (rides the stored
        # entries of config_sync like the CU load signals): `shell
        # workload <table>` folds these per table with ONE admin call
        self._workload_reports: Dict[tuple, dict] = {}
        # in-flight learner adds: gpid -> (learner, started_at); prevents
        # every guardian tick from restarting a slow learn from scratch
        self._pending_learns: Dict[Gpid, Tuple[str, float]] = {}
        self._learn_timeout = 60.0
        self._learn_resend = 9.0  # re-drive lost add-learner cmds
        # balancer copy-secondary moves waiting on a learn: gpid -> node to
        # remove once the learner lands
        self._pending_moves: Dict[Gpid, str] = {}
        # partitions created from a backup that have not restored yet:
        # gpid -> {root, policy, backup_id, src_app_id}. The guardian must
        # not add learners to these (a learner would copy the pre-restore
        # empty state). Persisted so a meta restart keeps driving them.
        self.pending_restores: Dict[Gpid, dict] = {}
        self._load_pending_restores()
        from pegasus_tpu_torch.meta.backup_service import MetaBackupService
        from pegasus_tpu_torch.meta.bulk_load_service import MetaBulkLoadService
        from pegasus_tpu_torch.meta.duplication_service import (
            MetaDuplicationService,
        )

        from pegasus_tpu_torch.meta.elasticity import ElasticityController
        from pegasus_tpu_torch.meta.split_service import MetaSplitService

        self.backup = MetaBackupService(self)
        self.bulk_load = MetaBulkLoadService(self)
        self.duplication = MetaDuplicationService(self)
        self.split = MetaSplitService(self)
        # the detect→decide→act elasticity closed loop (signals flow in
        # through config_sync whatever the level; it ACTS only in lively)
        self.elasticity = ElasticityController(self)
        # cluster-level compaction stagger: heavy-compaction demand
        # reports ride config_sync, leased grants ride the reply
        from pegasus_tpu_torch.meta.compaction_scheduler import (
            CompactionCoordinator,
        )

        self.compaction = CompactionCoordinator(self)
        # cluster flight-recorder fold: every node's watchdog digest +
        # typed health events ride config_sync into this per-node/
        # per-table status machine (`shell health` / `shell timeline`)
        from pegasus_tpu_torch.meta.cluster_health import ClusterHealth

        self.health = ClusterHealth(self)
        # cluster function level (parity: meta_function_level / shell
        # get_meta_level|set_meta_level): "freezed" = no guardian cures
        # or proposals; "steady" = cures but manual balance only
        # (default); "lively" = auto-rebalance on the guardian timer
        self.function_level = self.storage.get("/meta_level") or "steady"
        self._lively_last_balance = 0.0
        self._lively_interval = 30.0
        from pegasus_tpu_torch.utils.command_manager import CommandManager

        self.commands = CommandManager()
        self.commands.register(
            "meta.status",
            lambda _a: {"name": self.name,
                        "leader": self.election.leader,
                        "is_leader": self.election.is_leader,
                        "term": self.election.term,
                        "state_seq": self.storage.seq,
                        "alive_nodes": self.fd.alive_workers()},
            "leadership + state version + live workers")
        net.register(name, self.on_message)

    # ---- multi-meta plumbing ------------------------------------------

    @property
    def is_leader(self) -> bool:
        return self.election.is_leader

    def reload_state(self) -> None:
        """Follower: re-derive in-memory views after replicated storage
        changed underneath (cheap — meta state is small)."""
        self.state = ServerState(self.storage)

    def on_leadership_acquired(self) -> None:
        """Fresh leader: rebuild every service's in-memory view from the
        replicated storage. The FD starts empty — no worker is declared
        dead until its grace expires from MISSING beacons, so a leader
        change never mass-cures healthy partitions."""
        self.reload_state()
        self._load_pending_restores()
        self.backup._load()
        self.bulk_load._load_state()
        self.duplication._load()
        self.split._load()
        self.function_level = self.storage.get("/meta_level") or "steady"

    # ---- messages -----------------------------------------------------

    _LEADER_ONLY = frozenset({
        "beacon", "learn_completed", "replication_error",
        "replica_corrupted", "config_sync",
        "admin", "backup_partition_done", "restore_partition_done",
        "ingest_done", "duplication_sync", "register_child",
        "query_config", "admin_reply",
    })

    def on_message(self, src: str, msg_type: str, payload) -> None:
        if self.election.on_message(src, msg_type, payload):
            return
        if msg_type == "meta_forward":
            # a follower forwarded a request (the wrapper keeps transport
            # routes clean); handle it as if from the original requester —
            # replies travel over OUR route to that requester
            self.on_message(payload["src"], payload["msg_type"],
                            payload["payload"])
            return
        if msg_type == "config_sync" and not self.election.is_leader:
            # stubs broadcast config_sync to the whole group; followers
            # gain nothing from it and forwarding would just triple the
            # leader's work — drop silently
            return
        if msg_type == "beacon":
            # every group member tracks beacons PASSIVELY (parity:
            # multimaster FD) so a freshly elected leader has a warm
            # liveness view — but only the LEADER grants leases (acks):
            # a follower ack would let a worker keep serving while the
            # actual authority considers it dead
            self.fd.on_beacon(payload["node"], self.clock())
            if self.election.is_leader:
                self.net.send(self.name, src, "beacon_ack", {"ok": True})
            return
        if (msg_type in self._LEADER_ONLY
                and self.election.forward_to_leader(src, msg_type,
                                                    payload)):
            return  # forwarded with the ORIGINAL src; reply goes direct
        if msg_type == "learn_completed":
            self._on_learn_completed(tuple(payload["gpid"]),
                                     payload["learner"])
            return
        if msg_type == "replication_error":
            self._on_replication_error(tuple(payload["gpid"]),
                                       payload["member"])
            return
        if msg_type == "replica_corrupted":
            self._on_replica_corrupted(tuple(payload["gpid"]),
                                       payload["node"])
            return
        if msg_type == "config_sync":
            self._on_config_sync(src, payload)
            return
        if msg_type == "admin":
            self._on_admin(src, payload)
            return
        if msg_type == "backup_partition_done":
            self.backup.on_backup_partition_done(payload)
            return
        if msg_type == "restore_partition_done":
            self.backup.on_restore_partition_done(payload)
            return
        if msg_type == "ingest_done":
            self.bulk_load.on_ingest_done(payload)
            return
        if msg_type == "duplication_sync":
            self.duplication.on_duplication_sync(payload)
            return
        if msg_type == "register_child":
            self.split.on_register_child(src, payload)
            return
        if msg_type == "admin_reply":
            # replies to admin verbs THIS meta issued (dup bootstrap
            # asking the follower cluster's meta to restore_app; the
            # failover drill's follower-side flip)
            self.duplication.on_admin_reply(payload)
            self.duplication.on_flip_reply(payload)
            return
        if msg_type == "remote_command":
            rid = payload.get("rid")
            try:
                result = self.commands.call(payload["cmd"],
                                            payload.get("args") or [])
                err = 0
            except (KeyError, ValueError, TypeError) as e:
                result = str(e)
                err = int(ErrorCode.ERR_HANDLER_NOT_FOUND)
            self.net.send(self.name, src, "remote_command_reply", {
                "rid": rid, "err": err, "result": result})
            return
        if msg_type == "query_config":
            # client partition-config resolution (parity: RPC_CM_QUERY_
            # PARTITION_CONFIG_BY_INDEX, the miss path of the client
            # resolver — partition_resolver.h:122)
            rid = payload.get("rid")
            try:
                app_id, count, configs = self.query_config(
                    payload["app_name"])
                app = self.state.find_app(payload["app_name"])
                reply = {
                    "rid": rid, "err": int(ErrorCode.ERR_OK),
                    "app_id": app_id, "partition_count": count,
                    "configs": [{"ballot": pc.ballot, "primary": pc.primary,
                                 "secondaries": list(pc.secondaries)}
                                for pc in configs],
                    # table envs ride the config reply so clients can
                    # adopt table-scoped defaults (qos.default_tenant)
                    # without a second admin round-trip
                    "envs": dict(app.envs) if app is not None else {},
                }
            except PegasusError as e:
                reply = {"rid": rid, "err": int(e.code), "app_id": 0,
                         "partition_count": 0, "configs": []}
            self.net.send(self.name, src, "query_config_reply", reply)
            return
        raise ValueError(f"meta: unknown message {msg_type}")

    def tick(self) -> None:
        """Periodic FD check + guardian pass (parity: the meta's FD check
        timer and partition-guardian scans). Followers only run the
        election timer."""
        self.election.tick()
        if not self.election.is_leader:
            return
        if self.function_level != "freezed":
            # frozen: beacons still refresh leases but nothing is
            # DECLARED dead (fd.check skipped) and no cures run —
            # unfreezing replays missed death declarations on the next
            # tick. Orchestration (backup/bulk-load/dup/split) below
            # keeps ticking either way: fl_freezed stops cure/balance
            # CONFIG actions, not in-flight operational state machines.
            self.fd.check(self.clock())
            self._guardian_pass()
        self.backup.tick()
        self.bulk_load.tick()
        self.duplication.tick()
        self.split.tick()
        if self.function_level != "freezed":
            # steady: signals + metrics only; lively: the controller may
            # also split/move (its own pacing + pressure backoff inside)
            self.elasticity.tick(act=(self.function_level == "lively"))
        if self.function_level == "lively":
            now = self.clock()
            if now - self._lively_last_balance >= self._lively_interval:
                self._lively_last_balance = now
                self.rebalance()

    def http_routes(self) -> dict:
        """The cluster/table info REST surface (parity:
        meta/meta_http_service.h): /meta/apps, /meta/app?name=,
        /meta/nodes, /meta/status."""

        def apps(_q):
            return [{"app_id": a.app_id, "app_name": a.app_name,
                     "partition_count": a.partition_count,
                     "replica_count": a.max_replica_count,
                     "envs": dict(a.envs)} for a in self.list_apps()]

        def app(q):
            app_id, count, configs = self.query_config(q["name"])
            return {"app_id": app_id, "partition_count": count,
                    "partitions": [{"pidx": i, "ballot": pc.ballot,
                                    "primary": pc.primary,
                                    "secondaries": list(pc.secondaries)}
                                   for i, pc in enumerate(configs)]}

        def nodes(_q):
            return {"alive": self.fd.alive_workers()}

        def status(_q):
            return {"name": self.name, "leader": self.election.leader,
                    "is_leader": self.election.is_leader,
                    "term": self.election.term,
                    "state_seq": self.storage.seq}

        return {"/meta/apps": apps, "/meta/app": app,
                "/meta/nodes": nodes, "/meta/status": status}

    # ---- restore bookkeeping ------------------------------------------

    def _load_pending_restores(self) -> None:
        raw = self.state._storage.get("/restore/pending") or []
        self.pending_restores = {tuple(e["gpid"]): e["info"] for e in raw}

    def persist_pending_restores(self) -> None:
        self.state._storage.set_batch({"/restore/pending": [
            {"gpid": list(gpid), "info": info}
            for gpid, info in self.pending_restores.items()]})

    def _on_admin(self, src: str, payload: dict) -> None:
        """Networked DDL/admin surface (parity: the meta admin RPC table,
        meta_service.cpp:480-571 — create/drop/recall app, envs, balancer
        — invoked by shell/admin clients over the wire)."""
        rid = payload.get("rid")
        cmd = payload.get("cmd")
        args = payload.get("args") or {}
        try:
            if cmd == "create_app":
                result = self.create_app(
                    args["app_name"], args["partition_count"],
                    args.get("replica_count", 3), args.get("envs"))
            elif cmd == "drop_app":
                result = self.drop_app(args["app_name"])
            elif cmd == "recall_app":
                result = self.recall_app(args["app_name"])
            elif cmd == "list_apps":
                result = [{"app_id": a.app_id, "app_name": a.app_name,
                           "partition_count": a.partition_count,
                           "envs": dict(a.envs),
                           "replica_count": a.max_replica_count}
                          for a in self.list_apps()]
            elif cmd == "update_app_envs":
                result = self.update_app_envs(args["app_name"],
                                              args["envs"])
            elif cmd == "rebalance":
                result = len(self.rebalance())
            elif cmd == "drain_node":
                result = self.drain_node(args["node"])
            elif cmd == "list_nodes":
                result = self.fd.alive_workers()
            elif cmd == "start_backup":
                result = self.backup.start_backup(
                    args["app_name"], args["root"],
                    args.get("policy", "manual"))
            elif cmd == "backup_status":
                result = self.backup.backup_status(args["backup_id"])
            elif cmd == "add_backup_policy":
                result = self.backup.add_policy(
                    args["name"], args["app_names"], args["root"],
                    args.get("interval_seconds", 86400),
                    args.get("backup_history_count", 3))
            elif cmd == "restore_app":
                result = self.backup.create_app_from_backup(
                    args["new_name"], args["root"],
                    args.get("policy", "manual"), args["backup_id"],
                    args.get("replica_count", 3))
            elif cmd == "start_bulk_load":
                result = self.bulk_load.start_bulk_load(
                    args["app_name"], args["root"], args.get("src_app"))
            elif cmd == "bulk_load_status":
                result = self.bulk_load.bulk_load_status(args["app_name"])
            elif cmd == "add_dup":
                result = self.duplication.add_duplication(
                    args["app_name"], args["follower_meta"],
                    args["follower_app"])
            elif cmd == "query_dup":
                result = self.duplication.query_duplication(
                    args["app_name"])
            elif cmd == "remove_dup":
                result = self.duplication.remove_duplication(
                    args["dupid"])
            elif cmd == "start_partition_split":
                result = self.split.start_partition_split(
                    args["app_name"])
            elif cmd == "split_status":
                result = self.split.split_status(args["app_name"])
            elif cmd == "hot_partitions":
                result = self.elasticity.status(
                    args.get("app_name", ""))
            elif cmd == "compact_sched":
                result = self.compaction.status()
            elif cmd == "cluster_health":
                # the `shell health` surface: damped per-node/per-table
                # status + firing rules off the config-sync digests
                result = self.health.status()
            elif cmd == "health_events":
                result = self.health.events(
                    node=args.get("node"), table=args.get("table"),
                    since=args.get("since"),
                    limit=int(args.get("limit", 128)))
            elif cmd == "partition_primary":
                # routing-hash -> hosting primary (one meta call: the
                # shell's wire-mode `explain` routes straight to the
                # serving node instead of probing the fleet)
                app = self.state.find_app(args["app_name"])
                if app is None:
                    raise PegasusError(ErrorCode.ERR_APP_NOT_EXIST,
                                       args["app_name"])
                pidx = (int(args.get("partition_hash") or 0)
                        % app.partition_count)
                pc_ = self.state.get_partition(app.app_id, pidx)
                result = {"app_id": app.app_id, "pidx": pidx,
                          "primary": pc_.primary}
            elif cmd == "workload":
                # the `shell workload <table>` surface: per-partition
                # shape digests (off the config-sync stored entries)
                # folded into one table rollup
                result = self.workload_status(args.get("app_name", ""))
            elif cmd == "slow_traces":
                # per-node tail-kept trace roots, newest last (the
                # `shell traces --slow` surface; full spans fan out on
                # demand via the trace-dump remote command)
                result = {n: dict(t) for n, t in
                          sorted(self._trace_reports.items())}
            elif cmd == "del_app_envs":
                result = self.del_app_envs(args["app_name"], args["keys"])
            elif cmd == "clear_app_envs":
                result = self.clear_app_envs(args["app_name"],
                                             args.get("prefix", ""))
            elif cmd == "rename_app":
                result = self.rename_app(args["old_name"],
                                         args["new_name"])
            elif cmd == "get_meta_level":
                result = self.function_level
            elif cmd == "set_meta_level":
                result = self.set_meta_level(args["level"])
            elif cmd == "get_replica_count":
                app = self.state.find_app(args["app_name"])
                if app is None:
                    raise PegasusError(ErrorCode.ERR_APP_NOT_EXIST,
                                       args["app_name"])
                result = app.max_replica_count
            elif cmd == "set_replica_count":
                result = self.set_app_replica_count(args["app_name"],
                                                    args["count"])
            elif cmd == "cluster_info":
                result = self.cluster_info()
            elif cmd == "ddd_diagnose":
                result = self.ddd_diagnose()
            elif cmd == "recover":
                result = self.recover_from_reports()
            elif cmd == "list_dups":
                result = self.duplication.list_all()
            elif cmd == "dup_stats":
                result = self.duplication.dup_stats(
                    args.get("app_name", ""))
            elif cmd == "tenant_stats":
                result = self.tenant_stats()
            elif cmd == "dup_failover":
                result = self.duplication.start_failover(
                    args["app_name"])
            elif cmd == "dup_failover_status":
                result = self.duplication.failover_status(
                    args["app_name"])
            elif cmd == "query_restore_status":
                result = self.query_restore_status(
                    args.get("app_name", ""))
            elif cmd == "propose":
                result = self.propose(args["app_name"], args["pidx"],
                                      args["action"], args["node"],
                                      force=bool(args.get("force")))
            elif cmd == "ls_backup_policy":
                result = self.backup.list_policies()
            elif cmd == "query_backup_policy":
                result = self.backup.query_policy(args["name"])
            elif cmd == "modify_backup_policy":
                result = self.backup.modify_policy(
                    args["name"], add_apps=args.get("add_apps"),
                    remove_apps=args.get("remove_apps"),
                    interval_seconds=args.get("interval_seconds"),
                    backup_history_count=args.get("backup_history_count"))
            elif cmd == "enable_backup_policy":
                result = self.backup.enable_policy(args["name"], True)
            elif cmd == "disable_backup_policy":
                result = self.backup.enable_policy(args["name"], False)
            elif cmd == "pause_dup":
                result = self.duplication.pause_duplication(args["dupid"])
            elif cmd == "start_dup":
                result = self.duplication.resume_duplication(args["dupid"])
            elif cmd == "set_dup_fail_mode":
                result = self.duplication.set_fail_mode(args["dupid"],
                                                        args["fail_mode"])
            elif cmd == "pause_bulk_load":
                result = self.bulk_load.pause_bulk_load(args["app_name"])
            elif cmd == "restart_bulk_load":
                result = self.bulk_load.restart_bulk_load(
                    args["app_name"])
            elif cmd == "cancel_bulk_load":
                result = self.bulk_load.cancel_bulk_load(args["app_name"])
            elif cmd == "clear_bulk_load":
                result = self.bulk_load.clear_bulk_load(args["app_name"])
            else:
                self.net.send(self.name, src, "admin_reply", {
                    "rid": rid,
                    "err": int(ErrorCode.ERR_HANDLER_NOT_FOUND),
                    "result": None})
                return
        except PegasusError as e:
            self.net.send(self.name, src, "admin_reply", {
                "rid": rid, "err": int(e.code), "result": str(e)})
            return
        except (KeyError, TypeError, ValueError) as e:
            # malformed request: reply immediately instead of letting the
            # client burn its full timeout waiting for nothing
            self.net.send(self.name, src, "admin_reply", {
                "rid": rid, "err": int(ErrorCode.ERR_INVALID_PARAMETERS),
                "result": f"bad admin args: {e}"})
            return
        except OSError as e:
            # e.g. a wrong bucket path handed to start_bulk_load/restore
            self.net.send(self.name, src, "admin_reply", {
                "rid": rid,
                "err": int(ErrorCode.ERR_FILE_OPERATION_FAILED),
                "result": str(e)})
            return
        self.net.send(self.name, src, "admin_reply", {
            "rid": rid, "err": int(ErrorCode.ERR_OK), "result": result})

    def _on_config_sync(self, src: str, payload: dict) -> None:
        """Pull-reconciliation (parity: on_query_configuration_by_node,
        meta_service.cpp:793 + meta_admin.thrift:103-115): reply with the
        node's authoritative partition configs and the stored replicas it
        should delete. GC is deliberately conservative: only replicas of
        apps that no longer exist anywhere (fully gone, not in the
        dropped-recall window) are listed — a replica missing from its
        partition's member list may be an in-flight learner."""
        node = payload["node"]
        self._stored_reports[node] = list(payload.get("stored", []))
        if "trace_report" in payload:
            self._trace_reports[node] = payload["trace_report"]
        if "tenants" in payload:
            self._tenant_reports[node] = {"at": self.clock(),
                                          "tenants": payload["tenants"]}
        # per-partition workload digests (primaries stamp them onto
        # their stored entries, exactly like the CU load signals);
        # digests of apps meta no longer knows AT ALL are pruned each
        # report — without this, per-job temp-table churn grows the map
        # forever (dropped-but-recallable apps keep their profile)
        for entry in payload.get("stored", []):
            wl = entry.get("workload")
            if wl is not None:
                self._workload_reports[tuple(entry["gpid"])] = dict(
                    wl, node=node, at=self.clock())
        if self._workload_reports:
            self._workload_reports = {
                g: w for g, w in self._workload_reports.items()
                if g[0] in self.state.apps}
        # elasticity detect phase: the same report carries per-partition
        # capacity units + hotkey results and the node's pressure counts
        self.elasticity.on_report(node, payload)
        # duplication health: per-dup lag/shipping entries feeding the
        # dup_stats surface and the failover drill's drain evidence
        self.duplication.on_report(node, payload)
        # watchdog digest + typed events -> the ClusterHealth machine;
        # the reply acks the journaled event seq so the node can stop
        # re-shipping those events
        health_ack = self.health.on_report(node, payload)
        # compaction stagger: demand in, leased grant out (None = the
        # node reported no compaction block — say nothing)
        compact_grant = self.compaction.on_report(node, payload)
        # recovery adoption: a replica holding a HIGHER ballot than our
        # state knows (e.g. updates lost across a leader change) is the
        # truth — adopt its view before answering
        for entry in payload.get("stored", []):
            gpid = tuple(entry["gpid"])
            if gpid[0] not in self.state.apps or "primary" not in entry:
                continue
            pc = self.state.get_partition(*gpid)
            if entry["ballot"] > pc.ballot:
                self.state.update_partition(gpid[0], gpid[1], PartitionConfig(
                    ballot=entry["ballot"], primary=entry["primary"],
                    secondaries=list(entry["secondaries"])))
        configs = []
        for app in self.list_apps():
            for pidx in range(app.partition_count):
                pc = self.state.get_partition(app.app_id, pidx)
                if node in pc.members():
                    configs.append({
                        "gpid": (app.app_id, pidx), "ballot": pc.ballot,
                        "primary": pc.primary,
                        "secondaries": list(pc.secondaries),
                        "partition_count": app.partition_count,
                        "envs": dict(app.envs),
                    })
        gc = []
        # freezed level suspends GC entirely: an operator recovering a
        # meta that lost its state sets freezed FIRST, so replicas of
        # apps this meta does not know yet are never deleted before
        # `recover` can adopt them
        if self.function_level != "freezed":
            for entry in payload.get("stored", []):
                app_id = tuple(entry["gpid"])[0]
                # dropped apps stay in state (recall window) — only
                # replicas of apps unknown to meta entirely are garbage
                if app_id not in self.state.apps:
                    gc.append(tuple(entry["gpid"]))
        reply = {"configs": configs, "gc": gc}
        if compact_grant is not None:
            reply["compact_grant"] = compact_grant
        if health_ack is not None:
            reply["health_ack"] = health_ack
        self.net.send(self.name, src, "config_sync_reply", reply)

    def tenant_stats(self) -> dict:
        """Cluster-folded per-tenant QoS view from the config-sync
        tenant blocks. Counters fold by MAX, not sum: in-process sim
        stubs share ONE process-global registry, so every node reports
        the identical snapshot and a sum would multiply by node count
        (same dedupe rule as the collector's workload fold); deployed,
        max reports the worst node — the honest aggregate for an SLO
        check. The burn ratio keeps the worst node's value; brownout
        is true if ANY node holds the gate (the aggressor is shed
        wherever it lands)."""
        tenants: Dict[str, dict] = {}
        for node, rep in sorted(self._tenant_reports.items()):
            for name, st in (rep.get("tenants") or {}).items():
                agg = tenants.setdefault(name, {
                    "weight": st.get("weight"),
                    "cu_budget": st.get("cu_budget"),
                    "cu_total": 0, "cu_ratio": 0.0,
                    "shed": 0, "overbudget": 0,
                    "browned": False, "nodes": 0})
                agg["cu_total"] = max(agg["cu_total"],
                                      int(st.get("cu_total") or 0))
                agg["cu_ratio"] = max(agg["cu_ratio"],
                                      float(st.get("cu_ratio") or 0.0))
                agg["shed"] = max(agg["shed"],
                                  int(st.get("shed") or 0))
                agg["overbudget"] = max(agg["overbudget"],
                                        int(st.get("overbudget") or 0))
                agg["browned"] = agg["browned"] or bool(st.get("browned"))
                agg["nodes"] += 1
        return {"tenants": tenants,
                "nodes_reporting": len(self._tenant_reports)}

    def workload_status(self, app_name: str = "") -> dict:
        """Per-table workload shape rollup from the config-sync
        digests: partition rows + one folded table row (counts sum,
        percentile-ish stats take the worst partition)."""
        from pegasus_tpu_torch.server.workload import fold_summaries

        apps = {}
        for app in self.list_apps():
            if app_name and app.app_name != app_name:
                continue
            apps[app.app_id] = app.app_name
        out: dict = {}
        for gpid, wl in sorted(self._workload_reports.items()):
            name = apps.get(gpid[0])
            if name is None:
                continue
            tbl = out.setdefault(name, {"partitions": []})
            tbl["partitions"].append(dict(wl, gpid=list(gpid)))
        for name, tbl in out.items():
            tbl["table"] = fold_summaries(tbl["partitions"])
        return out

    # ---- DDL surface (parity: meta_service.cpp:480-571) ---------------

    def create_app(self, app_name: str, partition_count: int,
                   replica_count: int = 3,
                   envs: Optional[Dict[str, str]] = None,
                   restore_from: Optional[dict] = None) -> int:
        if self.state.find_app(app_name) is not None:
            raise PegasusError(ErrorCode.ERR_APP_EXIST, app_name)
        nodes = self.fd.alive_workers()
        if not nodes:
            raise PegasusError(ErrorCode.ERR_NOT_ENOUGH_MEMBER,
                               "no alive replica servers")
        # the DESIRED replica count is preserved even when fewer nodes are
        # alive now — the guardian restores the level as nodes return
        # (placement clamps, the app state doesn't)
        app = AppState(self.state.next_app_id(), app_name, partition_count,
                       AS_AVAILABLE, dict(envs or {}), replica_count)
        # restore-from-backup starts primary-only: secondaries join later
        # via LT_APP learning of the RESTORED state (guardian is held off
        # until the primary's download completes)
        placed = 1 if restore_from else min(replica_count, len(nodes))
        configs = []
        for pidx in range(partition_count):
            members = [nodes[(pidx + i) % len(nodes)]
                       for i in range(placed)]
            configs.append(PartitionConfig(
                ballot=1, primary=members[0], secondaries=members[1:]))
        self.state.put_app(app, configs)
        if restore_from:
            for pidx in range(partition_count):
                self.pending_restores[(app.app_id, pidx)] = dict(
                    restore_from)
            self.persist_pending_restores()
        for pidx, pc in enumerate(configs):
            self._propose(app.app_id, pidx, pc)
        if app.envs:
            self._propagate_envs(app)
        if restore_from:
            self.backup.drive_restores()
        return app.app_id

    def drop_app(self, app_name: str) -> None:
        app = self.state.find_app(app_name)
        if app is None:
            raise PegasusError(ErrorCode.ERR_APP_NOT_EXIST, app_name)
        app.status = AS_DROPPED
        self.state.put_app(app)
        for pidx in range(app.partition_count):
            pc = self.state.get_partition(app.app_id, pidx)
            old_members = pc.members()
            dead_pc = PartitionConfig(ballot=pc.ballot + 1, primary="",
                                      secondaries=[])
            self.state.update_partition(app.app_id, pidx, dead_pc)
            for node in old_members:
                self._send_proposal(node, app, pidx, dead_pc)

    def recall_app(self, app_name: str) -> int:
        """Parity: recall_app — resurrect a dropped table inside the recall
        window (data dirs still on the nodes)."""
        if self.state.find_app(app_name) is not None:
            # the name is back in use by a live table — recalling would
            # create two AVAILABLE apps with one name (reference rejects)
            raise PegasusError(ErrorCode.ERR_APP_EXIST, app_name)
        app = self.state.find_dropped_app(app_name)
        if app is None:
            raise PegasusError(ErrorCode.ERR_APP_NOT_EXIST, app_name)
        if not self.fd.alive_workers():
            raise PegasusError(ErrorCode.ERR_NOT_ENOUGH_MEMBER,
                               "no alive replica servers to recall onto")
        app.status = AS_AVAILABLE
        self.state.put_app(app)
        for pidx in range(app.partition_count):
            pc = self.state.get_partition(app.app_id, pidx)
            # reuse the last known membership before the drop is gone;
            # fall back to fresh placement
            members = [n for n in pc.members() if self.fd.is_alive(n)]
            if not members:
                nodes = self.fd.alive_workers()
                members = [nodes[(pidx + i) % len(nodes)]
                           for i in range(min(app.max_replica_count,
                                              len(nodes)))]
            new_pc = PartitionConfig(ballot=pc.ballot + 1,
                                     primary=members[0],
                                     secondaries=members[1:])
            self.state.update_partition(app.app_id, pidx, new_pc)
            self._propose(app.app_id, pidx, new_pc)
        return app.app_id

    def list_apps(self) -> List[AppState]:
        return [a for a in self.state.apps.values()
                if a.status == AS_AVAILABLE]

    def query_config(self, app_name: str
                     ) -> Tuple[int, int, List[PartitionConfig]]:
        """Parity: query_cfg (idl/rrdb.thrift:366) — (app_id,
        partition_count, configs)."""
        app = self.state.find_app(app_name)
        if app is None:
            raise PegasusError(ErrorCode.ERR_APP_NOT_EXIST, app_name)
        return app.app_id, app.partition_count, [
            self.state.get_partition(app.app_id, pidx)
            for pidx in range(app.partition_count)]

    def update_app_envs(self, app_name: str, envs: Dict[str, str]) -> None:
        app = self.state.find_app(app_name)
        if app is None:
            raise PegasusError(ErrorCode.ERR_APP_NOT_EXIST, app_name)
        app.envs.update(envs)
        self.state.put_app(app)
        self._propagate_envs(app)

    def del_app_envs(self, app_name: str, keys: List[str]) -> int:
        """Parity: shell del_app_envs — drop named per-table envs; the
        full (reduced) set re-propagates so nodes converge on removal."""
        app = self.state.find_app(app_name)
        if app is None:
            raise PegasusError(ErrorCode.ERR_APP_NOT_EXIST, app_name)
        removed = 0
        for k in keys:
            removed += app.envs.pop(k, None) is not None
        self.state.put_app(app)
        self._propagate_envs(app)
        return removed

    def clear_app_envs(self, app_name: str,
                       prefix: str = "") -> int:
        """Parity: shell clear_app_envs [-p prefix]."""
        app = self.state.find_app(app_name)
        if app is None:
            raise PegasusError(ErrorCode.ERR_APP_NOT_EXIST, app_name)
        victims = [k for k in app.envs if k.startswith(prefix)]
        for k in victims:
            del app.envs[k]
        self.state.put_app(app)
        self._propagate_envs(app)
        return len(victims)

    def rename_app(self, old_name: str, new_name: str) -> None:
        """Parity: shell rename (RPC_CM_RENAME_APP). Routing is by
        app_id, so a rename is pure metadata — clients resolving the new
        name pick up the same partitions on their next config query."""
        if self.state.find_app(new_name) is not None:
            raise PegasusError(ErrorCode.ERR_INVALID_PARAMETERS,
                               f"{new_name} already exists")
        app = self.state.find_app(old_name)
        if app is None:
            raise PegasusError(ErrorCode.ERR_APP_NOT_EXIST, old_name)
        app.app_name = new_name
        self.state.put_app(app)
        # backup policies cover tables BY NAME — follow the rename or
        # the table silently drops out of its backup schedule
        self.backup.on_app_renamed(old_name, new_name)

    def set_meta_level(self, level: str) -> str:
        """Parity: shell set_meta_level (RPC_CM_CONTROL_META).
        freezed|steady|lively — see function_level in __init__."""
        if level not in ("freezed", "steady", "lively"):
            raise PegasusError(ErrorCode.ERR_INVALID_PARAMETERS, level)
        self.function_level = level
        self.storage.set("/meta_level", level)
        return level

    def set_app_replica_count(self, app_name: str, count: int) -> int:
        """Parity: shell set_replica_count (online max_replica_count
        update, RPC_CM_SET_MAX_REPLICA_COUNT). The guardian converges
        membership: add-learner cures grow under-replicated partitions;
        the over-replication shed path drains extras one per tick."""
        if count < 1:
            raise PegasusError(ErrorCode.ERR_INVALID_PARAMETERS,
                               str(count))
        app = self.state.find_app(app_name)
        if app is None:
            raise PegasusError(ErrorCode.ERR_APP_NOT_EXIST, app_name)
        app.max_replica_count = count
        self.state.put_app(app)
        return count

    def cluster_info(self) -> dict:
        """Parity: shell cluster_info."""
        apps = self.list_apps()
        return {
            "meta": self.name,
            "meta_leader": self.election.leader,
            "term": self.election.term,
            "meta_level": self.function_level,
            "alive_nodes": self.fd.alive_workers(),
            "app_count": len(apps),
            "partition_count": sum(a.partition_count for a in apps),
            "state_seq": self.storage.seq,
        }

    def query_restore_status(self, app_name: str = "") -> List[dict]:
        """Restore progress per pending partition (parity: shell
        query_restore_status): which partitions of a
        created-from-backup app are still downloading their
        checkpoint."""
        want_id = None
        if app_name:
            app = self.state.find_app(app_name)
            if app is None:
                raise PegasusError(ErrorCode.ERR_APP_NOT_EXIST, app_name)
            want_id = app.app_id
        out = []
        for gpid, info in sorted(self.pending_restores.items()):
            if want_id is not None and gpid[0] != want_id:
                continue
            out.append({"gpid": list(gpid), "status": "restoring",
                        **{k: info[k] for k in ("policy", "backup_id")
                           if k in info}})
        return out

    def recover_from_reports(self) -> dict:
        """Rebuild app state for replicas this meta does not know
        (parity: shell `recover` from replica list, commands.h:209 —
        used after total meta-state loss). For each unknown app_id in
        the nodes' config-sync reports, recreate the app (named
        recovered_<id>; rename_app afterwards) adopting each partition's
        HIGHEST-ballot reported config. Run under `freezed` level so
        config-sync GC cannot delete the orphans first."""
        by_app: Dict[int, Dict[int, dict]] = {}
        for _node, stored in self._stored_reports.items():
            for entry in stored:
                gpid = tuple(entry["gpid"])
                if gpid[0] in self.state.apps or "ballot" not in entry:
                    continue
                cur = by_app.setdefault(gpid[0], {}).get(gpid[1])
                if cur is None or entry["ballot"] > cur["ballot"]:
                    by_app[gpid[0]][gpid[1]] = entry
        created = []
        for app_id in sorted(by_app):
            parts = by_app[app_id]
            partition_count = max(
                int(e.get("partition_count") or 0)
                for e in parts.values()) or (max(parts) + 1)
            app = AppState(app_id, f"recovered_{app_id}",
                           partition_count, AS_AVAILABLE, {}, 3)
            configs = []
            for pidx in range(partition_count):
                e = parts.get(pidx)
                if e is None:
                    # no survivor reported this partition: leave it
                    # empty for ddd_diagnose / propose to resolve
                    configs.append(PartitionConfig(ballot=0, primary="",
                                                   secondaries=[]))
                else:
                    configs.append(PartitionConfig(
                        ballot=e["ballot"], primary=e.get("primary", ""),
                        secondaries=list(e.get("secondaries") or [])))
            self.state.put_app(app, configs)
            created.append({"app_id": app_id, "app_name": app.app_name,
                            "partition_count": partition_count,
                            "recovered_partitions": len(parts)})
        return {"created": created,
                "nodes_reporting": sorted(self._stored_reports)}

    def ddd_diagnose(self) -> List[dict]:
        """Parity: shell ddd_diagnose (DDD = 'double-dead diagnosis',
        partition_guardian's on_ddd): partitions with no live primary —
        the guardian cannot cure them without operator action (a member
        returning, or a `propose` forcing a primary)."""
        out = []
        for app in self.list_apps():
            for pidx in range(app.partition_count):
                pc = self.state.get_partition(app.app_id, pidx)
                dead_primary = bool(pc.primary) and not self.fd.is_alive(
                    pc.primary)
                if pc.primary and not dead_primary:
                    continue
                out.append({
                    "gpid": [app.app_id, pidx],
                    "app_name": app.app_name,
                    "ballot": pc.ballot,
                    "last_primary": pc.primary,
                    "secondaries": list(pc.secondaries),
                    "alive_members": [m for m in pc.members()
                                      if self.fd.is_alive(m)],
                })
        return out

    def propose(self, app_name: str, pidx: int, action: str,
                node: str, force: bool = False) -> None:
        """Parity: shell propose — a manual config proposal
        (ASSIGN_PRIMARY / ADD_SECONDARY / DOWNGRADE_TO_INACTIVE) for
        operator-driven recovery of partitions the guardian won't touch.

        assign_primary requires `node` to be alive and (unless `force`)
        already a member holding the partition's data — promoting a
        non-member opens an EMPTY replica there and serves empty reads.
        `force=True` is the operator's explicit data-loss acknowledgment
        for unrecoverable partitions."""
        app = self.state.find_app(app_name)
        if app is None:
            raise PegasusError(ErrorCode.ERR_APP_NOT_EXIST, app_name)
        if not 0 <= pidx < app.partition_count:
            raise PegasusError(ErrorCode.ERR_INVALID_PARAMETERS,
                               f"pidx {pidx}")
        gpid = (app.app_id, pidx)
        pc = self.state.get_partition(app.app_id, pidx)
        if action in ("assign_primary", "add_secondary"):
            if not self.fd.is_alive(node):
                raise PegasusError(ErrorCode.ERR_INVALID_PARAMETERS,
                                   f"{node} is not alive")
        if action == "assign_primary":
            if pc.primary == node:
                return
            # a revived ex-member is out of pc.members() (its death was
            # reconciled away) but still HOLDS the data on disk — its
            # config-sync stored-replica report proves it. That is the
            # DDD-recovery case propose exists for (parity: shell
            # `propose`/`recover`, commands.h:209-211); only a node with
            # neither membership nor stored data needs `force`.
            holds_data = any(
                tuple(e["gpid"]) == gpid
                for e in self._stored_reports.get(node, []))
            if node not in pc.members() and not holds_data and not force:
                raise PegasusError(
                    ErrorCode.ERR_INVALID_PARAMETERS,
                    f"{node} holds no replica of {app_name}.{pidx} — "
                    "pass force=true to accept an empty primary")
            # keep the old primary only if it is alive — appending a
            # dead node would park it in the config forever (its death
            # event already fired and will not fire again)
            keep_old = (pc.primary and pc.primary != node
                        and self.fd.is_alive(pc.primary))
            new_pc = PartitionConfig(
                ballot=pc.ballot + 1, primary=node,
                secondaries=[s for s in pc.secondaries if s != node] +
                            ([pc.primary] if keep_old else []))
        elif action == "add_secondary":
            if node in pc.members():
                return
            if not pc.primary:
                raise PegasusError(ErrorCode.ERR_INVALID_STATE,
                                   "no primary to learn from")
            self._pending_learns[gpid] = (node, self.clock())
            self.net.send(self.name, pc.primary, "add_learner_cmd", {
                "gpid": gpid, "learner": node})
            return
        elif action == "downgrade":
            if node not in pc.secondaries:
                raise PegasusError(ErrorCode.ERR_INVALID_PARAMETERS,
                                   f"{node} is not a secondary")
            new_pc = PartitionConfig(
                ballot=pc.ballot + 1, primary=pc.primary,
                secondaries=[s for s in pc.secondaries if s != node])
        else:
            raise PegasusError(ErrorCode.ERR_INVALID_PARAMETERS, action)
        self.state.update_partition(app.app_id, pidx, new_pc)
        self._propose(app.app_id, pidx, new_pc)
        if action == "downgrade":
            self._send_proposal(node, app, pidx, new_pc)

    # ---- guardian (parity: partition_guardian.h:41) -------------------

    def _on_node_dead(self, node: str) -> None:
        for app in self.list_apps():
            for pidx in range(app.partition_count):
                pc = self.state.get_partition(app.app_id, pidx)
                if node not in pc.members():
                    continue
                if pc.primary == node:
                    alive_secs = [s for s in pc.secondaries
                                  if self.fd.is_alive(s)]
                    if not alive_secs:
                        continue  # DDD: wait for a node to return
                    new_pc = PartitionConfig(
                        ballot=pc.ballot + 1, primary=alive_secs[0],
                        secondaries=alive_secs[1:])
                else:
                    new_pc = PartitionConfig(
                        ballot=pc.ballot + 1, primary=pc.primary,
                        secondaries=[s for s in pc.secondaries if s != node])
                self.state.update_partition(app.app_id, pidx, new_pc)
                self._propose(app.app_id, pidx, new_pc)

    def _on_replication_error(self, gpid: Gpid, member: str) -> None:
        """A member NAK'd replication (e.g. gap after a lost prepare):
        remove it; the guardian pass re-adds it as a learner."""
        app = self.state.apps.get(gpid[0])
        if app is None or app.status != AS_AVAILABLE:
            return
        pc = self.state.get_partition(*gpid)
        if member == pc.primary or member not in pc.members():
            return
        new_pc = PartitionConfig(
            ballot=pc.ballot + 1, primary=pc.primary,
            secondaries=[s for s in pc.secondaries if s != member])
        self.state.update_partition(gpid[0], gpid[1], new_pc)
        self._propose(gpid[0], gpid[1], new_pc)
        # the removed node must deactivate too
        self._send_proposal(member, app, gpid[1], new_pc)

    def _on_replica_corrupted(self, gpid: Gpid, node: str) -> None:
        """A replica self-quarantined over storage corruption (block
        crc / index failure / disk IO error). The cure is removal +
        re-learn: a corrupt SECONDARY leaves the membership (ballot+1)
        and the guardian pass tops the partition back up with a fresh
        learner built from a healthy peer; a corrupt PRIMARY demotes —
        an alive secondary is promoted in the same config change (the
        client's retry + config refresh lands on it) and the sick node
        drops out. The quarantined node already trashed its store, so
        when the guardian picks it as the learn target it rebuilds from
        clean bytes, never from the corrupt ones."""
        app = self.state.apps.get(gpid[0])
        if app is None or app.status != AS_AVAILABLE:
            return
        # PR 5 quarantine firing mid-split: a corrupt REGISTERED child
        # must be unregistered (its single replica just trashed its
        # store) so the split re-spawns it from the parent — the normal
        # demote/remove cure below cannot repair a one-replica child
        if self.split.on_replica_corrupted(gpid, src_node=node):
            return
        pc = self.state.get_partition(*gpid)
        # a pending learn targeting the quarantined node is dead; clear
        # it BEFORE the membership check — a corrupt LEARNER is not in
        # members() (it was never upgraded), and leaving the entry
        # would stall the repair learn for the full learn timeout
        pending = self._pending_learns.get(gpid)
        if pending is not None and pending[0] == node:
            self._pending_learns.pop(gpid, None)
            self._pending_moves.pop(gpid, None)
        if node not in pc.members():
            return  # corrupt learner / duplicate report: nothing to cure
        if node == pc.primary:
            alive = [s for s in pc.secondaries if self.fd.is_alive(s)]
            if not alive:
                # no healthy member to promote: leave the config for
                # ddd_diagnose / an operator `propose` — promoting
                # nothing beats promoting nothing-with-data-loss
                return
            new_pc = PartitionConfig(ballot=pc.ballot + 1,
                                     primary=alive[0],
                                     secondaries=alive[1:])
        else:
            new_pc = PartitionConfig(
                ballot=pc.ballot + 1, primary=pc.primary,
                secondaries=[s for s in pc.secondaries if s != node])
        self.state.update_partition(gpid[0], gpid[1], new_pc)
        self._propose(gpid[0], gpid[1], new_pc)

    def _guardian_pass(self) -> None:
        """Re-replicate under-replicated partitions onto spare nodes."""
        now = self.clock()
        for app in self.list_apps():
            for pidx in range(app.partition_count):
                gpid = (app.app_id, pidx)
                if gpid in self.pending_restores:
                    continue  # no learners until the restore lands
                pc = self.state.get_partition(app.app_id, pidx)
                if not pc.primary:
                    continue
                pending = self._pending_learns.get(gpid)
                if len(pc.members()) >= app.max_replica_count:
                    # a pending learn on a FULL partition is a balancer
                    # copy-secondary move: keep its guard alive until the
                    # learner lands, dies, or times out (dropping it early
                    # would let a second move start and over-replicate)
                    if pending is not None:
                        learner, started = pending[0], pending[1]
                        if (learner in pc.members()
                                or now - started >= self._learn_timeout
                                or not self.fd.is_alive(learner)):
                            self._pending_learns.pop(gpid, None)
                            if learner not in pc.members():
                                # the move failed: forget the planned
                                # removal or a later unrelated learn would
                                # strip a healthy secondary
                                self._pending_moves.pop(gpid, None)
                    elif (len(pc.members()) > app.max_replica_count
                            and pc.secondaries):
                        # over-replicated (set_replica_count lowered the
                        # target): shed one secondary per pass — gradual,
                        # like the guardian's one-cure-per-tick style.
                        # Prefer shedding a dead one.
                        victim = next((s for s in pc.secondaries
                                       if not self.fd.is_alive(s)),
                                      pc.secondaries[-1])
                        new_pc = PartitionConfig(
                            ballot=pc.ballot + 1, primary=pc.primary,
                            secondaries=[s for s in pc.secondaries
                                         if s != victim])
                        self.state.update_partition(app.app_id, pidx,
                                                    new_pc)
                        self._propose(app.app_id, pidx, new_pc)
                        self._send_proposal(victim, app, pidx, new_pc)
                    continue
                if pending is not None:
                    learner, started = pending[0], pending[1]
                    last_sent = pending[2] if len(pending) > 2 else started
                    if (now - started < self._learn_timeout
                            and self.fd.is_alive(learner)):
                        # learn in flight: re-send the command at a slow
                        # cadence — the one-shot cmd (or its learn RPCs)
                        # may have been LOST in a partition/storm, and
                        # without a re-drive the cure stalls a full
                        # learn_timeout. The primary's add_learner and
                        # the learner's learn_request are idempotent.
                        if now - last_sent >= self._learn_resend:
                            self._pending_learns[gpid] = (learner,
                                                          started, now)
                            self.net.send(self.name, pc.primary,
                                          "add_learner_cmd",
                                          {"gpid": gpid,
                                           "learner": learner})
                        continue
                    self._pending_moves.pop(gpid, None)  # stale move, if any
                spare = [n for n in self.fd.alive_workers()
                         if n not in pc.members()]
                if not spare:
                    continue
                learner = spare[(app.app_id + pidx) % len(spare)]
                self._pending_learns[gpid] = (learner, now)
                self.net.send(self.name, pc.primary, "add_learner_cmd", {
                    "gpid": gpid, "learner": learner})

    def _on_learn_completed(self, gpid: Gpid, learner: str) -> None:
        app = self.state.apps.get(gpid[0])
        if app is None or app.status != AS_AVAILABLE:
            return
        self._pending_learns.pop(gpid, None)
        pc = self.state.get_partition(*gpid)
        if learner in pc.members():
            return
        secondaries = pc.secondaries + [learner]
        # a balancer copy-secondary move completes here: the source node
        # leaves in the same config update its TARGET learner joins in
        # (a different learner completing — e.g. a guardian heal — must
        # not trigger the removal)
        leaving = None
        move = self._pending_moves.get(gpid)
        if move is not None and move[0] == learner:
            leaving = move[1]
            del self._pending_moves[gpid]
        if leaving is not None and leaving in secondaries:
            secondaries = [s for s in secondaries if s != leaving]
        new_pc = PartitionConfig(ballot=pc.ballot + 1, primary=pc.primary,
                                 secondaries=secondaries)
        self.state.update_partition(gpid[0], gpid[1], new_pc)
        self._propose(gpid[0], gpid[1], new_pc)
        if leaving is not None and leaving not in new_pc.members():
            self._send_proposal(leaving, app, gpid[1], new_pc)
        # the newcomer needs the table's envs too (it wasn't a member when
        # they were last propagated)
        if app.envs:
            self.net.send(self.name, learner, "update_app_envs", {
                "app_id": app.app_id, "envs": dict(app.envs)})

    # ---- balancer (parity: meta_service rebalance RPC ->
    # greedy_load_balancer proposals) -----------------------------------

    def rebalance(self) -> List:
        """Compute and apply balance proposals (parity:
        RPC_CM_START_BALANCER -> server_load_balancer::rebalance).
        Primary moves apply immediately (zero-copy config change);
        secondary copies start a targeted learner flow and complete when
        the learn lands. Returns the proposals applied/started."""
        from pegasus_tpu_torch.meta.balancer import propose_app_balanced_moves

        nodes = self.fd.alive_workers()
        configs = {}
        for app in self.list_apps():
            if app.app_id in self.split._splits:
                # an in-flight split owns this app's configuration: a
                # balancer move racing the child registration / count
                # flip could relocate a fenced parent or start a learn
                # the flip invalidates — skip until the split lands
                # (start_partition_split refuses the mirror race)
                continue
            for pidx in range(app.partition_count):
                configs[(app.app_id, pidx)] = self.state.get_partition(
                    app.app_id, pidx)
        proposals = propose_app_balanced_moves(configs, nodes)
        self.elasticity._proposal_count.increment(len(proposals))
        for prop in proposals:
            app = self.state.apps[prop.gpid[0]]
            pc = self.state.get_partition(*prop.gpid)
            if prop.kind == "move_primary":
                if prop.to_node not in pc.secondaries:
                    continue  # config changed since proposal generation
                self._move_primary(prop.gpid, prop.to_node)
            else:  # copy_secondary via the learner flow
                if prop.gpid in self._pending_learns:
                    continue
                self._pending_moves[prop.gpid] = (prop.to_node,
                                                  prop.from_node)
                self._pending_learns[prop.gpid] = (prop.to_node,
                                                   self.clock())
                self.net.send(self.name, pc.primary, "add_learner_cmd", {
                    "gpid": prop.gpid, "learner": prop.to_node})
        return proposals

    def drain_node(self, node: str) -> int:
        """Move every primary OFF `node` (graceful offline — parity:
        admin_tools/pegasus_offline_node.sh's migrate-primaries step).
        Each affected partition promotes one remaining secondary via a
        zero-copy config change; the drained node stays a secondary so
        the operator can stop it without a read-availability dip and
        let the guardian re-replicate afterwards. Returns the number of
        primaries moved; partitions with no other member are skipped
        (dropping their primary would lose the partition)."""
        moved = 0
        for app in self.list_apps():
            for pidx in range(app.partition_count):
                pc = self.state.get_partition(app.app_id, pidx)
                if pc is None or pc.primary != node:
                    continue
                # only hand leadership to a LIVE secondary — in the
                # beacon-timeout window a dead one still sits in the
                # config and promoting it would black out the partition
                live = [s for s in pc.secondaries
                        if self.fd.is_alive(s)]
                if not live:
                    continue
                self._move_primary((app.app_id, pidx), live[0])
                moved += 1
        return moved

    def _move_primary(self, gpid, target: str) -> None:
        """Zero-copy leadership move: the target secondary becomes
        primary at ballot+1 and the old primary stays as a secondary
        (shared by the balancer's move_primary and drain_node)."""
        pc = self.state.get_partition(*gpid)
        new_pc = PartitionConfig(
            ballot=pc.ballot + 1, primary=target,
            secondaries=[s for s in pc.secondaries
                         if s != target] + [pc.primary])
        self.state.update_partition(gpid[0], gpid[1], new_pc)
        self._propose(gpid[0], gpid[1], new_pc)

    # ---- proposal delivery --------------------------------------------

    def _propose(self, app_id: int, pidx: int, pc: PartitionConfig) -> None:
        app = self.state.apps[app_id]
        for node in pc.members():
            self._send_proposal(node, app, pidx, pc)

    def _send_proposal(self, node: str, app: AppState, pidx: int,
                       pc: PartitionConfig) -> None:
        self.net.send(self.name, node, "config_proposal", {
            "gpid": (app.app_id, pidx), "ballot": pc.ballot,
            "primary": pc.primary, "secondaries": list(pc.secondaries),
            "partition_count": app.partition_count,
            # a partition created from a backup must not serve until its
            # restore lands — the replica gates clients on this flag
            "restoring": (app.app_id, pidx) in self.pending_restores,
            # a split parent whose child registered stays write-fenced on
            # whoever holds primaryship until the count flip
            "splitting": self.split.is_parent_fenced(app.app_id, pidx)})

    def _propagate_envs(self, app: AppState) -> None:
        nodes = set()
        for pidx in range(app.partition_count):
            nodes.update(self.state.get_partition(app.app_id,
                                                  pidx).members())
        for node in nodes:
            self.net.send(self.name, node, "update_app_envs", {
                "app_id": app.app_id, "envs": dict(app.envs)})
