"""ReplicaStub: one replica-server node hosting many partition replicas.

Parity: src/replica/replica_stub.{h,cpp} — a node owns all its `Replica`
instances, routes gpid-addressed messages to them (the rDSN layer-2
interception, src/runtime/service_engine.cpp:163), creates replicas on
meta config proposals, reports its stored replicas in config-sync, and
runs the failure-detector client side (beacons to meta).

All inter-node traffic is enveloped as ("replica", {gpid, type, payload})
so one network address serves every partition on the node.

The port's stub serves its replicas on the card (`device=None`) unless
the caller names the CPU.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

from pegasus_tpu_torch.replica.replica import (
    PartitionStatus,
    Replica,
    ReplicaBusyError,
    ReplicaConfig,
)
from pegasus_tpu_torch.server import tenancy
from pegasus_tpu_torch.server.tenancy import TENANTS
from pegasus_tpu_torch.utils.device import resolve_device
from pegasus_tpu_torch.utils.errors import StorageCorruptionError

Gpid = Tuple[int, int]  # (app_id, partition_index)


class _GpidTransport:
    """Binds a replica's sends to its node + gpid envelope. Prepares
    and prepare acks divert into the node's write flush window while
    one is open, so a window's worth of per-partition 2PC traffic to
    one peer collapses into a single prepare_batch/prepare_batch_ack
    message (group_commit.WriteFlushWindow)."""

    def __init__(self, net, node_name: str, gpid: Gpid,
                 window=None) -> None:
        self._net = net
        self._node = node_name
        self._gpid = gpid
        self._window = window

    def send(self, _src: str, dst: str, msg_type: str, payload) -> None:
        if (self._window is not None
                and self._window.queue_replica_msg(
                    dst, msg_type, self._gpid, payload)):
            return
        self._net.send(self._node, dst, "replica", {
            "gpid": self._gpid, "type": msg_type, "payload": payload})


class ReplicaStub:
    def __init__(self, name: str, data_dir, net,
                 clock: Optional[Callable[[], float]] = None,
                 sim_clock: Optional[Callable[[], float]] = None,
                 cluster_id: int = 1, device=None) -> None:
        """`data_dir`: one path or a list of paths (multi-disk layout —
        parity: fs_manager dir_nodes; replicas place on the least-loaded
        disk). `device`: where every replica's partition serves; None is
        the card (raises without CUDA), "cpu" the plain torch path."""
        from pegasus_tpu_torch.replica.fs_manager import FsManager

        self.name = name
        self.device = resolve_device(device)
        dirs = [data_dir] if isinstance(data_dir, str) else list(data_dir)
        self.fs = FsManager(dirs)
        self.data_dir = dirs[0]
        if os.environ.get("PEGASUS_ENCRYPT_AT_REST") == "1":
            # at-rest encryption (parity: FLAGS_encrypt_data_at_rest +
            # kms_key_provider): each data dir becomes an encryption
            # zone keyed by one per-server data key, wrapped by the
            # KMS root and stored beside the data it protects
            from pegasus_tpu_torch.security.kms import (
                KeyProvider, LocalKmsClient, root_key_from_env)
            from pegasus_tpu_torch.storage.efile import enable_encryption

            root = root_key_from_env()
            if root is None:
                # fail LOUDLY: a silent built-in fallback root would let
                # a cluster believe its disks are protected while the
                # key sits in the source tree
                raise RuntimeError(
                    "PEGASUS_ENCRYPT_AT_REST=1 requires PEGASUS_KMS_"
                    "ROOT_KEY (hex) or PEGASUS_KMS_ROOT_KEY_FILE")
            kms = LocalKmsClient(root)
            # ONE data key per server, shared by all its data dirs:
            # disk-migrate raw-copies files between dirs, which must
            # stay decryptable at the destination; the wrapped key is
            # replicated to every dir so no single disk is a key SPOF
            provider = KeyProvider.for_dirs(dirs, kms)
            for d in dirs:
                enable_encryption(d, provider)
            self._encryption_dirs = list(dirs)
        self.net = net
        self.clock = clock
        # FD timeline clock (sim time); defaults to the wall clock
        self.sim_clock = sim_clock or clock or (lambda: 0.0)
        self._start_clock = self.sim_clock()
        if sim_clock is not None:
            # the QoS governor's CU buckets must refill in VIRTUAL
            # seconds under sim — a compressed schedule burns hours of
            # virtual time in wall milliseconds, so wall-clocked
            # buckets would never refill. Same timebase threading as
            # scrub_tick/health_tick; the registry is process-global
            # (like METRICS) and sim nodes share one loop, so the last
            # node's clock is everyone's clock.
            TENANTS.set_clock(self.sim_clock)
        self.replicas: Dict[Gpid, Replica] = {}
        # the meta group (parity: failure_detector_multimaster — workers
        # beacon the whole group; only the leader acts, followers forward)
        self.meta_addrs: list = []
        self.meta_addr: Optional[str] = None
        # (gpid, dupid) -> ClusterDuplicator on this node's primaries
        self._dup_sessions: Dict = {}
        # this node's cluster identity (timetag cluster bits + the
        # duplication origin-echo filter); distinct per geo-replicated
        # cluster so master-master topologies don't ping-pong writes
        self.cluster_id = cluster_id
        # AIMD backpressure for dup catch-up shipping (all sessions on
        # this node share the WAN egress budget)
        from pegasus_tpu_torch.replica.dup_governor import DupGovernor

        self.dup_governor = DupGovernor(name, clock=self.sim_clock)
        # long-op dedup: a meta tick re-sends commands until done arrives;
        # a second copy of an in-flight backup/ingest must be ignored
        self._backup_inflight: set = set()
        self._ingest_inflight: set = set()
        # parent gpid -> split session state (see _split_advance)
        self._split_sessions: Dict[Gpid, dict] = {}
        # remote-command verb registry (parity: command_manager.h:52)
        from pegasus_tpu_torch.utils.command_manager import CommandManager

        self.commands = CommandManager()
        self._register_default_commands()
        # file-transfer service (parity: src/nfs/ — learning/migration
        # file copies between hosts); shared_fs=True means checkpoint
        # paths are locally reachable (onebox/sim) and transfers are
        # bypassed
        from pegasus_tpu_torch.replica.file_transfer import TransferServer

        # cluster auth secret (None = auth disabled); parity:
        # security/negotiation + ranger table ACLs
        self.auth_secret: Optional[str] = None
        self._negotiation = None  # lazy NegotiationServer (needs secret)
        self.shared_fs = True
        self.transfer = TransferServer(net, name, self.fs.data_dirs)
        self._fetch_sessions: Dict = {}
        self._last_beacon_ack = float("-inf")
        # node-level write flush window: plog group commit (one shared
        # flush/fsync per dispatch window across every partition) +
        # prepare fan-out aggregation; metrics live on the node's
        # "write" entity next to the transport's read-shed counters
        from pegasus_tpu_torch.replica.group_commit import WriteFlushWindow
        from pegasus_tpu_torch.utils.metrics import METRICS

        self.write_metrics = METRICS.entity("write", name)
        self.write_window = WriteFlushWindow(net, name, self.write_metrics)
        # storage-integrity observability + the background scrubber
        # (parity: the disk-error/scrub counters the reference keeps on
        # its server entity; the scrub itself is this repo's analogue
        # of rocksdb background verification)
        from pegasus_tpu_torch.storage.scrub import ReplicaScrubber

        storage_ent = METRICS.entity("storage", "node")
        self._quarantine_count = storage_ent.counter(
            "replica_quarantine_count")
        self._disk_io_errors = storage_ent.counter("disk_io_error_count")
        # split-fence observability: writes rejected ERR_SPLITTING while
        # a parent drains its tail (the hash-gate's misroute twin lives
        # on the same entity, incremented in PartitionServer._hash_gate)
        self._split_fence_rejects = storage_ent.counter(
            "split_fence_reject_count")
        # failover-drill fence observability: client writes rejected
        # typed ERR_DUP_FENCED while a table drains its duplication
        self._dup_fence_rejects = storage_ent.counter(
            "dup_fence_reject_count")
        # follower-read observability (per-table twins live on each
        # partition's "replica" entity): reads answered by a SECONDARY
        # under its beacon lease, reads bounced typed ERR_STALE_REPLICA,
        # and the subset of bounces caused by a lapsed lease
        self._follower_reads = storage_ent.counter("follower_read_count")
        self._stale_bounces = storage_ent.counter("stale_bounce_count")
        self._lease_rejects = storage_ent.counter(
            "read_lease_reject_count")
        self.scrubber = ReplicaScrubber(
            lambda: self.replicas, self._on_scrub_corruption,
            clock=self.sim_clock)
        # node-scoped foreground-pressure twins of the transport's
        # process-wide "rpc"/"dispatch" counters: the stub's own gates
        # (deadline fast-fail, injected shedding) count HERE, so sim
        # clusters sharing one process registry still attribute
        # pressure to the node that felt it
        self.node_rpc_metrics = METRICS.entity("rpc", name,
                                               {"node": name})
        self._node_read_shed = self.node_rpc_metrics.counter(
            "read_shed_count")
        self._node_deadline_expired = self.node_rpc_metrics.counter(
            "deadline_expired_count")
        self._beacon_age_gauge = self.node_rpc_metrics.gauge(
            "beacon_ack_age_s")
        # sustained-shed injection point for incident drills (the PR 2
        # chaos surface): `FAIL_POINTS.cfg("stub_read_shed:<node>", ...)`
        # makes THIS node's read gate shed with ERR_BUSY
        self._shed_fp_name = f"stub_read_shed:{name}"
        # chaos surface for lease-expiry fencing:
        # `FAIL_POINTS.cfg("fd::beacon_drop:<node>", ...)` drops THIS
        # node's outgoing FD beacons so a test can lapse one secondary's
        # read lease deterministically (seeded like every fail point)
        self._beacon_drop_fp_name = f"fd::beacon_drop:{name}"
        # flight recorder + health watchdog (utils/timeseries, utils/
        # health): fixed-cadence ring capture over this node's metric
        # entities, rules journaling typed events, digest riding
        # config-sync to the meta ClusterHealth machine
        from pegasus_tpu_torch.utils.health import HealthEngine
        from pegasus_tpu_torch.utils.timeseries import FlightRecorder

        self.recorder = FlightRecorder(
            name, clock=self.clock or self.sim_clock,
            owns=self._owns_entity)
        self.health = HealthEngine(name, self.recorder)
        net.register(name, self.on_message)
        batch_reg = getattr(net, "register_batch", None)
        if batch_reg is not None:
            # transport flush-window hook: a consecutive run of queued
            # client reads delivers as ONE batch, and its point ops
            # (get/ttl/multi_get(sort keys)/batch_get) serve through the
            # cross-partition read coordinator in one flush
            batch_reg(name, "client_read", self._on_client_read_batch)
            # and a consecutive run of queued client writes shares ONE
            # group-commit window (solo writes over TCP coalesce their
            # plog hardening + prepare fan-out without client changes)
            batch_reg(name, "client_write", self._on_client_write_window)
        # load existing replica dirs across every data dir (parity:
        # replica_stub boot scan, replica_stub.cpp:594 load_replicas per
        # disk); each dir carries a .replica_info with its partition_count
        for gpid, rdir in self.fs.scan_replicas().items():
            info_path = os.path.join(rdir, ".replica_info")
            partition_count = 1
            if os.path.exists(info_path):
                import json
                with open(info_path) as f:
                    partition_count = json.load(f)["partition_count"]
            try:
                self._open_replica(gpid, partition_count)
            except (StorageCorruptionError, OSError) as e:
                # a replica whose store fails its integrity checks at
                # boot must not take the whole node down: retire it to
                # trash and let the guardian re-learn it onto us (the
                # node will report it missing at the next config_sync)
                self._quarantine_count.increment()
                if isinstance(e, OSError):
                    self._disk_io_errors.increment()
                    self.fs.note_io_error(rdir, e)
                self.replicas.pop(gpid, None)
                try:
                    self.fs.trash_replica(gpid)
                except OSError:
                    pass

    def _register_default_commands(self) -> None:
        """The node's built-in control verbs (parity: the verbs replicas
        register with command_manager — slow-query dumps, replica info,
        metrics; invoked via shell remote_command, commands.h:111)."""
        from pegasus_tpu_torch.replica.replica import PartitionStatus

        def slow_query_dump(args):
            clear = "clear" in args
            out = []
            for gpid, r in sorted(self.replicas.items()):
                # one shared log per replica; the name prefix tells the
                # request class apart
                for rep in r.server.slow_log.dump(clear=clear):
                    kind = ("write" if rep.get("name", "").startswith(
                        "write.") else "read")
                    out.append(dict(rep, gpid=list(gpid), kind=kind))
            return sorted(out, key=lambda d: -d.get("total_ms", 0))

        def replica_info(_args):
            return [{"gpid": list(gpid),
                     "status": PartitionStatus(r.status).name,
                     "ballot": r.config.ballot,
                     "last_committed": r.last_committed_decree,
                     "last_prepared": r.last_prepared_decree(),
                     "partition_count": r.server.partition_count}
                    for gpid, r in sorted(self.replicas.items())]

        def metrics_dump(args):
            from pegasus_tpu_torch.utils.metrics import METRICS

            return METRICS.snapshot(args[0] if args else None)

        def flush_all(_args):
            n = 0
            for r in self.replicas.values():
                if r.server.engine.flush():
                    n += 1
            return f"flushed {n} replicas"

        self.commands.register(
            "slow-query-dump", slow_query_dump,
            "dump recent slow requests (arg 'clear' empties the ring)")
        self.commands.register(
            "replica.info", replica_info,
            "list hosted replicas with roles and decrees")
        self.commands.register("metrics", metrics_dump,
                               "metrics snapshot [entity_type]")
        self.commands.register("flush", flush_all,
                               "flush every hosted replica's memtable")

        def task_profiler(args):
            from pegasus_tpu_torch.utils.profiler import PROFILER

            return PROFILER.control(args)

        self.commands.register(
            "task-profiler", task_profiler,
            "per-task-code profiler toollet: enable|disable|clear|dump "
            "(queue/exec latency + qps per message type)")

        def trace_dump(args):
            # the cross-node stitch's fan-out target: this node's span
            # ring (+ tail-kept traces), optionally one trace only
            from pegasus_tpu_torch.utils import tracing

            return tracing.ring_for(self.name).dump(
                args[0] if args else None)

        def trace_list(args):
            from pegasus_tpu_torch.utils import tracing

            limit = int(args[0]) if args else 16
            return tracing.ring_for(self.name).slow_roots(limit)

        self.commands.register(
            "trace-dump", trace_dump,
            "dump this node's spans (arg: one trace id) for stitching")
        self.commands.register(
            "trace-list", trace_list,
            "list this node's tail-kept slow trace roots [limit]")

        def fs_stats(_args):
            return self.fs.stats()

        def clean_trash(args):
            age = float(args[0]) if args else 86400.0
            return self.fs.clean_trash(age)

        def migrate(args):
            import os as _os

            app_id, pidx, dest = int(args[0]), int(args[1]), args[2]
            gpid = (app_id, pidx)
            # validate EVERYTHING before taking the replica down — a bad
            # destination must not leave the partition unserved
            if _os.path.abspath(dest) not in self.fs.data_dirs:
                raise ValueError(f"{dest} is not a managed data dir")
            r = self.replicas.get(gpid)
            if r is None:
                raise ValueError(f"replica {gpid} not hosted here")
            count = r.server.partition_count
            del self.replicas[gpid]
            r.close()
            try:
                new_dir = self.fs.migrate(gpid, dest)
            finally:
                # reopen from wherever the replica now lives — even a
                # failed copy leaves the source intact
                self._open_replica(gpid, count)
            return new_dir

        self.commands.register("fs.stats", fs_stats,
                               "per-data-dir replicas + usage")
        self.commands.register("fs.clean-trash", clean_trash,
                               "remove trashed replica dirs older than "
                               "[seconds]")
        self.commands.register(
            "replica.migrate", migrate,
            "replica.migrate <app_id> <pidx> <dest_data_dir>")

        def hotkey(args):
            """hotkey <start|query|stop> <app_id> <pidx> <read|write>
            (parity: on_detect_hotkey, pegasus_server_impl.h:470)."""
            action, app_id, pidx, kind = (args[0], int(args[1]),
                                          int(args[2]), args[3])
            r = self.replicas.get((app_id, pidx))
            if r is None:
                raise ValueError(f"replica {(app_id, pidx)} not here")
            hc = r.server.hotkey_collectors[kind]
            if action == "start":
                hc.start()
                return "started"
            if action == "stop":
                hc.stop()
                return "stopped"
            result = hc.result
            return {"state": hc.state.value,
                    "hot_key": result.decode(errors="replace")
                    if result else None}

        self.commands.register(
            "hotkey", hotkey,
            "hotkey <start|query|stop> <app_id> <pidx> <read|write>")

        def server_info(_args):
            """Parity: shell server_info / server_stat basics."""
            import pegasus_tpu_torch

            by_status = {}
            for r in self.replicas.values():
                s = PartitionStatus(r.status).name
                by_status[s] = by_status.get(s, 0) + 1
            return {"node": self.name,
                    "version": pegasus_tpu_torch.__version__,
                    "uptime_s": round(self.sim_clock()
                                      - self._start_clock, 1),
                    "replica_count": len(self.replicas),
                    "by_status": by_status}

        def replica_disk(_args):
            """Per-replica on-disk footprint (parity: shell app_disk —
            sst + plog bytes per hosted replica)."""
            def size_of(path):
                try:
                    return os.path.getsize(path)
                except OSError:
                    return 0  # compaction/gc raced the stat — skip

            out = []
            for gpid, r in sorted(self.replicas.items()):
                d = r.server.engine.data_dir
                sst = os.path.join(d, "sst")
                try:
                    names = os.listdir(sst)
                except OSError:
                    names = []
                sst_bytes = sum(size_of(os.path.join(sst, f))
                                for f in names)
                log_bytes = size_of(r.log.path)
                out.append({"gpid": list(gpid),
                            "status": PartitionStatus(r.status).name,
                            "sst_bytes": sst_bytes,
                            "log_bytes": log_bytes,
                            "dir": d})
            return out

        self.commands.register("server.info", server_info,
                               "node version/uptime/replica summary")
        self.commands.register("replica.disk", replica_disk,
                               "per-replica sst+plog bytes")

        def fs_health(_args):
            """Per-dir health state + error counts (parity: the
            fs_manager disk_status surface shell query_disk_info
            reads)."""
            return self.fs.health()

        def replica_scrub(args):
            """replica.scrub [app_id|status [app_id]] — no args / an
            app_id triggers a full synchronous scrub of the hosted
            replicas (of that table) and returns per-partition results;
            'status' reports the paced background scrubber's progress
            + last results without triggering anything."""
            if args and args[0] == "status":
                app_id = int(args[1]) if len(args) > 1 else None
                return self.scrubber.status(app_id)
            app_id = int(args[0]) if args else None
            for gpid, r in sorted(list(self.replicas.items())):
                if app_id is not None and gpid[0] != app_id:
                    continue
                if self.replicas.get(gpid) is r:  # not quarantined yet
                    self.scrubber.scrub_now(gpid, r)
            return self.scrubber.status(app_id)

        self.commands.register("fs.health", fs_health,
                               "per-data-dir health + io error counts")
        self.commands.register(
            "replica.scrub", replica_scrub,
            "replica.scrub [app_id | status [app_id]] — trigger a full "
            "scrub / report scrub progress+results")

        def dup_stats(_args):
            """Per-duplication shipping stats on this node (scraped by
            tools/collector.py and the shell's dup_stats verb): lag,
            inflight decree, fail_mode, shipped bytes, last error —
            plus the node governor's throttle state."""
            return {
                "node": self.name,
                "sessions": [s.stats()
                             for s in self._dup_sessions.values()],
                "governor": self.dup_governor.status(),
            }

        self.commands.register("dup.stats", dup_stats,
                               "per-duplication lag/shipping stats + "
                               "governor state")

        def fault_set(args):
            """fault.set <drop|delay> <value> [src] [dst] — live-adjust
            this node's chaos plan (installs one if absent). The WAN
            scale harness uses it to black out / heal the inter-cluster
            link mid-run without restarting nodes."""
            kind, value = args[0], float(args[1])
            src = args[2] if len(args) > 2 and args[2] else None
            dst = args[3] if len(args) > 3 and args[3] else None
            plan = getattr(self.net, "fault_plan", None)
            if plan is None:
                install = getattr(self.net, "install_fault_plan", None)
                if install is not None:
                    from pegasus_tpu_torch.rpc.fault import FaultPlan

                    plan = FaultPlan()
                    install(plan)
            target = plan if plan is not None else self.net
            fn = getattr(target, f"set_{kind}", None)
            if fn is None:
                raise ValueError(f"no fault surface for {kind!r}")
            fn(value, src, dst)
            return "ok"

        self.commands.register(
            "fault.set", fault_set,
            "fault.set <drop|delay|duplicate> <value> [src] [dst] — "
            "live chaos-plan adjustment")

        def timeseries_dump(args):
            """timeseries-dump [entity_type [entity_id [metric
            [window_s]]]] — this node's flight-recorder ring slices
            ('' wildcards a position); the `shell timeline` fan-out
            target."""
            sel = [a if a else None for a in args[:3]]
            sel += [None] * (3 - len(sel))
            window = float(args[3]) if len(args) > 3 and args[3] else None
            return self.recorder.dump(sel[0], sel[1], sel[2], window)

        def health_status(_args):
            return self.health.status()

        def health_events(args):
            limit = int(args[0]) if args else 64
            entity_id = args[1] if len(args) > 1 and args[1] else None
            return self.health.events(limit, entity_id)

        def placement(args):
            """placement [workload [batch_bytes [n_windows]]] — the
            quantified pays/doesn't-pay offload verdict
            (ops/placement.py offload_breakdown) plus the live
            cost-model drift audit, operator-visible instead of
            PERF.md-only. The `mesh` block is the resident SPMD
            serving layer: verdict share, tunnel health, watchdog
            state. The breakdown's `compact` block is the compaction
            FILTER stage's mesh-vs-host verdict (drift class
            `mesh_compact`); pass n_windows to model a specific
            pipeline geometry instead of the default."""
            from pegasus_tpu_torch.ops.placement import (
                compact_breakdown,
                offload_breakdown,
            )
            from pegasus_tpu_torch.parallel.mesh_resident import MESH_SERVING
            from pegasus_tpu_torch.server.workload import DRIFT

            workload = args[0] if args else "rules"
            batch_bytes = int(args[1]) if len(args) > 1 else 1 << 20
            bd = offload_breakdown(workload, batch_bytes)
            if len(args) > 2 and args[2]:
                bd["compact"] = compact_breakdown(
                    batch_bytes, n_windows=int(args[2]))
            return {"breakdown": bd,
                    "drift": DRIFT.status(),
                    "mesh": MESH_SERVING.status()}

        self.commands.register(
            "placement", placement,
            "offload pays/doesn't-pay verdict + cost-model drift "
            "[workload [batch_bytes]]")

        def workload_stats(args):
            """Per-hosted-replica workload shape summaries + the node
            cost-model drift (shell `workload` wire-mode fan-out)."""
            from pegasus_tpu_torch.replica.replica import PartitionStatus
            from pegasus_tpu_torch.server.workload import DRIFT

            app_id = int(args[0]) if args else None
            rows = []
            for gpid, r in sorted(self.replicas.items()):
                if app_id is not None and gpid[0] != app_id:
                    continue
                if r.status != PartitionStatus.PRIMARY:
                    continue
                rows.append(dict(r.server.workload.summary(),
                                 gpid=list(gpid)))
            return {"node": self.name, "partitions": rows,
                    "drift": DRIFT.status()}

        self.commands.register(
            "workload.stats", workload_stats,
            "per-replica workload shape stats + drift [app_id]")

        def perf_explain(args):
            """perf.explain <json-spec> — run one captured op on a
            hosted PRIMARY and return the explain report.
            spec: {app_id, op, hash_key, sort_key?|sort_keys?,
            batch_size?} (keys utf-8)."""
            import json as _json

            from pegasus_tpu_torch.base.key_schema import key_hash_parts
            from pegasus_tpu_torch.replica.replica import PartitionStatus
            from pegasus_tpu_torch.server.explain import explain_op, op_from_spec

            spec = _json.loads(args[0])
            app_id = int(spec["app_id"])
            hk = spec.get("hash_key", "").encode()
            candidates = [
                (gpid, r) for gpid, r in sorted(self.replicas.items())
                if gpid[0] == app_id
                and r.status == PartitionStatus.PRIMARY]
            if not candidates:
                raise ValueError(f"no primary of app {app_id} here")
            if hk:
                want = (key_hash_parts(hk, b"")
                        % candidates[0][1].server.partition_count)
                owned = [(g, r) for g, r in candidates if g[1] == want]
                if not owned:
                    raise ValueError(
                        f"partition {want} of app {app_id} not here")
                _gpid, r = owned[0]
            else:
                _gpid, r = candidates[0]
            op, op_args, ph = op_from_spec(spec)
            return explain_op(r.server, op, op_args, partition_hash=ph)

        self.commands.register(
            "perf.explain", perf_explain,
            "run one captured op with a forced PerfContext and return "
            "the explain report (json spec)")

        self.commands.register(
            "timeseries-dump", timeseries_dump,
            "flight-recorder ring slices [entity_type [entity_id "
            "[metric [window_s]]]]")
        self.commands.register(
            "health.status", health_status,
            "this node's watchdog verdict: status + firing rules + "
            "ring memory")
        self.commands.register(
            "health.events", health_events,
            "this node's health-event journal [limit [entity_id]]")

        def qos_tenants(_args):
            """Per-tenant QoS governor snapshot: weight, CU budget +
            bucket level, consumed CU, shed/over-budget counts, and
            whether the brownout gate is holding this tenant (shell
            `tenants` + the collector's _tenants row read this)."""
            return TENANTS.snapshot()

        self.commands.register(
            "qos.tenants", qos_tenants,
            "per-tenant QoS snapshot: weights, CU budgets/levels, "
            "shed + over-budget counts, brownout state")

    def close(self) -> None:
        # release outstanding capture pins: a node closing mid-incident
        # must not leave the process's trace/profiler settings raised
        self.health.close()
        for r in self.replicas.values():
            r.close()
        if getattr(self, "_encryption_dirs", None):
            from pegasus_tpu_torch.storage.efile import disable_encryption

            for d in self._encryption_dirs:
                disable_encryption(d)

    # ---- replica management -------------------------------------------

    def _replica_dir(self, gpid: Gpid) -> str:
        return self.fs.replica_dir(gpid)

    def _open_replica(self, gpid: Gpid, partition_count: int) -> Replica:
        r = self.replicas.get(gpid)
        if r is None:
            import json
            rdir = self._replica_dir(gpid)
            os.makedirs(rdir, exist_ok=True)
            info_path = os.path.join(rdir, ".replica_info")
            if not os.path.exists(info_path):
                with open(info_path, "w") as f:
                    json.dump({"app_id": gpid[0], "pidx": gpid[1],
                               "partition_count": partition_count}, f)
            r = Replica(self.name, rdir,
                        _GpidTransport(self.net, self.name, gpid,
                                       self.write_window),
                        app_id=gpid[0], pidx=gpid[1],
                        partition_count=partition_count, clock=self.clock,
                        cluster_id=self.cluster_id, device=self.device)
            r.plog_sink = self.write_window
            r.write_metrics = self.write_metrics
            if self.sim_clock is not None:
                # range-read time budgets must burn VIRTUAL seconds
                # under sim (read_limiter.py), same threading as
                # scrub_tick/health_tick
                sc = self.sim_clock
                r.server.clock_ns = lambda: int(sc() * 1e9)
            r.on_learn_completed = (
                lambda learner, g=gpid: self._notify_learn_completed(g, learner))
            r.on_replication_error = (
                lambda member, decree, g=gpid:
                self._notify_replication_error(g, member))
            r.shared_fs = self.shared_fs
            r.on_remote_checkpoint = (
                lambda src, payload, g=gpid:
                self._start_ckpt_fetch(g, src, payload))
            self.replicas[gpid] = r
        return r

    def get_replica(self, gpid: Gpid) -> Optional[Replica]:
        return self.replicas.get(gpid)

    # ---- storage integrity: detect -> quarantine -> repair via re-learn
    # (parity: the reference's disk-error handling —
    # replica::handle_local_failure marks the replica PS_ERROR, the
    # stub's disk monitor flags the dir, and the partition guardian
    # re-replicates; the repair channel is the learner flow) -----------

    def scrub_tick(self) -> None:
        """Timer: one paced scrub advance (storage/scrub.py). Corrupt
        blocks found here quarantine their replica exactly like a
        corrupt client read would."""
        self.scrubber.tick()

    # ---- flight recorder + health watchdog ----------------------------

    def _owns_entity(self, ent) -> bool:
        """Which registry entities this node's recorder captures. In a
        real deployment the process IS the node, but in-process sim
        clusters share ONE registry, so ownership must be explicit:
        this node's named entities, the per-process singletons (which
        are node-local once deployed), the replicas it hosts, and its
        duplication sessions."""
        et, ei = ent.entity_type, ent.entity_id
        if ei == self.name:
            return True  # write / tracing / rpc:<node> / dup governor
        if (et, ei) in (("rpc", "dispatch"), ("storage", "node"),
                        ("workload", "node")):
            # KNOWN sim artifact: these singletons are shared by every
            # in-process stub, so one node's scrub/quarantine signal
            # fires the rule on ALL sim nodes (and meta folds them all
            # as degraded). Deployed, process == node and attribution
            # is exact; node-attributable signals use the per-node rpc
            # twins above instead. ("workload", "node") carries the
            # cost-model drift gauge — per-process like the placement
            # probe it audits.
            return True
        if et == "task":
            return True  # profiler codes (process == node deployed)
        if et == "tenant":
            # QoS tenant series (server/tenancy.py) — process-global
            # like the singletons above (same sim-sharing caveat);
            # deployed, each node journals its own tenants' burn
            return True
        if et in ("replica", "workload"):
            # per-partition entities share the replica id shape
            # (app.pidx): owned when this node hosts the partition
            try:
                a, p = ei.split(".")
                return (int(a), int(p)) in self.replicas
            except ValueError:
                return False
        if et == "duplication":
            return ent.attrs.get("node") == self.name
        return False

    def health_tick(self) -> None:
        """Timer: one flight-recorder pass + one watchdog evaluation.
        The WHOLE body coalesces to the recorder cadence (the timer may
        fire far faster — sim schedules compress hours of virtual time
        into milliseconds, so per-call work here must be one clock
        read on the off-cadence path). Firing rules auto-pin deeper
        capture (trace sample ratio + profiler) until clear."""
        from pegasus_tpu_torch.utils.profiler import PROFILER

        if not self.recorder.due():
            return
        now = self.sim_clock()
        self.beacon_ack_age()
        if PROFILER.enabled and (
                now - getattr(self, "_profiler_published_at", -1e18)
                >= 30.0):
            # keep the per-code "task" entities fresh so the recorder
            # rings (and Prometheus scrapes) see profiler stats — on
            # its OWN slower cadence: a publish re-reads every per-code
            # window, and paying that on every recorder tick made
            # compressed sim schedules (hours of virtual time) crawl
            self._profiler_published_at = now
            PROFILER.publish()
        # decay the cost-model drift gauge: a class whose kernel waves
        # stopped must age out instead of pinning the rule firing
        from pegasus_tpu_torch.server.workload import DRIFT

        DRIFT.refresh()
        # publish each tenant's cu_ratio (consumption vs budget) so the
        # recorder ring the tenant_brownout burn-rate rule reads is
        # fresh at every evaluation
        TENANTS.refresh()
        if self.recorder.tick() is not None:
            for ev in self.health.evaluate():
                if ev.rule == "tenant_brownout":
                    # aggressor-only brownout: the rule fires per
                    # TENANT entity, so only the outlier tenant's
                    # reads start shedding — everyone else is served
                    TENANTS.set_brownout(ev.entity[1], ev.firing)

    def _on_scrub_corruption(self, gpid: Gpid, exc: Exception) -> None:
        self._on_storage_error(gpid, exc)

    def _replica_for_path(self, path: str) -> Optional[Gpid]:
        """Map a corrupt file path to the replica whose store owns it
        (batched reads span partitions; the exception names the file)."""
        p = os.path.abspath(path)
        for gpid, r in self.replicas.items():
            d = os.path.abspath(r.data_dir)
            if p == d or p.startswith(d + os.sep):
                return gpid
        return None

    def _on_storage_error(self, gpid: Optional[Gpid], exc: Exception) -> int:
        """One storage failure -> typed error code + disk-health note +
        replica quarantine. Returns the ErrorCode int the RPC reply
        should carry."""
        from pegasus_tpu_torch.utils.errors import ErrorCode

        if isinstance(exc, StorageCorruptionError):
            code = int(ErrorCode.ERR_CHECKSUM_FAILED)
            if gpid is None:
                gpid = self._replica_for_path(exc.path)
        else:  # OSError: the disk itself is failing, mark its dir sick
            code = int(ErrorCode.ERR_DISK_IO_ERROR)
            self._disk_io_errors.increment()
            path = getattr(exc, "filename", None)
            if path is None and gpid is not None:
                r = self.replicas.get(gpid)
                if r is not None:
                    path = r.data_dir
            if path is not None:
                self.fs.note_io_error(path, exc)
        if gpid is not None:
            self._quarantine_replica(gpid, repr(exc))
        return code

    def _quarantine_replica(self, gpid: Gpid, reason: str) -> None:
        """Self-quarantine: stop serving, retire the sick store to
        trash (the boot scan ignores trash, so these bytes can never be
        reopened), drop the node caches that could still hold pre-
        corruption rows, and report to the partition guardian — which
        removes us from the membership and tops the partition back up
        by re-learning a fresh replica from a healthy peer (possibly
        onto this same node, on a healthy dir)."""
        r = self.replicas.pop(gpid, None)
        if r is None:
            return  # already quarantined (scrub + read raced)
        self._quarantine_count.increment()
        # quarantine firing mid-split: a session touching this replica
        # cannot outlive its store
        import shutil as _shutil

        sess = self._split_sessions.pop(gpid, None)
        if sess is not None:
            # the PARENT quarantined: abandon the session and reap the
            # half-built child (meta demotes us and re-drives the split
            # at the promoted primary, which re-spawns the child)
            child = self.replicas.pop(sess["child_gpid"], None)
            if child is not None:
                child.close()
            _shutil.rmtree(self._replica_dir(sess["child_gpid"]),
                           ignore_errors=True)
            # the child may already be REGISTERED at meta (session in
            # the register phase) with its config pointing at this
            # node: report it corrupted too, so meta unregisters it and
            # the re-driven split re-spawns it — otherwise the count
            # would flip onto a phantom child whose replica was just
            # reaped here (unregistered children make this a no-op)
            for meta in self._meta_targets():
                self.net.send(self.name, meta, "replica_corrupted", {
                    "gpid": sess["child_gpid"], "node": self.name,
                    "reason": reason})
        for parent_gpid, psess in self._split_sessions.items():
            if psess["child_gpid"] == gpid:
                # the half-built CHILD quarantined (its store is
                # trashed): restart the session from a fresh checkpoint
                # — resuming drain/register would replay the tail into
                # (or register) a child whose base bytes are gone
                psess["phase"] = "ckpt"
                parent = self.replicas.get(parent_gpid)
                if parent is not None:
                    parent.splitting = False  # re-fenced at drain
                break
        # no stale pre-repair bytes may serve: the node row cache drops
        # this partition NOW (install_engine/_on_store_publish re-cover
        # this when the re-learned engine installs, but the window
        # between quarantine and repair must be closed too)
        from pegasus_tpu_torch.server.row_cache import ROW_CACHE

        ROW_CACHE.invalidate_gid(gpid)
        r.status = PartitionStatus.ERROR
        try:
            r.close()
        except (OSError, RuntimeError, ValueError):
            pass  # the store is already known-bad; closing is best-effort
        try:
            self.fs.trash_replica(gpid)
        except OSError:
            pass
        # an in-flight checkpoint fetch must die with the replica
        sess = self._fetch_sessions.pop(gpid, None)
        if sess is not None:
            sess._finished = True
        for meta in self._meta_targets():
            self.net.send(self.name, meta, "replica_corrupted", {
                "gpid": gpid, "node": self.name, "reason": reason})

    # ---- message routing ----------------------------------------------

    def on_message(self, src: str, msg_type: str, payload) -> None:
        # every dispatch runs inside the node's write flush window:
        # plog appends it causes stage under one shared flush/fsync and
        # its prepare/ack fan-out aggregates per peer, all released
        # when the (outermost) window closes
        with self.write_window:
            self._dispatch_message(src, msg_type, payload)

    def _on_client_write_window(self, items) -> None:
        """Transport flush-window delivery for writes: a consecutive
        run of queued client_write messages shares ONE group-commit
        window — one plog flush/fsync and one prepare_batch per peer
        for the whole run. Each message keeps its own dispatch span
        parented to its own carried context (the transport's batch
        drain skips the generic per-message join point)."""
        from pegasus_tpu_torch.utils import tracing

        with self.write_window:
            for src, payload in items:
                span = tracing.start_server_span(
                    self.name, "client_write", payload.get("trace"))
                try:
                    with tracing.activate(span):
                        self._on_client_write(src, payload)
                finally:
                    if span is not None:
                        span.finish()

    def _dispatch_message(self, src: str, msg_type: str, payload) -> None:
        if msg_type == "replica":
            gpid = tuple(payload["gpid"])
            r = self.replicas.get(gpid)
            if r is None and payload["type"] == "add_learner":
                # a learner replica is born from the add-learner flow
                # (parity: on_add_learner creates the potential secondary)
                r = self._open_replica(
                    gpid, payload["payload"].get("partition_count", 1))
            if r is not None:
                try:
                    r.on_message(src, payload["type"], payload["payload"])
                except (StorageCorruptionError, OSError) as e:
                    # a SECONDARY can trip corruption too (apply-path
                    # compaction re-reads blocks, learning copies
                    # files): quarantine instead of killing the
                    # dispatcher — the primary sees the missing ack and
                    # the guardian repairs via re-learn
                    self._on_storage_error(gpid, e)
            return
        if msg_type in ("prepare_batch", "prepare_batch_ack"):
            # aggregated 2PC fan-out (group_commit): one message carries
            # (gpid, payload, trace-ctx) items for many partitions;
            # items route in order to each partition's solo handler, and
            # our own acks re-aggregate under the already-open flush
            # window. Tracing: every batched item keeps its OWN span
            # parented to its own hop context — N legs in one carrier
            # yield N spans, never N carriers
            from pegasus_tpu_torch.utils import tracing

            kind = ("prepare" if msg_type == "prepare_batch"
                    else "prepare_ack")
            for entry in payload["items"]:
                gpid, item = entry[0], entry[1]
                ctx = entry[2] if len(entry) > 2 else None
                leg_tenant = entry[3] if len(entry) > 3 else None
                r = self.replicas.get(tuple(gpid))
                if r is None:
                    continue
                span = None
                if ctx is not None:
                    if kind == "prepare_ack":
                        tracing.on_inbound_ctx(self.name, ctx)
                    else:
                        span = tracing.start_server_span(
                            self.name, f"replica.{kind}", ctx)
                        if span is not None and leg_tenant:
                            span.tags["tenant"] = leg_tenant
                try:
                    with tracing.activate(span):
                        r.on_message(src, kind, item)
                except (StorageCorruptionError, OSError) as e:
                    self._on_storage_error(tuple(gpid), e)
                finally:
                    if span is not None:
                        span.finish()
            return
        if msg_type == "negotiate":
            # SASL-style connection auth handshake (negotiation.h:37).
            # The identity binds to the CONNECTION session id, never to
            # the frame's self-reported src (any TCP peer could forge
            # that name); identities die with their connection.
            from pegasus_tpu_torch.security.negotiation import (
                NegotiationServer,
            )

            if not self.auth_secret:
                reply = {"stage": "fail", "reason": "auth disabled",
                         "rid": payload.get("rid")}
            else:
                if self._negotiation is None:
                    self._negotiation = NegotiationServer(
                        self.auth_secret)
                    closed = getattr(self.net, "on_session_closed",
                                     None)
                    if closed is not None:
                        closed(self._negotiation.forget_session)
                reply = self._negotiation.on_message(
                    self._peer_key(src), payload)
            self.net.send(self.name, src, "negotiate_reply", reply)
            return
        if msg_type == "config_proposal":
            self._on_config_proposal(src, payload)
            return
        if msg_type == "add_learner_cmd":
            self._on_add_learner_cmd(src, payload)
            return
        if msg_type == "update_app_envs":
            self._on_update_app_envs(src, payload)
            return
        if msg_type == "beacon_ack":
            self._last_beacon_ack = self.sim_clock()
            # ONLY the meta leader acks beacons, so the acker identifies
            # the current leader — route direct notifications
            # (learn_completed / replication_error) there, or they'd
            # keep going to a dead ex-leader after a meta failover
            self.meta_addr = src
            return
        if msg_type == "config_sync_reply":
            self._on_config_sync_reply(src, payload)
            return
        if msg_type == "backup_partition":
            self._on_backup_partition(src, payload)
            return
        if msg_type == "restore_partition":
            self._on_restore_partition(src, payload)
            return
        if msg_type == "trigger_ingest":
            self._on_trigger_ingest(src, payload)
            return
        if msg_type == "start_split":
            self._on_start_split(src, payload)
            return
        if msg_type == "detect_hotkey":
            # the elasticity controller's detect command (parity:
            # on_detect_hotkey): start both collectors on the flagged
            # partition; results flow back on the config_sync report
            gpid = tuple(payload["gpid"])
            r = self.replicas.get(gpid)
            # primaries only: client reads/writes flow through the
            # primary, so a collector started on a just-demoted node
            # would sample nothing and never finish
            if r is not None and r.status == PartitionStatus.PRIMARY:
                for hc in r.server.hotkey_collectors.values():
                    if hc.state.value in ("stopped", "finished"):
                        hc.start()
            return
        if msg_type == "dup_add":
            self._on_dup_add(src, payload)
            return
        if msg_type == "dup_remove":
            gpid = tuple(payload["gpid"])
            dup = self._dup_sessions.pop((gpid, payload["dupid"]), None)
            if dup is not None:
                r = self.replicas.get(gpid)
                if r is not None and dup in r.duplicators:
                    # unhook or the log-GC floor stays pinned forever
                    r.duplicators.remove(dup)
            return
        if msg_type == "dup_apply_batch":
            self._on_dup_apply_batch(src, payload)
            return
        if msg_type == "dup_apply_batch_ack":
            # acks to duplication envelopes this node shipped
            for dup in self._dup_sessions.values():
                if dup.on_write_reply(payload):
                    dup.tick()
                    return
            return
        if msg_type == "query_config_reply":
            for dup in self._dup_sessions.values():
                if dup.on_follower_config(payload):
                    dup.tick()
                    return
            return
        if msg_type == "client_write_reply":
            # replies to duplication-shipped writes come back to the node
            for dup in self._dup_sessions.values():
                if dup.on_write_reply(payload):
                    dup.tick()
                    return
            return
        if msg_type == "list_dir":
            self.transfer.on_list_dir(src, payload)
            return
        if msg_type == "fetch_chunk":
            self.transfer.on_fetch_chunk(src, payload)
            return
        if msg_type in ("list_dir_reply", "fetch_chunk_reply"):
            for sess in list(self._fetch_sessions.values()):
                if sess.on_reply(msg_type, payload):
                    return
            return
        if msg_type == "remote_command":
            from pegasus_tpu_torch.utils.errors import ErrorCode

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
        if msg_type == "client_scan_multi":
            self._on_client_scan_multi(src, payload)
            return
        if msg_type == "client_read_batch":
            self._on_client_read_batch_rpc(src, payload)
            return
        if msg_type == "client_write_batch":
            self._on_client_write_batch(src, payload)
            return
        if msg_type == "client_write":
            self._on_client_write(src, payload)
            return
        if msg_type == "client_read":
            self._on_client_read(src, payload)
            return
        raise ValueError(f"stub {self.name}: unknown message {msg_type}")

    # ---- client request path (parity: replica_stub read/write dispatch,
    # replica_stub.cpp:1100 + replica.cpp:386 gates) -------------------

    def lease_valid(self) -> bool:
        """Worker-side self-fencing: a node whose FD lease lapsed must stop
        serving BEFORE meta's grace expires (failure_detector.h:79-121) —
        otherwise a partitioned primary would serve stale reads after its
        partition was reassigned. Follower reads lean on the SAME lease:
        it is what bounds how long a partitioned secondary can keep
        answering after the world moved on."""
        from pegasus_tpu_torch.meta.failure_detector import worker_lease_valid

        return worker_lease_valid(self._last_beacon_ack, self.sim_clock())

    def beacon_ack_age(self) -> float:
        """Seconds since the last beacon ack, on the node's sim clock —
        the ONE number both the lease check and the `fd_beacon_miss`
        health rule consume. Stamped onto the `beacon_ack_age_s` gauge
        at every call (the recorder-cadence health_tick AND the
        replica-side lease decisions), so an incident timeline shows the
        age a read-lease rejection actually read, not a snapshot from up
        to a recorder period earlier."""
        # before the first ack the node is still joining — 0, not inf
        age = (0.0 if self._last_beacon_ack == float("-inf")
               else max(0.0, self.sim_clock() - self._last_beacon_ack))
        self._beacon_age_gauge.set(round(age, 3))
        return age

    def _deadline_expired(self, payload: dict) -> bool:
        """True when the request's end-to-end deadline already passed on
        this node's clock (the client stamps the same timebase: wall
        time over TCP, the epoch-anchored virtual clock in sim)."""
        dl = payload.get("deadline")
        return (dl is not None and self.clock is not None
                and self.clock() > dl)

    def _on_client_write(self, src: str, payload: dict) -> None:
        from pegasus_tpu_torch.replica.mutation import WriteOp
        from pegasus_tpu_torch.replica.replica import PartitionStatus
        from pegasus_tpu_torch.utils.errors import ErrorCode

        gpid = tuple(payload["gpid"])
        rid = payload["rid"]
        if self._deadline_expired(payload):
            # fast-fail BEFORE the 2PC starts: an expired write has not
            # (and will not) run, so the explicit ERR_TIMEOUT reply is
            # unambiguous — safe to retry even for atomic ops
            self.net.send(self.name, src, "client_write_reply", {
                "rid": rid, "err": int(ErrorCode.ERR_TIMEOUT),
                "results": []})
            return
        r = self.replicas.get(gpid)
        if not self._client_allowed(r, payload, access="w", src=src):
            self.net.send(self.name, src, "client_write_reply", {
                "rid": rid, "err": int(ErrorCode.ERR_ACL_DENY),
                "results": []})
            return
        # CU budget gate (writes are NEVER brownout-shed — the mutation
        # path degrades last — but an over-budget tenant's writes do
        # bounce typed-retryable until refill pays the debt down)
        over = TENANTS.admit(payload.get("tenant"), kind="write")
        if over:
            self.net.send(self.name, src, "client_write_reply", {
                "rid": rid, "err": over, "results": []})
            return
        if r is not None and getattr(r, "splitting", False):
            # write fence during the split's final catch-up (parity: the
            # reference fences the parent before the count flip)
            self._split_fence_rejects.increment()
            self.net.send(self.name, src, "client_write_reply", {
                "rid": rid, "err": int(ErrorCode.ERR_SPLITTING),
                "results": []})
            return
        if self._dup_fenced(r, payload.get("ops")):
            # failover-drill fence: the table is draining its
            # duplication before the flip — typed and RETRYABLE, so an
            # in-flight client rides its backoff onto the flipped
            # follower instead of acking a write the drill would strand
            self._dup_fence_rejects.increment()
            self.net.send(self.name, src, "client_write_reply", {
                "rid": rid, "err": int(ErrorCode.ERR_DUP_FENCED),
                "results": []})
            return
        if (r is None or r.status != PartitionStatus.PRIMARY
                or getattr(r, "restoring", False)
                or not self.lease_valid()):
            self.net.send(self.name, src, "client_write_reply", {
                "rid": rid, "err": int(ErrorCode.ERR_INVALID_STATE),
                "results": []})
            return
        gate = r.server._hash_gate(payload.get("partition_hash"))
        if gate:
            self.net.send(self.name, src, "client_write_reply", {
                "rid": rid, "err": gate, "results": []})
            return
        ops = [WriteOp(op, req) for op, req in payload["ops"]]
        sgate = r.server._write_gate()
        if sgate:
            # deny/throttle rejections are STORAGE statuses per op (the
            # standalone handlers return TryAgain the same way), not
            # framework routing errors — the caller must see them, not
            # retry into them
            self.net.send(self.name, src, "client_write_reply", {
                "rid": rid, "err": int(ErrorCode.ERR_OK),
                "results": [sgate] * len(ops)})
            return

        def reply(results) -> None:
            self.net.send(self.name, src, "client_write_reply", {
                "rid": rid, "err": int(ErrorCode.ERR_OK),
                "results": results})

        try:
            # ambient tenant around the 2PC submission: client_write
            # captures it for the deferred prepare fan-out's span tags
            with tenancy.bind(TENANTS.resolve(
                    payload.get("tenant")).name):
                r.client_write(ops, reply)
            # bill the tenant ONCE, here at the accepting primary, with
            # the same per-op math the apply path uses: apply runs at
            # commit on EVERY member (no client tenant ambient there),
            # so ambient attribution would miss it — and billing each
            # member's apply would charge a tenant its replication
            # factor
            from pegasus_tpu_torch.server.capacity_units import (
                client_write_units,
            )

            TENANTS.charge(payload.get("tenant"),
                           client_write_units(payload["ops"]))
        except ReplicaBusyError:
            # typed retryable overload: the client backs off WITHOUT a
            # config refresh (the routing is right, the queue is full)
            self.net.send(self.name, src, "client_write_reply", {
                "rid": rid, "err": int(ErrorCode.ERR_BUSY),
                "results": []})
        except (StorageCorruptionError, OSError) as e:
            # the store under this write is corrupt or its disk is
            # dying: typed reply (retryable — the client's refresh
            # lands on the healed primary after the guardian's cure),
            # then detect -> quarantine -> re-learn
            self.net.send(self.name, src, "client_write_reply", {
                "rid": rid, "err": self._on_storage_error(gpid, e),
                "results": []})
        except (RuntimeError, ValueError):
            self.net.send(self.name, src, "client_write_reply", {
                "rid": rid, "err": int(ErrorCode.ERR_INVALID_STATE),
                "results": []})

    def _on_client_write_batch(self, src: str, payload: dict) -> None:
        """Explicitly batched writes from the cluster client: one
        message carries every write op for the partitions this node
        hosts; each partition's run of batchable ops replicates as ONE
        mutation through the existing 2PC pipeline (which keeps
        coalescing via MAX_BATCH_OPS/PIPELINE_DEPTH), all inside one
        group-commit window — one plog flush/fsync and one
        prepare_batch per peer for the whole message.

        payload: {rid, auth, deadline?, groups: [(gpid, items)]} with
        items = [(ops, partition_hash, deadline), ...] and ops =
        [(op_code, request), ...] (one item = one client write, the
        shape solo client_write carries). Reply: {rid, err, result:
        [(pidx, err, [(op_err, results)])]} aligned with the request's
        groups; per-partition gate failures surface in their slot's
        err, per-op failures (deadline, hash gate, busy) in that op's
        own err, so the client retries exactly what failed. The reply
        is sent only after every op's 2PC callback resolved (acks are
        durability-gated by the group-commit window)."""
        from pegasus_tpu_torch.replica.mutation import ATOMIC_OPS, WriteOp
        from pegasus_tpu_torch.utils.errors import ErrorCode

        ok = int(ErrorCode.ERR_OK)
        rid = payload.get("rid")
        if self._deadline_expired(payload):
            # whole-batch deadline lapsed before any 2PC started: an
            # unambiguous typed fast-fail (nothing ran — safe to retry)
            self.net.send(self.name, src, "client_write_reply", {
                "rid": rid, "err": int(ErrorCode.ERR_TIMEOUT),
                "result": None})
            return
        from pegasus_tpu_torch.utils import tracing

        # CU budget gate, once for the carrier (one client = one
        # tenant); accepted items bill the tenant per submitted run
        # below. Writes stay exempt from brownout shedding.
        over = TENANTS.admit(payload.get("tenant"), kind="write")
        if over:
            self.net.send(self.name, src, "client_write_reply", {
                "rid": rid, "err": over, "result": None})
            return
        wtenant = TENANTS.resolve(payload.get("tenant")).name
        from pegasus_tpu_torch.server.capacity_units import client_write_units

        groups = payload.get("groups") or []
        slots: list = []
        # batching-seam fan-out (write side): every batched item keeps
        # its own span under the carrier's dispatch span; the shared
        # 2PC rounds (combined runs) hang off the carrier too
        carrier = tracing.current_span()
        state = {"outstanding": 0, "armed": False, "replied": False}

        def maybe_reply() -> None:
            if (state["armed"] and not state["replied"]
                    and state["outstanding"] == 0):
                state["replied"] = True
                self.net.send(self.name, src, "client_write_reply", {
                    "rid": rid, "err": ok, "result": slots})

        for gpid, items in groups:
            gpid = tuple(gpid)
            r = self.replicas.get(gpid)
            if not self._client_allowed(r, payload, access="w", src=src):
                slots.append((gpid[1], int(ErrorCode.ERR_ACL_DENY),
                              None))
                continue
            if r is not None and getattr(r, "splitting", False):
                self._split_fence_rejects.increment()
                slots.append((gpid[1], int(ErrorCode.ERR_SPLITTING),
                              None))
                continue
            if self._dup_fenced(r):
                self._dup_fence_rejects.increment()
                slots.append((gpid[1], int(ErrorCode.ERR_DUP_FENCED),
                              None))
                continue
            if (r is None or r.status != PartitionStatus.PRIMARY
                    or getattr(r, "restoring", False)
                    or not self.lease_valid()):
                slots.append((gpid[1],
                              int(ErrorCode.ERR_INVALID_STATE), None))
                continue
            item_res: list = [None] * len(items)
            slots.append((gpid[1], ok, item_res))

            def submit(spans, ops_list, replica=r, results=item_res):
                """One client_write for a combined run; its response
                list splits back per original item via the spans."""
                if not ops_list:
                    return

                def cb(res, spans=spans, results=results) -> None:
                    off = 0
                    for i, n in spans:
                        results[i] = (ok, res[off:off + n])
                        off += n
                    state["outstanding"] -= 1
                    maybe_reply()

                state["outstanding"] += 1
                try:
                    with tenancy.bind(wtenant):
                        replica.client_write(ops_list, cb)
                    # accepted: bill the tenant at the primary with the
                    # apply path's per-op math (same single-billing
                    # rationale as the solo write handler)
                    TENANTS.charge(wtenant, client_write_units(
                        [(wo.op, wo.request) for wo in ops_list]))
                except ReplicaBusyError:
                    state["outstanding"] -= 1
                    for i, _n in spans:
                        results[i] = (int(ErrorCode.ERR_BUSY), [])
                except (StorageCorruptionError, OSError) as e:
                    state["outstanding"] -= 1
                    code = self._on_storage_error(
                        (replica.server.app_id, replica.server.pidx), e)
                    for i, _n in spans:
                        results[i] = (code, [])
                except (RuntimeError, ValueError):
                    state["outstanding"] -= 1
                    for i, _n in spans:
                        results[i] = (int(ErrorCode.ERR_INVALID_STATE),
                                      [])

            # runs of batchable ops combine into one client_write (one
            # mutation); atomic ops ride alone, submission order kept
            run_spans: list = []
            run_ops: list = []
            item_spans: list = []
            for i, (raw_ops, ph, dl) in enumerate(items):
                ispan = None
                if carrier is not None:
                    # per-item span opened around THIS item's handling
                    # (gates + its submission leg), so a gated item is
                    # visibly near-zero and items keep distinct windows
                    ispan = tracing.child_of(carrier,
                                             f"op.write.{gpid[1]}")
                    item_spans.append(ispan)
                if self._deadline_expired(
                        {"deadline": dl if dl is not None
                         else payload.get("deadline")}):
                    # per-op deadline: THIS op fast-fails before its
                    # 2PC starts; its window neighbors proceed
                    item_res[i] = (int(ErrorCode.ERR_TIMEOUT), [])
                    if ispan is not None:
                        ispan.tags["gated"] = "deadline"
                        ispan.finish()
                    continue
                gate = r.server._hash_gate(ph)
                if gate:
                    item_res[i] = (gate, [])
                    if ispan is not None:
                        ispan.tags["gated"] = "hash"
                        ispan.finish()
                    continue
                sgate = r.server._write_gate()
                if sgate:
                    # deny/throttle are STORAGE statuses per op, same
                    # as the solo handler's [sgate] * len(ops) reply
                    item_res[i] = (ok, [sgate] * len(raw_ops))
                    if ispan is not None:
                        ispan.tags["gated"] = "throttle"
                        ispan.finish()
                    continue
                wos = [WriteOp(op, req) for op, req in raw_ops]
                atomic = any(wo.op in ATOMIC_OPS for wo in wos)
                if atomic or len(run_ops) + len(wos) > r.MAX_BATCH_OPS:
                    submit(run_spans, run_ops)
                    run_spans, run_ops = [], []
                if atomic:
                    submit([(i, len(wos))], wos)
                    if ispan is not None:
                        ispan.finish()  # its leg submitted inline
                else:
                    run_spans.append((i, len(wos)))
                    run_ops.extend(wos)
            submit(run_spans, run_ops)
            for sp in item_spans:
                sp.finish()  # idempotent: gated/atomic already closed
        state["armed"] = True
        maybe_reply()

    def _on_client_read(self, src: str, payload: dict) -> None:
        """Dispatch a read op to the partition's storage app through the
        replica gate (parity: replica_stub::on_client_read
        replica_stub.cpp:1100 -> replica::on_client_read replica.cpp:386 ->
        storage_serverlet dispatch, common/storage_serverlet.h:52).

        payload: {gpid, rid, op, args, partition_hash?}; the reply carries
        `err` (framework routing error space) and `result` (the storage
        handler's return value — storage status codes live inside it).
        """
        from pegasus_tpu_torch.utils.errors import ErrorCode

        rid = payload["rid"]
        op = payload.get("op", "get")
        err, r = self._client_read_gate(payload, src)
        if err is not None:
            self.net.send(self.name, src, "client_read_reply", {
                "rid": rid, "err": err, "result": None})
            return
        ph = payload.get("partition_hash")
        args = payload.get("args")
        srv = r.server
        from pegasus_tpu_torch.replica.replica import PartitionStatus
        from pegasus_tpu_torch.utils import perf_context as perf
        from pegasus_tpu_torch.utils import tracing

        served_by = ("primary" if r.status == PartitionStatus.PRIMARY
                     else "secondary")
        tenant = TENANTS.resolve(payload.get("tenant")).name
        sp = tracing.current_span()
        if sp is not None:
            sp.tags["served_by"] = served_by
            sp.tags["tenant"] = tenant
        # activate the op's cost vector HERE with served_by pre-set: the
        # storage handlers adopt the ambient context (perf.current()),
        # so explain/trace/slow-log all show which replica role answered
        pc = perf.start(f"read.{op}")
        if pc is not None:
            pc.served_by = served_by
            pc.tenant = tenant
            perf.push(pc)
        # bind the requesting tenant for the serving body: every CU the
        # storage handlers bill below flows to this tenant's budget
        _tb = tenancy.bind(tenant)
        _tb.__enter__()
        try:
            if op == "get":
                result = srv.on_get(args, partition_hash=ph)
            elif op == "ttl":
                result = srv.on_ttl(args, partition_hash=ph)
            elif op == "multi_get":
                result = srv.on_multi_get(args)
            elif op == "batch_get":
                result = srv.on_batch_get(args)
            elif op == "sortkey_count":
                result = srv.on_sortkey_count(args)
            elif op == "get_scanner":
                result = srv.on_get_scanner(args)
            elif op == "scan_batch":
                result = srv.on_get_scanner_batch(args)
            elif op == "scan":
                result = srv.on_scan(args)
            elif op == "clear_scanner":
                result = srv.on_clear_scanner(args)
            else:
                self.net.send(self.name, src, "client_read_reply", {
                    "rid": rid,
                    "err": int(ErrorCode.ERR_HANDLER_NOT_FOUND),
                    "result": None})
                return
        except ValueError:
            # bad request arguments: permanent, NOT retryable — the client
            # must surface it, not burn retries refreshing its config
            self.net.send(self.name, src, "client_read_reply", {
                "rid": rid, "err": int(ErrorCode.ERR_INVALID_PARAMETERS),
                "result": None})
            return
        except (StorageCorruptionError, OSError) as e:
            # a block failed its crc (or the disk failed the read):
            # typed retryable reply — the client's backoff + config
            # refresh lands it on the healed primary — then the replica
            # quarantines and the guardian repairs via re-learn
            self.net.send(self.name, src, "client_read_reply", {
                "rid": rid,
                "err": self._on_storage_error(tuple(payload["gpid"]), e),
                "result": None})
            return
        except RuntimeError:
            self.net.send(self.name, src, "client_read_reply", {
                "rid": rid, "err": int(ErrorCode.ERR_INVALID_STATE),
                "result": None})
            return
        finally:
            _tb.__exit__(None, None, None)
            if pc is not None:
                perf.pop(pc)
        # the committed-decree stamp is the monotonic session token: the
        # client's next `monotonic` read for this partition carries it
        # as min_decree, so no later read can observe an older prefix
        self.net.send(self.name, src, "client_read_reply", {
            "rid": rid, "err": int(ErrorCode.ERR_OK), "result": result,
            "decree": r.last_committed_decree, "served_by": served_by})

    def _client_read_gate(self, payload: dict, src: str):
        """The read path's framework gates (ACL -> primary/lease ->
        split staleness), factored so the solo handler and both batched
        point-read paths apply them identically. Returns (err, replica);
        err None means the request may reach the storage app."""
        from pegasus_tpu_torch.replica.replica import PartitionStatus
        from pegasus_tpu_torch.utils.errors import ErrorCode

        if self._deadline_expired(payload):
            # abandoned work: the client's end-to-end deadline lapsed,
            # so the cheapest correct answer is a typed fast-fail
            self._node_deadline_expired.increment()
            return int(ErrorCode.ERR_TIMEOUT), None
        from pegasus_tpu_torch.utils.fail_point import fail_point

        if fail_point(self._shed_fp_name) is not None:
            # injected sustained shedding (incident drills / the seeded
            # flight-recorder scenario): same typed ERR_BUSY the real
            # dispatcher shed returns, counted on the node's rpc entity
            self._node_read_shed.increment()
            return int(ErrorCode.ERR_BUSY), None
        tenant = payload.get("tenant")
        if TENANTS.browned(tenant):
            # aggressor-only brownout: the health engine flagged THIS
            # tenant's burn rate as the outlier, so only its reads shed
            # (typed ERR_BUSY — the client backs off without a config
            # refresh); every other tenant keeps being served
            self._node_read_shed.increment()
            TENANTS.note_shed(tenant)
            return int(ErrorCode.ERR_BUSY), None
        over = TENANTS.admit(tenant, kind="read")
        if over:
            # over CU budget: typed retryable ERR_CU_OVERBUDGET — the
            # client jitter-backs-off and re-sends without refreshing
            # its config (the routing table is right; the budget isn't)
            return over, None
        gpid = tuple(payload["gpid"])
        r = self.replicas.get(gpid)
        if not self._client_allowed(r, payload, access="r", src=src):
            return int(ErrorCode.ERR_ACL_DENY), None
        if (r is None or getattr(r, "restoring", False)
                or not r.ready_to_serve()):
            return int(ErrorCode.ERR_INVALID_STATE), None
        if r.status == PartitionStatus.PRIMARY:
            if not self.lease_valid():
                return int(ErrorCode.ERR_INVALID_STATE), None
        else:
            ferr = self._follower_gate(r, payload)
            if ferr is not None:
                return ferr, None
        # split staleness gate for EVERY read op (scanner paging ops
        # carry ph=None — their context was validated at get_scanner);
        # follower-served reads keep it too: a secondary of a split
        # parent must bounce rows the flip moved, exactly like a primary
        gate = r.server._hash_gate(payload.get("partition_hash"))
        if gate:
            return gate, None
        return None, r

    def _follower_gate(self, r, payload: dict) -> Optional[int]:
        """Secondary-serving decision for one consistency-levelled read.
        Returns None when this SECONDARY may answer it, else the typed
        bounce: ERR_INVALID_STATE for ops secondaries never serve
        (linearizable — the client misrouted, refresh + go to the
        primary), ERR_STALE_REPLICA (RETRYABLE, subset-only) when the
        beacon lease lapsed or the committed watermark misses the op's
        bound — the routing table is still right, so the client re-sends
        just the bounced ops to the primary without a config refresh.

        The lease guarantee: a secondary only answers while its
        beacon-acknowledged lease (worker lease < meta grace) is live,
        so by the time meta could have reassigned the partition around a
        partitioned node, that node has ALREADY stopped serving — the
        same self-fencing clock that gates a partitioned primary."""
        from pegasus_tpu_torch.replica.replica import PartitionStatus
        from pegasus_tpu_torch.utils.errors import ErrorCode

        cons = payload.get("consistency")
        if r.status != PartitionStatus.SECONDARY or not cons:
            return int(ErrorCode.ERR_INVALID_STATE)
        level = cons.get("level")
        if level not in ("bounded_stale", "monotonic"):
            return int(ErrorCode.ERR_INVALID_STATE)
        # stamping the gauge HERE is the point: the health rule and this
        # lease decision read the same age on the same clock
        self.beacon_ack_age()
        if not self.lease_valid():
            self._lease_rejects.increment()
            self._stale_bounces.increment()
            r.server._lease_rejects.increment()
            r.server._stale_bounces.increment()
            return int(ErrorCode.ERR_STALE_REPLICA)
        if level == "bounded_stale":
            max_lag_ms = float(cons.get("max_lag_ms") or 0.0)
            if r.staleness_s(self.sim_clock()) * 1000.0 > max_lag_ms:
                self._stale_bounces.increment()
                r.server._stale_bounces.increment()
                return int(ErrorCode.ERR_STALE_REPLICA)
        # the monotonic session token (and any bound a bounded_stale op
        # chooses to carry): never serve below the decree the client has
        # already observed for this partition
        min_decree = int(cons.get("min_decree") or 0)
        if r.last_committed_decree < min_decree:
            self._stale_bounces.increment()
            r.server._stale_bounces.increment()
            return int(ErrorCode.ERR_STALE_REPLICA)
        self._follower_reads.increment()
        r.server._follower_reads.increment()
        return None

    def _on_client_read_batch(self, items) -> None:
        """Transport flush-window delivery: a consecutive run of queued
        client_read messages as [(src, payload)]. Point ops (get / ttl
        / multi_get with sort keys / batch_get) from the whole window
        serve through the cross-partition read coordinator in ONE
        flush; everything else falls through to the solo handler in
        arrival order."""
        from pegasus_tpu_torch.replica.replica import PartitionStatus
        from pegasus_tpu_torch.server.read_coordinator import (
            is_point_read,
            point_read_multi,
        )
        from pegasus_tpu_torch.utils import tracing
        from pegasus_tpu_torch.utils.errors import ErrorCode

        flush: list = []  # (src, payload, replica, span) past the gates
        for src, payload in items:
            op = payload.get("op", "get")
            ctx = payload.get("trace")
            if not is_point_read(op, payload.get("args")):
                # solo fallback still gets its dispatch span (the
                # transport's batch drain skipped the generic one)
                span = tracing.start_server_span(
                    self.name, "client_read", ctx)
                try:
                    with tracing.activate(span):
                        self._on_client_read(src, payload)
                finally:
                    if span is not None:
                        span.finish()
                continue
            err, r = self._client_read_gate(payload, src)
            if err is not None:
                self.net.send(self.name, src, "client_read_reply", {
                    "rid": payload.get("rid"), "err": err,
                    "result": None})
                continue
            # per-message span parented to its OWN context: a flush
            # coalesces reads from many independent traces — each op
            # keeps its span, the flush never becomes one carrier
            span = tracing.start_server_span(self.name, "client_read", ctx)
            if span is not None:
                span.tags["served_by"] = (
                    "primary" if r.status == PartitionStatus.PRIMARY
                    else "secondary")
                span.tags["tenant"] = TENANTS.resolve(
                    payload.get("tenant")).name
            flush.append((src, payload, r, span))
        if not flush:
            return
        # group by (server, tenant): the transport's flush window
        # coalesces MANY clients' reads, so one batch may mix tenants —
        # splitting the groups keeps each finish pass (where the CU
        # funnel fires) billed to exactly the tenant that asked
        groups: dict = {}
        for i, (_src, payload_i, rep, _sp) in enumerate(flush):
            tname = TENANTS.resolve(payload_i.get("tenant")).name
            groups.setdefault((id(rep.server), tname),
                              (rep.server, tname, []))[2].append(i)
        pairs = [(server, [(flush[i][1].get("op", "get"),
                            flush[i][1].get("args"),
                            flush[i][1].get("partition_hash"))
                           for i in idxs])
                 for server, _tname, idxs in groups.values()]
        tenants = [tname for _server, tname, _idxs in groups.values()]
        # NO flush-wide deadline here: members carry INDEPENDENT
        # deadlines (already gate-checked above, microseconds ago), and
        # bounding the flush by the tightest one would let a single
        # tight-deadline client abort 31 healthy neighbors into a retry
        # round-trip. The explicit batch RPC passes its deadline down
        # because there one deadline really does govern the whole batch.
        try:
            try:
                results = point_read_multi(pairs, tenants=tenants)
            except (ValueError, RuntimeError, OSError):
                # malformed op in the flush — or a corrupt block /
                # failing disk under ONE member: re-serve each solo so
                # every request gets its own precise error instead of a
                # shared one (the solo path carries the typed corruption
                # handling and quarantines exactly the sick replica)
                for src, payload, _srv, span in flush:
                    with tracing.activate(span):
                        self._on_client_read(src, payload)
                return
            for (_server, _tname, idxs), res in zip(groups.values(),
                                                    results):
                for i, result in zip(idxs, res):
                    src, payload, rep, span = flush[i]
                    # the reply rides this op's span context (tail-keep
                    # bit included) back to its client; the decree stamp
                    # feeds the client's monotonic session token
                    with tracing.activate(span):
                        self.net.send(
                            self.name, src, "client_read_reply", {
                                "rid": payload.get("rid"),
                                "err": int(ErrorCode.ERR_OK),
                                "result": result,
                                "decree": rep.last_committed_decree,
                                "served_by": (
                                    "primary" if rep.status
                                    == PartitionStatus.PRIMARY
                                    else "secondary")})
        finally:
            for _src, _payload, _srv, span in flush:
                if span is not None:
                    span.finish()

    def _on_client_read_batch_rpc(self, src: str, payload: dict) -> None:
        """Explicitly batched point reads from the cluster client: one
        message carries every point op for the partitions this node
        hosts, served through the cross-partition read coordinator.
        Reply: {rid, err, result: [(pidx, err, results)]} aligned with
        the request's groups; per-partition gate failures surface in
        their slot's err so the client re-resolves just those."""
        from pegasus_tpu_torch.server.read_coordinator import (
            is_point_read,
            point_read_multi,
        )
        from pegasus_tpu_torch.utils.errors import ErrorCode, PegasusError

        from pegasus_tpu_torch.replica.replica import PartitionStatus

        rid = payload.get("rid")
        groups = payload.get("groups") or []
        # batch-wide consistency level; per-partition monotonic session
        # tokens ride as (pidx, min_decree) pairs next to it
        cons = payload.get("consistency")
        min_decrees = dict(payload.get("min_decrees") or [])
        slots: list = []
        decrees: list = []  # (pidx, committed decree) for served slots
        ok: list = []  # (slot index, replica, ops)
        for gpid, ops in groups:
            gpid = tuple(gpid)
            # validate BEFORE planning: one malformed op must fail its
            # own slot, never leave the whole node batch unreplied
            if not all(len(o) == 3 and is_point_read(o[0], o[1])
                       for o in ops):
                slots.append((gpid[1],
                              int(ErrorCode.ERR_INVALID_PARAMETERS),
                              None))
                continue
            slot_cons = cons
            if cons is not None:
                slot_cons = dict(cons, min_decree=max(
                    int(cons.get("min_decree") or 0),
                    int(min_decrees.get(gpid[1], 0))))
            err, r = self._client_read_gate(
                {"gpid": gpid, "auth": payload.get("auth"),
                 "deadline": payload.get("deadline"),
                 "tenant": payload.get("tenant"),
                 "consistency": slot_cons}, src)
            if err is not None:
                slots.append((gpid[1], err, None))
                continue
            slots.append((gpid[1], int(ErrorCode.ERR_OK), None))
            decrees.append((gpid[1], r.last_committed_decree,
                            "primary" if r.status
                            == PartitionStatus.PRIMARY else "secondary"))
            ok.append((len(slots) - 1, r, ops))
        # batching-seam fan-out: each op in the carrier gets its own
        # span parented to the CARRIER's dispatch span — N ops in one
        # carrier yield N child spans, never N carriers
        from pegasus_tpu_torch.utils import tracing

        # one carrier = one client = ONE tenant: bind it ambient around
        # the whole coordinator call so every partition's finish pass
        # bills this tenant's budget
        tname = TENANTS.resolve(payload.get("tenant")).name
        carrier = tracing.current_span()
        op_spans: list = []
        if carrier is not None:
            carrier.tags["tenant"] = tname
            for _slot_i, rep, ops in ok:
                role = ("primary" if rep.status == PartitionStatus.PRIMARY
                        else "secondary")
                for o in ops:
                    osp = tracing.child_of(
                        carrier, f"op.{o[0]}.{rep.server.pidx}")
                    osp.tags["served_by"] = role
                    osp.tags["tenant"] = tname
                    op_spans.append(osp)
        if ok:
            try:
                with tenancy.bind(tname):
                    results = point_read_multi(
                        [(rep.server, [tuple(o) for o in ops])
                         for _i, rep, ops in ok],
                        deadline=payload.get("deadline"), clock=self.clock)
            except PegasusError:
                # the batch's deadline lapsed mid-flush: typed timeout
                # for every slot this node accepted
                for slot_i, _srv, _ops in ok:
                    slots[slot_i] = (slots[slot_i][0],
                                     int(ErrorCode.ERR_TIMEOUT), None)
            except (ValueError, TypeError, AttributeError):
                # malformed args that slipped past the shape check:
                # a definite reply, never an unreplied batch
                for slot_i, _srv, _ops in ok:
                    slots[slot_i] = (slots[slot_i][0], int(
                        ErrorCode.ERR_INVALID_PARAMETERS), None)
            except (StorageCorruptionError, OSError) as e:
                # one member's store is corrupt: its slot gets the
                # typed code (and the replica quarantines); healthy
                # neighbors get retryable INVALID_STATE — their work
                # was lost with the shared flush, not their data
                bad = (self._replica_for_path(e.path)
                       if isinstance(e, StorageCorruptionError) else None)
                code = self._on_storage_error(bad, e)
                for slot_i, rep, _ops in ok:
                    hit = bad is not None and \
                        (rep.server.app_id, rep.server.pidx) == bad
                    slots[slot_i] = (
                        slots[slot_i][0],
                        code if (hit or bad is None)
                        else int(ErrorCode.ERR_INVALID_STATE), None)
            except RuntimeError:
                for slot_i, _rep, _ops in ok:
                    slots[slot_i] = (slots[slot_i][0], int(
                        ErrorCode.ERR_INVALID_STATE), None)
            else:
                for (slot_i, _rep, _ops), res in zip(ok, results):
                    slots[slot_i] = (slots[slot_i][0],
                                     int(ErrorCode.ERR_OK), res)
            finally:
                for sp in op_spans:
                    sp.finish()
        # `decrees` travels NEXT TO the slots (pidx, decree, served_by):
        # slot shape stays (pidx, err, results) for every existing
        # consumer, and the client folds the stamps into its monotonic
        # session tokens only for slots that actually served
        self.net.send(self.name, src, "client_read_reply", {
            "rid": rid, "err": int(ErrorCode.ERR_OK), "result": slots,
            "decrees": decrees})

    def _on_config_proposal(self, src: str, payload: dict) -> None:
        """Meta assigns a configuration (parity: on_config_proposal,
        replica_stub.cpp:2487 -> replica_config.cpp)."""
        gpid = tuple(payload["gpid"])
        config = ReplicaConfig(payload["ballot"], payload["primary"],
                               list(payload["secondaries"]))
        r = self._open_replica(gpid, payload.get("partition_count", 1))
        if payload.get("restoring"):
            # created from a backup: serve NOTHING until the restore
            # lands, or a stray early write would make the idempotence
            # check misread the partition as already restored
            r.restoring = True
        if gpid not in self._split_sessions:
            # the meta-carried fence: a parent whose child registered
            # stays fenced across failovers (a local split session's own
            # fence is authoritative while it runs)
            r.splitting = bool(payload.get("splitting"))
        new_count = payload.get("partition_count", 1)
        if new_count > r.server.partition_count:
            # the split's group count flip (meta_split_service _finish):
            # routing + the stale-half predicate switch to the new count,
            # the write fence lifts, and the split session retires
            r.server.update_partition_count(new_count)
            import json as _json

            info_path = os.path.join(self._replica_dir(gpid),
                                     ".replica_info")
            with open(info_path, "w") as f:
                _json.dump({"app_id": gpid[0], "pidx": gpid[1],
                            "partition_count": new_count}, f)
            r.splitting = False
            self._split_sessions.pop(gpid, None)
        r.assign_config(config)

    def _on_add_learner_cmd(self, src: str, payload: dict) -> None:
        """Meta tells the primary to pull in a learner (parity: config
        proposal ADD_SECONDARY -> primary starts the learn flow)."""
        gpid = tuple(payload["gpid"])
        r = self.replicas.get(gpid)
        if r is not None and r.status == PartitionStatus.PRIMARY:
            r.add_learner(payload["learner"])

    def _on_update_app_envs(self, src: str, payload: dict) -> None:
        """Meta propagates table envs (parity: config-sync env delivery)."""
        for gpid, r in self.replicas.items():
            if gpid[0] == payload["app_id"]:
                # meta always sends the table's complete env map, so
                # absent keys are deletions to un-apply
                r.server.update_app_envs(payload["envs"], full_set=True)
        # tenant declarations ride table envs too (``qos.tenants``), so
        # `shell set_app_envs` re-shapes weights/budgets online without
        # a restart — the registry ignores envs without the key
        TENANTS.configure_from_envs(payload.get("envs") or {})

    # ---- meta-driven backup / restore (parity: the replica-side cold
    # backup flow, replica/replica_backup.cpp, and restore,
    # replica/replica_restore.cpp — commanded by the meta services) -----

    def _on_backup_partition(self, src: str, payload: dict) -> None:
        from pegasus_tpu_torch.replica.replica import PartitionStatus
        from pegasus_tpu_torch.server.backup import BackupEngine
        from pegasus_tpu_torch.storage.block_service import block_service_for

        gpid = tuple(payload["gpid"])
        r = self.replicas.get(gpid)
        if r is None or r.status != PartitionStatus.PRIMARY:
            return  # meta's tick retries against the current primary
        if not r.ready_to_serve():
            return  # promotion window not re-committed; meta retries
        key = (gpid, payload["backup_id"])
        if key in self._backup_inflight:
            return  # meta re-sends until done; one upload is enough
        self._backup_inflight.add(key)
        # checkpoint HERE (needs engine serialization with applies);
        # the slow upload runs off the dispatcher so beacons/prepares
        # keep flowing during a large backup
        import shutil
        import tempfile

        ckpt_dir = tempfile.mkdtemp(prefix="pegbk")
        try:
            decree = r.server.checkpoint(ckpt_dir)
        except Exception:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
            self._backup_inflight.discard(key)
            raise

        def upload() -> None:
            from pegasus_tpu_torch.utils.fail_point import fail_point

            try:
                if fail_point(f"{self.name}::backup_upload") is not None:
                    # upload to the block service failed: report nothing;
                    # the meta backup tick re-commands this partition
                    # until an upload completes
                    return
                engine = BackupEngine(block_service_for(payload["root"]),
                                      payload["policy"])
                engine.upload_checkpoint(payload["backup_id"], gpid[0],
                                         gpid[1], ckpt_dir, decree)
                self.net.send(self.name, src, "backup_partition_done", {
                    "gpid": gpid, "backup_id": payload["backup_id"],
                    "decree": decree})
            finally:
                shutil.rmtree(ckpt_dir, ignore_errors=True)
                self._backup_inflight.discard(key)

        self.net.offload(upload)

    def _on_restore_partition(self, src: str, payload: dict) -> None:
        from pegasus_tpu_torch.replica.replica import PartitionStatus
        from pegasus_tpu_torch.server.backup import BackupEngine
        from pegasus_tpu_torch.storage.block_service import block_service_for

        gpid = tuple(payload["gpid"])
        r = self.replicas.get(gpid)
        if r is None or r.status != PartitionStatus.PRIMARY:
            return
        if not getattr(r, "restoring", False):
            # already restored (idempotence against meta's retry timer) —
            # clients were gated until the flag cleared, so no stray
            # write can masquerade as a completed restore
            self.net.send(self.name, src, "restore_partition_done",
                          {"gpid": gpid})
            return
        engine = BackupEngine(block_service_for(payload["root"]),
                              payload["policy"])
        app_dir = r.server.engine.data_dir
        r.server.engine.close()
        new_engine = engine.restore_partition(
            payload["backup_id"], payload["src_app_id"], gpid[1], app_dir,
            device=r.server.device)
        r.server.install_engine(new_engine)
        r.prepare_list.reset(new_engine.last_committed_decree)
        r.restoring = False
        self.net.send(self.name, src, "restore_partition_done",
                      {"gpid": gpid})

    def _on_trigger_ingest(self, src: str, payload: dict) -> None:
        """Meta commands an ingestion: the primary replicates an
        OP_INGEST mutation through 2PC so every member ingests at the
        same decree (parity: bulk-load ingestion, replica_2pc.cpp:211)."""
        from pegasus_tpu_torch.replica.mutation import WriteOp
        from pegasus_tpu_torch.replica.replica import PartitionStatus
        from pegasus_tpu_torch.rpc.codec import OP_INGEST

        from pegasus_tpu_torch.utils.fail_point import fail_point

        gpid = tuple(payload["gpid"])
        r = self.replicas.get(gpid)
        if r is None or r.status != PartitionStatus.PRIMARY:
            return  # meta's tick retries against the current primary
        if fail_point(f"{self.name}::ingest") is not None:
            # download/ingest failure before the 2PC round: no ack; the
            # meta bulk-load tick keeps re-commanding until it succeeds
            return
        load_id = payload.get("load_id", 0)
        key = (gpid, load_id)
        if r.has_ingested(load_id):
            # the load already committed groupwide (the marker is written
            # by every member at apply, so it survives failovers); re-ack
            # WITHOUT re-ingesting — a second OP_INGEST at a later decree
            # would resurrect keys deleted since the first one
            self.net.send(self.name, src, "ingest_done",
                          {"gpid": gpid, "err": 0})
            return
        if key in self._ingest_inflight:
            return  # download/2PC still running; meta's tick re-sends

        def done(results) -> None:
            self._ingest_inflight.discard(key)
            err = results[0] if results else 0
            self.net.send(self.name, src, "ingest_done", {
                "gpid": gpid, "err": err})

        self._ingest_inflight.add(key)
        try:
            r.client_write(
                [WriteOp(OP_INGEST,
                         (payload["root"], payload["src_app"], load_id))],
                done)
        except (RuntimeError, ValueError):
            self._ingest_inflight.discard(key)

    def _on_client_scan_multi(self, src: str, payload: dict) -> None:
        """Cross-partition batched scans: one message covers every
        partition this node hosts for the table; qualifying partitions
        share ONE stacked device evaluation (scan_coordinator). Reply:
        {rid, err, result: [(pidx, [ScanResponse])]} aligned with the
        request's groups; per-partition gate failures surface as
        error responses in that partition's slot. The gates and the reply
        are the task profiler's stages pegasus.stub.gate and
        pegasus.stub.reply; scan_multi stages the rest."""
        from pegasus_tpu_torch.replica.replica import PartitionStatus
        from pegasus_tpu_torch.server.scan_coordinator import scan_multi
        from pegasus_tpu_torch.server.types import ScanResponse
        from pegasus_tpu_torch.utils.errors import ErrorCode
        from pegasus_tpu_torch.utils.profiler import PROFILER

        rid = payload.get("rid")
        groups = payload.get("groups") or []
        cons = payload.get("consistency")
        min_decrees = dict(payload.get("min_decrees") or [])
        now = None
        ok_servers = []
        slots = []
        decrees = []  # (pidx, committed decree, served_by) per served slot
        with PROFILER.stage("pegasus.stub.gate"):
            for gpid, reqs in groups:
                gpid = tuple(gpid)
                r = self.replicas.get(gpid)
                if not self._client_allowed(r, payload, access="r", src=src):
                    # auth/ACL is PERMANENT — distinct from stale-primary so
                    # the client doesn't burn retries re-resolving
                    errs = []
                    for _req in reqs:
                        resp = ScanResponse()
                        resp.error = int(ErrorCode.ERR_ACL_DENY)
                        errs.append(resp)
                    slots.append((gpid[1], errs))
                    continue
                gerr = None
                if (r is None or getattr(r, "restoring", False)
                        or not r.ready_to_serve()):
                    gerr = int(ErrorCode.ERR_INVALID_STATE)
                elif r.status == PartitionStatus.PRIMARY:
                    if not self.lease_valid():
                        gerr = int(ErrorCode.ERR_INVALID_STATE)
                else:
                    # same consistency gate as the point paths: a SECONDARY
                    # serves the scan slot under its lease + watermark, or
                    # bounces it typed so the client re-flies JUST this slot
                    slot_cons = cons
                    if cons is not None:
                        slot_cons = dict(cons, min_decree=max(
                            int(cons.get("min_decree") or 0),
                            int(min_decrees.get(gpid[1], 0))))
                    gerr = self._follower_gate(
                        r, {"consistency": slot_cons})
                if gerr is None:
                    # same tenant gates as the point-read path: brownout
                    # sheds only the flagged aggressor, the CU budget
                    # bounces over-budget scans typed-retryable
                    tn = payload.get("tenant")
                    if TENANTS.browned(tn):
                        self._node_read_shed.increment()
                        TENANTS.note_shed(tn)
                        gerr = int(ErrorCode.ERR_BUSY)
                    else:
                        gerr = TENANTS.admit(tn, kind="read") or None
                if gerr is not None:
                    errs = []
                    for _req in reqs:
                        resp = ScanResponse()
                        resp.error = gerr
                        errs.append(resp)
                    slots.append((gpid[1], errs))
                    continue
                slots.append((gpid[1], None))
                decrees.append((gpid[1], r.last_committed_decree,
                                "primary" if r.status
                                == PartitionStatus.PRIMARY else "secondary"))
                ok_servers.append((len(slots) - 1, r.server, reqs))
        if ok_servers:
            from pegasus_tpu_torch.base.value_schema import epoch_now

            now = epoch_now()
            # one carrier = one client = one tenant: the whole stacked
            # evaluation (finish_scan_batch bills the CU there) runs
            # under the requesting tenant's ambient binding
            tname = TENANTS.resolve(payload.get("tenant")).name
            try:
                with tenancy.bind(tname):
                    results = scan_multi(
                        [(srv, reqs) for _i, srv, reqs in ok_servers],
                        now)
            except (StorageCorruptionError, OSError) as e:
                # one member's store is corrupt (a scan-path block or
                # encoded-probe crc failed): its slot gets the typed
                # code (and the replica quarantines); healthy neighbors
                # get retryable INVALID_STATE — their work was lost
                # with the shared evaluation, not their data
                bad = (self._replica_for_path(e.path)
                       if isinstance(e, StorageCorruptionError) else None)
                code = self._on_storage_error(bad, e)
                for slot_i, srv, reqs in ok_servers:
                    hit = bad is not None and \
                        (srv.app_id, srv.pidx) == bad
                    errs = []
                    for _req in reqs:
                        resp = ScanResponse()
                        resp.error = (code if (hit or bad is None)
                                      else int(ErrorCode.ERR_INVALID_STATE))
                        errs.append(resp)
                    slots[slot_i] = (slots[slot_i][0], errs)
            except ValueError as e:
                # malformed request: a DEFINITE reply, not a dropped one
                # (retrying a deterministic failure helps no one)
                for slot_i, _srv, reqs in ok_servers:
                    errs = []
                    for _req in reqs:
                        resp = ScanResponse()
                        resp.error = int(
                            ErrorCode.ERR_INVALID_PARAMETERS)
                        errs.append(resp)
                    slots[slot_i] = (slots[slot_i][0], errs)
            else:
                for (slot_i, _srv, _reqs), resps in zip(ok_servers,
                                                        results):
                    slots[slot_i] = (slots[slot_i][0], resps)
        with PROFILER.stage("pegasus.stub.reply"):
            self.net.send(self.name, src, "client_read_reply", {
                "rid": rid, "err": int(ErrorCode.ERR_OK), "result": slots,
                "decrees": decrees})

    def _peer_key(self, src: str):
        """Session-scoped peer key for negotiation state: (src,
        connection id). On the TCP transport the connection id is
        unforgeable; the sim transport (in-process, trusted) has no
        sessions and keys on the name alone."""
        current = getattr(self.net, "current_session", None)
        return (src, current() if current is not None else "")

    def _client_allowed(self, r, payload: dict,
                        access: str = "", src: str = None) -> bool:
        """Auth + table-ACL gate (parity: the ACL gate leading the client
        gate stack, replica_2pc.cpp:117 / replica.cpp:388), with the
        Ranger-style per-verb access class (access_type.h) when the
        table carries a `replica.access_policy` env. A peer that
        completed the connection negotiation (security/negotiation.py)
        may omit per-request credentials: its SESSION identity applies,
        exactly like the reference attaches the negotiated user to the
        RPC session."""
        from pegasus_tpu_torch.security.auth import check_client

        allowed = ""
        policy = ""
        if r is not None:
            allowed = r.server.app_envs.get("replica.allowed_users", "")
            policy = r.server.app_envs.get("replica.access_policy", "")
        auth = payload.get("auth")
        if (auth is None and src is not None and self.auth_secret
                and self._negotiation is not None):
            user = self._negotiation.identity(self._peer_key(src))
            if user is not None:
                # authenticated at negotiation time; only ACLs remain
                return check_client((user, ""), None, allowed,
                                    policy=policy, access=access)
        return check_client(auth, self.auth_secret,
                            allowed, policy=policy, access=access)

    # ---- partition split (parity: replica_split_manager.h:58 — the
    # replica-side parent/child state copy + catch-up; meta owns the
    # group count flip) --------------------------------------------------

    def _on_start_split(self, src: str, payload: dict) -> None:
        from pegasus_tpu_torch.replica.replica import PartitionStatus

        gpid = tuple(payload["gpid"])
        r = self.replicas.get(gpid)
        if r is None or r.status != PartitionStatus.PRIMARY:
            return  # meta retries against the current primary
        if gpid in self._split_sessions:
            return  # already in progress on this node
        self._split_sessions[gpid] = {
            "phase": "ckpt", "child_gpid": tuple(payload["child_gpid"]),
            "new_count": payload["new_count"], "ckpt_decree": 0,
        }
        self._split_advance(gpid)

    def split_tick(self) -> None:
        """Timer: advance split sessions (drain waits on the in-flight
        window; register re-sends until the flip proposal lands)."""
        for gpid in list(self._split_sessions):
            self._split_advance(gpid)

    def _split_advance(self, gpid: Gpid) -> None:
        import shutil

        from pegasus_tpu_torch.replica.replica import PartitionStatus

        sess = self._split_sessions.get(gpid)
        if sess is None:
            return
        r = self.replicas.get(gpid)
        if r is None or r.status != PartitionStatus.PRIMARY:
            # lost primaryship mid-split: abandon; meta re-drives the new
            # primary. Unfence locally (a meta proposal re-fences if the
            # child did register) and reap the half-built child — it was
            # never part of any config, and leaving it would resurrect at
            # boot scan as a zombie replica
            import shutil

            if r is not None:
                r.splitting = False
            child = self.replicas.pop(sess["child_gpid"], None)
            if child is not None:
                child.close()
            shutil.rmtree(self._replica_dir(sess["child_gpid"]),
                          ignore_errors=True)
            del self._split_sessions[gpid]
            return
        child_gpid = sess["child_gpid"]
        if sess["phase"] == "ckpt":
            # phase 1 — checkpoint copy WITHOUT a write fence (bulk of the
            # data moves while writes continue). A child replica already
            # open here is a leftover from a crashed/aborted earlier
            # attempt (boot scan resurrects half-built dirs): close and
            # rebuild from a fresh checkpoint, never resume unknown bytes
            stale = self.replicas.pop(child_gpid, None)
            if stale is not None:
                stale.close()
            child_dir = self._replica_dir(child_gpid)
            shutil.rmtree(child_dir, ignore_errors=True)
            os.makedirs(os.path.join(child_dir, "app"), exist_ok=True)
            sess["ckpt_decree"] = r.server.checkpoint(
                os.path.join(child_dir, "app", "sst"))
            # phase 2 — fence writes (clients get ERR_SPLITTING, retry);
            # only the small log tail remains to move
            r.splitting = True
            sess["phase"] = "drain"
        if sess["phase"] == "drain":
            if r.last_committed_decree < r.last_prepared_decree():
                return  # in-flight window still committing; tick retries
            child = self._open_replica(child_gpid, sess["new_count"])
            # replay the post-checkpoint tail THROUGH the child's own
            # prepare/commit pipeline: the child is born with a proper
            # plog and the exact apply semantics (atomic-op determinism)
            from pegasus_tpu_torch.replica.mutation import Mutation  # noqa: F401

            for mu in r.log.read_range(sess["ckpt_decree"] + 1,
                                       r.last_committed_decree):
                child.prepare_list.prepare(mu)
                child.log.append(mu)
            from pegasus_tpu_torch.replica.prepare_list import (
                COMMIT_TO_DECREE_HARD,
            )

            child.prepare_list.commit(r.last_committed_decree,
                                      COMMIT_TO_DECREE_HARD)
            sess["phase"] = "register"
        if sess["phase"] == "register":
            if self.meta_addr is not None:
                self.net.send(self.name, self.meta_addr, "register_child", {
                    "gpid": gpid, "child_gpid": child_gpid,
                    "primary": self.name})
            # stays in register until the flip proposal arrives
            # (_on_config_proposal clears the session + the fence)

    def _start_ckpt_fetch(self, gpid: Gpid, primary_src: str,
                          payload: dict) -> None:
        """LT_APP checkpoint on another host: pull it via the transfer
        service, then resume the learn (parity: on_learn_reply ->
        nfs copy_remote_files -> on_copy_remote_state_completed)."""
        import shutil

        from pegasus_tpu_torch.replica.file_transfer import FileFetchSession

        if gpid in self._fetch_sessions:
            return
        r = self.replicas.get(gpid)
        if r is None:
            return
        local = os.path.join(self._replica_dir(gpid), "learn_fetch")
        shutil.rmtree(local, ignore_errors=True)

        def done(ok: bool) -> None:
            self._fetch_sessions.pop(gpid, None)
            if ok and self.replicas.get(gpid) is r:
                r.complete_remote_learn(primary_src, payload, local)
            shutil.rmtree(local, ignore_errors=True)

        self._fetch_sessions[gpid] = FileFetchSession(
            self.net, self.name, payload["checkpoint_node"],
            payload["checkpoint_dir"], local, done)

    def transfer_tick(self) -> None:
        """Timer: re-send possibly-lost transfer requests."""
        for sess in list(self._fetch_sessions.values()):
            sess.resend()

    # ---- duplication (parity: duplication_sync_timer driving the
    # replica-side pipeline; meta owns WHICH partitions duplicate) -------

    @staticmethod
    def _dup_fenced(r, ops=None) -> bool:
        """True when the replica's table is fenced for client writes by
        a duplication failover drill (`dup.fence` app env, propagated
        through config-sync like every env). Inbound DUPLICATION writes
        are exempt — they are replication-class traffic and a fenced
        master-master peer must still drain."""
        if r is None or not r.server.app_envs.get("dup.fence"):
            return False
        if ops:
            from pegasus_tpu_torch.rpc.codec import OP_DUP_PUT, OP_DUP_REMOVE

            if all(op in (OP_DUP_PUT, OP_DUP_REMOVE)
                   for op, _req in ops):
                return False
        return True

    def _on_dup_apply_batch(self, src: str, payload: dict) -> None:
        """Follower side of WAN-shaped shipping: decompress one
        envelope, apply its ops IN DECREE ORDER as one 2PC mutation, ack
        at the batch's max decree. The ack carries this node's
        foreground-pressure counters so the source's dup governor backs
        catch-up off before this node starts shedding its own clients.
        No deadline and no dup fence apply — replication-class traffic
        (the source's log-GC floor waits on it)."""
        from pegasus_tpu_torch.replica.mutation import WriteOp
        from pegasus_tpu_torch.replica.replica import PartitionStatus
        from pegasus_tpu_torch.rpc.codec import decode_write
        from pegasus_tpu_torch.storage.block_codec import inflate_payload
        from pegasus_tpu_torch.utils.errors import ErrorCode
        from pegasus_tpu_torch.utils.fail_point import fail_point
        from pegasus_tpu_torch.utils.metrics import METRICS

        gpid = tuple(payload["gpid"])
        rid = payload["rid"]

        def reply(err) -> None:
            rpc_ent = METRICS.entity("rpc", "dispatch", {})
            self.net.send(self.name, src, "dup_apply_batch_ack", {
                "rid": rid, "err": int(err), "node": self.name,
                "max_decree": payload.get("max_decree"),
                "pressure": {
                    "deadline_expired": rpc_ent.counter(
                        "deadline_expired_count").value(),
                    "read_shed": rpc_ent.counter(
                        "read_shed_count").value(),
                }})

        fp = fail_point("dup::apply_batch")
        if fp is not None:
            # chaos/test hook: reject the envelope with a typed error
            reply(int(fp) if str(fp).isdigit()
                  else int(ErrorCode.ERR_INVALID_STATE))
            return
        r = self.replicas.get(gpid)
        if not self._client_allowed(r, payload, access="w", src=src):
            reply(ErrorCode.ERR_ACL_DENY)
            return
        if r is not None and getattr(r, "splitting", False):
            self._split_fence_rejects.increment()
            reply(ErrorCode.ERR_SPLITTING)
            return
        if (r is None or r.status != PartitionStatus.PRIMARY
                or getattr(r, "restoring", False)
                or not self.lease_valid()):
            reply(ErrorCode.ERR_INVALID_STATE)
            return
        import struct as _struct

        try:
            raw = inflate_payload(payload["blob_mode"],
                                  payload["ops_blob"],
                                  payload["raw_len"])
            ops = []
            pos = 0
            for _ in range(payload["n_ops"]):
                (length,) = _struct.unpack_from("<I", raw, pos)
                pos += 4
                op, req, end = decode_write(raw, pos)
                if end != pos + length:
                    raise ValueError("dup envelope op length mismatch")
                ops.append(WriteOp(op, req))
                pos = end
        except (ValueError, KeyError, RuntimeError,
                _struct.error) as e:
            from pegasus_tpu_torch.rpc.transport import _RateLimitedLog

            if not hasattr(self, "_dup_decode_log"):
                self._dup_decode_log = _RateLimitedLog()
            self._dup_decode_log.log(f"dup.decode.{gpid}", e)
            reply(ErrorCode.ERR_INVALID_PARAMETERS)
            return

        def done(_results) -> None:
            reply(ErrorCode.ERR_OK)

        try:
            r.client_write(ops, done)
        except ReplicaBusyError:
            reply(ErrorCode.ERR_BUSY)
        except (StorageCorruptionError, OSError) as e:
            reply(self._on_storage_error(gpid, e))
        except (RuntimeError, ValueError):
            reply(ErrorCode.ERR_INVALID_STATE)

    def _on_dup_add(self, src: str, payload: dict) -> None:
        from pegasus_tpu_torch.replica.duplication_cluster import (
            ClusterDuplicator,
        )
        from pegasus_tpu_torch.replica.replica import PartitionStatus

        gpid = tuple(payload["gpid"])
        dupid = payload["dupid"]
        r = self.replicas.get(gpid)
        if r is None or r.status != PartitionStatus.PRIMARY:
            return  # meta re-sends to the current primary on its tick
        key = (gpid, dupid)
        if key in self._dup_sessions:
            self._dup_sessions[key].fail_mode = payload.get("fail_mode",
                                                            "slow")
            return

        def progress(dup_id: int, confirmed: int) -> None:
            if self.meta_addr is not None:
                self.net.send(self.name, self.meta_addr,
                              "duplication_sync", {
                                  "gpid": gpid, "dupid": dup_id,
                                  "confirmed": confirmed})

        self._dup_sessions[key] = ClusterDuplicator(
            self, gpid, dupid, payload["follower_meta"],
            payload["follower_app"],
            confirmed_decree=payload.get("confirmed", 0),
            source_cluster_id=payload.get("source_cluster_id")
            or self.cluster_id,
            on_progress=progress,
            fail_mode=payload.get("fail_mode", "slow"))

    def dup_tick(self) -> None:
        """Timer: drive every dup session (parity: duplication_sync_timer).
        Sessions whose replica lost primaryship are dropped — meta
        re-homes them on the new primary."""
        from pegasus_tpu_torch.replica.replica import PartitionStatus

        for key in list(self._dup_sessions):
            gpid, _dupid = key
            r = self.replicas.get(gpid)
            if r is None or r.status != PartitionStatus.PRIMARY:
                dup = self._dup_sessions.pop(key)
                if r is not None and dup in r.duplicators:
                    r.duplicators.remove(dup)
                continue
            self._dup_sessions[key].tick()

    # ---- notifications to meta ----------------------------------------

    def _notify_learn_completed(self, gpid: Gpid, learner: str) -> None:
        if self.meta_addr is not None:
            self.net.send(self.name, self.meta_addr, "learn_completed", {
                "gpid": gpid, "learner": learner})

    def _notify_replication_error(self, gpid: Gpid, member: str) -> None:
        if self.meta_addr is not None:
            self.net.send(self.name, self.meta_addr, "replication_error", {
                "gpid": gpid, "member": member})

    # ---- config sync (parity: the pull-reconciliation protocol —
    # replica_stub.cpp:944-954 query_configuration_by_node,
    # idl/meta_admin.thrift:103-115 stored_replicas/gc_replicas,
    # meta/meta_service.cpp:793) ----------------------------------------

    def _meta_targets(self) -> list:
        return self.meta_addrs or ([self.meta_addr]
                                   if self.meta_addr else [])

    def config_sync(self) -> None:
        """Timer: report stored replicas; meta replies with this node's
        authoritative configs plus replicas to garbage-collect. Pull-based
        reconciliation is how replicas converge after meta-side
        reconfiguration that happened while this node was unreachable.
        The report carries each replica's full config VIEW: after a meta
        leader change lost recent updates, the new leader adopts any
        reported config with a higher ballot (replicas are the recovery
        source of truth — parity: `recover` from replica list)."""
        from pegasus_tpu_torch.utils.metrics import METRICS

        now = self.sim_clock()
        stored = []
        for gpid, r in self.replicas.items():
            entry = {"gpid": gpid, "ballot": r.config.ballot,
                     "primary": r.config.primary,
                     "secondaries": list(r.config.secondaries),
                     "partition_count": r.server.partition_count}
            if r.status == PartitionStatus.PRIMARY:
                # elasticity detect signals ride the existing report:
                # cumulative capacity units + the hotkey detector's
                # published result, sampled on the node's clock so the
                # meta-side controller can turn them into rates
                srv = r.server
                hot = (srv.hotkey_collectors["read"].hot_hash_key()
                       or srv.hotkey_collectors["write"].hot_hash_key())
                entry["load"] = {
                    "read_cu": srv.cu.read_cu,
                    "write_cu": srv.cu.write_cu,
                    "hot_key": hot,
                    "hot_state": {
                        k: hc.state.value
                        for k, hc in srv.hotkey_collectors.items()},
                    "at": now,
                }
                # workload shape digest rides the same report (op mix,
                # batch/value sizes, scan selectivity, hot share) —
                # meta folds per table for `shell workload`
                entry["workload"] = srv.workload.summary()
            stored.append(entry)
        # foreground-pressure counters (PR 2 shed/deadline machinery):
        # the controller backs its move pacing off when these grow
        rpc_ent = METRICS.entity("rpc", "dispatch", {})
        pressure = {
            "deadline_expired": rpc_ent.counter(
                "deadline_expired_count").value(),
            "read_shed": rpc_ent.counter("read_shed_count").value(),
        }
        # compaction demand for the meta-side stagger coordinator (the
        # reply's compact_grant answers it); the same tick drives the
        # governor's pressure feedback on nodes with no compaction
        # currently paying acquire()
        from pegasus_tpu_torch.storage.compact_governor import GOVERNOR

        GOVERNOR.poke()
        compaction = GOVERNOR.report()
        # tail-kept slow-trace summaries ride the EXISTING config-sync
        # channel so `shell traces --slow` is ONE meta call instead of a
        # cluster-wide fan-out (the full spans still fan out on demand
        # via the trace-dump verb)
        from pegasus_tpu_torch.utils import tracing

        ring = tracing.ring_for(self.name)
        trace_report = {
            "kept": ring.kept_count.value(),
            "roots": ring.slow_roots(limit=16),
        }
        # duplication health rides the same report: per-dup lag (decrees
        # + ms), shipped bytes, error counts, last error — meta's
        # duplication_service aggregates these into cluster-wide dup
        # health (`dup_stats`) and the failover drill's drain check
        dup_report = []
        for (dgpid, _dupid), sess in list(self._dup_sessions.items()):
            dr = self.replicas.get(dgpid)
            if dr is None or dr.status != PartitionStatus.PRIMARY:
                continue
            dup_report.append(sess.stats())
        # health digest + the watchdog events since the last report ride
        # the SAME channel into the meta-side ClusterHealth machine —
        # drained ONCE, outside the target loop (every meta-group member
        # gets the identical block; only the leader acts)
        health_report = self.health.drain_report()
        # per-tenant QoS stats ride the same report so meta (and the
        # collector's cluster view) can fold tenant burn across nodes
        # without a fan-out
        tenant_report = TENANTS.snapshot()
        for meta in self._meta_targets():
            self.net.send(self.name, meta, "config_sync", {
                "node": self.name, "stored": stored,
                "pressure": pressure, "compaction": compaction,
                "dup": dup_report,
                "health": health_report,
                "tenants": tenant_report,
                # NB: key must not be "trace" — that's the wire slot
                # for the distributed-tracing context
                "trace_report": trace_report})

    def _on_config_sync_reply(self, src: str, payload: dict) -> None:
        import shutil

        if "compact_grant" in payload:
            from pegasus_tpu_torch.storage.compact_governor import GOVERNOR

            GOVERNOR.set_cluster_grant(bool(payload["compact_grant"]))
        if "health_ack" in payload:
            # meta journaled our shipped health events up to this seq:
            # stop re-shipping them
            self.health.ack_report(int(payload["health_ack"]))
        for entry in payload["configs"]:
            gpid = tuple(entry["gpid"])
            r = self._open_replica(gpid, entry["partition_count"])
            r.assign_config(ReplicaConfig(entry["ballot"], entry["primary"],
                                          list(entry["secondaries"])))
            if "envs" in entry:
                # authoritative full set from meta — empty means ALL
                # table envs were deleted and must be un-applied
                r.server.update_app_envs(entry["envs"], full_set=True)
        for gpid in payload.get("gc", []):
            gpid = tuple(gpid)
            r = self.replicas.pop(gpid, None)
            if r is not None:
                # an in-flight checkpoint fetch must die with the replica
                # (its completion callback would resurrect a closed one)
                sess = self._fetch_sessions.pop(gpid, None)
                if sess is not None:
                    sess._finished = True
                r.close()
                # trash, don't delete: the disk cleaner ages it out
                # (parity: .gar dirs, replica/disk_cleaner.*)
                self.fs.trash_replica(gpid)

    # ---- failure detector (worker side) -------------------------------

    def send_beacon(self) -> None:
        """Parity: the FD beacon ping (failure_detector.h:79) — sent to
        every meta-group member; only the leader's FD acts."""
        from pegasus_tpu_torch.utils.fail_point import fail_point

        if fail_point(self._beacon_drop_fp_name) is not None:
            # chaos: this node's beacon dies on the floor — no ack, so
            # its worker lease (and with it the follower-read lease)
            # lapses deterministically while meta's grace counts down,
            # exactly the partitioned-node timeline the lease must fence
            return
        for meta in self._meta_targets():
            self.net.send(self.name, meta, "beacon", {"node": self.name})
