"""Multi-process onebox: 1 meta + N replica server PROCESSES on one box.

Parity: the reference onebox (run.sh:60-66 start_onebox — real meta and
replica-server processes on one machine, the target of all function
tests). `start()` writes the cluster topology, spawns node processes via
`python -m pegasus_tpu_torch.server.node_main`, and waits for liveness;
`connect()`/`admin()` return wire clients; `stop()` tears down.

The port's replica processes serve on the card. `start(...,
device="cpu")` writes `"device": "cpu"` into cluster.json and every node
then runs the plain torch path; `flags` ({(section, name): value}) are
set in every node process before any store opens.

CLI:
    python -m pegasus_tpu_torch.tools.onebox_cluster start  [--dir D] [--nodes 3]
    python -m pegasus_tpu_torch.tools.onebox_cluster status [--dir D]
    python -m pegasus_tpu_torch.tools.onebox_cluster stop   [--dir D]
"""

from __future__ import annotations

import itertools
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from pegasus_tpu_torch.utils.errors import ErrorCode, PegasusError

DEFAULT_DIR = "/tmp/pegasus_tpu_onebox"
# the longest one wait of a wire client for its reply lasts: a wait ends
# early when the reply lands
WIRE_WAIT_S = 0.01
_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _cluster_paths(directory: str) -> Dict[str, str]:
    return {"config": os.path.join(directory, "cluster.json"),
            "pids": os.path.join(directory, "pids.json"),
            "logs": os.path.join(directory, "logs")}


def start(directory: str = DEFAULT_DIR, n_replica: int = 3,
          n_meta: int = 1, auth_secret: Optional[str] = None,
          name_prefix: str = "",
          extra_peers: Optional[Dict[str, Tuple[str, int]]] = None,
          fault_plan: Optional[dict] = None,
          disk_fault_plan: Optional[dict] = None,
          cluster_id: int = 1, device: Optional[str] = None,
          flags: Optional[dict] = None) -> dict:
    """`name_prefix` namespaces this cluster's node names (two oneboxes
    on one host must not both own "meta"); `extra_peers` maps REMOTE
    node names to (host, port) — written into the address book with
    role "external" so this cluster's nodes can dial another cluster
    (cross-cluster duplication), but never spawned or health-checked
    here. Remote names must match the peer cluster's own node names:
    the wire frame's dst field is how the receiving dispatcher finds
    its handler. `device`: where the replica processes serve (None is
    the card); `flags`: set in every node process at boot."""
    paths = _cluster_paths(directory)
    os.makedirs(paths["logs"], exist_ok=True)
    if n_meta <= 1:
        nodes = {f"{name_prefix}meta": {
            "host": "127.0.0.1", "port": _free_port(), "role": "meta"}}
    else:
        nodes = {f"{name_prefix}meta{i}": {
            "host": "127.0.0.1", "port": _free_port(), "role": "meta"}
            for i in range(n_meta)}
    for i in range(n_replica):
        nodes[f"{name_prefix}node{i}"] = {
            "host": "127.0.0.1", "port": _free_port(),
            "role": "replica"}
    for name, (host, port) in (extra_peers or {}).items():
        if name in nodes:
            raise ValueError(
                f"extra peer {name!r} collides with a local node — "
                "give one cluster a name_prefix")
        nodes[name] = {"host": host, "port": port, "role": "external"}
    cfg = {"data_root": os.path.join(directory, "data"), "nodes": nodes,
           # this cluster's identity in value timetags + the dup
           # origin-echo filter (geo-replicated clusters must differ)
           "cluster_id": cluster_id}
    if fault_plan:
        # chaos wiring for REAL processes: every node installs this
        # rpc/fault.FaultPlan schedule on its transport at boot (see
        # node_main), so kill_test/integration runs inject network
        # faults without any in-process hook
        cfg["fault_plan"] = fault_plan
    if disk_fault_plan:
        # the disk twin: storage/vfs.py fail-point actions (bit_flip /
        # torn_write / eio / enospc), armed in every node process at
        # boot from one seed so the run replays
        cfg["disk_fault_plan"] = disk_fault_plan
    if device is not None:
        cfg["device"] = str(device)
    if flags:
        cfg["flags"] = _flag_sections(flags)
    if auth_secret:
        # onebox-grade key distribution: the secret lives in the cluster
        # config file (the keytab-file analogue)
        cfg["auth_secret"] = auth_secret
    with open(paths["config"], "w") as f:
        json.dump(cfg, f, indent=1)

    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")

    pids = {}
    procs = {}
    log_starts = {}
    for name in nodes:
        if nodes[name]["role"] == "external":
            continue  # book-only remote peer (another cluster's node)
        log = open(os.path.join(paths["logs"], f"{name}.log"), "ab")
        log_starts[name] = log.tell()
        p = subprocess.Popen(
            [sys.executable, "-m", "pegasus_tpu_torch.server.node_main",
             "--config", paths["config"], "--name", name],
            stdout=log, stderr=subprocess.STDOUT, env=env,
            cwd=_REPO_ROOT)
        pids[name] = p.pid
        procs[name] = p
    with open(paths["pids"], "w") as f:
        json.dump(pids, f)

    # liveness: every node prints its boot line within the deadline; a
    # boot that fails stops the nodes already started
    try:
        _wait_alive(nodes, procs, paths["logs"], log_starts,
                    time.monotonic() + 30)
    except BaseException:
        stop(directory)
        raise
    return cfg


def _wait_alive(nodes: dict, procs: dict, log_dir: str,
                log_starts: dict, deadline: float) -> None:
    """Every node printed its boot line since this start: its port is
    open and its role registered its handlers. A node that exits first
    raises with its log's tail: its port may have opened before its
    boot failed."""
    for name, n in nodes.items():
        if n["role"] == "external":
            continue
        while True:
            if procs[name].poll() is not None:
                raise RuntimeError(
                    f"{name} exited with {procs[name].returncode} "
                    f"during boot:\n{_log_tail(log_dir, name)}")
            if _booted(log_dir, name, n["role"], log_starts[name]):
                break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"{name} did not come up:\n{_log_tail(log_dir, name)}")
            time.sleep(0.2)


def _booted(log_dir: str, name: str, role: str, start: int) -> bool:
    """The node's boot line (server/node_main.py) is in its log past
    `start`."""
    with open(os.path.join(log_dir, f"{name}.log"), "rb") as f:
        f.seek(start)
        return f"[{name}] {role} serving on ".encode() in f.read()


def _flag_sections(flags: dict) -> dict:
    """{(section, name): value} as cluster.json's {section: {name:
    value}}."""
    out: dict = {}
    for (section, name), value in flags.items():
        out.setdefault(section, {})[name] = value
    return out


def _log_tail(log_dir: str, name: str, n_bytes: int = 4000) -> str:
    with open(os.path.join(log_dir, f"{name}.log"), "rb") as f:
        f.seek(0, os.SEEK_END)
        f.seek(max(0, f.tell() - n_bytes))
        return f.read().decode(errors="replace")


def stop(directory: str = DEFAULT_DIR) -> List[str]:
    paths = _cluster_paths(directory)
    stopped = []
    if not os.path.exists(paths["pids"]):
        return stopped
    with open(paths["pids"]) as f:
        pids = json.load(f)
    for name, pid in pids.items():
        try:
            os.kill(pid, signal.SIGTERM)
            stopped.append(name)
        except ProcessLookupError:
            pass
    os.remove(paths["pids"])
    return stopped


def status(directory: str = DEFAULT_DIR) -> Dict[str, bool]:
    paths = _cluster_paths(directory)
    if not os.path.exists(paths["pids"]):
        return {}
    with open(paths["pids"]) as f:
        pids = json.load(f)
    out = {}
    for name, pid in pids.items():
        try:
            os.kill(pid, 0)
            out[name] = True
        except ProcessLookupError:
            out[name] = False
    return out


def kill_node(name: str, directory: str = DEFAULT_DIR) -> None:
    """kill -9 one node (parity: the kill_test harness)."""
    paths = _cluster_paths(directory)
    with open(paths["pids"]) as f:
        pids = json.load(f)
    os.kill(pids[name], signal.SIGKILL)


def pause_node(name: str, directory: str = DEFAULT_DIR) -> None:
    """SIGSTOP one node: the process is alive but serves nothing and
    beacons nothing — the hung-node shape (GC pause, disk stall) that
    exercises FD lease expiry instead of crash recovery."""
    paths = _cluster_paths(directory)
    with open(paths["pids"]) as f:
        pids = json.load(f)
    os.kill(pids[name], signal.SIGSTOP)


def resume_node(name: str, directory: str = DEFAULT_DIR) -> None:
    """SIGCONT a paused node. It wakes believing it is still serving;
    the worker-side lease check must fence it until meta re-admits."""
    paths = _cluster_paths(directory)
    with open(paths["pids"]) as f:
        pids = json.load(f)
    os.kill(pids[name], signal.SIGCONT)


class OneboxAdmin:
    """Wire admin client: DDL against the onebox meta."""

    def __init__(self, directory: str = DEFAULT_DIR,
                 name: str = "admin-cli") -> None:
        from pegasus_tpu_torch.rpc.transport import TcpTransport

        paths = _cluster_paths(directory)
        with open(paths["config"]) as f:
            self.cfg = json.load(f)
        book = {n: (c["host"], c["port"])
                for n, c in self.cfg["nodes"].items()}
        self.net = TcpTransport(None, book)
        self.name = name
        self._rids = itertools.count(1)
        self._replies: Dict[int, dict] = {}
        self._landed = threading.Event()
        from pegasus_tpu_torch.utils.backoff import Backoff

        self._backoff = Backoff()
        self.net.register(name, self._on_message)

    def _on_message(self, src: str, msg_type: str, payload) -> None:
        if msg_type in ("admin_reply", "remote_command_reply"):
            self._replies[payload["rid"]] = payload
            self._landed.set()

    def _wait(self, until: float) -> None:
        """Block until a reply lands or WIRE_WAIT_S passes, never past
        `until` (time.monotonic)."""
        self._landed.wait(max(0.0, min(WIRE_WAIT_S,
                                       until - time.monotonic())))
        self._landed.clear()

    def remote_command(self, node: str, verb: str, args=None,
                       timeout: float = 10.0):
        """Invoke a registered control verb on one node (the chaos
        harness uses this to force flushes and read the integrity
        counters; the shell's wire mode has its own copy)."""
        rid = next(self._rids)
        self.net.send(self.name, node, "remote_command",
                      {"rid": rid, "cmd": verb, "args": args or []})
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if rid in self._replies:
                reply = self._replies.pop(rid)
                if reply["err"] != 0:
                    raise PegasusError(ErrorCode.ERR_HANDLER_NOT_FOUND,
                                       str(reply["result"]))
                return reply["result"]
            self._wait(deadline)
        raise PegasusError(ErrorCode.ERR_TIMEOUT,
                           f"remote_command {verb} to {node}")

    def call(self, cmd: str, timeout: float = 15.0, **args):
        """One OVERALL deadline shared across the meta-group rotation —
        the caller's timeout bound holds in both directions."""
        metas = [n for n, c in self.cfg["nodes"].items()
                 if c["role"] == "meta"]
        overall = time.monotonic() + timeout
        last = None
        for i, meta in enumerate(metas):
            if i:
                # jittered pause before the next group member — the
                # same anti-storm pacing the data clients apply
                self._backoff.sleep(i)
            remaining = overall - time.monotonic()
            if remaining <= 0:
                break
            rid = next(self._rids)
            self.net.send(self.name, meta, "admin",
                          {"rid": rid, "cmd": cmd, "args": args})
            slice_deadline = time.monotonic() + remaining / (len(metas) - i)
            while time.monotonic() < slice_deadline:
                if rid in self._replies:
                    reply = self._replies.pop(rid)
                    if reply["err"] != int(ErrorCode.ERR_OK):
                        raise PegasusError(ErrorCode(reply["err"]),
                                           str(reply.get("result")))
                    return reply["result"]
                self._wait(slice_deadline)
            last = PegasusError(ErrorCode.ERR_TIMEOUT,
                                f"admin {cmd} via {meta}")
        raise last or PegasusError(ErrorCode.ERR_TIMEOUT, f"admin {cmd}")

    def create_table(self, app_name: str, partition_count: int = 8,
                     replica_count: int = 3,
                     envs: Optional[Dict[str, str]] = None) -> int:
        return self.call("create_app", app_name=app_name,
                         partition_count=partition_count,
                         replica_count=replica_count, envs=envs)

    def close(self) -> None:
        self.net.close()


def connect(app_name: str, directory: str = DEFAULT_DIR,
            client_name: Optional[str] = None, user: str = "admin",
            op_timeout_ms: Optional[float] = None,
            tenant: Optional[str] = None):
    """Wire data client for a onebox table. `op_timeout_ms` bounds each
    op end-to-end (all retries included); None keeps the
    client_op_timeout_ms flag default. `tenant` tags every request for
    server-side QoS accounting (None adopts the table's
    qos.default_tenant env, if any)."""
    from pegasus_tpu_torch.client.cluster_client import ClusterClient
    from pegasus_tpu_torch.rpc.transport import TcpTransport

    paths = _cluster_paths(directory)
    with open(paths["config"]) as f:
        cfg = json.load(f)
    book = {n: (c["host"], c["port"]) for n, c in cfg["nodes"].items()}
    net = TcpTransport(None, book)
    metas = [n for n, c in cfg["nodes"].items() if c["role"] == "meta"]
    auth = None
    if cfg.get("auth_secret"):
        from pegasus_tpu_torch.security.auth import make_credentials

        auth = make_credentials(user, cfg["auth_secret"])
    # the transport delivers on its own threads: a wait ends when the
    # reply lands, and a reply that never comes still costs the retry
    # window of 400 slices of 10 ms
    return ClusterClient(
        net, client_name or f"client-{os.getpid()}", metas, app_name,
        pump=None, reply_wait_s=WIRE_WAIT_S, max_retries=8, pump_rounds=400,
        auth=auth, op_timeout_ms=op_timeout_ms, tenant=tenant)


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("action", choices=["start", "stop", "status"])
    ap.add_argument("--dir", default=DEFAULT_DIR)
    ap.add_argument("--nodes", type=int, default=3)
    ap.add_argument("--metas", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="where the replica processes serve: the card "
                         "(default) or cpu")
    args = ap.parse_args()
    if args.action == "start":
        cfg = start(args.dir, args.nodes, args.metas, device=args.device)
        print(json.dumps(cfg["nodes"], indent=1))
    elif args.action == "stop":
        print("stopped:", ", ".join(stop(args.dir)) or "(nothing)")
    else:
        print(json.dumps(status(args.dir), indent=1))


if __name__ == "__main__":
    main()
