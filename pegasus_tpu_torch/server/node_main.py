"""Node boot: the config-driven service host.

Parity: src/server/main.cpp:34-74 + dsn_run (runtime/service_api_c.cpp:279)
— ONE entry point; the cluster config decides whether this process runs
the meta role or a replica role (the rDSN idea that applications are
plugins selected by config, SURVEY §1). Timers stand in for the task
engine's timer tasks: FD beacons, group checks, config-sync, meta ticks.

Run:  python -m pegasus_tpu_torch.server.node_main --config cluster.json --name node0

cluster.json:
    {"data_root": "/path",
     "nodes": {"meta":  {"host": "127.0.0.1", "port": 34601, "role": "meta"},
               "node0": {"host": "127.0.0.1", "port": 34801, "role": "replica"},
               ...},
     "device": "cpu",                                   (optional)
     "flags": {"pegasus.storage": {"block_codec": "none"}}}  (optional)

The port's replica role serves its partitions on the card: the stub is
built with `device=None`, and a process that finds no CUDA device exits
with an error rather than serving on the host. `"device": "cpu"` asks
for the plain torch path: the process then hides the card from itself
before torch first touches CUDA. The meta role needs no card and always
hides it. `"flags"` are set (`FLAGS.set`) before any store opens, as a
config file would set them. Neither key changes an answer.

A node imports its role's modules and fills the message registry before
its port opens (`preload`), so a peer's first frame never makes a reader
thread import a package that the main thread is importing too. A boot
that raises prints its traceback and exits with 1.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import signal
import sys
import time
import traceback

_STARTED = time.perf_counter()

# what each role's boot imports, and what the transport's own threads
# import at their first message (server/tenancy, utils/profiler)
ROLE_MODULES = {
    "meta": ("pegasus_tpu_torch.meta.meta_service",
             "pegasus_tpu_torch.http.http_server"),
    "replica": ("pegasus_tpu_torch.replica.stub",
                "pegasus_tpu_torch.replica.replica",
                "pegasus_tpu_torch.server.scan_coordinator",
                "pegasus_tpu_torch.http.http_server"),
}
TRANSPORT_MODULES = ("pegasus_tpu_torch.server.tenancy",
                     "pegasus_tpu_torch.utils.profiler")


def load_config(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def address_book(cfg: dict) -> dict:
    return {name: (n["host"], n["port"])
            for name, n in cfg["nodes"].items()}


def apply_flags(cfg: dict) -> None:
    """The config's {section: {name: value}} flags, set over the
    defaults. The modules that define the store, server and meta flags
    are imported first."""
    import pegasus_tpu_torch.meta.compaction_scheduler  # noqa: F401
    import pegasus_tpu_torch.replica.stub  # noqa: F401 - defines flags
    from pegasus_tpu_torch.utils.flags import FLAGS

    for section, values in (cfg.get("flags") or {}).items():
        for flag, value in values.items():
            FLAGS.set(section, flag, value, force=True)


def serving_device(cfg: dict):
    """The replica role's device: the card unless the config names the
    CPU. Exits when the card is asked for and there is none."""
    import torch

    from pegasus_tpu_torch.utils.device import resolve_device

    try:
        dev = resolve_device(cfg.get("device"))
    except RuntimeError as e:
        raise SystemExit(f"no device to serve on: {e}") from e
    if dev.type == "cuda":
        return dev, f"{dev} ({torch.cuda.get_device_name(dev)})"
    return dev, str(dev)


def preload(role: str) -> None:
    """Import the role's modules and fill the message registry. Called
    before the port opens: no inbound frame reaches a process that is
    still importing."""
    for module in ROLE_MODULES.get(role, ()) + TRANSPORT_MODULES:
        importlib.import_module(module)
    from pegasus_tpu_torch.rpc.message import fill_registry

    fill_registry()


def print_boot(name: str, preload_s: float) -> None:
    """The boot's seconds, from the module's import to the role's
    serving, on the line before the boot line."""
    print(f"[{name}] booted in {time.perf_counter() - _STARTED} s "
          f"({preload_s} s before the port opened)", flush=True)


def kernel_launches(args) -> dict:
    """The `kernel.launches` verb of a replica node: this process's
    launch counts of the hand-written kernels (each wrapper counts its
    launches); `reset` zeroes them after the read. The port's own verb:
    a caller reads what the node ran on the card."""
    from pegasus_tpu_torch.ops import fused_compaction, fused_mesh, fused_scan

    out = {}
    for mod in (fused_scan, fused_compaction, fused_mesh):
        out[mod.__name__.rsplit(".", 1)[1]] = dict(mod.LAUNCHES)
        if args and args[0] == "reset":
            mod.LAUNCHES.update(dict.fromkeys(mod.LAUNCHES, 0))
    return out


def run_node(cfg: dict, name: str) -> None:
    node_cfg = cfg["nodes"][name]
    role = node_cfg["role"]
    if role == "meta" or cfg.get("device") == "cpu":
        # before anything imports torch: this process never opens a
        # context on the card
        from pegasus_tpu_torch.utils.cpu_isolation import force_cpu

        force_cpu(verify=True)
    apply_flags(cfg)
    if role == "replica":
        # before the port opens: a node that cannot serve never looks up
        device, device_name = serving_device(cfg)
    preload(role)
    preload_s = time.perf_counter() - _STARTED
    from pegasus_tpu_torch.rpc.transport import TcpTransport

    data_root = cfg["data_root"]
    book = address_book(cfg)
    transport = TcpTransport((node_cfg["host"], node_cfg["port"]), book)
    if cfg.get("fault_plan"):
        # config-driven chaos (rpc/fault.py): every node of a chaos
        # onebox installs the same seeded schedule, so link faults are
        # charged once at the sender and the run replays from its seed
        from pegasus_tpu_torch.rpc.fault import FaultPlan

        transport.install_fault_plan(
            FaultPlan.from_config(cfg["fault_plan"]))
        print(f"[{name}] fault plan armed: {cfg['fault_plan']}",
              flush=True)
    if cfg.get("disk_fault_plan"):
        # the disk twin of fault_plan (storage/vfs.py): bit-flip /
        # torn-write / EIO / ENOSPC injection on the data-file layer,
        # seeded so a chaos run replays exactly
        from pegasus_tpu_torch.storage.vfs import install_disk_faults

        install_disk_faults(cfg["disk_fault_plan"])
        print(f"[{name}] disk fault plan armed: "
              f"{cfg['disk_fault_plan']}", flush=True)
    meta_names = [n for n, c in cfg["nodes"].items()
                  if c["role"] == "meta"]

    stop = {"flag": False}

    def on_term(_sig, _frm):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)

    http_server = None
    if role == "meta":
        from pegasus_tpu_torch.http.http_server import MetricsHttpServer
        from pegasus_tpu_torch.meta.meta_service import MetaService

        svc = MetaService(name, os.path.join(data_root, name), transport,
                          clock=time.monotonic, peers=meta_names)
        transport.run_timer(1.0, svc.tick)
        http_server = MetricsHttpServer(
            port=node_cfg.get("http_port", 0), commands=svc.commands,
            routes=svc.http_routes()).start()
        print_boot(name, preload_s)
        print(f"[{name}] meta serving on {node_cfg['host']}:"
              f"{node_cfg['port']} http={http_server.port}", flush=True)
    elif role == "replica":
        from pegasus_tpu_torch.replica.replica import PartitionStatus
        from pegasus_tpu_torch.replica.stub import ReplicaStub

        dirs = node_cfg.get("data_dirs") or [os.path.join(data_root, name)]
        stub = ReplicaStub(name, dirs, transport,
                           clock=time.time, sim_clock=time.monotonic,
                           cluster_id=int(cfg.get("cluster_id", 1)),
                           device=device)
        stub.auth_secret = cfg.get("auth_secret")
        stub.commands.register("kernel.launches", kernel_launches,
                               "kernel.launches [reset]: launch counts "
                               "of the hand-written kernels")
        stub.meta_addrs = meta_names
        stub.meta_addr = meta_names[0]
        transport.run_timer(1.0, stub.send_beacon)
        transport.run_timer(2.5, stub.config_sync)

        def group_checks() -> None:
            for r in stub.replicas.values():
                if r.status == PartitionStatus.PRIMARY:
                    r.broadcast_group_check()

        transport.run_timer(1.0, group_checks)
        transport.run_timer(1.0, stub.dup_tick)
        transport.run_timer(1.0, stub.split_tick)
        transport.run_timer(2.0, stub.transfer_tick)
        # paced background scrub: verify at-rest block CRCs so latent
        # corruption on a non-serving replica is found and repaired
        # (quarantine + re-learn) before a promotion serves it
        transport.run_timer(1.0, stub.scrub_tick)
        # flight recorder + health watchdog (rings, rules, auto-pin);
        # the tick coalesces itself to the configured cadence
        transport.run_timer(2.0, stub.health_tick)
        # keep device predicate masks warm so scans never wait on a
        # block's first evaluation (scan_coordinator)
        from pegasus_tpu_torch.server.scan_coordinator import MaskPrefresher

        MaskPrefresher(lambda: [r.server
                                for r in stub.replicas.values()]).start()
        # disk cleaner (parity: replica/disk_cleaner.*): age out trashed
        # replica dirs so rebalancing churn cannot fill the disk
        transport.run_timer(600.0, stub.fs.clean_trash)
        from pegasus_tpu_torch.http.http_server import MetricsHttpServer

        http_server = MetricsHttpServer(
            port=node_cfg.get("http_port", 0),
            commands=stub.commands).start()
        print_boot(name, preload_s)
        print(f"[{name}] replica serving on {node_cfg['host']}:"
              f"{node_cfg['port']} http={http_server.port} "
              f"device={device_name}", flush=True)
    else:
        raise SystemExit(f"unknown role {role!r} for {name}")

    try:
        while not stop["flag"]:
            time.sleep(0.2)
    finally:
        transport.close()
        if role == "replica":
            stub.close()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--name", required=True)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    try:
        run_node(load_config(args.config), args.name)
    except Exception:  # noqa: BLE001 - a failed boot must end the process
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        # the transport's and the timers' threads must not keep a dead
        # node's port open
        os._exit(1)


if __name__ == "__main__":
    main()
