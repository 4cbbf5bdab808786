"""Rolling restart of a onebox cluster's replica nodes.

Parity: admin_tools/pegasus_rolling_update.sh — restart nodes ONE at a
time, waiting between steps until the cluster is healthy again (every
partition back to full replication with a primary), so a binary/config
rollout never drops below quorum.

CLI: python -m pegasus_tpu_torch.tools.rolling_update --dir D
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import List

from pegasus_tpu_torch.utils.errors import PegasusError

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


def _healthy(admin, apps: List[dict]) -> bool:
    from pegasus_tpu_torch.tools.onebox_cluster import connect

    for app in apps:
        try:
            client = connect(app["app_name"],
                             admin_directory(admin))
            client.refresh_config()
            for pc in client._configs:
                members = ([pc["primary"]] if pc["primary"] else []) \
                    + pc["secondaries"]
                if not pc["primary"] or len(members) < min(
                        app["replica_count"], 3):
                    client.net.close()
                    return False
            client.net.close()
        except PegasusError:
            return False
    return True


def admin_directory(admin) -> str:
    return admin._directory


def rolling_update(directory: str, settle_timeout: float = 120.0) -> None:
    from pegasus_tpu_torch.tools import onebox_cluster as ob

    admin = ob.OneboxAdmin(directory)
    admin._directory = directory
    with open(os.path.join(directory, "cluster.json")) as f:
        cfg = json.load(f)
    replicas = [n for n, c in cfg["nodes"].items()
                if c["role"] == "replica"]
    apps = admin.call("list_apps")
    for node in replicas:
        print(f"[rolling] restarting {node}", flush=True)
        with open(os.path.join(directory, "pids.json")) as f:
            pids = json.load(f)
        try:
            os.kill(pids[node], 15)
        except ProcessLookupError:
            pass
        time.sleep(1.0)
        env = dict(os.environ)
        env["PYTHONPATH"] = _REPO_ROOT + os.pathsep + env.get(
            "PYTHONPATH", "")
        log = open(os.path.join(directory, "logs",
                                f"{node}.rolling.log"), "ab")
        p = subprocess.Popen(
            [sys.executable, "-m", "pegasus_tpu_torch.server.node_main",
             "--config", os.path.join(directory, "cluster.json"),
             "--name", node],
            stdout=log, stderr=subprocess.STDOUT, env=env,
            cwd=_REPO_ROOT)
        pids[node] = p.pid
        with open(os.path.join(directory, "pids.json"), "w") as f:
            json.dump(pids, f)
        # wait until the cluster is fully healthy before the next node
        deadline = time.monotonic() + settle_timeout
        while time.monotonic() < deadline:
            if _healthy(admin, apps):
                break
            time.sleep(2.0)
        else:
            raise RuntimeError(
                f"cluster did not settle after restarting {node}")
        print(f"[rolling] {node} back, cluster healthy", flush=True)
    admin.close()
    print("[rolling] update complete", flush=True)


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True)
    ap.add_argument("--settle-timeout", type=float, default=120.0)
    args = ap.parse_args()
    rolling_update(args.dir, args.settle_timeout)


if __name__ == "__main__":
    main()
