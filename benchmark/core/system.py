"""The system under test: the port's served path for one configuration.

A `SimCluster` of the configuration's nodes (one MetaService and the
ReplicaStubs, their partitions on the card) and a `ClusterClient` on
its network: bench.py's BenchCluster front end. The records go in by
one of the table states a traffic file names:

- "compacted": through each primary as client_write messages of 1000
  puts (two in flight a partition), then `manual_compact` of every
  partition, as bench.py's build_cluster leaves the table;
- "bulk_l0": staged by `SSTGenerator` in a local block service and
  ingested by the meta's `start_bulk_load` verb, served from the
  ingested L0 runs until a compaction runs.
"""

from __future__ import annotations

import os
import threading
import time

LOAD_MUTATION_PUTS = 1000   # bench.py:219-222: puts a client_write
LOAD_IN_FLIGHT = 2          # client_write messages in flight a partition
BULK_ROUNDS = 400           # timer rounds a bulk load may take


class SetupError(RuntimeError):
    """The system could not be set up as the configuration states."""


def build_kernels(device) -> float:
    """Build the port's libraries the served path loads (the host
    packer; on the card the scan and compaction kernels), all at once.
    A library already built from the same sources is kept. Seconds."""
    from pegasus_tpu_torch import native
    from pegasus_tpu_torch.ops import fused_compaction, fused_scan

    t0 = time.perf_counter()
    builds = [native.build]
    if device.type == "cuda":
        builds += [fused_scan.build, fused_compaction.build]
    errors: list = []

    def run(fn) -> None:
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"{fn.__module__}: {e}")

    threads = [threading.Thread(target=run, args=(fn,)) for fn in builds]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise SetupError("kernel build failed: " + "; ".join(errors))
    return time.perf_counter() - t0


def set_store_flags(store: list) -> None:
    """The configuration's [section, name, value] store flags."""
    import pegasus_tpu_torch.server.partition_server  # noqa: F401 - flags
    from pegasus_tpu_torch.utils.flags import FLAGS

    for section, name, value in store:
        FLAGS.set(section, name, value, force=True)


class System:
    def __init__(self, config: dict, device, data_dir: str,
                 seed: int) -> None:
        from pegasus_tpu_torch.tools.cluster import SimCluster

        self.config = config
        self.device = device
        self.data_dir = data_dir
        self.table = config["table"]
        self.partitions = int(config["partitions"])
        self.sim = SimCluster(os.path.join(data_dir, "cluster"),
                              n_nodes=int(config["nodes"]),
                              seed=seed % (1 << 32), device=device)
        self.app_id = self.sim.create_table(
            self.table, partition_count=self.partitions,
            replica_count=int(config["replicas"]))
        self.sim.step()
        self._replies: dict = {}
        self._rid = 0
        self.sim.net.register("loader", lambda _src, _mt, p:
                              self._replies.__setitem__(p["rid"], p))
        self.client = None

    # ---- the loader endpoint ------------------------------------------

    def _send(self, node: str, msg_type: str, payload: dict) -> int:
        self._rid += 1
        self.sim.net.send("loader", node, msg_type,
                          dict(payload, rid=self._rid))
        return self._rid

    def _keep_alive(self) -> None:
        sim = self.sim
        if sim.loop.now - sim._last_step_time >= sim.beacon_interval:
            sim.step()

    def _admin(self, cmd: str, args: dict):
        rid = self._send(self.sim.meta.name, "admin",
                         {"cmd": cmd, "args": args})
        self.sim.loop.run_until_idle()
        reply = self._replies.pop(rid)
        if reply["err"] != 0:
            raise SetupError(f"admin {cmd} answered {reply['err']}: "
                             f"{reply['result']}")
        return reply["result"]

    def primary(self, pidx: int) -> str:
        return self.sim.meta.state.get_partition(self.app_id, pidx).primary

    def servers(self) -> list:
        out = []
        for p in range(self.partitions):
            node = self.primary(p)
            out.append(self.sim.stubs[node].get_replica(
                (self.app_id, p)).server)
        return out

    # ---- loading ------------------------------------------------------

    def load_writes(self, puts: dict) -> int:
        """{pidx: [(key, value, expire_ts)]} through each primary as
        client_write messages; the puts acknowledged."""
        from pegasus_tpu_torch.rpc.codec import OP_PUT

        chunks = {p: [[(OP_PUT, r) for r in lst[i:i + LOAD_MUTATION_PUTS]]
                      for i in range(0, len(lst), LOAD_MUTATION_PUTS)]
                  for p, lst in puts.items()}
        acked = 0
        while any(chunks.values()):
            sent = []
            for p, todo in chunks.items():
                for _ in range(LOAD_IN_FLIGHT):
                    if todo:
                        batch = todo.pop(0)
                        sent.append((self._send(
                            self.primary(p), "client_write",
                            {"gpid": (self.app_id, p), "ops": batch}),
                            len(batch)))
            self.sim.loop.run_until_idle()
            for rid, n in sent:
                reply = self._replies.pop(rid)
                if reply["err"] != 0 or reply["results"] != [0] * n:
                    raise SetupError(
                        f"load: client_write answered {reply['err']}, "
                        f"results {reply['results'][:4]}")
                acked += n
            self._keep_alive()
        return acked

    def compact(self) -> None:
        for srv in self.servers():
            srv.manual_compact()

    def bulk_load(self, records, root: str) -> int:
        """(hash_key, sort_key, value, expire_ts) records staged and
        ingested; the records staged."""
        from pegasus_tpu_torch.server.bulk_load import SSTGenerator
        from pegasus_tpu_torch.storage.block_service import (
            LocalBlockService,
        )

        counts = SSTGenerator(LocalBlockService(root), self.table,
                              self.partitions).generate(records)
        self._admin("start_bulk_load", {"app_name": self.table,
                                        "root": root})
        for _ in range(BULK_ROUNDS):
            self.sim.step()
            status = self._admin("bulk_load_status",
                                 {"app_name": self.table})
            if status.get("failed"):
                raise SetupError(f"bulk load failed: {status}")
            if status["complete"]:
                break
        else:
            raise SetupError(f"bulk load not complete after "
                             f"{BULK_ROUNDS} timer rounds")
        return sum(counts.values())

    def open_client(self):
        self.client = self.sim.client(self.table, name="bench-client")
        self.client.refresh_config()
        return self.client

    def lsm_state(self) -> dict:
        """The table's runs: L0 runs, L1 runs, memtable rows, summed over
        the primaries."""
        l0 = l1 = mem = 0
        for srv in self.servers():
            lsm = srv.engine.lsm
            l0 += len(lsm.l0)
            l1 += len(lsm.l1_runs)
            mem += len(lsm.memtable)
        return {"l0_runs": l0, "l1_runs": l1, "memtable_rows": mem}

    def close(self) -> None:
        self.sim.close()
