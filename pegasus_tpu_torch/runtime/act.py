"""Declarative scripted cluster cases (the .act harness).

Parity: src/replica/storage/simple_kv/test — the reference verifies
PacificA with declarative .act scripts run under the deterministic
simulator (case-000.act:30-64: client ops, config assertions, state
assertions, fault injection), numbered by fault class. This runner
executes the same idea against SimCluster: one line per step, seeded
determinism, every assertion against live cluster state.

Case grammar (one `verb: args` per line; '#' comments):

    create: <table> partitions=N replicas=N     create the table
    set: <hk> <sk> <value>                      client write (must ack)
    set_fail: <hk> <sk> <value>                 client write must NOT ack
    expect_read: <hk> <sk> <value|NOT_FOUND>    client read assertion
    kill: <node>     revive: <node>             crash / restore a node
    drop: <src> <dst> <prob>                    inject link loss
    heal_links:                                 clear loss injection
    step: <rounds>                              beacon/guardian rounds
    expect_primary_not: <pidx> <node>           cure assertion
    expect_members: <pidx> <count>              replication level
    expect_ballot_ge: <pidx> <n>                ballot monotonicity
    expect_consistent: <hk> <sk>                every member agrees
    fail_point: <name> <action>                 e.g. node1::plog_append raise(io)
    split: <table>                              start the online 2x split
    expect_partition_count: <table> <n>         (after steps) count settled
    dup: <master> <follower>                    add duplication
    expect_follower_read: <follower> <hk> <sk> <value>
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

from pegasus_tpu_torch.tools.cluster import SimCluster
from pegasus_tpu_torch.utils.errors import PegasusError, StorageStatus

OK = int(StorageStatus.OK)


class ActError(AssertionError):
    pass


def _parse(text: str) -> List[Tuple[int, str, List[str]]]:
    steps = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        if ":" not in line:
            raise ValueError(f"line {lineno}: expected 'verb: args'")
        verb, _sep, rest = line.partition(":")
        steps.append((lineno, verb.strip(), rest.split()))
    return steps


class ActRunner:
    def __init__(self, data_dir: str, n_nodes: int = 4,
                 seed: int = 0, device=None) -> None:
        """`device`: where the cluster's partitions serve (None is the
        card, "cpu" the plain torch path); it changes no outcome."""
        self.device = device
        self.cluster = SimCluster(data_dir, n_nodes=n_nodes, seed=seed,
                                  device=device)
        self.dir = data_dir
        self.client = None
        self._auth_clients: dict = {}
        self.app_id: Optional[int] = None
        self._follower_clients: dict = {}
        self._backup_id = None
        self.last_killed: Optional[str] = None

    def close(self) -> None:
        from pegasus_tpu_torch.utils.fail_point import FAIL_POINTS

        FAIL_POINTS.teardown()  # a case must not leak faults
        self.cluster.close()

    def run_text(self, text: str, name: str = "<case>") -> None:
        for lineno, verb, args in _parse(text):
            try:
                self._step(verb, args)
            except (ActError, AssertionError) as e:
                raise ActError(
                    f"{name}:{lineno}: `{verb}: {' '.join(args)}` "
                    f"failed: {e}") from e

    def run_file(self, path: str) -> None:
        with open(path) as f:
            self.run_text(f.read(), os.path.basename(path))

    # ---- verbs ---------------------------------------------------------

    def _step(self, verb: str, args: List[str]) -> None:
        c = self.cluster
        if verb == "create":
            kw = dict(kv.split("=") for kv in args[1:])
            app_id = c.create_table(
                args[0], partition_count=int(kw.get("partitions", 4)),
                replica_count=int(kw.get("replicas", 3)))
            if self.client is None:
                # the FIRST table is the case's subject; later creates
                # (dup followers etc.) are reached via their own verbs
                self.app_id = app_id
                self.client = c.client(args[0])
        elif verb == "set":
            hk, sk, value = (a.encode() for a in args)
            err = self.client.set(hk, sk, value)
            if err != OK:
                raise ActError(f"write not acked (err {err})")
        elif verb == "set_fail":
            hk, sk, value = (a.encode() for a in args)
            try:
                err = self.client.set(hk, sk, value)
            except PegasusError:
                return
            if err == OK:
                raise ActError("write unexpectedly acked")
        elif verb == "expect_read":
            hk, sk = args[0].encode(), args[1].encode()
            want = args[2]
            err, value = self.client.get(hk, sk)
            if want == "NOT_FOUND":
                if err == OK:
                    raise ActError(f"found {value!r}, wanted NOT_FOUND")
            else:
                if err != OK or value != want.encode():
                    raise ActError(f"got (err={err}, {value!r}), "
                                   f"wanted {want!r}")
        elif verb == "kill":
            c.kill(args[0])
        elif verb == "revive":
            c.revive(args[0])
        elif verb == "revive_last_killed":
            if self.last_killed is None:
                raise ActError("nothing was killed via kill_primary")
            c.revive(self.last_killed)
        elif verb == "drop":
            c.net.set_drop(float(args[2]), args[0], args[1])
        elif verb == "drop_all":
            c.net.set_drop(float(args[0]))
        elif verb == "delay":
            # delay: [<src> <dst>] <ms> — extra fixed latency on one
            # link, or on EVERY link when only <ms> is given
            if len(args) == 1:
                c.net.set_delay(float(args[0]) / 1000.0)
            else:
                c.net.set_delay(float(args[2]) / 1000.0, args[0],
                                args[1])
        elif verb == "partition":
            # cut a live node off the network entirely (unlike kill:, the
            # process keeps running — lease expiry, not crash recovery)
            c.net.partition(args[0])
        elif verb == "heal":
            c.net.heal(args[0])
        elif verb == "heal_links":
            c.net._drop_prob.clear()
            c.net._extra_delay.clear()
        elif verb == "fail_point":
            from pegasus_tpu_torch.utils.fail_point import FAIL_POINTS

            FAIL_POINTS.setup()
            FAIL_POINTS.cfg(args[0], " ".join(args[1:]))
        elif verb == "fail_point_primary":
            # fail_point_primary: <pidx> <site> <action> — configure
            # <current primary of pidx>::<site> (cases must not hardcode
            # which node the seed elected)
            from pegasus_tpu_torch.utils.fail_point import FAIL_POINTS

            pc = c.meta.state.get_partition(self.app_id, int(args[0]))
            if not pc.primary:
                raise ActError("partition has no primary")
            self.last_fault_node = pc.primary
            FAIL_POINTS.setup()
            FAIL_POINTS.cfg(f"{pc.primary}::{args[1]}",
                            " ".join(args[2:]))
        elif verb == "fail_point_all":
            # fail_point_all: <site> <action> — every node
            from pegasus_tpu_torch.utils.fail_point import FAIL_POINTS

            FAIL_POINTS.setup()
            for name in c.stubs:
                FAIL_POINTS.cfg(f"{name}::{args[0]}",
                                " ".join(args[1:]))
        elif verb == "split":
            c.meta.split.start_partition_split(args[0])
        elif verb == "expect_partition_count":
            app = c.meta.state.find_app(args[0])
            if app is None or app.partition_count != int(args[1]):
                raise ActError(
                    f"partition_count "
                    f"{app.partition_count if app else None}, "
                    f"wanted {args[1]}")
        elif verb == "dup":
            c.meta.duplication.add_duplication(args[0], "meta", args[1])
        elif verb == "config":
            if self.client is not None:
                raise ActError("config: must precede create:")
            kw = dict(kv.split("=") for kv in args)
            import shutil
            self.cluster.close()
            shutil.rmtree(self.dir, ignore_errors=True)
            self.cluster = SimCluster(
                self.dir, n_nodes=int(kw.get("nodes", 4)),
                seed=int(kw.get("seed", 7)),
                n_meta=int(kw.get("n_meta", 1)),
                auth_secret=kw.get("auth_secret"), device=self.device)
        elif verb == "app_env":
            # app_env: <key> <value> — set a table env (ACLs, throttles)
            # on the acting app; config-sync delivers it to replicas
            app_name = c.meta.state.apps[self.app_id].app_name
            c.meta.update_app_envs(app_name, {args[0]: args[1]})
            c.step()
        elif verb == "auth":
            # auth: <user> — subsequent client ops run as this identity
            app_name = c.meta.state.apps[self.app_id].app_name
            key = args[0]
            cl = self._auth_clients.get(key)
            if cl is None:
                cl = c.client(app_name, name=f"act-auth-{key}",
                              user=key)
                self._auth_clients[key] = cl
            self.client = cl
        elif verb == "kill_primary":
            # kill partition <pidx>'s current primary; remembered for
            # expect_primary_unchanged / expect_primary_recovered
            pc = c.meta.state.get_partition(self.app_id, int(args[0]))
            if not pc.primary:
                raise ActError("partition has no primary to kill")
            self.last_killed = pc.primary
            c.kill(pc.primary)
        elif verb == "expect_primary_unchanged":
            pc = c.meta.state.get_partition(self.app_id, int(args[0]))
            if pc.primary != self.last_killed:
                raise ActError(
                    f"primary moved to {pc.primary!r} (expected still "
                    f"{self.last_killed!r})")
        elif verb == "expect_primary_recovered":
            pc = c.meta.state.get_partition(self.app_id, int(args[0]))
            if not pc.primary or pc.primary == self.last_killed:
                raise ActError(f"primary {pc.primary!r} not recovered "
                               f"away from {self.last_killed!r}")
        elif verb == "kill_meta_leader":
            leader = [m for m in c.metas
                      if m.election.is_leader]
            if not leader:
                raise ActError("no meta leader to kill")
            c.kill(leader[0].name)
        elif verb == "bulkload_stage":
            # stage offline SSTs for the FIRST table: keys k<000..n-1>
            from pegasus_tpu_torch.server.bulk_load import SSTGenerator
            from pegasus_tpu_torch.storage.block_service import LocalBlockService

            opts = dict(kv.split("=") for kv in args)
            n = int(opts.get("records", 40))
            app = c.meta.state.apps[self.app_id]
            root = os.path.join(self.dir, "bulk_root")
            gen = SSTGenerator(LocalBlockService(root), app.app_name,
                               partition_count=app.partition_count)
            gen.generate([(b"bl%04d" % i, b"s", b"ingested-%d" % i, 0)
                          for i in range(n)])
        elif verb == "bulkload_start":
            app = c.meta.state.apps[self.app_id]
            root = os.path.join(self.dir, "bulk_root")
            c.meta.bulk_load.start_bulk_load(app.app_name, root)
        elif verb == "expect_bulkload_done":
            app = c.meta.state.apps[self.app_id]
            st = c.meta.bulk_load.bulk_load_status(app.app_name)
            if not st.get("complete"):
                raise ActError(f"bulk load incomplete: {st}")
        elif verb == "backup":
            root = os.path.join(self.dir, "backup_root")
            self._backup_id = c.meta.backup.start_backup(
                args[0], root, "act")
        elif verb == "expect_backup_done":
            if self._backup_id is None:
                raise ActError("expect_backup_done: no backup: ran")
            st = c.meta.backup.backup_status(self._backup_id)
            if not st["complete"]:
                raise ActError(f"backup incomplete: {st}")
        elif verb == "restore":
            if self._backup_id is None:
                raise ActError("restore: no backup: ran")
            root = os.path.join(self.dir, "backup_root")
            c.meta.backup.create_app_from_backup(
                args[0], root, "act", self._backup_id, replica_count=3)
        elif verb == "expect_follower_read":
            fc = self._follower_clients.get(args[0])
            if fc is None:
                # NOT setdefault: its eagerly-evaluated default would
                # register a fresh client over the same transport name
                # each call, stealing replies from the kept instance
                fc = c.client(args[0], name=f"act-f-{args[0]}")
                self._follower_clients[args[0]] = fc
            hk, sk, want = (a.encode() for a in args[1:])
            err, value = fc.get(hk, sk)
            if err != OK or value != want:
                raise ActError(f"follower got (err={err}, {value!r}), "
                               f"wanted {want!r}")
        elif verb == "write_many":
            # write_many: <prefix> <n> — n writes fanned over hashkeys;
            # each must ack (drives schedule diversity under faults)
            prefix, n = args[0], int(args[1])
            for i in range(n):
                hk = f"{prefix}{i % max(1, n // 4)}".encode()
                err = self.client.set(hk, b"s%04d" % i,
                                      b"v%04d" % i)
                if err != OK:
                    raise ActError(f"write {i} not acked (err {err})")
        elif verb == "write_many_any":
            # like write_many but individual writes MAY fail (loss storms,
            # dead primaries); remembers which acked for expect_many
            prefix, n = args[0], int(args[1])
            acked = self.__dict__.setdefault("_acked", {})
            for i in range(n):
                hk = f"{prefix}{i % max(1, n // 4)}".encode()
                try:
                    err = self.client.set(hk, b"s%04d" % i, b"v%04d" % i)
                except PegasusError:
                    continue
                if err == OK:
                    acked[(hk, b"s%04d" % i)] = b"v%04d" % i
        elif verb == "expect_many":
            # every ACKED write from write_many/_any must read back
            prefix, n = args[0], int(args[1])
            acked = self.__dict__.get("_acked")
            if acked is None:
                acked = {}
                for i in range(n):
                    hk = f"{prefix}{i % max(1, n // 4)}".encode()
                    acked[(hk, b"s%04d" % i)] = b"v%04d" % i
            missing = []
            for (hk, sk), want in acked.items():
                err, value = self.client.get(hk, sk)
                if err != OK or value != want:
                    missing.append((hk, sk, err, value))
            if missing:
                raise ActError(
                    f"{len(missing)}/{len(acked)} acked writes lost; "
                    f"first: {missing[0]}")
        elif verb == "flush":
            # flush: <node>|all — checkpoint storage + GC the WAL on a
            # node's replicas (pushes later learns onto the LT_APP path)
            for name, stub in c.stubs.items():
                if args and args[0] != "all" and name != args[0]:
                    continue
                if name in c._dead:
                    continue
                for r in list(stub.replicas.values()):
                    r.flush_and_gc_log()
            c.loop.run_until_idle()
        elif verb == "step":
            c.step(rounds=int(args[0]) if args else 1)
        elif verb == "expect_primary_not":
            pc = c.meta.state.get_partition(self.app_id, int(args[0]))
            if pc.primary == args[1]:
                raise ActError(f"primary still {args[1]}")
            if not pc.primary:
                raise ActError("partition has NO primary")
        elif verb == "expect_members":
            pc = c.meta.state.get_partition(self.app_id, int(args[0]))
            if len(pc.members()) != int(args[1]):
                raise ActError(f"{len(pc.members())} members "
                               f"({pc.members()}), wanted {args[1]}")
        elif verb == "expect_ballot_ge":
            pc = c.meta.state.get_partition(self.app_id, int(args[0]))
            if pc.ballot < int(args[1]):
                raise ActError(f"ballot {pc.ballot} < {args[1]}")
        elif verb == "set_replica_count":
            c.meta.set_app_replica_count(
                c.meta.state.apps[self.app_id].app_name, int(args[0]))
        elif verb == "meta_level":
            c.meta.set_meta_level(args[0])
        elif verb == "expect_ddd":
            gpids = {tuple(d["gpid"]) for d in c.meta.ddd_diagnose()}
            want = (self.app_id, int(args[0]))
            if want not in gpids:
                raise ActError(f"{want} not in ddd list {gpids}")
        elif verb == "propose":
            # propose: <pidx> <action> <node> [force]
            c.meta.propose(c.meta.state.apps[self.app_id].app_name,
                           int(args[0]), args[1], args[2],
                           force="force" in args[3:])
        elif verb == "wipe_meta_state":
            # simulate total meta-state loss for the case's table (the
            # `recover` scenario: replicas become the source of truth)
            c.meta.state.apps.pop(self.app_id, None)
            c.meta.state.configs.pop(self.app_id, None)
        elif verb == "config_sync":
            for stub in c.stubs.values():
                if stub.name not in c._dead:
                    stub.config_sync()
            c.loop.run_until_idle()
        elif verb == "recover":
            res = c.meta.recover_from_reports()
            if not res["created"]:
                raise ActError(f"recover created nothing: {res}")
        elif verb == "rename":
            c.meta.rename_app(args[0], args[1])
        elif verb == "expect_hosted_count":
            # replicas of the case's table still hosted across the
            # cluster (freezed GC protection assertion)
            n = sum(1 for stub in c.stubs.values()
                    for gpid in stub.replicas if gpid[0] == self.app_id)
            if n != int(args[0]):
                raise ActError(f"hosted {n} != expected {args[0]}")
        elif verb == "expect_consistent":
            from pegasus_tpu_torch.base.key_schema import (
                generate_key,
                key_hash_parts,
            )

            hk, sk = args[0].encode(), args[1].encode()
            app = c.meta.state.apps[self.app_id]
            pidx = key_hash_parts(hk, sk) % app.partition_count
            pc = c.meta.state.get_partition(self.app_id, pidx)
            key = generate_key(hk, sk)
            seen = {}
            for node in pc.members():
                if node in c._dead:
                    continue
                r = c.stubs[node].get_replica((self.app_id, pidx))
                seen[node] = r.server.engine.get(key)
            if len({repr(v) for v in seen.values()}) > 1:
                raise ActError(f"members disagree: {seen}")
        else:
            raise ValueError(f"unknown act verb {verb!r}")
