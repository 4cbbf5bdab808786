"""Chaos harness: random process kills under continuous verification.

Parity: src/test/kill_test/ — process killers plus data_verifier.cpp's
continuous write/read consistency checking, driven as a script
(admin_tools/pegasus_kill_test.sh). Runs against the multi-process
onebox: a verifier loop writes sequenced records and re-reads a random
sample of everything previously acked; a killer loop kill -9s a random
replica node, waits, and restarts it.

Modes: kill (kill -9 + restart), pause (SIGSTOP/SIGCONT hung-node),
corrupt (seeded bit-flips inside a live replica's SST blocks — the
victim stays up; detection must come from verify-on-read / the
background scrubber, then quarantine + guardian re-learn repair the
replica while the DataVerifier invariant holds).

A restarted node reads the same cluster.json, so it serves on the
device the onebox was started with (`onebox_cluster.start(device=)`).

CLI:
    python -m pegasus_tpu_torch.tools.kill_test --dir D --duration 120
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time
from typing import Dict, List, Optional

from pegasus_tpu_torch.utils.errors import PegasusError

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


class DataVerifier:
    """Continuous write->read verification (data_verifier.cpp parity):
    every acked write must remain readable with its exact value.

    `monotonic_ledger` adds the follower-read invariant: a small set of
    REPEATEDLY-OVERWRITTEN ledger keys carries a strictly increasing
    counter, and every ledger read (issued at `read_consistency`, e.g.
    MONOTONIC so it fans out to lease-holding secondaries) must never
    observe a counter below what this session already saw for that key
    — and never NotFound after a value was observed. The write-once
    `kt` keys can't catch a time-travelling follower read; the ledger
    keys exist to."""

    LEDGER_KEYS = 8

    def __init__(self, client, rng: random.Random,
                 monotonic_ledger: bool = False,
                 read_consistency=None) -> None:
        self.client = client
        self.rng = rng
        self.acked: Dict[bytes, bytes] = {}
        self.seq = 0
        self.write_ok = 0
        self.write_rejected = 0
        self.violations: List[str] = []
        self.monotonic_ledger = monotonic_ledger
        self.read_consistency = read_consistency
        self.ledger_next: Dict[bytes, int] = {}   # next counter to write
        self.ledger_seen: Dict[bytes, int] = {}   # session read floor
        self.ledger_reads = 0

    def step(self) -> None:
        # one write
        self.seq += 1
        hk = b"kt%06d" % self.seq
        value = b"v%d" % self.seq
        try:
            if self.client.set(hk, b"s", value) == 0:
                self.acked[hk] = value
                self.write_ok += 1
            else:
                self.write_rejected += 1
        except PegasusError:
            self.write_rejected += 1
        # verify a sample of history
        if self.acked:
            for hk in self.rng.sample(sorted(self.acked),
                                      min(4, len(self.acked))):
                want = self.acked[hk]
                try:
                    err, got = self.client.get(hk, b"s")
                except PegasusError:
                    continue  # unavailable now; durability checked later
                if err == 0 and got != want:
                    self.violations.append(
                        f"{hk!r}: read {got!r}, acked {want!r}")
                elif err == 1:  # NotFound: an acked write vanished
                    self.violations.append(f"{hk!r}: acked write lost")
        if self.monotonic_ledger:
            self._ledger_step()

    @staticmethod
    def _ledger_counter(value: bytes) -> Optional[int]:
        if value[:1] == b"c" and value[1:].isdigit():
            return int(value[1:])
        return None

    def _ledger_step(self) -> None:
        # bump one ledger key. An unacked write may still have
        # committed — harmless: the floor only ratchets on READS, and
        # a committed-but-unacked counter that becomes visible simply
        # raises the floor when first observed.
        hk = b"ml%02d" % self.rng.randrange(self.LEDGER_KEYS)
        nxt = self.ledger_next.get(hk, 0) + 1
        self.ledger_next[hk] = nxt
        try:
            self.client.set(hk, b"c", b"c%08d" % nxt)
        except PegasusError:
            pass
        # read a sample back at the session's consistency level: the
        # observed counter must never regress below this session's floor
        for hk in self.rng.sample(sorted(self.ledger_next),
                                  min(2, len(self.ledger_next))):
            try:
                if self.read_consistency is not None:
                    err, got = self.client.get(
                        hk, b"c", consistency=self.read_consistency)
                else:  # plain clients lack the kwarg entirely
                    err, got = self.client.get(hk, b"c")
            except PegasusError:
                continue  # unavailable now; not a monotonicity breach
            self.ledger_reads += 1
            floor = self.ledger_seen.get(hk, 0)
            if err == 1:
                if floor:
                    self.violations.append(
                        f"ledger {hk!r}: NotFound after observing "
                        f"counter {floor} (monotonic-reads breach)")
                continue
            if err != 0:
                continue
            cur = self._ledger_counter(got)
            if cur is None:
                self.violations.append(
                    f"ledger {hk!r}: unparseable value {got!r}")
            elif cur < floor:
                self.violations.append(
                    f"ledger {hk!r}: read counter {cur} below session "
                    f"floor {floor} (monotonic-reads breach)")
            else:
                self.ledger_seen[hk] = cur

    def final_check(self, deadline_s: float = 120.0) -> None:
        """After chaos ends: EVERY acked write must read back."""
        deadline = time.monotonic() + deadline_s
        pending = dict(self.acked)
        while pending and time.monotonic() < deadline:
            for hk in list(pending):
                try:
                    err, got = self.client.get(hk, b"s")
                except PegasusError:
                    break
                if err == 0 and got == pending[hk]:
                    del pending[hk]
                elif err == 1:
                    self.violations.append(
                        f"final: {hk!r} acked write lost")
                    del pending[hk]
            if pending:
                time.sleep(1)
        for hk in pending:
            self.violations.append(f"final: {hk!r} unreadable at deadline")


def corrupt_sst_file(path: str, rng: random.Random) -> bool:
    """Flip one seeded bit inside a random DATA BLOCK of a live SST —
    the at-rest single-event-upset. The flip targets block bytes
    specifically (never the index/footer/bloom section) so detection
    exercises the per-block crc32, exactly the protection a real
    flipped sector relies on. Returns False when the file has no
    blocks to corrupt."""
    import struct  # noqa: F401 - FOOTER below is a struct.Struct

    from pegasus_tpu_torch.storage.sstable import FOOTER

    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if size < FOOTER.size + 4:
            return False
        f.seek(size - FOOTER.size)
        index_offset, index_size, _crc, _magic = FOOTER.unpack(
            f.read(FOOTER.size))
        f.seek(index_offset)
        index = json.loads(f.read(index_size))
        blocks = index.get("blocks") or []
        if not blocks:
            return False
        b = blocks[rng.randrange(len(blocks))]
        pos = b["off"] + rng.randrange(b["size"])
        f.seek(pos)
        byte = f.read(1)
        f.seek(pos)
        f.write(bytes([byte[0] ^ (1 << rng.randrange(8))]))
        f.flush()
        os.fsync(f.fileno())
    return True


class Killer:
    """Random chaos strikes against replica processes.

    mode='kill': kill -9 + cold restart (crash recovery).
    mode='pause': SIGSTOP + later SIGCONT (the hung-node shape — GC
    pause, disk stall — that must trip failure-detector lease expiry,
    and whose victim wakes up believing it still serves).
    mode='corrupt': flip seeded bits in a live replica's SST files (the
    process stays up and trusts its disk; the block-crc verify-on-read
    path or the background scrubber must detect, quarantine, and
    re-learn — `admin` forces flushes so SSTs exist to corrupt)."""

    def __init__(self, directory: str, rng: random.Random,
                 mode: str = "kill", admin=None) -> None:
        if mode not in ("kill", "pause", "corrupt"):
            raise ValueError(f"unknown chaos mode {mode!r}")
        self.directory = directory
        self.rng = rng
        self.mode = mode
        self.admin = admin
        with open(os.path.join(directory, "cluster.json")) as f:
            self.cfg = json.load(f)
        self.replica_nodes = [n for n, c in self.cfg["nodes"].items()
                              if c["role"] == "replica"]
        self.down: Optional[str] = None
        self.kills = 0

    def corrupt_one(self) -> Optional[str]:
        """Flip a bit in one SST of a random node; returns the victim
        (None when no SST was available to corrupt yet)."""
        victim = self.rng.choice(self.replica_nodes)
        if self.admin is not None:
            try:
                # memtables flush so there are on-disk blocks to flip
                self.admin.remote_command(victim, "flush", [])
            except PegasusError:
                return None  # node busy/unreachable; try next strike
        import glob

        ssts = sorted(glob.glob(os.path.join(
            self.cfg["data_root"], victim, "*", "app", "sst", "*.sst")))
        if not ssts:
            return None
        try:
            hit = corrupt_sst_file(self.rng.choice(ssts), self.rng)
        except (OSError, ValueError, KeyError):
            # the live node's compaction unlinked (or was mid-rewriting)
            # the chosen file between the glob and the open: skip this
            # strike, the next one picks from the current file set
            return None
        if hit:
            self.kills += 1
            return victim
        return None

    def kill_one(self) -> Optional[str]:
        from pegasus_tpu_torch.tools.onebox_cluster import kill_node, pause_node

        if self.mode == "corrupt":
            return self.corrupt_one()
        victim = self.rng.choice([n for n in self.replica_nodes
                                  if n != self.down])
        if self.mode == "pause":
            pause_node(victim, self.directory)
        else:
            kill_node(victim, self.directory)
        self.down = victim
        self.kills += 1
        return victim

    def restart_down(self) -> Optional[str]:
        if self.down is None:
            return None
        if self.mode == "pause":
            from pegasus_tpu_torch.tools.onebox_cluster import resume_node

            name = self.down
            resume_node(name, self.directory)
            self.down = None
            return name
        name = self.down
        env = dict(os.environ)
        env["PYTHONPATH"] = _REPO_ROOT + os.pathsep + env.get(
            "PYTHONPATH", "")
        log = open(os.path.join(self.directory, "logs",
                                f"{name}.restart.log"), "ab")
        p = subprocess.Popen(
            [sys.executable, "-m", "pegasus_tpu_torch.server.node_main",
             "--config", os.path.join(self.directory, "cluster.json"),
             "--name", name],
            stdout=log, stderr=subprocess.STDOUT, env=env,
            cwd=_REPO_ROOT)
        # track the fresh pid so stop()/later kills target the live one
        pids_path = os.path.join(self.directory, "pids.json")
        with open(pids_path) as f:
            pids = json.load(f)
        pids[name] = p.pid
        with open(pids_path, "w") as f:
            json.dump(pids, f)
        self.down = None
        return name


def run_kill_test(directory: str, duration_s: float = 60.0,
                  kill_every_s: float = 12.0, seed: int = 0,
                  table: str = "killtest", mode: str = "kill",
                  op_timeout_ms: Optional[float] = None,
                  monotonic_ledger: bool = False) -> dict:
    """`op_timeout_ms`: verifier-client end-to-end op deadline — under
    chaos every op must either succeed or raise a typed PegasusError
    within it (no hangs); None keeps the flag default.
    `monotonic_ledger`: also run the follower-read monotonic-reads
    ledger, with the ledger reads issued at MONOTONIC consistency so
    they fan out to secondaries under the read lease while nodes die."""
    from pegasus_tpu_torch.tools import onebox_cluster as ob

    rng = random.Random(seed)
    admin = ob.OneboxAdmin(directory)
    deadline = time.monotonic() + 90
    n_nodes = len([1 for c in admin.cfg["nodes"].values()
                   if c["role"] == "replica"])
    while time.monotonic() < deadline:
        try:
            if len(admin.call("list_nodes", timeout=6)) == n_nodes:
                break
        except PegasusError:
            pass  # meta still booting/electing (slow loaded machines)
        time.sleep(0.5)
    create_deadline = time.monotonic() + 60
    while True:
        try:
            admin.create_table(table, partition_count=4, replica_count=3)
            break
        except PegasusError as e:
            if "APP_EXIST" in str(e):
                break
            if time.monotonic() > create_deadline:
                raise
            time.sleep(1)
    client = ob.connect(table, directory, op_timeout_ms=op_timeout_ms)
    if monotonic_ledger:
        from pegasus_tpu_torch.client.cluster_client import MONOTONIC

        verifier = DataVerifier(client, rng, monotonic_ledger=True,
                                read_consistency=MONOTONIC)
    else:
        verifier = DataVerifier(client, rng)
    killer = Killer(directory, rng, mode=mode,
                    admin=admin if mode == "corrupt" else None)

    t_end = time.monotonic() + duration_s
    next_kill = time.monotonic() + kill_every_s
    next_restart = None
    while time.monotonic() < t_end:
        verifier.step()
        now = time.monotonic()
        if next_restart is not None and now >= next_restart:
            killer.restart_down()
            next_restart = None
        if now >= next_kill and killer.down is None:
            killer.kill_one()
            next_restart = now + kill_every_s / 2
            next_kill = now + kill_every_s
        time.sleep(0.05)
    killer.restart_down()
    verifier.final_check()
    report = {
        "mode": mode,
        "kills": killer.kills,
        "writes_acked": verifier.write_ok,
        "writes_rejected": verifier.write_rejected,
        "violations": verifier.violations,
    }
    if monotonic_ledger:
        report["ledger_reads"] = verifier.ledger_reads
    if mode == "corrupt":
        # the integrity loop's observability: every planted flip must
        # have been detected (read path or scrub), quarantined, and
        # repaired — the storage-entity counters record each stage
        quarantines = scrub_hits = 0
        for n in killer.replica_nodes:
            try:
                for ent in admin.remote_command(n, "metrics",
                                                ["storage"]):
                    m = ent.get("metrics", {})
                    quarantines += m.get("replica_quarantine_count",
                                         {}).get("value", 0)
                    scrub_hits += m.get("scrub_corrupt_blocks",
                                        {}).get("value", 0)
            except PegasusError:
                pass  # node mid-restart; counters are best-effort
        report["quarantines"] = quarantines
        report["scrub_corrupt_blocks"] = scrub_hits
    admin.close()
    return report


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True)
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--kill-every", type=float, default=12.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mode", choices=["kill", "pause", "corrupt"],
                    default="kill",
                    help="kill: kill -9 + restart (crash recovery); "
                         "pause: SIGSTOP/SIGCONT (hung-node detection); "
                         "corrupt: seeded SST bit-flips (block-crc "
                         "detection -> quarantine -> re-learn)")
    ap.add_argument("--monotonic-ledger", action="store_true",
                    help="also run the follower-read monotonic-reads "
                         "ledger (MONOTONIC-consistency reads against "
                         "secondaries under chaos)")
    args = ap.parse_args()
    report = run_kill_test(args.dir, args.duration, args.kill_every,
                           args.seed, mode=args.mode,
                           monotonic_ledger=args.monotonic_ledger)
    print(json.dumps(report, indent=1))
    sys.exit(1 if report["violations"] else 0)


if __name__ == "__main__":
    main()
