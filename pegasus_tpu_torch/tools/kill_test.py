"""The kill test's data verifier and its SST corrupter.

Parity: src/test/kill_test/ data_verifier.cpp (reference module:
`pegasus_tpu/tools/kill_test.py`, `DataVerifier` at :36 and
`corrupt_sst_file` at :170): continuous write/read consistency checking
against any client with `set` / `get`, and the seeded bit-flip inside a
live SST's data blocks. The reference's `Killer`, `run_kill_test` and
`main` drive onebox processes (`tools/onebox_cluster`), which are slice
6(c) of the port, and wait for it.
"""

from __future__ import annotations

import json
import os
import random
import time
from typing import Dict, List, Optional

from pegasus_tpu_torch.utils.errors import PegasusError


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
