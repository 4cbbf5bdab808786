"""Background scrubber: paced verification of at-rest SSTable bytes.

Parity: the role RocksDB's `CheckConsistency` + background verification
plays under the reference (and the scrub loops of LSM-OPD/CompassDB's
integrity layers, PAPERS.md): latent disk corruption must be FOUND
before a read trips over it — a secondary serves no client reads, so
without a scrub its flipped bit survives until the replica is promoted
and starts returning garbage. The scrubber walks every hosted store's
runs re-reading raw block bytes against their index CRCs
(`SSTable.verify_block` — no decode, no block-cache pollution) plus a
structural pass (fence ordering, bloom-answers-resident-keys, and
phash-locates-resident-keys: every block's first key must map to
exactly (that block, slot 0) through the perfect-hash index — a
corrupt or stale index would turn into silent NotFound under probe
pruning) per table, a bounded number of blocks per tick so a multi-GB
store never monopolizes the dispatcher.

Compaction awareness: a scrub position is keyed to the store's
`(store_uid, generation)`; any publish (flush / compaction / ingest /
engine swap) restarts that replica's pass — the old runs are unlinked
and the new ones deserve a fresh walk. A tick also skips replicas whose
engine is mid-compaction (`compact_lock` held): the merge is already
re-reading and re-writing every block, and disk bandwidth is better
spent on it.

A corrupt block raises the owner's quarantine callback (the stub wires
`on_corruption` to its detect → quarantine → re-learn loop) and ticks
`scrub_corrupt_blocks` on the node storage entity.

The port's copy of the JAX package's storage/scrub.py, its imports rewritten to
pegasus_tpu_torch (it imports nothing of that package).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

from pegasus_tpu_torch.utils.errors import StorageCorruptionError
from pegasus_tpu_torch.utils.metrics import METRICS

Gpid = Tuple[int, int]

_SCRUB_CORRUPT = METRICS.entity("storage", "node").counter(
    "scrub_corrupt_blocks")
# one tick per mid-pass restart caused by a publish (flush / compaction
# / ingest changed the run set under the cursor): under PIPELINED
# compaction a single logical compaction bumps the generation more than
# once (freeze-flush, then the publish cut-over), and the restart logic
# must collapse that into ONE restart per publish observation — this
# counter is how the test proves it does
_SCRUB_RESTART = METRICS.entity("storage", "node").counter(
    "scrub_restart_count")


class ReplicaScrubber:
    """One per node; walks the node's replicas round-robin.

    `replicas()` returns the live {gpid -> replica} map each tick (the
    set changes under cures/splits); `on_corruption(gpid, exc)` is the
    quarantine hook. `blocks_per_tick` bounds one tick's IO."""

    def __init__(self, replicas: Callable[[], Dict[Gpid, object]],
                 on_corruption: Callable[[Gpid, Exception], None],
                 blocks_per_tick: int = 256,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self._replicas = replicas
        self._on_corruption = on_corruption
        self.blocks_per_tick = blocks_per_tick
        # minimum quiet time between full passes of one replica: a
        # small store must not be re-walked every tick (disk bandwidth
        # belongs to serving); manual `scrub_now` bypasses this
        self.pass_interval = 10.0
        # how long a departed replica's last result stays reportable
        # before it ages out of the status map
        self.result_ttl = 600.0
        self._clock = clock or time.time
        # gpid -> {store, gen, table_i, block_i, scanned, started}
        self._cursor: Dict[Gpid, dict] = {}
        # rotating start position so one big store's pass cannot starve
        # its neighbors of tick budget forever
        self._rr = 0
        # gpid -> last completed pass result (the shell's `scrub`
        # progress/last-result surface)
        self.results: Dict[Gpid, dict] = {}

    # ---- one paced tick ------------------------------------------------

    def tick(self) -> None:
        reps = self._replicas()
        if not reps:
            return
        budget = self.blocks_per_tick
        order = sorted(reps)
        self._rr = (self._rr + 1) % len(order)
        for gpid in order[self._rr:] + order[:self._rr]:
            if budget <= 0:
                return
            r = reps.get(gpid)
            if r is None:
                continue  # quarantined earlier in this very tick
            budget -= self._advance(gpid, r, budget)
        # drop cursors of replicas no longer hosted; their last results
        # stay visible for a grace window (the shell's `scrub --status`
        # should still show WHY a quarantined replica left) and then
        # age out so a long-lived node's churn cannot grow the map
        # without bound
        now = self._clock()
        for gpid in list(self._cursor):
            if gpid not in reps:
                del self._cursor[gpid]
        for gpid, last in list(self.results.items()):
            if gpid not in reps and \
                    now - last.get("finished", now) > self.result_ttl:
                del self.results[gpid]

    def scrub_now(self, gpid: Gpid, replica) -> dict:
        """One full pass, synchronously (the shell trigger + tests);
        returns the pass result. Detection still routes through the
        quarantine callback."""
        self._cursor.pop(gpid, None)
        while self._advance(gpid, replica, 1_000_000_000,
                            force=True) > 0:
            if gpid not in self._cursor:
                break
        return self.results.get(gpid, {"state": "idle"})

    # ---- internals -----------------------------------------------------

    def _tables_of(self, replica) -> list:
        lsm = replica.server.engine.lsm
        return list(lsm.l0) + list(lsm.l1_runs)

    def _advance(self, gpid: Gpid, replica, budget: int,
                 force: bool = False) -> int:
        """Scrub up to `budget` blocks of one replica; returns blocks
        actually verified."""
        engine = replica.server.engine
        lsm = engine.lsm
        if engine.compact_lock.locked():
            return 0  # the merge owns the disk right now
        cur = self._cursor.get(gpid)
        if cur is None and not force:
            last = self.results.get(gpid)
            if (last is not None and "finished" in last
                    and self._clock() - last["finished"]
                    < self.pass_interval):
                return 0  # pass-interval pacing: recently walked
        if cur is not None and (cur["store"] != lsm.store_uid
                                or cur["gen"] != lsm.generation):
            # the run set changed mid-pass: restart — the old cursor
            # points into unlinked files. ONE restart per observed
            # publish, however many generation bumps the publish's
            # pipeline stages produced while the scrubber was parked
            # on the compact_lock skip (freeze-flush + cut-over is
            # still one logical publish)
            _SCRUB_RESTART.increment()
            cur = None
        if cur is None:
            cur = {"store": lsm.store_uid, "gen": lsm.generation,
                   "table_i": 0, "block_i": 0, "scanned": 0,
                   "started": self._clock(), "structural_done": False}
            self._cursor[gpid] = cur
        tables = self._tables_of(replica)
        done = 0
        try:
            while done < budget:
                if engine.compact_lock.locked():
                    # a compaction started under us: PAUSE, keep the
                    # cursor — if its publish changes the generation
                    # the entry check above restarts exactly once;
                    # if it aborts, the pass resumes where it stopped
                    return done
                if lsm.generation != cur["gen"]:
                    # a publish landed between blocks: stop here with
                    # the stale cursor in place — the next tick's
                    # entry check restarts (and counts) it exactly
                    # once, the same path as a publish observed
                    # between ticks
                    return done
                if cur["table_i"] >= len(tables):
                    # pass complete
                    self.results[gpid] = {
                        "state": "clean",
                        "blocks_scanned": cur["scanned"],
                        "tables": len(tables),
                        "started": cur["started"],
                        "finished": self._clock(),
                    }
                    del self._cursor[gpid]
                    return done
                table = tables[cur["table_i"]]
                if not cur["structural_done"]:
                    table.verify_index_consistency()
                    cur["structural_done"] = True
                if cur["block_i"] >= len(table.blocks):
                    cur["table_i"] += 1
                    cur["block_i"] = 0
                    cur["structural_done"] = False
                    continue
                table.verify_block(cur["block_i"])
                cur["block_i"] += 1
                cur["scanned"] += 1
                done += 1
        except StorageCorruptionError as e:
            _SCRUB_CORRUPT.increment()
            self.results[gpid] = {
                "state": "corrupt",
                "detail": str(e),
                "blocks_scanned": cur["scanned"],
                "started": cur["started"],
                "finished": self._clock(),
            }
            self._cursor.pop(gpid, None)
            self._on_corruption(gpid, e)
            return done + 1
        return done

    def status(self, app_id: Optional[int] = None) -> list:
        """Progress + last result per hosted partition (shell `scrub`)."""
        out = []
        gpids = set(self._cursor) | set(self.results)
        for gpid in sorted(gpids):
            if app_id is not None and gpid[0] != app_id:
                continue
            entry = {"gpid": list(gpid)}
            cur = self._cursor.get(gpid)
            if cur is not None:
                entry["in_progress"] = {
                    "table_i": cur["table_i"], "block_i": cur["block_i"],
                    "blocks_scanned": cur["scanned"],
                    "started": cur["started"],
                }
            last = self.results.get(gpid)
            if last is not None:
                entry["last_result"] = dict(last)
            out.append(entry)
        return out
