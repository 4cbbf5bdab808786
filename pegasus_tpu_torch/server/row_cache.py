"""Node-level hot-row cache — hot hashkeys served without the LSM.

The port's copy of pegasus_tpu/server/row_cache.py. Role parity:
RocksDB's row cache in front of the table stack; one byte-capped LRU is
shared by every partition a node hosts, so a handful of viral hashkeys
cannot each pin a partition-private cache.

Keying and correctness:

- Entries are keyed `(gid, store_uid, generation, key)` — the store
  identity token plus its run-set generation. A flush, compaction
  publish, ingest, or wholesale engine swap (restore / learner
  swap) changes the generation or the store uid, so every prior
  entry silently stops matching; `invalidate_gid` additionally drops
  the bytes eagerly on publish/swap so dead entries don't occupy the
  cap.
- Writes invalidate WRITE-THROUGH: the engine's mutation apply hook
  removes the touched keys and bumps the gid's invalidation epoch
  BEFORE the write is acknowledged, so a later read can never hit a
  value the writer already replaced.
- The populate race (read resolves an old value from the LSM, a write
  lands, then the read admits the old value) is closed by the epoch:
  admission passes the epoch observed BEFORE the LSM lookup and the
  cache refuses the entry if any invalidation touched the gid since.

Admission is gated by repeat traffic: a key must miss twice (bounded
touch table) before its bytes are admitted — one-shot scans must not
flush the working set — and the partition HotkeyCollector's published
result is a fast-admit: a detected-hot hashkey caches on first touch.

Knob: `[pegasus.server] row_cache_bytes` (mutable; 0 disables). Hits,
misses and evicted bytes are counted on the node's ("storage", "node")
metric entity, and per partition (PartitionServer.point_stats).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Tuple

from pegasus_tpu_torch.utils.flags import FLAGS, define_flag
from pegasus_tpu_torch.utils.metrics import METRICS

define_flag("pegasus.server", "row_cache_bytes", 33_554_432,
            "node-level hot-row cache capacity in bytes (0 = disabled)",
            mutable=True)

# per-entry bookkeeping overhead charged against the byte cap (tuple +
# dict slot + key copies), so a million tiny rows cannot blow past the
# configured budget on Python object overhead alone
_ENTRY_OVERHEAD = 120

_TOUCH_CAP = 8192


class RowCache:
    """Byte-capped LRU of (full encoded value, expire_ts) rows."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, Tuple[bytes, int, int]]" = \
            OrderedDict()
        self._bytes = 0
        self._epochs: dict = {}       # gid -> invalidation epoch
        # node-wide epoch component: bumped by disable-time clears and
        # by writes that arrive while the cache is disabled (the
        # lock-free fast path below). A gid that was never invalidated
        # has implicit per-gid epoch 0 — without this term, a write
        # landing in a disabled window would leave that gid's epoch
        # unchanged and a plan spanning the off/on flag toggle could
        # admit the pre-write value. epoch() sums both terms: both only
        # grow, so any invalidation event changes the sum.
        self._flush_epoch = 0
        # gid -> {entry keys}: publishes drop one partition wholesale,
        # and a node-shared cache must not scan every other partition's
        # entries under the global lock to do it
        self._gid_index: dict = {}
        self._touch: "OrderedDict[tuple, int]" = OrderedDict()
        ent = METRICS.entity("storage", "node")
        self._hit = ent.relaxed_counter("row_cache_hit")
        self._miss = ent.relaxed_counter("row_cache_miss")
        self._evicted = ent.relaxed_counter("row_cache_evict_bytes")

    @property
    def capacity(self) -> int:
        return int(FLAGS.get("pegasus.server", "row_cache_bytes"))

    @property
    def enabled(self) -> bool:
        cap = self.capacity
        if cap <= 0:
            if self._entries or self._touch:
                # the mutable knob was turned off with rows resident:
                # free them now (eviction otherwise only runs inside
                # admit, which a disabled cache never reaches) and bump
                # the node epoch so an in-flight admission that
                # observed the enabled cache can never land later
                with self._lock:
                    evicted = self._bytes
                    self._entries.clear()
                    self._gid_index.clear()
                    self._touch.clear()
                    self._bytes = 0
                    self._flush_epoch += 1
                if evicted:
                    self._evicted.increment(evicted)
            return False
        return True

    def epoch(self, gid) -> int:
        return self._epochs.get(gid, 0) + self._flush_epoch

    # ---- serve --------------------------------------------------------

    def get_many(self, gid, store_uid: int, generation: int, keys
                 ) -> dict:
        """{key -> (value, expire_ts)} for the hits; a hit refreshes
        LRU recency. ONE lock round serves a whole flush — the plan
        loop must not pay a node-global lock acquisition per key. TTL
        semantics stay the caller's job (identical to the engine
        contract), so a cached row expires exactly like an LSM row."""
        out: dict = {}
        entries = self._entries
        with self._lock:
            for key in keys:
                k = (gid, store_uid, generation, key)
                ent = entries.get(k)
                if ent is not None:
                    entries.move_to_end(k)
                    out[key] = (ent[0], ent[1])
        hits = len(out)
        if hits:
            self._hit.increment(hits)
        misses = len(keys) - hits
        if misses:
            self._miss.increment(misses)
        return out

    def get(self, gid, store_uid: int, generation: int, key: bytes
            ) -> Optional[Tuple[bytes, int]]:
        return self.get_many(gid, store_uid, generation, [key]).get(key)

    # ---- admit --------------------------------------------------------

    def note_and_check_many(self, gid, keys, fast=()) -> list:
        """Count one base-resolved miss per key; return the keys that
        have earned admission (second touch, or membership in `fast` —
        the hotkey fast-admit set). One lock round per flush."""
        if not self.enabled:
            return []
        granted = []
        touch = self._touch
        with self._lock:
            for key in keys:
                if key in fast:
                    granted.append(key)
                    continue
                t = (gid, key)
                c = touch.get(t, 0) + 1
                touch[t] = c
                touch.move_to_end(t)
                if c >= 2:
                    granted.append(key)
            while len(touch) > _TOUCH_CAP:
                touch.popitem(last=False)
        return granted

    def note_and_check(self, gid, key: bytes, fast: bool = False) -> bool:
        return bool(self.note_and_check_many(
            gid, [key], fast={key} if fast else ()))

    def admit_many(self, gid, store_uid: int, generation: int, items,
                   epoch: Optional[int] = None) -> None:
        """Insert [(key, full encoded value, expire_ts)] rows, evicting
        LRU past the byte cap — one lock round per flush. `epoch` is
        the invalidation epoch observed BEFORE the LSM reads that
        produced these rows: a mismatch means a write/publish raced the
        plan, and caching would preserve the overwritten value."""
        cap = self.capacity
        if cap <= 0:
            return
        evicted = 0
        with self._lock:
            if epoch is not None and self._epochs.get(gid, 0) \
                    + self._flush_epoch != epoch:
                return  # a write/publish raced this read: don't cache
            for key, value, expire_ts in items:
                nbytes = len(key) + len(value) + _ENTRY_OVERHEAD
                if nbytes > cap:
                    continue
                k = (gid, store_uid, generation, key)
                old = self._entries.pop(k, None)
                if old is not None:
                    self._bytes -= old[2]
                self._entries[k] = (value, expire_ts, nbytes)
                self._gid_index.setdefault(gid, set()).add(k)
                self._bytes += nbytes
            while self._bytes > cap and self._entries:
                ek, (_v, _e, nb) = self._entries.popitem(last=False)
                idx = self._gid_index.get(ek[0])
                if idx is not None:
                    idx.discard(ek)
                self._bytes -= nb
                evicted += nb
        if evicted:
            self._evicted.increment(evicted)

    def admit(self, gid, store_uid: int, generation: int, key: bytes,
              value: bytes, expire_ts: int,
              epoch: Optional[int] = None) -> None:
        self.admit_many(gid, store_uid, generation,
                        [(key, value, expire_ts)], epoch=epoch)

    # ---- invalidate ---------------------------------------------------

    def invalidate(self, gid, store_uid: int, generation: int,
                   keys) -> None:
        """Write-through invalidation from the mutation apply path:
        drop the touched keys and bump the gid epoch (which also voids
        any in-flight admission that read before this write)."""
        if not self._entries and self.capacity <= 0:
            # disabled and empty: no rows to drop and none can be
            # admitted while capacity <= 0 — but a plan that observed
            # the ENABLED cache may still be in flight across the flag
            # toggle, so this write must still void its admission: the
            # node-epoch bump below is lock-free (a lost increment
            # under a concurrent bump still leaves the sum changed,
            # which is all the admission check needs)
            self._flush_epoch += 1
            return
        with self._lock:
            self._epochs[gid] = self._epochs.get(gid, 0) + 1
            entries = self._entries
            idx = self._gid_index.get(gid)
            for key in keys:
                k = (gid, store_uid, generation, key)
                ent = entries.pop(k, None)
                if ent is not None:
                    self._bytes -= ent[2]
                    if idx is not None:
                        idx.discard(k)
                self._touch.pop((gid, key), None)

    def invalidate_gid(self, gid) -> None:
        """Wholesale drop for one partition: store publish (compaction
        / flush visible-set swap) and engine swaps. O(entries of THIS
        gid) via the per-gid index — a publish must not scan every
        other partition's rows under the node-shared lock (the touch
        table scan stays: it is bounded at _TOUCH_CAP)."""
        with self._lock:
            self._epochs[gid] = self._epochs.get(gid, 0) + 1
            dead = self._gid_index.pop(gid, None)
            if dead:
                for k in dead:
                    ent = self._entries.pop(k, None)
                    if ent is not None:
                        self._bytes -= ent[2]
            for t in [t for t in self._touch if t[0] == gid]:
                del self._touch[t]

    # ---- observability ------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            per_gid: dict = {}
            for (gid, _su, _gen, _key), (_v, _e, nb) in \
                    self._entries.items():
                g = per_gid.setdefault(str(gid), {"entries": 0, "bytes": 0})
                g["entries"] += 1
                g["bytes"] += nb
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "capacity": self.capacity, "per_gid": per_gid}



# the node-level shared instance (parity: one rocksdb row cache object
# shared across column families / replicas on a server)
ROW_CACHE = RowCache()
