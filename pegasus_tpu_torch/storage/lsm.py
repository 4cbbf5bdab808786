"""LSMStore: memtable + L0 runs + ranged L1 runs, flush, merge, compaction.

Role parity: the RocksDB instance behind one replica
(src/server/pegasus_server_impl.cpp:1551; manual compaction drives
CompactRange, src/server/pegasus_manual_compact_service.h:48).

Flushes produce L0 SSTs (overlapping, newest wins). L1 is a sequence of
non-overlapping, size-capped runs ordered by key. Compaction merges the
overlay and L1 in one pass through a filter seam that drops tombstones,
expired records and stale post-split keys — the bottommost-level
semantics of src/server/key_ttl_compaction_filter.h:55,91. The filter of
one batch runs on the device while the host gathers the next.

Durability: a manifest (temp+rename) names the live L1 runs; boot
removes obsolete compaction inputs/outputs from crash windows. The
directory layout is the JAX package's, so either package opens a store
the other wrote.

Every writer (flush, merge compaction) stamps the current
`[pegasus.storage] block_codec` and builds the bloom and perfect-hash
sidecars its flags ask for (storage/sstable.py); a point get consults
them, hashing the key once.

Scan merge order: memtable > newest L0 > ... > oldest L0 > L1 runs.
"""

from __future__ import annotations

import heapq
import itertools
import json
import os
import tempfile
from typing import Callable, Iterator, List, Optional, Tuple

from pegasus_tpu_torch.base.crc import crc64
from pegasus_tpu_torch.base.value_schema import update_expire_ts
from pegasus_tpu_torch.storage.bloom import bloom_probe_enabled
from pegasus_tpu_torch.storage.memtable import Memtable, TOMBSTONE
from pegasus_tpu_torch.storage.phash import phash_probe_enabled
from pegasus_tpu_torch.storage.sstable import (
    BLOCK_CAPACITY,
    SSTable,
    SSTableWriter,
)

# (key, value|None, expire_ts) record triple
Record = Tuple[bytes, Optional[bytes], int]

# records per L1 output run before the compactor starts a new one
L1_RUN_CAPACITY = 262_144

# process-wide store identities: the node row cache keys rows by
# (gid, store uid, generation), so a reopened store never serves rows
# cached from an earlier instance at the same generation number
_STORE_UIDS = itertools.count(1)


class LSMStore:
    def __init__(self, data_dir: str,
                 block_capacity: int = BLOCK_CAPACITY) -> None:
        self.data_dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        self._block_capacity = block_capacity
        self.memtable = Memtable()
        self.l0: List[SSTable] = []   # newest first
        self.l1_runs: List[SSTable] = []  # key-ordered, non-overlapping
        self._file_seq = 0
        # bumped whenever the visible run set changes (flush, compaction
        # publish): the scan plan cache is keyed on it, so plans
        # invalidate exactly when the block set does
        self.generation = 0
        self.store_uid = next(_STORE_UIDS)
        # last manual-compaction finish time (pegasus-epoch seconds),
        # persisted in the manifest independently of the run set
        self.compact_finish_time = 0
        # publish hook: called with the live L1 path set after every
        # compaction publish, so cache owners evict entries of dead runs
        self.on_publish: Optional[Callable[[set], None]] = None
        self._load_existing()

    # ---- files --------------------------------------------------------

    def _manifest_path(self) -> str:
        return os.path.join(self.data_dir, "MANIFEST.json")

    def _write_manifest(self, l1_names: List[str]) -> None:
        """Atomically record the live L1 run set + the seq horizon. Any
        l1-* file not listed, and any l0-* file older than the horizon,
        is a crash leftover boot removes."""
        fd, tmp = tempfile.mkstemp(dir=self.data_dir)
        with os.fdopen(fd, "w") as f:
            json.dump({"seq": self._file_seq, "l1": l1_names,
                       "mcft": self.compact_finish_time}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._manifest_path())

    def _load_existing(self) -> None:
        manifest = None
        if os.path.exists(self._manifest_path()):
            with open(self._manifest_path()) as f:
                manifest = json.load(f)
            self._file_seq = max(self._file_seq, manifest["seq"])
            self.compact_finish_time = manifest.get("mcft", 0)
        l0_files = []
        l1_files = []
        for name in os.listdir(self.data_dir):
            if name.endswith(".sst"):
                seq = int(name.split("-")[1].split(".")[0])
                self._file_seq = max(self._file_seq, seq + 1)
                if name.startswith("l0-"):
                    l0_files.append((seq, name))
                elif name.startswith("l1-"):
                    l1_files.append((seq, name))
            elif name.endswith(".sst.tmp"):
                os.remove(os.path.join(self.data_dir, name))
        if manifest is None:
            # pre-manifest layout: newest l1 file wins, older files are
            # obsolete compaction inputs
            l1_live = [max(l1_files)[1]] if l1_files else []
            horizon = max(l1_files)[0] if l1_files else -1
        else:
            l1_live = [n for n in manifest["l1"]
                       if os.path.exists(os.path.join(self.data_dir, n))]
            horizon = manifest["seq"]
        for _seq, name in l1_files:
            if name not in l1_live:
                os.remove(os.path.join(self.data_dir, name))
        for seq, name in sorted(l0_files, reverse=True):
            if seq < horizon:  # a consumed compaction input
                os.remove(os.path.join(self.data_dir, name))
            else:
                self.l0.append(SSTable(os.path.join(self.data_dir, name)))
        runs = [SSTable(os.path.join(self.data_dir, name))
                for name in l1_live]
        runs.sort(key=lambda t: t.first_key or b"")
        self.l1_runs = runs

    def _next_path(self, level: str) -> str:
        path = os.path.join(self.data_dir, f"{level}-{self._file_seq}.sst")
        self._file_seq += 1
        return path

    def close(self) -> None:
        for t in self.l0 + self.l1_runs:
            t.close()

    # ---- writes -------------------------------------------------------

    def put(self, key: bytes, value: bytes, expire_ts: int = 0) -> None:
        self.memtable.put(key, value, expire_ts)

    def delete(self, key: bytes) -> None:
        self.memtable.delete(key)

    def flush(self, meta: Optional[dict] = None) -> Optional[SSTable]:
        """Memtable -> new L0 SST carrying `meta` (decree watermark etc.)."""
        if len(self.memtable) == 0:
            return None
        writer = SSTableWriter(self._next_path("l0"),
                               block_capacity=self._block_capacity, meta=meta)
        for key, value, ets in self.memtable.items_sorted():
            if value is TOMBSTONE:
                writer.add(key, b"", 0, tombstone=True)
            else:
                writer.add(key, value, ets)
        writer.finish()
        table = SSTable(writer.path)
        self.l0.insert(0, table)
        self.memtable = Memtable()
        self.generation += 1
        return table

    # ---- reads --------------------------------------------------------

    def get(self, key: bytes) -> Optional[Tuple[bytes, int]]:
        """Visible (value, expire_ts) or None. TTL filtering is the
        caller's job (the reference checks expiry in the handlers).

        L0 tables short-circuit on their first/last-key fences, then on
        their sidecars: the key is hashed once (the crc64 every sidecar
        shares) when a candidate table carries a bloom or a perfect-hash
        index. An indexed table answers through its perfect hash alone
        (a miss touches no block); each kill switch disables only its
        own structure."""
        hit = self.memtable.get(key)
        if hit is not None:
            value, ets = hit
            return None if value is TOMBSTONE else (value, ets)
        bloom_on = bloom_probe_enabled()
        phash_on = phash_probe_enabled()
        key_hash: Optional[int] = None  # computed at most once

        def lookup(table):
            nonlocal key_hash
            use_phash = phash_on and table.phash is not None
            use_bloom = bloom_on and not use_phash \
                and table.bloom is not None
            if (use_phash or use_bloom) and key_hash is None:
                key_hash = crc64(key)
            if use_bloom and not table.may_contain(key, key_hash):
                return None  # definitively absent from this table
            return table.get(key, key_hash=key_hash
                             if use_phash else None)

        for table in self.l0:
            fk = table.first_key
            if fk is None or key < fk or key > table.last_key:
                continue
            hit = lookup(table)
            if hit is not None:
                value, ets = hit
                return None if value is None else (value, ets)
        run = self._run_for(key)
        if run is not None:
            hit = lookup(run)
            if hit is not None:
                value, ets = hit
                return None if value is None else (value, ets)
        return None

    def _run_for(self, key: bytes) -> Optional[SSTable]:
        """The (single) L1 run whose range may hold `key`."""
        runs = self.l1_runs
        lo, hi = 0, len(runs)
        while lo < hi:
            mid = (lo + hi) // 2
            if (runs[mid].last_key or b"") < key:
                lo = mid + 1
            else:
                hi = mid
        if lo < len(runs) and ((runs[lo].first_key or b"") <= key):
            return runs[lo]
        return None

    def iterate(self, start: bytes = b"", stop: Optional[bytes] = None,
                reverse: bool = False) -> Iterator[Record]:
        """Merged visible records (tombstones resolved, TTL not applied)."""
        sources: List[Iterator[Record]] = [
            self.memtable.iterate(start, stop, reverse)]
        for table in self.l0:
            sources.append(table.iterate(start, stop, reverse))
        if self.l1_runs:
            runs = (self.l1_runs if not reverse
                    else list(reversed(self.l1_runs)))
            sources.append(_chain_runs(runs, start, stop, reverse))
        return _merge(sources, reverse)

    def sorted_runs(self) -> Optional[List[SSTable]]:
        """The ordered L1 runs when the store is fully compacted and there
        is no overlay — the columnar scan path's qualifier."""
        if len(self.memtable) == 0 and not self.l0 and self.l1_runs:
            return self.l1_runs
        return None

    # ---- compaction ---------------------------------------------------

    def compact(self, record_filter=None, meta: Optional[dict] = None,
                patch_headers: bool = False) -> None:
        """Full merge compaction of memtable + L0 + L1 into new L1 runs of
        at most L1_RUN_CAPACITY records; the caller excludes writers.

        `record_filter(keys: List[bytes], expire_ts: List[int]) ->
        (drop, new_expire)` returns two tensors, possibly still being
        computed on the device: each batch's result is moved to the host
        with one `.cpu()` only after the next batch has been gathered and
        submitted. Tombstones always drop (bottommost)."""
        new_runs: List[SSTable] = []
        writer: Optional[SSTableWriter] = None
        written_in_run = 0

        def write_records(keys, vals, ets_orig, drop, new_ets) -> None:
            nonlocal writer, written_in_run
            for i, k in enumerate(keys):
                if drop is not None and drop[i]:
                    continue
                if writer is None:
                    writer = SSTableWriter(
                        self._next_path("l1"),
                        block_capacity=self._block_capacity, meta=meta)
                ne = int(new_ets[i])
                v = vals[i]
                if patch_headers and ne != ets_orig[i]:
                    # a TTL rewrite must reach the encoded value header
                    v = update_expire_ts(1, v, ne)
                writer.add(k, v, ne)
                written_in_run += 1
                if written_in_run >= L1_RUN_CAPACITY:
                    writer.finish()
                    new_runs.append(SSTable(writer.path))
                    writer = None
                    written_in_run = 0

        def submit(keys, vals, ets):
            if record_filter is None:
                return (keys, vals, ets, None, ets)
            drop, new_ets = record_filter(keys, ets)
            return (keys, vals, ets, drop, new_ets)

        def drain(entry) -> None:
            keys, vals, ets_orig, drop, new_ets = entry
            if drop is not None:
                drop = drop.cpu().numpy()
                new_ets = new_ets.cpu().numpy()
            write_records(keys, vals, ets_orig, drop, new_ets)

        pending = None
        batch: Tuple[list, list, list] = ([], [], [])
        # the filter batch spans 16 write blocks: one device evaluation
        # per 16k records
        filter_batch = self._block_capacity * 16
        ok = False
        try:
            for key, value, ets in self.iterate():
                batch[0].append(key)
                batch[1].append(value)
                batch[2].append(ets)
                if len(batch[0]) >= filter_batch:
                    entry = submit(*batch)
                    if pending is not None:
                        drain(pending)
                    pending = entry
                    batch = ([], [], [])
            if batch[0]:
                entry = submit(*batch)
                if pending is not None:
                    drain(pending)
                pending = entry
            if pending is not None:
                drain(pending)
            if writer is not None:
                writer.finish()
                new_runs.append(SSTable(writer.path))
                writer = None
            ok = True
        finally:
            if not ok:
                if writer is not None:
                    writer.abandon()
                for t in new_runs:
                    t.close()
                    os.remove(t.path)
        self._publish_l1(new_runs, mcft=(meta or {}).get(
            "manual_compact_finish_time", 0))

    def _publish_l1(self, new_runs: List[SSTable], mcft: int = 0) -> None:
        """Swap in a freshly-compacted L1: manifest first (atomic), then
        remove the inputs — boot cleans up either crash window. The
        overlay the merge consumed resets."""
        if mcft:
            self.compact_finish_time = mcft
        self._write_manifest([os.path.basename(t.path) for t in new_runs])
        superseded = self.l0 + self.l1_runs
        self.l1_runs = new_runs
        self.generation += 1
        self.l0 = []
        self.memtable = Memtable()
        for t in superseded:
            t.close()
            os.remove(t.path)
        if self.on_publish is not None:
            self.on_publish({t.path for t in new_runs})


class _HeapEntry:
    """Heap ordering: key asc (or desc when reverse), then source index asc —
    so for equal keys the newest source (lowest index) pops first."""

    __slots__ = ("key", "src_idx", "record", "it", "reverse")

    def __init__(self, key, src_idx, record, it, reverse):
        self.key = key
        self.src_idx = src_idx
        self.record = record
        self.it = it
        self.reverse = reverse

    def __lt__(self, other: "_HeapEntry") -> bool:
        if self.key != other.key:
            return self.key > other.key if self.reverse else self.key < other.key
        return self.src_idx < other.src_idx


def _merge(sources: List[Iterator[Record]], reverse: bool = False
           ) -> Iterator[Record]:
    """K-way merge; on duplicate keys the lowest source index (newest) wins;
    shadowed duplicates are skipped and tombstone winners are dropped."""
    heap: List[_HeapEntry] = []
    for src_idx, it in enumerate(sources):
        first = next(it, None)
        if first is not None:
            heap.append(_HeapEntry(first[0], src_idx, first, it, reverse))
    heapq.heapify(heap)
    prev_key: Optional[bytes] = None
    while heap:
        entry = heapq.heappop(heap)
        key, value, ets = entry.record
        if key != prev_key:
            prev_key = key
            if value is not None:  # tombstone winners are invisible
                yield key, value, ets
        nxt = next(entry.it, None)
        if nxt is not None:
            heapq.heappush(heap,
                           _HeapEntry(nxt[0], entry.src_idx, nxt, entry.it,
                                      reverse))


def _chain_runs(runs: List[SSTable], start: bytes, stop: Optional[bytes],
                reverse: bool) -> Iterator[Record]:
    """Iterate non-overlapping key-ordered runs as one ordered stream,
    skipping runs outside [start, stop)."""
    for run in runs:
        first = run.first_key or b""
        last = run.last_key or b""
        if stop is not None and first >= stop:
            continue
        if start and last < start:
            continue
        yield from run.iterate(start, stop, reverse)
