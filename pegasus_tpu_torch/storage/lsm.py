"""LSMStore: memtable + L0 runs + ranged L1 runs, flush, merge, compaction.

Role parity: the RocksDB instance behind one replica
(src/server/pegasus_server_impl.cpp:1551; manual compaction drives
CompactRange, src/server/pegasus_manual_compact_service.h:48).

Flushes produce L0 SSTs (overlapping, newest wins). L1 is a sequence of
non-overlapping, size-capped runs ordered by key. Compaction merges the
overlay and L1 in one pass through a filter seam that drops tombstones,
expired records and stale post-split keys and applies user-specified
rules — the bottommost-level semantics of
src/server/key_ttl_compaction_filter.h:55,91. The filter of one batch
runs on the device while the host gathers the next. A pure-L1 store
compacts block-wise instead (`bulk_compact_*`): whole blocks are
filtered and rewritten with vectorized gathers, untouched compressed
blocks copied verbatim. Either shape can run over an immutable snapshot
with writes flowing (`publish_lock`), taking the lock only to publish.

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

import numpy as np

from pegasus_tpu_torch.base.crc import crc64
from pegasus_tpu_torch.base.value_schema import update_expire_ts
from pegasus_tpu_torch.storage.block_codec import (
    CODEC_NONE,
    EncodedBlock,
    codec_accepts,
)
from pegasus_tpu_torch.storage.bloom import (
    bloom_build_bits,
    bloom_probe_enabled,
)
from pegasus_tpu_torch.storage.compact_governor import GOVERNOR
from pegasus_tpu_torch.storage.memtable import Memtable, TOMBSTONE
from pegasus_tpu_torch.storage.phash import (
    phash_build_enabled,
    phash_probe_enabled,
)
from pegasus_tpu_torch.storage.sstable import (
    BLOCK_CAPACITY,
    SSTable,
    SSTableWriter,
    block_codec,
)
from pegasus_tpu_torch.utils.perf_context import current as _perf_current

# (key, value|None, expire_ts) record triple
Record = Tuple[bytes, Optional[bytes], int]

# records per L1 output run before the compactor starts a new one
L1_RUN_CAPACITY = 262_144

# process-wide store identities: the node row cache keys rows by
# (gid, store uid, generation), so a reopened store never serves rows
# cached from an earlier instance at the same generation number
_STORE_UIDS = itertools.count(1)


def survivor_mask(drop: np.ndarray, flags) -> np.ndarray:
    """Rows a compaction keeps: the filter's drop mask plus the tombstone
    flags — the one survivor definition of the block rewrite."""
    keep = ~np.asarray(drop, bool)
    if flags is not None:
        keep &= np.asarray(flags) == 0  # tombstones never stay
    return keep


class LSMStore:
    def __init__(self, data_dir: str, block_capacity: int = BLOCK_CAPACITY,
                 l0_compaction_trigger: int = 4,
                 l1_run_capacity: int = L1_RUN_CAPACITY) -> None:
        self.data_dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        self._block_capacity = block_capacity
        # L0 tables that trigger an auto-compaction
        self._l0_trigger = l0_compaction_trigger
        # records per L1 output run
        self._l1_run_capacity = l1_run_capacity
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

    def ingest(self, build_sst, meta: Optional[dict] = None) -> SSTable:
        """Adopt an externally built run as the newest L0 SST.
        `build_sst(dest_path, meta)` writes the file; the naming and
        newest-first invariants stay inside the store."""
        dest = self._next_path("l0")
        build_sst(dest, meta)
        table = SSTable(dest)
        self.l0.insert(0, table)
        self.generation += 1
        return table

    def should_compact(self) -> bool:
        return len(self.l0) >= self._l0_trigger

    # ---- reads --------------------------------------------------------

    def get(self, key: bytes) -> Optional[Tuple[bytes, int]]:
        """Visible (value, expire_ts) or None. TTL filtering is the
        caller's job (the reference checks expiry in the handlers).

        L0 tables short-circuit on their first/last-key fences, then on
        their sidecars: the key is hashed once (the crc64 every sidecar
        shares) when a candidate table carries a bloom or a perfect-hash
        index. An indexed table answers through its perfect hash alone
        (a miss touches no block); each kill switch disables only its
        own structure. The ambient PerfContext counts an overlay hit or
        the runs the key was answered against."""
        pc = _perf_current()  # solo-path cost vector (None = untracked)
        hit = self.memtable.get(key)
        if hit is not None:
            if pc is not None:
                pc.overlay_hits += 1
            value, ets = hit
            return None if value is TOMBSTONE else (value, ets)
        bloom_on = bloom_probe_enabled()
        phash_on = phash_probe_enabled()
        if pc is not None:
            pc.runs_considered += len(self.l0) + len(self.l1_runs)
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
                patch_headers: bool = False, publish_lock=None) -> None:
        """Full merge compaction into new L1 runs of at most
        `l1_run_capacity` records.

        `publish_lock=None`: the caller excludes writers for the whole
        merge; memtable + L0 + L1 merge and the overlay resets at
        publish. `publish_lock` set (snapshot mode, the narrow critical
        section): the caller froze the memtable with a flush, the merge
        runs over the immutable L0/L1 snapshot with writes flowing, and
        the lock is taken only for the publish cut-over — post-snapshot
        writes (fresh memtable, newer L0 flushes) survive untouched.

        `record_filter(keys: List[bytes], expire_ts: List[int]) ->
        (drop, new_expire)` returns arrays or tensors, possibly still
        being computed on the device: each batch's result is moved to
        the host only after the next batch has been gathered and
        submitted. Tombstones always drop (bottommost). Every filter
        batch pays the governor for its bytes."""
        runs_snap = list(self.l1_runs)
        if publish_lock is not None:
            l0_snap = list(self.l0)
            sources: List[Iterator[Record]] = [
                t.iterate() for t in l0_snap]
            if runs_snap:
                sources.append(_chain_runs(runs_snap, b"", None, False))
            merged = _merge(sources)
        else:
            l0_snap = None
            merged = self.iterate()
        new_runs: List[SSTable] = []
        writer: Optional[SSTableWriter] = None
        written_in_run = 0
        # block writes stream on the writer's IO thread while the merge
        # keeps producing; filled runs finish on the _FinishPool (joined
        # before publish)
        finish_pool = _FinishPool()

        def open_writer() -> SSTableWriter:
            return SSTableWriter(self._next_path("l1"),
                                 block_capacity=self._block_capacity,
                                 meta=meta, async_io=True)

        def write_records(keys, vals, ets_orig, drop, new_ets) -> None:
            nonlocal writer, written_in_run
            for i, k in enumerate(keys):
                if drop is not None and drop[i]:
                    continue
                if writer is None:
                    writer = open_writer()
                ne = int(new_ets[i])
                v = vals[i]
                if patch_headers and ne != ets_orig[i]:
                    # a TTL rewrite must reach the encoded value header
                    v = update_expire_ts(1, v, ne)
                writer.add(k, v, ne)
                written_in_run += 1
                if written_in_run >= self._l1_run_capacity:
                    finish_pool.submit(writer)
                    writer = None
                    written_in_run = 0

        def submit(keys, vals, ets):
            if record_filter is None:
                return (keys, vals, ets, None, ets)
            drop, new_ets = record_filter(keys, ets)
            return (keys, vals, ets, drop, new_ets)

        def host(a) -> np.ndarray:
            return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)

        def drain(entry) -> None:
            keys, vals, ets_orig, drop, new_ets = entry
            if drop is not None:
                drop = host(drop)
                new_ets = host(new_ets)
            write_records(keys, vals, ets_orig, drop, new_ets)

        pending = None
        batch_keys: List[bytes] = []
        batch_vals: List[bytes] = []
        batch_ets: List[int] = []
        batch_bytes = 0
        # the filter batch spans 16 write blocks: one device evaluation
        # per 16k records
        filter_batch = self._block_capacity * 16
        ok = False
        try:
            for key, value, ets in merged:
                if value is None:  # tombstone: bottommost level -> drop
                    continue
                batch_keys.append(key)
                batch_vals.append(value)
                batch_ets.append(ets)
                batch_bytes += len(key) + len(value)
                if len(batch_keys) >= filter_batch:
                    GOVERNOR.acquire(batch_bytes)
                    entry = submit(batch_keys, batch_vals, batch_ets)
                    if pending is not None:
                        drain(pending)
                    pending = entry
                    batch_keys, batch_vals, batch_ets = [], [], []
                    batch_bytes = 0
            if batch_keys:
                GOVERNOR.acquire(batch_bytes)
                entry = submit(batch_keys, batch_vals, batch_ets)
                if pending is not None:
                    drain(pending)
                pending = entry
            if pending is not None:
                drain(pending)
            if writer is not None:
                finish_pool.submit(writer)
                writer = None
            new_runs = finish_pool.results()
            ok = True
        finally:
            finish_pool.shutdown(ok, open_writer=writer)

        self._publish_l1(new_runs, consumed_l0=l0_snap,
                         old_runs=runs_snap, publish_lock=publish_lock,
                         mcft=(meta or {}).get(
                             "manual_compact_finish_time", 0))

    def _publish_l1(self, new_runs: List[SSTable],
                    consumed_l0: Optional[List[SSTable]] = None,
                    old_runs: Optional[List[SSTable]] = None,
                    publish_lock=None, mcft: int = 0) -> None:
        """Swap in a freshly compacted L1 under `publish_lock` (None: the
        caller already excludes writers): manifest first (atomic), then
        remove the inputs — boot cleans up either crash window.

        consumed_l0=None: the merge consumed the live overlay, which
        resets wholesale. consumed_l0=[...]: snapshot mode — exactly
        those L0 tables leave; the memtable and newer L0 flushes survive.
        old_runs: the L1 snapshot the merge consumed, revalidated against
        the live list under the lock — compactions are serialized
        (engine.compact_lock), so a mismatch means a torn merge whose
        output must not publish. mcft: the manual-compaction finish time,
        recorded here with the manifest, so a failed run never satisfies
        a re-delivered env trigger."""
        import contextlib

        lock = publish_lock if publish_lock is not None \
            else contextlib.nullcontext()
        old_l0: List[SSTable] = []
        with lock:
            if old_runs is not None and \
                    [id(t) for t in self.l1_runs] != \
                    [id(t) for t in old_runs]:
                for t in new_runs:
                    try:
                        t.close()
                        os.remove(t.path)
                    except OSError:
                        pass
                raise RuntimeError(
                    "concurrent L1 publish detected; compaction output "
                    "discarded")
            if mcft:
                self.compact_finish_time = mcft
            self._write_manifest([os.path.basename(t.path)
                                  for t in new_runs])
            superseded = self.l1_runs
            self.l1_runs = new_runs
            self.generation += 1
            if consumed_l0 is None:
                old_l0, self.l0 = self.l0, []
                self.memtable = Memtable()
            elif consumed_l0:
                consumed = {id(t) for t in consumed_l0}
                self.l0 = [t for t in self.l0 if id(t) not in consumed]
                old_l0 = list(consumed_l0)
            # the inputs are unlinked now (the manifest no longer names
            # them) but their handles are released by GC, not closed: a
            # reader admitted before the swap may still be serving from
            # them (an env-triggered compaction publishes from its own
            # thread), and POSIX keeps unlinked open files readable
            for t in old_l0 + superseded:
                os.remove(t.path)
        hook = self.on_publish
        if hook is not None:
            hook({t.path for t in new_runs})

    # ---- bulk block-level compaction (the GB/s path) -------------------

    def bulk_compact_eligible(self) -> bool:
        """The store is pure non-overlapping L1: no merge is needed, so
        compaction can rewrite block-wise with vectorized gathers. v1
        files (no hash_lo column) take the merge path."""
        return (len(self.memtable) == 0 and not self.l0
                and bool(self.l1_runs)
                and all(getattr(r, "_has_hash_lo", False)
                        for r in self.l1_runs))

    def bulk_compact_entries(self):
        """Every L1 block in global key order: [(run, idx, BlockMeta)]."""
        out = []
        for run in self.l1_runs:
            for i, bm in enumerate(run.blocks):
                out.append((run, i, bm))
        return out

    def bulk_compact_rewrite(self, per_block, meta,
                             ttl_may_change: bool,
                             patch_headers: bool = False,
                             publish_lock=None,
                             transform_workers: int = 0) -> None:
        """Rewrite the L1 level from precomputed per-block filter results.

        `per_block`: [(run, idx, blk, drop, new_ets)] in key order (drop
        / new_ets sized to the block's real count). Untouched compressed
        blocks copy verbatim, untouched raw blocks re-serialize from
        their decoded columns; touched compressed blocks are subset in
        the encoded domain by the native kernel; the rest are rebuilt
        with numpy gathers, expire_ts value headers patched with scatter
        stores. The rewrite never touches the memtable/L0 (eligibility
        requires them empty at snapshot), so with `publish_lock` the
        whole disk pass runs with writes flowing.

        `transform_workers` > 0 (the pipelined compactor's write stage):
        the per-block transform runs on an ordered worker pool while this
        thread appends the results; the transform is one function run
        identically inline or pooled, so output bytes cannot depend on
        the mode."""
        import concurrent.futures as _cf

        from pegasus_tpu_torch import native

        runs_snap = list(self.l1_runs)
        finish_pool = _FinishPool()
        cblock_subset = native.cblock_subset_fn()
        writer: Optional[SSTableWriter] = None
        written_in_run = 0
        ok = False

        def roll_writer() -> SSTableWriter:
            nonlocal writer, written_in_run
            if writer is not None and \
                    written_in_run >= self._l1_run_capacity:
                finish_pool.submit(writer)
                writer = None
                written_in_run = 0
            if writer is None:
                writer = SSTableWriter(self._next_path("l1"),
                                       block_capacity=self._block_capacity,
                                       meta=meta, async_io=True)
            return writer

        # writer-independent state the transform latches once, so the
        # same decisions compute on any thread; `sidecar_now` (bloom OR
        # phash) decides whether the subset kernel emits per-row hashes
        codec_now = block_codec()
        sidecar_now = bloom_build_bits() > 0 or phash_build_enabled()

        def transform(item):
            """Stateless per-block transform -> (kind, payload)."""
            _run, _idx, blk, drop, new_ets = item
            dropped = bool(drop.any())
            encoded = isinstance(blk, EncodedBlock)
            ets_changed = ttl_may_change and \
                not np.array_equal(new_ets, blk.expire_ts)
            if not dropped and not ets_changed:
                if encoded:
                    if codec_now != CODEC_NONE:
                        # untouched compressed block: its bytes copy
                        # verbatim
                        return "verbatim", blk
                    blk = blk.decode()  # codec turned off mid-store
                return "copy", blk
            n = blk.count
            if encoded:
                # survivor check first: a fully dropped block must never
                # roll a writer (an empty L1 run would publish)
                keep = survivor_mask(drop, blk.flags)
                if not keep.any():
                    return "skip", None
                if codec_now != CODEC_NONE \
                        and codec_accepts(codec_now, blk.version):
                    # subset the block in the encoded domain: one
                    # GIL-free native pass
                    res = cblock_subset(
                        blk.raw, blk.raw_heap_len, blk.key_width,
                        keep, new_ets if ets_changed else None,
                        ets_changed and patch_headers,
                        want_hashes=sidecar_now)
                    if res is not None:
                        return "raw", (res, blk.key_width)
                # no zlib/zstd for the heap, or the codec flipped off
                # mid-store: materialize once, gather below
                blk = blk.decode()
            keep = survivor_mask(drop, blk.flags)
            kept = np.flatnonzero(keep)
            if kept.size == 0:
                return "skip", None
            vo = blk.value_offs.astype(np.int64)
            lens = vo[1:] - vo[:-1]
            heap_arr = blk.value_heap
            if not isinstance(heap_arr, np.ndarray):
                heap_arr = np.frombuffer(heap_arr, dtype=np.uint8)
            ets_col = new_ets if ets_changed else blk.expire_ts
            if ets_changed and patch_headers:
                # patch the big-endian u32 expire_ts value header in
                # place (value_schema.h: the header starts every value)
                heap_arr = heap_arr.copy()
                chg = np.flatnonzero((new_ets != blk.expire_ts) & keep)
                if chg.size:
                    pos = vo[chg]
                    vals = new_ets[chg].astype(np.uint32)
                    heap_arr[pos] = (vals >> 24).astype(np.uint8)
                    heap_arr[pos + 1] = \
                        ((vals >> 16) & 0xFF).astype(np.uint8)
                    heap_arr[pos + 2] = \
                        ((vals >> 8) & 0xFF).astype(np.uint8)
                    heap_arr[pos + 3] = (vals & 0xFF).astype(np.uint8)
            if kept.size == n:
                new_heap = heap_arr
                new_offs = blk.value_offs
                keys2d, klen = blk.keys, blk.key_len
                hlo, flg = blk.hash_lo, blk.flags
                ets_out = ets_col
            else:
                keep_bytes = np.repeat(keep, lens)
                new_heap = heap_arr[keep_bytes]
                kept_lens = lens[kept]
                new_offs = np.zeros(kept.size + 1, dtype=np.uint32)
                new_offs[1:] = np.cumsum(kept_lens)
                keys2d = blk.keys[kept]
                klen = blk.key_len[kept]
                ets_out = np.asarray(ets_col)[kept]
                hlo = blk.hash_lo[kept]
                flg = blk.flags[kept]
            return "columnar", (keys2d, klen, ets_out, hlo, flg,
                                new_offs, new_heap, int(kept.size))

        def consume(kind, payload) -> None:
            """Writer appends, strictly in block order on this thread."""
            nonlocal written_in_run
            if kind == "skip":
                return
            w = roll_writer()
            if kind == "verbatim":
                # add_block_encoded transcodes a version the writer's
                # codec cannot contain (flag moved mid-store)
                w.add_block_encoded(payload)
                written_in_run += payload.count
            elif kind == "copy":
                w.add_block_columnar(payload.keys, payload.key_len,
                                     payload.expire_ts, payload.hash_lo,
                                     payload.flags, payload.value_offs,
                                     payload.value_heap)
                written_in_run += payload.count
            elif kind == "raw":
                (buf, hashes, m, vsub, fk, lk), kw = payload
                w.add_block_encoded_raw(buf, m, kw, vsub, fk, lk, hashes)
                written_in_run += m
            else:
                w.add_block_columnar(*payload[:7])
                written_in_run += payload[7]

        try:
            if transform_workers > 0:
                # ordered lookahead: transforms run chunked on the pool
                # (one future per 16 blocks) while results append in order
                from collections import deque

                CHUNK = 16
                depth = 2 * transform_workers + 2

                def transform_chunk(chunk):
                    return [transform(x) for x in chunk]

                tpool = _cf.ThreadPoolExecutor(
                    max_workers=transform_workers)
                try:
                    pend: deque = deque()
                    chunk: list = []
                    for item in per_block:
                        chunk.append(item)
                        if len(chunk) >= CHUNK:
                            pend.append(tpool.submit(transform_chunk,
                                                     chunk))
                            chunk = []
                            if len(pend) >= depth:
                                for r in pend.popleft().result():
                                    consume(*r)
                    if chunk:
                        pend.append(tpool.submit(transform_chunk, chunk))
                    while pend:
                        for r in pend.popleft().result():
                            consume(*r)
                finally:
                    tpool.shutdown(wait=True)
            else:
                for item in per_block:
                    consume(*transform(item))
            if writer is not None:
                finish_pool.submit(writer)
                writer = None
            new_runs = finish_pool.results()
            ok = True
        finally:
            finish_pool.shutdown(ok, open_writer=writer)
        # memtable/L0 are untouched by construction
        self._publish_l1(new_runs, consumed_l0=[], old_runs=runs_snap,
                         publish_lock=publish_lock,
                         mcft=(meta or {}).get(
                             "manual_compact_finish_time", 0))


class _FinishPool:
    """Shared write-stage finisher of both compaction shapes: filled runs
    finish() (flush + fsync + rename + dir-fsync) on helper threads while
    the producer writes the next run; `results()` joins every future
    before the manifest publish, so all runs are durable before the
    manifest names them. `shutdown(ok=False, open_writer=...)` is the
    crash cleanup: no pool, in-flight finish, half-written handle or
    already-renamed partial l1-*.sst output may leak."""

    def __init__(self) -> None:
        import concurrent.futures as _cf

        self._pool = _cf.ThreadPoolExecutor(max_workers=2)
        self._futures: list = []
        self._writers: list = []

    @staticmethod
    def _finish_one(w) -> SSTable:
        w.finish()
        return SSTable(w.path)

    def submit(self, w) -> None:
        self._writers.append(w)
        self._futures.append(self._pool.submit(self._finish_one, w))

    def results(self) -> List[SSTable]:
        return [f.result() for f in self._futures]

    def shutdown(self, ok: bool, open_writer=None) -> None:
        self._pool.shutdown(wait=True)
        if ok:
            return
        for f, w in zip(self._futures, self._writers):
            try:
                t = f.result()
            except Exception:  # noqa: BLE001 - finish() died
                try:
                    w.abandon()
                except Exception:  # noqa: BLE001 - best-effort
                    pass
                continue
            try:
                t.close()
                os.remove(t.path)
            except OSError:
                pass
        if open_writer is not None:
            try:
                open_writer.abandon()
            except Exception:  # noqa: BLE001 - best-effort
                pass


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
