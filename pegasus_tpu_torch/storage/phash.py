"""Perfect-hash two-level SST index: key-hash -> (block, slot) in one probe.

The port's copy of pegasus_tpu/storage/phash.py: the same index bytes
for the same seed, the same probe answers. A bloom prunes tables, but
every key that passes it still pays a block-fence bisect plus an
in-block bisect. This index answers both questions at once: a miss dies
with zero block touches, and a hit goes straight to its (block, slot)
row.

Construction (CHD — compress, hash, displace):

    mix(h, seed)  splitmix-style finalizer over the crc64 full-key hash
                  the bloom path already computes (ONE shared hash pass)
    bucket        (x >> 32) % nb         (nb ~ n/4 buckets)
    position(d)   (p0 + d * delta) % ts  (ts ~ n/0.85 slots, odd)
    entry         fp(10 bits) | loc(22 bits)   per occupied slot

Buckets are placed in decreasing-size order; each bucket searches the
smallest displacement d (uint16) under which all of its keys land on
distinct empty slots. The displacement array (one u16 per bucket) plus
the slot array (one u32 per slot) is the WHOLE index: ~5.2 bytes/key
at the default geometry, replacing the bloom bits + the per-key resident
bisect state (key lists / probe tables charge ~64+ bytes/row once a
block turns hot) for point-read working sets.

`loc` packs (block_idx << slot_bits) | slot, where `slot` is the row
index inside the DECODED block — stable across the `none`/`dcz`/`dcz2`
codecs because decode reproduces row order byte-for-byte (including
dcz2's overflow rows), and stable across the verbatim-copy / native
subset compaction paths because every writer builds a fresh index from
its own per-block hash columns in append order.

Probing an absent key lands on an empty slot or a fingerprint mismatch
(definitive absent — if the key were present, the build would have
placed it at exactly this slot). A fingerprint COLLISION (~0.08%:
occupied slot, matching 10-bit fp, different key) surfaces as a located
row whose key does not match; callers must verify the row's key before
serving, which makes a collision one wasted block touch, never a wrong
answer.

Construction can fail (adversarial key sets, crc64 hash collisions,
oversized loc geometry): bounded seed retries, then the run is stamped
"no phash" and serves via bloom + bisect — a perf event
(`phash_build_fail_count`), never a correctness event.

Knobs (`[pegasus.server]`): `phash_index` (build-time), `phash_probe`
(mutable probe-time kill switch), `phash_force_fail` (deterministic
fail point for fallback tests).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from pegasus_tpu_torch.utils.flags import FLAGS, define_flag
from pegasus_tpu_torch.utils.metrics import METRICS

define_flag("pegasus.server", "phash_index", True,
            "build a perfect-hash (block, slot) index into new SST "
            "files at every writer finish site (flush / merge-compact "
            "/ bulk-compact / ingest); files without one keep serving "
            "via bloom + bisect", mutable=True)
define_flag("pegasus.server", "phash_probe", True,
            "consult SST perfect-hash indexes on the point-read path "
            "(misses die with zero block touches; hits skip both "
            "bisects)", mutable=True)
define_flag("pegasus.server", "phash_force_fail", False,
            "fail point: force every perfect-hash build to fail, "
            "exercising the bloom+bisect fallback deterministically",
            mutable=True)


def phash_build_enabled() -> bool:
    return bool(FLAGS.get("pegasus.server", "phash_index"))


def phash_probe_enabled() -> bool:
    return bool(FLAGS.get("pegasus.server", "phash_probe"))


# node-wide observability (the bloom counters' siblings): useful =
# definitive-absent answers that skipped every block touch; hit = keys
# located straight to (block, slot); build_fail = runs stamped
# "no phash" after the bounded seed retries
_STORAGE = METRICS.entity("storage", "node")
PHASH_USEFUL = _STORAGE.relaxed_counter("phash_useful_count")
PHASH_HIT = _STORAGE.relaxed_counter("phash_hit_count")
PHASH_BUILD_FAIL = _STORAGE.relaxed_counter("phash_build_fail_count")

PHASH_VERSION = 1
KNOWN_PHASH_VERSIONS = (1,)

_M64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15
_MIXK = 0xFF51AFD7ED558CCD
FP_BITS = 10
LOC_BITS = 22
LOC_MASK = (1 << LOC_BITS) - 1
EMPTY = 0xFFFFFFFF  # empty slot sentinel (also the probe's absent code)
ABSENT = 0xFFFFFFFF
_D_MAX = 1 << 16    # displacement is a uint16
_SEED_TRIES = 3


def _mix_arr(hashes: np.ndarray, seed: int) -> np.ndarray:
    """uint64[n] seed-keyed finalizer — bit-identical to the native
    kernel's phash_mix (the mixer is part of the on-disk format; the
    seed is stored in the index header)."""
    smul = np.uint64((_GOLDEN * (seed + 1)) & _M64)
    x = hashes.astype(np.uint64, copy=False) ^ smul
    x = x ^ (x >> np.uint64(33))
    x = x * np.uint64(_MIXK)
    return x ^ (x >> np.uint64(29))


def _mix_int(h: int, seed: int) -> int:
    x = (h ^ ((_GOLDEN * (seed + 1)) & _M64)) & _M64
    x ^= x >> 33
    x = (x * _MIXK) & _M64
    x ^= x >> 29
    return x


# (bucket, base position, step) from a mixed hash — Lemire
# multiply-shift reductions (one multiply where a `%` costs a divide;
# the native kernel's measured bottleneck was exactly these divisions)
# plus the ONE remaining modular step the displacement walk needs.
# These formulas are FORMAT: the native kernel's phash_bpd mirrors
# them bit-for-bit, and the stored seed/ts/nb only mean anything under
# them. With a PRIME ts every delta in [1, ts-1] is coprime, so
# (p0 + d*delta) % ts reaches the whole table.

def _bpd_int(x: int, ts: int, nb: int):
    bucket = ((x >> 32) * nb) >> 32
    p0 = ((x & 0xFFFFFFFF) * ts) >> 32
    delta = 1 + ((((x >> 17) & 0xFFFFFFFF) * (ts - 1)) >> 32)
    return bucket, p0, delta


def _bpd_arr(x: np.ndarray, ts: int, nb: int):
    lo32 = np.uint64(0xFFFFFFFF)
    s32 = np.uint64(32)
    bucket = ((x >> s32) * np.uint64(nb)) >> s32
    p0 = ((x & lo32) * np.uint64(ts)) >> s32
    delta = np.uint64(1) + (
        (((x >> np.uint64(17)) & lo32) * np.uint64(ts - 1)) >> s32)
    return bucket.astype(np.int64), p0.astype(np.int64), \
        delta.astype(np.int64)


def _next_prime(m: int) -> int:
    """Smallest prime >= m (trial division — m is bounded by the L1
    run capacity, so sqrt(m) stays a few hundred)."""
    if m <= 2:
        return 2
    m |= 1
    while True:
        d = 3
        while d * d <= m:
            if m % d == 0:
                break
            d += 2
        else:
            return m
        m += 2


def _geometry(n: int) -> Tuple[int, int]:
    """(table_size, n_buckets): ~0.85 load over a PRIME slot count,
    ~4 keys/bucket. Primality is load-bearing, not cosmetic: with a
    composite ts a key whose delta shares a large factor can only
    reach ts/gcd slots — a size-2 bucket whose key cycles through 5
    occupied positions is unplaceable at ANY displacement (observed at
    ts=825, gcd 165). A prime ts makes every delta coprime, so each
    key's probe sequence covers the whole table."""
    ts = _next_prime(max(3, (20 * n + 16) // 17))  # ceil(n / 0.85)
    nb = max(1, (n + 3) // 4)
    return ts, nb


class PHashIndex:
    """One run's CHD index: `slots` uint32[ts] (fp|loc entries, EMPTY
    for unoccupied), `disp` uint16[nb], plus the geometry the probe
    recomputes positions from."""

    __slots__ = ("slots", "disp", "ts", "nb", "seed", "slot_bits", "n")

    def __init__(self, slots: np.ndarray, disp: np.ndarray, seed: int,
                 slot_bits: int, n: int) -> None:
        self.slots = slots
        self.disp = disp
        self.ts = int(slots.shape[0])
        self.nb = int(disp.shape[0])
        self.seed = seed
        self.slot_bits = slot_bits
        self.n = n

    # ---- build ---------------------------------------------------------

    @staticmethod
    def build(hashes: np.ndarray, block_counts: List[int]
              ) -> Optional["PHashIndex"]:
        """Index over a finished run: `hashes` uint64[n] crc64 full-key
        hashes in FILE ORDER (the bloom's hash columns, concatenated),
        `block_counts` the per-block row counts in the same order.
        Returns None on construction failure (callers stamp "no phash"
        and tick `phash_build_fail_count` — never an error)."""
        n = int(hashes.shape[0])
        if n == 0 or sum(block_counts) != n:
            return None
        if bool(FLAGS.get("pegasus.server", "phash_force_fail")):
            return None
        counts = np.asarray(block_counts, dtype=np.int64)
        slot_bits = max(1, int(counts.max() - 1).bit_length())
        block_bits = max(1, int(len(block_counts) - 1).bit_length())
        if slot_bits + block_bits > LOC_BITS:
            return None  # run too large for the packed loc — fall back
        starts = np.zeros(len(block_counts) + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        block_ids = np.repeat(np.arange(len(block_counts),
                                        dtype=np.int64), counts)
        slot_in_block = (np.arange(n, dtype=np.int64)
                         - np.repeat(starts[:-1], counts))
        locs = ((block_ids << slot_bits) | slot_in_block).astype(np.uint32)
        h = np.ascontiguousarray(hashes, dtype=np.uint64)
        ts, nb = _geometry(n)
        from pegasus_tpu_torch import native

        build = native.phash_build_fn()
        for seed in range(_SEED_TRIES):
            res = build(h, locs, seed, ts, nb)
            if res is not None:
                slots, disp = res
                return PHashIndex(slots, disp, seed, slot_bits, n)
        return None

    # ---- probe ---------------------------------------------------------

    def lookup_hash(self, h: int) -> int:
        """Scalar probe (the solo-get path, sharing the batched
        kernel's crc64 hash): packed loc (block << slot_bits | slot),
        or -1 for a definitive absent. A returned loc may still be a
        fingerprint collision — the caller verifies the row's key."""
        x = _mix_int(int(h), self.seed)
        ts = self.ts
        bucket, p0, delta = _bpd_int(x, ts, self.nb)
        pos = (p0 + int(self.disp[bucket]) * delta) % ts
        e = int(self.slots[pos])
        if e == EMPTY or (e >> LOC_BITS) != (x >> (64 - FP_BITS)):
            return -1
        return e & LOC_MASK

    def probe_hashes(self, hashes: np.ndarray) -> np.ndarray:
        """uint32[n] packed locs (ABSENT = definitive miss) — ONE
        vectorized pass answers a whole read flush against this run."""
        x = _mix_arr(hashes, self.seed)
        b, p0, delta = _bpd_arr(x, self.ts, self.nb)
        d = self.disp[b].astype(np.int64)
        pos = (p0 + d * delta) % self.ts
        e = self.slots[pos]
        fp = (x >> np.uint64(64 - FP_BITS)).astype(np.uint32)
        ok = (e != np.uint32(EMPTY)) & ((e >> np.uint32(LOC_BITS)) == fp)
        return np.where(ok, e & np.uint32(LOC_MASK), np.uint32(ABSENT))

    def unpack(self, loc: int) -> Tuple[int, int]:
        """packed loc -> (block_idx, slot)."""
        return loc >> self.slot_bits, loc & ((1 << self.slot_bits) - 1)

    # ---- persistence ---------------------------------------------------

    def to_bytes(self) -> bytes:
        # u32 slots FIRST, u16 disp after: with the blob start 4-byte
        # aligned (the writer pads to a boundary) every section meets
        # its natural alignment, so the mmap-backed frombuffer views
        # hand the native probe pointers it may legally dereference
        return self.slots.tobytes() + self.disp.tobytes()

    def meta(self) -> dict:
        """The index-JSON header naming geometry + format version
        (version gates open exactly like the block codec: readers
        without this version refuse the file, never misparse)."""
        return {"version": PHASH_VERSION, "n": self.n, "ts": self.ts,
                "nb": self.nb, "seed": self.seed,
                "slot_bits": self.slot_bits}

    def mem_bytes(self) -> int:
        return self.disp.nbytes + self.slots.nbytes

    @staticmethod
    def from_bytes(raw, meta: dict) -> Optional["PHashIndex"]:
        """None on torn/mismatched geometry (degrade to bloom+bisect,
        like a torn bloom). Unknown VERSIONS are the caller's refusal
        (sstable open), not a degrade. A buffer whose base address is
        not 4-byte aligned (the writer pads new files, but encrypted
        reads / foreign buffers make no promise) is copied once —
        the native probe dereferences these as u32/u16 and a
        misaligned pointer is UB (SIGBUS on strict-alignment
        targets)."""
        nb, ts = int(meta["nb"]), int(meta["ts"])
        if len(raw) != 2 * nb + 4 * ts:
            return None
        buf = np.frombuffer(raw, dtype=np.uint8)
        if buf.ctypes.data % 4:
            buf = buf.copy()
        slots = np.frombuffer(buf, dtype=np.uint32, count=ts)
        disp = np.frombuffer(buf, dtype=np.uint16, count=nb,
                             offset=4 * ts)
        return PHashIndex(slots, disp, int(meta["seed"]),
                          int(meta["slot_bits"]), int(meta["n"]))

    @property
    def contiguous_slots(self) -> np.ndarray:
        if not self.slots.flags["C_CONTIGUOUS"]:
            self.slots = np.ascontiguousarray(self.slots)
        return self.slots

    @property
    def contiguous_disp(self) -> np.ndarray:
        if not self.disp.flags["C_CONTIGUOUS"]:
            self.disp = np.ascontiguousarray(self.disp)
        return self.disp


def _build_once_py(hashes: np.ndarray, locs: np.ndarray, seed: int,
                   ts: int, nb: int):
    """Python CHD build, bit-identical to pegasus_phash_build (same
    bucket order, same displacement search): the plain version the
    tests hold the native build against. The loop is per bucket."""
    x = _mix_arr(hashes, seed)
    fp = (x >> np.uint64(64 - FP_BITS)).astype(np.uint32)
    entries = (fp << np.uint32(LOC_BITS)) | locs
    if bool((entries == np.uint32(EMPTY)).any()):
        return None  # an entry colliding with the sentinel: reseed
    bucket, p0, delta = _bpd_arr(x, ts, nb)
    order = np.argsort(bucket, kind="stable")
    counts = np.bincount(bucket, minlength=nb)
    starts = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    # decreasing size, bucket id breaking ties — big buckets place
    # while the table is empty (the CHD ordering that makes high load
    # factors reachable)
    border = np.lexsort((np.arange(nb), -counts))
    slots = np.full(ts, EMPTY, dtype=np.uint32)
    disp = np.zeros(nb, dtype=np.uint16)
    for b in border:
        c = int(counts[b])
        if c == 0:
            continue
        ks = order[starts[b]:starts[b] + c]
        kp0 = p0[ks]
        kd = delta[ks]
        ke = entries[ks]
        for d in range(_D_MAX):
            pos = (kp0 + d * kd) % ts
            if c > 1 and len(set(pos.tolist())) < c:
                continue
            if (slots[pos] == np.uint32(EMPTY)).all():
                slots[pos] = ke
                disp[b] = d
                break
        else:
            return None
    return slots, disp


class PHashMultiProbe:
    """Every perfect-hash index of one partition's run set, probed in
    ONE pass — the sibling of storage.bloom.MultiProbe: the planner's
    flush hashes its disk-bound keys once and `probe` answers the whole
    (keys x indexed runs) LOCATION matrix with one native call
    (`pegasus_phash_probe_multi`). Returns row-major uint32 locs:
    out[key_i * n + table_t] is the packed (block << slot_bits | slot),
    or ABSENT for a definitive miss. Holding `indexes` keeps the slot
    arrays alive for the address columns."""

    __slots__ = ("indexes", "n", "slot_bits", "_native", "_slots_addrs",
                 "_disp_addrs", "_ts", "_nb", "_seeds", "_fixed_ptrs")

    def __init__(self, indexes) -> None:
        self.indexes = list(indexes)
        self.n = len(self.indexes)
        self.slot_bits = [ix.slot_bits for ix in self.indexes]
        from pegasus_tpu_torch.native import phash_probe_multi_fn

        self._native = phash_probe_multi_fn()
        self._slots_addrs = np.array(
            [ix.contiguous_slots.ctypes.data for ix in self.indexes],
            dtype=np.uint64)
        self._disp_addrs = np.array(
            [ix.contiguous_disp.ctypes.data for ix in self.indexes],
            dtype=np.uint64)
        self._ts = np.array([ix.ts for ix in self.indexes], dtype=np.uint64)
        self._nb = np.array([ix.nb for ix in self.indexes], dtype=np.uint64)
        self._seeds = np.array([ix.seed for ix in self.indexes],
                               dtype=np.uint64)
        # raw pointers of the immutable per-probe arrays, resolved once
        # (the probe runs once per read flush)
        self._fixed_ptrs = (
            self._slots_addrs.ctypes.data,
            self._disp_addrs.ctypes.data, self._ts.ctypes.data,
            self._nb.ctypes.data, self._seeds.ctypes.data)

    def probe(self, hashes: np.ndarray):
        """(loc cells, hit-mask bytes) for the whole matrix: the mask is
        read as python bytes per (key, table) cell, and the loc cells (a
        memoryview: plain-int reads) only for the located cells."""
        n_keys = len(hashes)
        out = np.empty(n_keys * self.n, dtype=np.uint32)
        hits = np.empty(n_keys * self.n, dtype=np.uint8)
        self._native(self._fixed_ptrs, self.n,
                     np.ascontiguousarray(hashes, dtype=np.uint64),
                     n_keys, out, hits)
        return memoryview(out), hits.tobytes()

    def probe_plain(self, hashes: np.ndarray):
        """Vectorized numpy twin of `probe` (`probe_hashes` per index),
        the plain version the tests hold the native probe against."""
        n_keys = len(hashes)
        out = np.empty(n_keys * self.n, dtype=np.uint32)
        for t, ix in enumerate(self.indexes):
            out[t::self.n] = ix.probe_hashes(
                np.asarray(hashes, dtype=np.uint64))
        return (memoryview(out),
                (out != np.uint32(ABSENT)).tobytes())
