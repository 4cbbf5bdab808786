"""Record predicates of the scan / multi_get path.

Parity with the reference's per-record scalar loop:
- validate_filter (src/server/pegasus_server_impl.cpp:2350): empty pattern
  matches everything; a region shorter than the pattern never matches;
  FT_MATCH_ANYWHERE/PREFIX/POSTFIX substring semantics.
- validate_key_value_for_scan (:2382): precedence is
  expired -> hash_invalid -> filtered -> normal.
- check_if_ts_expired (src/base/pegasus_value_schema.h:113):
  expired iff 0 < expire_ts <= now.

The two block predicates (`static_block_predicate`, without `now`, and
`scan_block_predicate`, with it) evaluate through the table function of
ops/fused_scan.py (`scan_table`, here a table of one block), and the
multi-flavour one (`multi_static_block_predicate_submit`) through its
flavour axis (`scan_table_multi`): on a CUDA block they launch the
hand-written kernel, on a CPU block they run the plain torch version
built from `match_filter` and `ttl_expired` below.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from pegasus_tpu_torch.ops.record_block import RecordBlock, next_bucket, u32
from pegasus_tpu_torch.utils.metrics import METRICS

# rrdb filter_type values (idl/rrdb.thrift:27-33)
FT_NO_FILTER = 0
FT_MATCH_ANYWHERE = 1
FT_MATCH_PREFIX = 2
FT_MATCH_POSTFIX = 3


def host_match_filter(data: bytes, filter_type: int,
                      pattern: bytes) -> bool:
    """Scalar twin of match_filter for host-side paths (overlay rows,
    oracles). Empty pattern matches everything."""
    if filter_type == FT_NO_FILTER or not pattern:
        return True
    if filter_type == FT_MATCH_ANYWHERE:
        return pattern in data
    if filter_type == FT_MATCH_PREFIX:
        return data.startswith(pattern)
    if filter_type == FT_MATCH_POSTFIX:
        return data.endswith(pattern)
    raise ValueError(f"unknown filter type {filter_type}")


class FilterSpec(NamedTuple):
    """A filter pattern on a device: `pattern` is uint8[P], zero-padded
    to a power-of-two width; `pattern_len` its real length. `raw` keeps
    the pattern bytes on the host for cache keys."""

    filter_type: int
    pattern: torch.Tensor
    pattern_len: int
    raw: bytes = b""

    @staticmethod
    def make(filter_type: int, pattern: bytes = b"",
             device="cpu") -> "FilterSpec":
        return _make_cached(int(filter_type), bytes(pattern),
                            torch.device(device))

    @staticmethod
    def none(device="cpu") -> "FilterSpec":
        return _make_cached(FT_NO_FILTER, b"", torch.device(device))

    @property
    def key(self) -> tuple:
        """Hashable host-side identity (for mask cache keys)."""
        return (self.filter_type, self.raw)


@functools.lru_cache(maxsize=256)
def _make_cached(filter_type: int, pattern: bytes,
                 device: torch.device) -> FilterSpec:
    """Specs are immutable, so identical filters share one device copy."""
    buf = np.zeros(next_bucket(len(pattern)), dtype=np.uint8)
    buf[:len(pattern)] = np.frombuffer(pattern, dtype=np.uint8)
    return FilterSpec(filter_type, torch.from_numpy(buf).to(device),
                      len(pattern), pattern)


def match_filter(keys: torch.Tensor, region_start: torch.Tensor,
                 region_len: torch.Tensor, pattern: torch.Tensor,
                 pattern_len: int, filter_type: int) -> torch.Tensor:
    """bool[B]: does each record's byte region match the pattern?

    keys uint8[B, K]; region_start/region_len int[B] (region within the
    padded key row, possibly negative or running past the row on
    malformed keys); pattern uint8[P]. PREFIX/POSTFIX read
    clip(offset + j, 0, K - 1); ANYWHERE tries starts t in [0, K) and
    reads zero bytes past K (predicates.py:96-137 of the JAX package).
    """
    b, k = keys.shape
    dev = keys.device
    if filter_type == FT_NO_FILTER or pattern_len == 0:
        return torch.ones(b, dtype=torch.bool, device=dev)
    p = pattern_len
    pat = pattern[:p]
    start = region_start.to(torch.int64)
    length = region_len.to(torch.int64)
    fits = length >= p
    jp = torch.arange(p, device=dev)
    if filter_type in (FT_MATCH_PREFIX, FT_MATCH_POSTFIX):
        offs = start if filter_type == FT_MATCH_PREFIX else start + length - p
        idx = (offs[:, None] + jp[None, :]).clamp(0, k - 1)
        window = torch.gather(keys, 1, idx)
        return (window == pat[None, :]).all(dim=1) & fits
    if filter_type != FT_MATCH_ANYWHERE:
        raise ValueError(f"unknown filter type {filter_type}")
    padded = torch.cat([keys, torch.zeros((b, p), dtype=keys.dtype,
                                          device=dev)], dim=1)
    window_ok = torch.ones((b, k), dtype=torch.bool, device=dev)
    for j in range(p):
        window_ok &= padded[:, j:j + k] == pat[j]
    t = torch.arange(k, device=dev)
    t_ok = ((t[None, :] >= start[:, None])
            & (t[None, :] <= (start + length - p)[:, None]))
    return (window_ok & t_ok).any(dim=1) & fits


def ttl_expired(expire_ts: torch.Tensor, now: int) -> torch.Tensor:
    """bool[B]: expired iff 0 < expire_ts <= now (value_schema.h:113),
    compared as unsigned 32-bit values."""
    ets = u32(expire_ts)
    return (ets > 0) & (ets <= (int(now) & 0xFFFFFFFF))


class ScanMasks(NamedTuple):
    """Per-record outcome masks, mutually exclusive, reference precedence
    (pegasus_server_impl.cpp:2382): expired -> hash_invalid -> filtered."""

    keep: torch.Tensor
    expired: torch.Tensor
    hash_invalid: torch.Tensor
    filtered: torch.Tensor


def pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """uint8[ceil(B/8)]: `jnp.packbits` of a bool mask — big-endian within
    each byte, the tail zero-padded."""
    b = mask.shape[0]
    bits = torch.zeros(-(-b // 8) * 8, dtype=torch.int32, device=mask.device)
    bits[:b] = mask.to(torch.int32)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                           device=mask.device)
    return (bits.view(-1, 8) * weights).sum(dim=1).to(torch.uint8)


def unpack_mask(packed: torch.Tensor, count: int) -> torch.Tensor:
    """bool[count] of `pack_mask`'s bytes, on their device."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    return ((packed[:, None] >> shifts) & 1).reshape(-1)[:count].bool()


def split_gate(validate_hash: bool, pidx, partition_version: int) -> bool:
    """The reject-all split-safety gate of a scalar `pidx`
    (pegasus_server_impl.cpp:2392-2401): pv < 0 or pidx > pv."""
    return (validate_hash and isinstance(pidx, int)
            and (partition_version < 0 or pidx > partition_version))


def static_block_predicate(block: RecordBlock,
                           hash_filter: Optional[FilterSpec] = None,
                           sort_filter: Optional[FilterSpec] = None,
                           validate_hash: bool = False,
                           pidx=0,
                           partition_version: int = -1,
                           pack: bool = False) -> torch.Tensor:
    """bool[B] (or packed uint8[ceil(B/8)]): records passing every
    `now`-independent predicate — filters and partition-hash validation.
    keep(now) == static_keep & ~expired(now), applied on the host from
    the block's expire_ts column. `pidx` is an int or a per-record int32
    column. The kernel writes the mask packed; `pack=False` unpacks it
    on the block's device."""
    from pegasus_tpu_torch.ops.fused_scan import scan_table

    dev = block.device
    if split_gate(validate_hash, pidx, partition_version):
        keep = torch.zeros(block.capacity, dtype=torch.bool, device=dev)
        return pack_mask(keep) if pack else keep
    packed = scan_table([block], [pidx], hash_filter or FilterSpec.none(dev),
                        sort_filter or FilterSpec.none(dev), validate_hash,
                        partition_version)
    return packed if pack else unpack_mask(packed, block.capacity)


def scan_block_predicate(block: RecordBlock, now: int,
                         hash_filter: Optional[FilterSpec] = None,
                         sort_filter: Optional[FilterSpec] = None,
                         validate_hash: bool = False,
                         pidx=0,
                         partition_version: int = -1) -> ScanMasks:
    """The full scan validation of a block at second `now`. When the
    scalar-`pidx` gate rejects, every non-expired record is hash-invalid
    (the reference checks expiry first, pegasus_server_impl.cpp:2392)."""
    from pegasus_tpu_torch.ops.fused_scan import (
        STATUS_EXPIRED,
        STATUS_FILTERED,
        STATUS_HASH_INVALID,
        STATUS_KEEP,
        scan_table,
    )

    dev = block.device
    if split_gate(validate_hash, pidx, partition_version):
        expired = ttl_expired(block.expire_ts, now) & block.valid
        zeros = torch.zeros(block.capacity, dtype=torch.bool, device=dev)
        return ScanMasks(zeros, expired, block.valid & ~expired, zeros)
    status = scan_table([block], [pidx], hash_filter or FilterSpec.none(dev),
                        sort_filter or FilterSpec.none(dev), validate_hash,
                        partition_version, now=now)
    return ScanMasks(status == STATUS_KEEP, status == STATUS_EXPIRED,
                     status == STATUS_HASH_INVALID, status == STATUS_FILTERED)


def multi_static_block_predicate_submit(block, filters, validate_hash: bool,
                                        pidx, partition_version: int
                                        ) -> torch.Tensor:
    """K filter flavours' static keep masks in one launch, without
    waiting: uint8[K, bytes] packed masks on the blocks' device, one
    flavour a row (predicates.py:586 of the JAX package).

    `block` is one RecordBlock with `pidx` an int or an int32 column, or
    a table: a list of up to MAX_TABLE_BLOCKS blocks with `pidx` a list
    of one int or column per block, each block's mask starting on its own
    byte of every row. `filters`: [(hash FilterSpec, sort FilterSpec)],
    all of one filter type pair (callers group by exactly that). A lone
    block with a scalar pidx keeps the reject-all split gate of
    static_block_predicate, and then launches nothing; a table carries
    per-block pidx and no gate, as the JAX stack carries a pidx column."""
    from pegasus_tpu_torch.ops.fused_scan import scan_table_multi

    if isinstance(block, RecordBlock):
        if split_gate(validate_hash, pidx, partition_version):
            return torch.zeros((len(filters), -(-block.capacity // 8)),
                               dtype=torch.uint8, device=block.device)
        block, pidx = [block], [pidx]
    return scan_table_multi(block, pidx, filters, validate_hash,
                            partition_version)


def multi_static_block_predicate(block: RecordBlock, filters,
                                 validate_hash: bool, pidx,
                                 partition_version: int) -> np.ndarray:
    """Synchronous form of multi_static_block_predicate_submit for one
    block: bool[K, capacity] host masks."""
    packed = multi_static_block_predicate_submit(
        block, filters, validate_hash, pidx, partition_version)
    return unpack_masks(packed, block.capacity)


def host_alive_mask(expire_ts: np.ndarray, now: int) -> np.ndarray:
    """bool[B] numpy twin of ~ttl_expired: rows NOT expired at `now`."""
    ets = np.asarray(expire_ts)
    return ~((ets > 0) & (ets <= np.uint32(now)))


def unpack_masks(packed, count: int) -> np.ndarray:
    """uint8[..., B//8] packed masks (tensor or array) -> bool[..., count]."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    return np.unpackbits(np.asarray(packed), axis=-1,
                         count=count).astype(bool)


# ---- host half: direct compute on encoded blocks and point probes ----
# (the port's copy of pegasus_tpu/ops/predicates.py:286-532)

def _region_filter_host(heap: np.ndarray, offs: np.ndarray,
                        filter_type: int, pattern: bytes) -> np.ndarray:
    """bool[n] pattern match over ragged byte regions
    heap[offs[i]:offs[i+1]], one native call (packer.cpp
    pegasus_region_filter). Device-kernel semantics: empty pattern
    matches everything; a region shorter than the pattern never
    matches."""
    from pegasus_tpu_torch import native

    n = len(offs) - 1
    if filter_type == FT_NO_FILTER or not pattern:
        return np.ones(n, dtype=bool)
    out = np.empty(n, dtype=np.uint8)
    native.region_filter_fn()(
        np.ascontiguousarray(heap),
        np.ascontiguousarray(offs, dtype=np.int64), n, pattern,
        filter_type, out)
    return out.astype(bool)


def region_filter_plain(heap: np.ndarray, offs: np.ndarray,
                        filter_type: int, pattern: bytes) -> np.ndarray:
    """Scalar twin of `_region_filter_host` (a host_match_filter loop),
    the plain version the tests hold the native filter against."""
    n = len(offs) - 1
    hv = np.asarray(heap)
    return np.fromiter(
        (host_match_filter(hv[offs[i]:offs[i + 1]].tobytes(),
                           filter_type, pattern) for i in range(n)),
        dtype=bool, count=n)


# probes answered from a compressed block's encoded form, with no key
# matrix rebuilt and no device launch
_ENCODED_PROBE = METRICS.entity("storage", "node").relaxed_counter(
    "encoded_probe_count")


def encoded_static_keep(enc, validate_hash: bool, pidx: int,
                        partition_version: int,
                        filter_key) -> Optional[np.ndarray]:
    """bool[n] static keep mask of an EncodedBlock
    (storage/block_codec.py), bit-identical to
    `static_block_predicate` over the decoded block — evaluated
    entirely on the HOST against the encoded representation:

    - partition-hash validation reads the raw `hash_lo` column;
    - the hashkey filter evaluates once per DICTIONARY entry (D unique
      hashkeys, not n rows) and gathers per-row through the index
      column;
    - the sortkey filter runs over the packed sortkey heap (no padded
      key matrix, no zero-byte scanning).

    Returns None when the block cannot take this path (malformed rows
    present — the device kernel's hashkey_len semantics differ there).
    TTL stays the caller's per-second host mask, exactly as on the
    device path (static masks are `now`-independent).
    """
    if enc.has_malformed:
        return None
    n = enc.n
    hft, hfp, sft, sfp = filter_key
    if validate_hash and (partition_version < 0
                          or pidx > partition_version):
        # split-safety reject-all gate, mirroring static_block_predicate
        _ENCODED_PROBE.increment()
        return np.zeros(n, dtype=bool)
    keep = np.asarray(enc.key_len) >= 2
    if validate_hash:
        pv = np.uint32(partition_version & 0xFFFFFFFF)
        keep = keep & ((np.asarray(enc.hash_lo) & pv)
                       == np.uint32(pidx))
    if hft != FT_NO_FILTER and hfp:
        do = np.asarray(enc.dict_offs, dtype=np.int64)
        per_dict = _region_filter_host(enc.dict_heap, do, hft, hfp)
        keep = keep & per_dict[enc.hk_idx]
    if sft != FT_NO_FILTER and sfp:
        keep = keep & _region_filter_host(enc.sk_heap, enc.sk_offs,
                                          sft, sfp)
    _ENCODED_PROBE.increment()
    return keep


def pad_probe_keys(probe_keys, width: int):
    """(uint8[P, width] padded rows, int64[P] lengths) for a batch of
    exact-match probe keys. Keys longer than `width` cannot exist in a
    block of that key width; their rows are zeroed and flagged by
    length so point_probe_rows reports them absent."""
    p = len(probe_keys)
    lens = np.fromiter((len(k) for k in probe_keys), dtype=np.int64,
                       count=p)
    buf = bytearray(p * width)
    for i, k in enumerate(probe_keys):
        if len(k) <= width:
            off = i * width
            buf[off:off + len(k)] = k
    return (np.frombuffer(bytes(buf), dtype=np.uint8).reshape(p, width),
            lens)


def point_probe_rows(keys_matrix: np.ndarray, key_len: np.ndarray,
                     probe_keys, block_void=None) -> np.ndarray:
    """Vectorized exact-key probe into ONE sorted columnar block.

    keys_matrix: uint8[N, W] zero-padded sorted rows (SST block order);
    key_len: int[N]; probe_keys: list[bytes]; block_void: optional
    precomputed memcmp-ordered void view of keys_matrix (cached per
    block by page.probe_nat). Returns int64[P] row indices (-1 =
    absent). One np.searchsorted over the void view locates every probe
    at once — the batched replacement for per-key Python bisects on the
    point-get hot path; no key materialization, so cold blocks probe as
    fast as hot ones.

    Zero padding makes two keys differing only in TRAILING zero bytes
    pad to identical rows; such twins are adjacent and sorted by true
    length, so the rare collision resolves with a short forward scan.
    """
    n, w = keys_matrix.shape
    p = len(probe_keys)
    if p == 0 or n == 0:
        return np.full(p, -1, dtype=np.int64)
    vt = np.dtype((np.void, w))
    if block_void is None:
        block_void = np.ascontiguousarray(keys_matrix).view(vt).ravel()
    if p <= 4:
        # scalar fast path: the common flush shape scatters 1-2 keys
        # per block, where the batch verify's array setup costs more
        # than the probes
        rows = np.full(p, -1, dtype=np.int64)
        for i, k in enumerate(probe_keys):
            lk = len(k)
            if lk > w:
                continue
            padded = k.ljust(w, b"\x00")
            pos = int(np.searchsorted(
                block_void, np.frombuffer(padded, dtype=vt))[0])
            while pos < n and block_void[pos].tobytes() == padded:
                if int(key_len[pos]) == lk:
                    rows[i] = pos
                    break
                pos += 1  # trailing-zero twin: true match is ahead
        return rows
    pm, lens = pad_probe_keys(probe_keys, w)
    probe_v = pm.view(vt).ravel()
    pos = np.searchsorted(block_void, probe_v)
    rows = np.full(p, -1, dtype=np.int64)
    in_range = (pos < n) & (lens <= w)
    cand = np.flatnonzero(in_range)
    if cand.size:
        cpos = pos[cand]
        same = (keys_matrix[cpos] == pm[cand]).all(axis=1)
        exact = same & (np.asarray(key_len)[cpos] == lens[cand])
        rows[cand[exact]] = cpos[exact]
        # padded-equal but length-mismatched: trailing-zero twins ahead
        for i in cand[same & ~exact]:
            j = int(pos[i]) + 1
            want = int(lens[i])
            while j < n and block_void[j] == probe_v[i]:
                if int(key_len[j]) == want:
                    rows[i] = j
                    break
                j += 1
    return rows


def phash_verify_rows(keys_matrix: np.ndarray, key_len: np.ndarray,
                      rows: np.ndarray, probe_keys) -> np.ndarray:
    """bool[P]: does block row rows[i] hold EXACTLY probe_keys[i]?

    The perfect-hash probe's fingerprint-collision rejector: the index
    (storage/phash.py) maps a batched flush straight to (block, slot)
    rows, and this one vectorized compare per touched block confirms
    each located row before it serves — a collision (~0.08% of absent
    keys) must read as "absent", never as another row's value. Scalar
    fast path below the same threshold as point_probe_rows (the 1-4
    key flush shape)."""
    p = len(probe_keys)
    if p == 0:
        return np.zeros(0, dtype=bool)
    n, w = keys_matrix.shape
    kl = np.asarray(key_len)
    if p <= 4:
        out = np.zeros(p, dtype=bool)
        for i, k in enumerate(probe_keys):
            r = int(rows[i])
            lk = len(k)
            out[i] = (lk <= w and int(kl[r]) == lk
                      and keys_matrix[r, :lk].tobytes() == k)
        return out
    pm, lens = pad_probe_keys(probe_keys, w)
    fits = lens <= w
    rows = np.asarray(rows, dtype=np.int64)
    same = (keys_matrix[rows] == pm).all(axis=1)
    return same & fits & (kl[rows] == lens)


def bloom_key_hashes(keys) -> np.ndarray:
    """uint64[B] full-key crc64 for a batch of probe keys — the hash
    input EVERY sidecar structure shares (bloom filters and the
    perfect-hash index probe the same column), evaluated once per read
    flush and consumed by every table/run the flush's candidates
    touch.

    Compute-trivial per byte, so it always runs on the host: small
    batches take the scalar crc64 (one call a key beats the batch call's
    array setup), larger flushes one `crc64_rows` pass over the padded
    key matrix.
    """
    n = len(keys)
    if n == 0:
        return np.zeros(0, dtype=np.uint64)
    from pegasus_tpu_torch.base.crc import crc64, crc64_rows

    if n < 16:
        return np.fromiter((crc64(k) for k in keys), dtype=np.uint64,
                           count=n)
    width = max(1, max(len(k) for k in keys))
    mat, lens = pad_probe_keys(keys, width)
    return crc64_rows(mat, lens)


def bloom_probe_rows(bloom, hashes: np.ndarray) -> np.ndarray:
    """bool[B]: may each hashed probe key be present in `bloom`
    (storage.bloom.BloomFilter)? False is definitive — the caller skips
    that run/table without decoding a block. One vectorized pass
    answers the whole flush; a filterless table answers all-True.

    This is the batch-evaluation form the coalesced read flush feeds
    (LSM-OPD's direct-on-format idea: membership for N keys is k
    vectorized gathers over the bit array, not N scalar walks).
    """
    if bloom is None:
        return np.ones(len(hashes), dtype=bool)
    return bloom.may_contain_hashes(hashes)


def host_key_hash_lo(hash_keys, sort_keys=None) -> np.ndarray:
    """uint32[B] low lane of pegasus_key_hash for a key batch, evaluated
    with ONE vectorized crc64 pass (base.crc.crc64_batch) instead of a
    per-key scalar crc loop — the batched probe-eval form of
    key_hash_parts used by the point-read coordinator's split-staleness
    gate. Empty hash keys hash by their sort key (pegasus_key_schema
    .h:150); compute-trivial per byte, so it runs on the host."""
    from pegasus_tpu_torch.base.crc import crc64_batch

    regions = list(hash_keys)
    if sort_keys is not None:
        regions = [hk if hk else sk
                   for hk, sk in zip(hash_keys, sort_keys)]
    b = len(regions)
    if b == 0:
        return np.zeros(0, dtype=np.uint32)
    width = max(1, max(len(r) for r in regions))
    mat, lens = pad_probe_keys(regions, width)
    return (crc64_batch(mat, lens, start=0)
            & np.uint64(0xFFFFFFFF)).astype(np.uint32)
