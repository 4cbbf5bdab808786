"""The scan-predicate kernel: counterpart of pegasus_tpu/ops/pallas_scan.py.

`scan_table` evaluates a table of up to MAX_TABLE_BLOCKS RecordBlocks of
one key width in one launch. With `now` it gives one status byte per
record — PAD, KEEP, EXPIRED, HASH_INVALID or FILTERED, in the reference's
precedence (validate_key_value_for_scan, pegasus_server_impl.cpp:2382);
without `now` it gives the static keep mask, bit-packed as `pack_mask`
packs it. Both serving predicates (ops/predicates.static_block_predicate
and scan_block_predicate), the stacked evaluation of the columnar path
(server/scan_coordinator.py) and the Pallas contract `fused_scan_block`
read their masks from it. `scan_table_multi` is the kernel's flavour
axis: the static keep masks of K filter flavours over one table in one
launch, one row of packed masks per flavour
(ops/predicates.multi_static_block_predicate_submit).

A block without a stored hash_lo column (`hash_lo` None: a PGT1 file's
block) is hashed where the table validates ownership: on CUDA by the
kernel's key-hash instance (csrc/key_hash.cuh, counted under
LAUNCHES["keyhash"] besides its mode), in the plain version by
ops/device_crc.key_hash_device.

On CUDA blocks it launches the hand-written kernel in
csrc/scan_predicate.cu, built with nvcc for sm_90a at first use into
`_build/` and bound through ctypes; on CPU blocks it runs
`scan_table_plain`, the plain torch version the CPU tests and
chip_smoke.py hold the kernel against. CUDA blocks either launch the
kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import struct
import subprocess
import threading
import time
import weakref
from collections import Counter, OrderedDict
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from pegasus_tpu_torch.base.crc import TABLE64_NP
from pegasus_tpu_torch.ops.device_crc import key_hash_device
from pegasus_tpu_torch.ops.predicates import (
    FT_MATCH_ANYWHERE,
    FT_MATCH_POSTFIX,
    FT_MATCH_PREFIX,
    FT_NO_FILTER,
    FilterSpec,
    match_filter,
    pack_mask,
    split_gate,
    ttl_expired,
)
from pegasus_tpu_torch.ops.record_block import RecordBlock, u32

STATUS_PAD = 0
STATUS_KEEP = 1
STATUS_EXPIRED = 2
STATUS_HASH_INVALID = 3
STATUS_FILTERED = 4

# blocks one launch takes (kMaxBlocks in csrc/scan_predicate.cu)
MAX_TABLE_BLOCKS = 16
# flavours one flavour-axis launch takes (kMaxFlavors)
MAX_FLAVORS = 4096

# kernel launches by mode: "static" (no `now`), "now", and "multi" (the
# flavour axis), and "keyhash", the launches (of any mode) that took the
# key-hash instance; a launch made by the wrapper adds here, nothing else
# does
LAUNCHES = {"static": 0, "now": 0, "multi": 0, "keyhash": 0}
# the same launches by (mode, card index)
DEVICE_LAUNCHES: Counter = Counter()

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG_DIR, "csrc", "scan_predicate.cu")
# the matcher and the key hash, shared with compaction_filter.cu
_HEADERS = (os.path.join(_PKG_DIR, "csrc", "match.cuh"),
            os.path.join(_PKG_DIR, "csrc", "key_hash.cuh"))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_LIB_PATH = os.path.join(BUILD_DIR, "libscan_predicate.so")

_lib = None
_lib_lock = threading.Lock()


# the six column pointers at the head of a `BlockDesc`
# (csrc/scan_predicate.cu); _table_struct packs the rest
_COLUMNS = struct.Struct("<6Q")

# RecordBlock's columns in field order, as the kernel reads them
_COLUMN_DTYPES = (torch.uint8, torch.int32, torch.int32, torch.int32,
                  torch.bool, torch.int32)

# blocks whose columns passed _check_block, by id(block): (weak
# references to its columns, the device they were checked on, key
# width, record count, packed column pointers, no stored hash). A hit
# needs every column to be the very tensor that was checked, so a freed
# block whose id is reused, or a block rebuilt around other columns, is
# checked anew. Bounded, oldest entry out first, so the entries of freed
# blocks age out.
_CHECKED: "OrderedDict[int, tuple]" = OrderedDict()
_CHECKED_MAX = 4096
_checked_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the scan-predicate kernel builds "
                       "with the CUDA toolkit")


def build(force: bool = False) -> Tuple[float, str]:
    """Compile csrc/scan_predicate.cu into _build/ when the library is
    missing, older than its sources, or `force` is set. Returns the
    seconds spent and nvcc's output (ptxas' register and shared-memory
    report); raises when nvcc fails."""
    t0 = time.perf_counter()
    newest = max(os.path.getmtime(f) for f in (_SOURCE,) + _HEADERS)
    if (not force and os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= newest):
        return 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", tmp, _SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, _LIB_PATH)
    return time.perf_counter() - t0, proc.stdout + proc.stderr


# TableArgs and MultiArgs in csrc/scan_predicate.cu: the entry points'
# arguments beside the block descriptors, packed so that a launch converts
# two ctypes arguments
_TABLE_ARGS = struct.Struct("<5Q2I8i")
_MULTI_ARGS = struct.Struct("<8QqI11i")
assert _TABLE_ARGS.size == 80 and _MULTI_ARGS.size == 120


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(_LIB_PATH)
            for fn in (lib.pegasus_scan_table, lib.pegasus_scan_table_multi):
                fn.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


# slicing tables of the kernels' key hash (kCrcSlices in
# csrc/key_hash.cuh)
CRC_SLICES = 4


def crc_slices() -> np.ndarray:
    """uint64[CRC_SLICES, 256]: entry [i][b] is the crc64 step of byte b
    from a zero state followed by i zero bytes; row 0 is TABLE64."""
    out = np.empty((CRC_SLICES, 256), dtype=np.uint64)
    out[0] = TABLE64_NP
    eight, low = np.uint64(8), np.uint64(0xFF)
    for i in range(1, CRC_SLICES):
        prev = out[i - 1]
        out[i] = (prev >> eight) ^ TABLE64_NP[(prev & low).astype(np.intp)]
    return out


def _stream(dev: torch.device) -> int:
    """The raw handle of `dev`'s current CUDA stream (without building a
    torch.cuda.Stream object a launch)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


@functools.lru_cache(maxsize=8)
def crc_tables(device: torch.device) -> torch.Tensor:
    """The crc64 slicing tables (CRC_SLICES x 256 entries) on `device`,
    for the kernels' key hash: one host-to-device copy a device."""
    return torch.from_numpy(crc_slices().view(np.int64).ravel().copy()).to(
        device)


def _hash_lo_of(block: RecordBlock) -> torch.Tensor:
    """The block's hash_lo column, or the plain key hash of its rows."""
    if block.hash_lo is not None:
        return block.hash_lo
    return key_hash_device(block.keys, block.key_len, block.hashkey_len)[1]


def _pattern_len(spec: FilterSpec) -> int:
    return 0 if spec.filter_type == FT_NO_FILTER else spec.pattern_len


def _check_filter(spec: FilterSpec, dev: torch.device) -> None:
    if spec.filter_type not in (FT_NO_FILTER, FT_MATCH_ANYWHERE,
                                FT_MATCH_PREFIX, FT_MATCH_POSTFIX):
        raise ValueError(f"unknown filter type {spec.filter_type}")
    pat = spec.pattern
    if pat.device != dev:
        raise ValueError(f"filter pattern on {pat.device}, block on {dev}")
    # the kernel reads the pattern in 32-bit words
    if (pat.dtype != torch.uint8 or not pat.is_contiguous()
            or pat.numel() < -(-_pattern_len(spec) // 4) * 4
            or pat.data_ptr() % 4):
        raise ValueError("filter pattern must be contiguous uint8, "
                         "4-byte aligned and padded to 4 bytes")


def _check_block(block: RecordBlock, dev: torch.device, k: int) -> int:
    b, width = block.keys.shape
    if width != k:
        raise ValueError(f"one table holds one key width: {width} != {k}")
    for name, t, dtype in zip(RecordBlock._fields, block, _COLUMN_DTYPES):
        if t is None and name == "hash_lo":
            continue  # no stored hash: the key-hash instance hashes
        if t.dtype != dtype or t.device != dev or not t.is_contiguous():
            raise ValueError(f"scan kernel needs contiguous {dtype} on {dev}, "
                             f"got {t.dtype} on {t.device}")
        if t.shape[0] != b:
            raise ValueError("record block columns differ in length")
    if b and block.keys.data_ptr() % 16:
        raise ValueError("key rows must start 16-byte aligned")
    return b


def _checked_columns(block: RecordBlock, dev: torch.device,
                     k: int) -> Tuple[bytes, int, bool]:
    """(packed column pointers, record count, no stored hash) of a block
    in a table on `dev` of key width `k`: _check_block at the block's
    first launch, the cached result at later ones (the device and the
    width are compared every time)."""
    hit = _CHECKED.get(id(block))
    if hit is not None:
        refs, on, width, count, cols, hashed = hit
        hash_ref = refs[5]
        if (refs[0]() is block[0] and refs[1]() is block[1]
                and refs[2]() is block[2] and refs[3]() is block[3]
                and refs[4]() is block[4]
                and (None if hash_ref is None else hash_ref()) is block[5]):
            if on != dev:
                raise ValueError("a table's blocks share one device")
            if width != k:
                raise ValueError(f"one table holds one key width: {width} "
                                 f"!= {k}")
            return cols, count, hashed
    if block.device != dev:
        raise ValueError("a table's blocks share one device")
    count = _check_block(block, dev, k)
    cols = _COLUMNS.pack(*(0 if t is None else t.data_ptr() for t in block))
    hashed = block.hash_lo is None and count > 0
    entry = (tuple(None if t is None else weakref.ref(t) for t in block),
             dev, k, count, cols, hashed)
    with _checked_lock:
        _CHECKED[id(block)] = entry
        while len(_CHECKED) > _CHECKED_MAX:
            _CHECKED.popitem(last=False)
    return cols, count, hashed


@functools.lru_cache(maxsize=MAX_TABLE_BLOCKS)
def _table_struct(n_blocks: int) -> struct.Struct:
    """A table of n BlockDescs: each its packed column pointers, then the
    pidx column, pidx, count, out_offset, first_tile, reserved."""
    return struct.Struct("<" + "48sQIiqii" * n_blocks)


def _descriptors(blocks: Sequence[RecordBlock], pidxs: Sequence,
                 packed: bool) -> Tuple[bytes, int, int, bool]:
    """(the table's packed BlockDesc array, key width, output bytes,
    whether a non-empty block lacks a stored hash): each block's output
    takes `count` bytes, or ceil(count / 8) when `packed`. Every block
    must lie on the first block's device."""
    if not 1 <= len(blocks) <= MAX_TABLE_BLOCKS:
        raise ValueError(f"a table holds 1..{MAX_TABLE_BLOCKS} blocks, "
                         f"got {len(blocks)}")
    if len(pidxs) != len(blocks):
        raise ValueError("one pidx per block")
    dev = blocks[0].device
    k = blocks[0].key_width
    if k < 32 or k & (k - 1):
        raise ValueError(f"key width {k} is not a power of two >= 32")
    args = []
    offset = 0
    any_hashed = False
    for block, pidx in zip(blocks, pidxs):
        cols, b, hashed = _checked_columns(block, dev, k)
        any_hashed |= hashed
        if isinstance(pidx, (int, np.integer)):
            col, scalar = 0, int(pidx) & 0xFFFFFFFF
        elif isinstance(pidx, torch.Tensor):
            if (pidx.device != dev or pidx.dtype != torch.int32
                    or pidx.shape != (b,) or not pidx.is_contiguous()):
                raise ValueError("per-record pidx must be int32[B] on the "
                                 "block's device")
            col, scalar = pidx.data_ptr(), 0
        else:
            col, scalar = 0, int(pidx) & 0xFFFFFFFF
        args += (cols, col, scalar, b, offset, 0, 0)
        offset += -(-b // 8) if packed else b
    return (_table_struct(len(blocks)).pack(*args), k, offset, any_hashed)


def _launch_table(blocks: Sequence[RecordBlock], pidxs: Sequence,
                  hash_filter: FilterSpec, sort_filter: FilterSpec,
                  validate_hash: bool, partition_version: int,
                  now: Optional[int]) -> torch.Tensor:
    dev = blocks[0].device
    descs, k, offset, hashed = _descriptors(blocks, pidxs,
                                            packed=now is None)
    _check_filter(hash_filter, dev)
    _check_filter(sort_filter, dev)
    out = torch.empty(offset, dtype=torch.uint8, device=dev)
    if offset == 0:
        # nothing to launch, so nothing to count
        return out
    hash_keys = validate_hash and hashed
    args = _TABLE_ARGS.pack(
        hash_filter.pattern.data_ptr(), sort_filter.pattern.data_ptr(),
        out.data_ptr(), _stream(dev),
        crc_tables(dev).data_ptr() if hash_keys else 0,
        partition_version & 0xFFFFFFFF,
        0 if now is None else int(now) & 0xFFFFFFFF, len(blocks), k,
        int(validate_hash), hash_filter.filter_type,
        _pattern_len(hash_filter), sort_filter.filter_type,
        _pattern_len(sort_filter), int(now is not None))
    lib = _library()
    # <<<>>> launches on the calling thread's current device
    with torch.cuda.device(dev):
        err = lib.pegasus_scan_table(args, descs)
    if err != 0:
        raise RuntimeError(f"scan_predicate launch failed: cuda error {err}")
    mode = "static" if now is None else "now"
    LAUNCHES[mode] += 1
    DEVICE_LAUNCHES[mode, dev.index] += 1
    if hash_keys:
        LAUNCHES["keyhash"] += 1
        DEVICE_LAUNCHES["keyhash", dev.index] += 1
    return out


def scan_status_plain(block: RecordBlock, hash_filter: FilterSpec,
                      sort_filter: FilterSpec, validate_hash: bool, pidx,
                      partition_version: int,
                      now: Optional[int] = None) -> torch.Tensor:
    """Plain torch status of one block, on any device: uint8[B]."""
    valid = block.valid
    if now is None:
        expired = torch.zeros_like(valid)
    else:
        expired = ttl_expired(block.expire_ts, now) & valid
    if validate_hash:
        owner = (u32(pidx) if isinstance(pidx, torch.Tensor)
                 else int(pidx) & 0xFFFFFFFF)
        hash_ok = ((u32(_hash_lo_of(block))
                    & (partition_version & 0xFFFFFFFF)) == owner)
    else:
        hash_ok = torch.ones_like(valid)
    two = torch.full_like(block.key_len, 2)
    hk_ok = match_filter(block.keys, two, block.hashkey_len,
                         hash_filter.pattern, hash_filter.pattern_len,
                         hash_filter.filter_type)
    sort_start = 2 + block.hashkey_len
    sk_ok = match_filter(block.keys, sort_start, block.key_len - sort_start,
                         sort_filter.pattern, sort_filter.pattern_len,
                         sort_filter.filter_type)

    def st(code: int) -> torch.Tensor:
        return torch.tensor(code, dtype=torch.uint8, device=valid.device)

    status = torch.where(hk_ok & sk_ok, st(STATUS_KEEP), st(STATUS_FILTERED))
    status = torch.where(hash_ok, status, st(STATUS_HASH_INVALID))
    status = torch.where(expired, st(STATUS_EXPIRED), status)
    return torch.where(valid, status, st(STATUS_PAD))


def scan_table_plain(blocks: Sequence[RecordBlock], pidxs: Sequence,
                     hash_filter: FilterSpec, sort_filter: FilterSpec,
                     validate_hash: bool, partition_version: int,
                     now: Optional[int] = None) -> torch.Tensor:
    """Plain torch version of the kernel, on any device: the blocks'
    status bytes (with `now`) or packed keep masks (without),
    concatenated in table order."""
    parts = []
    for block, pidx in zip(blocks, pidxs):
        status = scan_status_plain(block, hash_filter, sort_filter,
                                   validate_hash, pidx, partition_version,
                                   now)
        parts.append(status if now is not None
                     else pack_mask(status == STATUS_KEEP))
    if not parts:
        return torch.empty(0, dtype=torch.uint8)
    return torch.cat(parts)


def scan_table(blocks: Sequence[RecordBlock], pidxs: Sequence,
               hash_filter: FilterSpec, sort_filter: FilterSpec,
               validate_hash: bool, partition_version: int,
               now: Optional[int] = None) -> torch.Tensor:
    """uint8 on the blocks' device, block after block: `count` status
    bytes each with `now`, the static keep mask packed into
    ceil(count / 8) bytes each without. `pidxs` holds one int or int32[B]
    column per block. The kernel on CUDA, the plain version on the CPU;
    no split gate (the callers apply it)."""
    if not blocks:
        raise ValueError("empty table")
    dev = blocks[0].device
    if dev.type == "cuda":
        # every block's device is checked with its columns
        return _launch_table(blocks, pidxs, hash_filter, sort_filter,
                             validate_hash, partition_version, now)
    if any(b.device != dev for b in blocks):
        raise ValueError("a table's blocks share one device")
    if dev.type != "cpu":
        raise ValueError(f"no scan predicate for device {dev}")
    return scan_table_plain(blocks, pidxs, hash_filter, sort_filter,
                            validate_hash, partition_version, now)


def _flavor_types(flavors: Sequence[Tuple[FilterSpec, FilterSpec]]
                  ) -> Tuple[int, int]:
    """The (hashkey, sortkey) filter types the flavours share."""
    if not flavors:
        raise ValueError("no filter flavours")
    types = {(hf.filter_type, sf.filter_type) for hf, sf in flavors}
    if len(types) != 1:
        raise ValueError(f"one launch takes one filter type pair, got "
                         f"{sorted(types)}")
    hft, sft = types.pop()
    for ft in (hft, sft):
        if ft not in (FT_NO_FILTER, FT_MATCH_ANYWHERE, FT_MATCH_PREFIX,
                      FT_MATCH_POSTFIX):
            raise ValueError(f"unknown filter type {ft}")
    return hft, sft


def _window(pattern: bytes, filter_type: int) -> Tuple[int, int]:
    """(pattern, mask) of a sortkey pattern of up to 8 bytes against the
    kernel's 8-byte window, little-endian: the region's first 8 bytes
    for PREFIX (the pattern in the low bytes), its last 8 for POSTFIX
    (the pattern in the high bytes); (0, 0) for an empty pattern, a
    longer one or another filter type, which the window does not
    decide."""
    p = len(pattern)
    if filter_type not in (FT_MATCH_PREFIX, FT_MATCH_POSTFIX) or not \
            0 < p <= 8:
        return 0, 0
    shift = 0 if filter_type == FT_MATCH_PREFIX else 8 * (8 - p)
    return (int.from_bytes(pattern, "little") << shift,
            ((1 << 8 * p) - 1) << shift)


@functools.lru_cache(maxsize=256)
def _pattern_buffer(device: torch.device, raws: Tuple[Tuple[bytes, bytes]],
                    hft: int, sft: int):
    """(device buffer, hpitch, spitch, n_short, need_hash, need_sort) of K
    flavours' patterns, as pegasus_scan_table_multi reads them. The
    flavours go in a staged order: for a sortkey PREFIX or POSTFIX pair
    without a hashkey filter, the n_short flavours of at most 8 sortkey
    bytes first (the sortkey window's), then the rest, each group in the
    callers' order; for any other pair the callers' order (n_short 0).
    The buffer holds, by staged flavour: K sortkey windows (uint32
    pattern lo, hi, mask lo, hi; `_window`), K (hashkey, sortkey) int32
    lengths (0 under FT_NO_FILTER), K int32 output rows (the flavour's
    index in `raws`), the hashkey patterns at a pitch of hpitch bytes,
    the sortkey patterns at spitch (each pitch a multiple of 4,
    zero-padded). One host-to-device copy; cached, since a flush re-sends
    the flavours of the last one."""
    k = len(raws)
    hlens = [len(h) if hft != FT_NO_FILTER else 0 for h, _s in raws]
    slens = [len(s) if sft != FT_NO_FILTER else 0 for _h, s in raws]
    rows = list(range(k))
    n_short = 0
    if hft == FT_NO_FILTER and sft in (FT_MATCH_PREFIX, FT_MATCH_POSTFIX):
        rows.sort(key=lambda f: slens[f] > 8)
        n_short = sum(n <= 8 for n in slens)
    hpitch = max(4, -(-max(hlens) // 4) * 4)
    spitch = max(4, -(-max(slens) // 4) * 4)
    windows = np.zeros((k, 2), dtype=np.uint64)
    lens = np.zeros((k, 2), dtype=np.int32)
    hpats = np.zeros((k, hpitch), dtype=np.uint8)
    spats = np.zeros((k, spitch), dtype=np.uint8)
    for f, row in enumerate(rows):
        h, s = raws[row]
        hl, sl = hlens[row], slens[row]
        windows[f] = _window(s[:sl], sft)
        lens[f] = hl, sl
        hpats[f, :hl] = np.frombuffer(h[:hl], dtype=np.uint8)
        spats[f, :sl] = np.frombuffer(s[:sl], dtype=np.uint8)
    buf = np.concatenate([windows.view(np.uint8).ravel(),
                          lens.view(np.uint8).ravel(),
                          np.array(rows, dtype=np.int32).view(np.uint8),
                          hpats.ravel(), spats.ravel()])
    return (torch.from_numpy(buf).to(device), hpitch, spitch, n_short,
            int(any(hlens)), int(any(slens)))


def _launch_table_multi(blocks: Sequence[RecordBlock], pidxs: Sequence,
                        flavors, validate_hash: bool,
                        partition_version: int) -> torch.Tensor:
    dev = blocks[0].device
    hft, sft = _flavor_types(flavors)
    n_flavors = len(flavors)
    if n_flavors > MAX_FLAVORS:
        raise ValueError(f"one launch takes at most {MAX_FLAVORS} flavours, "
                         f"got {n_flavors}")
    descs, k, row_bytes, hashed = _descriptors(blocks, pidxs, packed=True)
    out = torch.empty((n_flavors, row_bytes), dtype=torch.uint8, device=dev)
    if row_bytes == 0:
        return out
    buf, hpitch, spitch, n_short, need_hash, need_sort = _pattern_buffer(
        dev, tuple((hf.raw, sf.raw) for hf, sf in flavors), hft, sft)
    windows = buf.data_ptr()
    lens = windows + 16 * n_flavors
    perm = lens + 8 * n_flavors
    hpats = perm + 4 * n_flavors
    hash_keys = validate_hash and hashed
    args = _MULTI_ARGS.pack(
        hpats, hpats + n_flavors * hpitch, lens, windows, perm,
        out.data_ptr(), _stream(dev),
        crc_tables(dev).data_ptr() if hash_keys else 0, row_bytes,
        partition_version & 0xFFFFFFFF, len(blocks), k, int(validate_hash),
        hft, hpitch, sft, spitch, n_flavors, n_short, need_hash, need_sort)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.pegasus_scan_table_multi(args, descs)
    if err != 0:
        raise RuntimeError(f"scan_predicate multi launch failed: cuda error "
                           f"{err}")
    LAUNCHES["multi"] += 1
    DEVICE_LAUNCHES["multi", dev.index] += 1
    if hash_keys:
        LAUNCHES["keyhash"] += 1
        DEVICE_LAUNCHES["keyhash", dev.index] += 1
    return out


def scan_table_multi_plain(blocks: Sequence[RecordBlock], pidxs: Sequence,
                           flavors, validate_hash: bool,
                           partition_version: int) -> torch.Tensor:
    """Plain torch version of the flavour axis, on any device: uint8[K,
    Σ ceil(count / 8)], row k holding flavour k's packed static keep
    masks block after block. `valid & hash_ok` is computed once a block,
    as the kernel does."""
    _flavor_types(flavors)
    dev = blocks[0].device
    rows = [[] for _ in flavors]
    for block, pidx in zip(blocks, pidxs):
        base = block.valid
        if validate_hash:
            owner = (u32(pidx) if isinstance(pidx, torch.Tensor)
                     else int(pidx) & 0xFFFFFFFF)
            base = base & ((u32(_hash_lo_of(block))
                            & (partition_version & 0xFFFFFFFF)) == owner)
        two = torch.full_like(block.key_len, 2)
        sort_start = 2 + block.hashkey_len
        for row, (hf, sf) in zip(rows, flavors):
            keep = (base
                    & match_filter(block.keys, two, block.hashkey_len,
                                   hf.pattern, _pattern_len(hf),
                                   hf.filter_type)
                    & match_filter(block.keys, sort_start,
                                   block.key_len - sort_start, sf.pattern,
                                   _pattern_len(sf), sf.filter_type))
            row.append(pack_mask(keep))
    if not blocks:
        return torch.empty((len(flavors), 0), dtype=torch.uint8, device=dev)
    return torch.stack([torch.cat(row) for row in rows])


def scan_table_multi(blocks: Sequence[RecordBlock], pidxs: Sequence,
                     flavors, validate_hash: bool,
                     partition_version: int) -> torch.Tensor:
    """The flavour axis: uint8[K, Σ ceil(count / 8)] on the blocks'
    device for K `flavors` [(hash FilterSpec, sort FilterSpec)] sharing
    one filter type pair; row k holds flavour k's packed static keep
    masks, block after block, each block's mask starting on its own byte.
    `pidxs` holds one int or int32[B] column per block. One kernel launch
    on CUDA, the plain version on the CPU; no split gate (the callers
    apply it)."""
    if not blocks:
        raise ValueError("empty table")
    dev = blocks[0].device
    if dev.type == "cuda":
        # every block's device is checked with its columns
        return _launch_table_multi(blocks, pidxs, flavors, validate_hash,
                                   partition_version)
    if any(b.device != dev for b in blocks):
        raise ValueError("a table's blocks share one device")
    if dev.type != "cpu":
        raise ValueError(f"no scan predicate for device {dev}")
    return scan_table_multi_plain(blocks, pidxs, flavors, validate_hash,
                                  partition_version)


def fused_scan_block(block: RecordBlock, now: int,
                     sort_filter: Optional[FilterSpec] = None,
                     pidx: int = 0, partition_version: int = -1,
                     validate_hash: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keep, expired) bool masks: the Pallas kernel's contract
    (pallas_scan.fused_scan_block), sortkey filter only, with its
    reject-all gate for an invalid ownership state."""
    dev = block.device
    if split_gate(validate_hash, pidx, partition_version):
        expired = ttl_expired(block.expire_ts, now) & block.valid
        return torch.zeros_like(block.valid), expired
    status = scan_table([block], [pidx], FilterSpec.none(dev),
                        sort_filter or FilterSpec.none(dev), validate_hash,
                        partition_version, now=now)
    return status == STATUS_KEEP, status == STATUS_EXPIRED
