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

# kernel launches by mode: "static" (no `now`), "now", and "multi" (the
# flavour axis), and "keyhash", the launches (of any mode) that took the
# key-hash instance; a launch made by the wrapper adds here, nothing else
# does
LAUNCHES = {"static": 0, "now": 0, "multi": 0, "keyhash": 0}

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG_DIR, "csrc", "scan_predicate.cu")
# the matcher and the key hash, shared with compaction_filter.cu
_HEADERS = (os.path.join(_PKG_DIR, "csrc", "match.cuh"),
            os.path.join(_PKG_DIR, "csrc", "key_hash.cuh"))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_LIB_PATH = os.path.join(BUILD_DIR, "libscan_predicate.so")

_lib = None
_lib_lock = threading.Lock()


# one block of a table, `BlockDesc` in csrc/scan_predicate.cu: seven
# column pointers, pidx, count, out_offset, first_tile, reserved
_DESC = struct.Struct("<7QIiqii")
assert _DESC.size == 80

# RecordBlock's columns in field order, as the kernel reads them
_COLUMN_DTYPES = (torch.uint8, torch.int32, torch.int32, torch.int32,
                  torch.bool, torch.int32)


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


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(_LIB_PATH)
            fn = lib.pegasus_scan_table
            p, u32_, i32 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int
            fn.argtypes = [ctypes.c_char_p, i32, i32, u32_, i32, i32, p,
                           i32, i32, p, i32, i32, u32_, p, p, p]
            fn.restype = ctypes.c_int
            fn = lib.pegasus_scan_table_multi
            fn.argtypes = [ctypes.c_char_p, i32, i32, u32_, i32, i32, p,
                           i32, i32, p, i32, p, i32, i32, i32,
                           ctypes.c_int64, p, p, p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


@functools.lru_cache(maxsize=8)
def crc_table(device: torch.device) -> torch.Tensor:
    """The crc64 table (256 entries) on `device`, for the kernels' key
    hash: one host-to-device copy a device."""
    return torch.from_numpy(TABLE64_NP.view(np.int64).copy()).to(device)


def _hashes_keys(blocks: Sequence[RecordBlock], validate_hash: bool) -> bool:
    """Does this table take the key-hash instance: validation on, and a
    non-empty block without a stored hash_lo column?"""
    return validate_hash and any(b.hash_lo is None and b.capacity
                                 for b in blocks)


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


def _descriptors(blocks: Sequence[RecordBlock], pidxs: Sequence,
                 packed: bool) -> Tuple[bytes, int, int]:
    """(the table's packed BlockDesc array, key width, output bytes): each
    block's output takes `count` bytes, or ceil(count / 8) when
    `packed`."""
    if not 1 <= len(blocks) <= MAX_TABLE_BLOCKS:
        raise ValueError(f"a table holds 1..{MAX_TABLE_BLOCKS} blocks, "
                         f"got {len(blocks)}")
    if len(pidxs) != len(blocks):
        raise ValueError("one pidx per block")
    dev = blocks[0].device
    k = blocks[0].key_width
    if k < 32 or k & (k - 1):
        raise ValueError(f"key width {k} is not a power of two >= 32")
    descs = []
    offset = 0
    for block, pidx in zip(blocks, pidxs):
        b = _check_block(block, dev, k)
        if isinstance(pidx, torch.Tensor):
            if (pidx.device != dev or pidx.dtype != torch.int32
                    or pidx.shape != (b,) or not pidx.is_contiguous()):
                raise ValueError("per-record pidx must be int32[B] on the "
                                 "block's device")
            col, scalar = pidx.data_ptr(), 0
        else:
            col, scalar = 0, int(pidx) & 0xFFFFFFFF
        descs.append(_DESC.pack(*(0 if t is None else t.data_ptr()
                                  for t in block), col, scalar,
                                b, offset, 0, 0))
        offset += -(-b // 8) if packed else b
    return b"".join(descs), k, offset


def _launch_table(blocks: Sequence[RecordBlock], pidxs: Sequence,
                  hash_filter: FilterSpec, sort_filter: FilterSpec,
                  validate_hash: bool, partition_version: int,
                  now: Optional[int]) -> torch.Tensor:
    dev = blocks[0].device
    descs, k, offset = _descriptors(blocks, pidxs, packed=now is None)
    _check_filter(hash_filter, dev)
    _check_filter(sort_filter, dev)
    out = torch.empty(offset, dtype=torch.uint8, device=dev)
    if offset == 0:
        # nothing to launch, so nothing to count
        return out
    hash_keys = _hashes_keys(blocks, validate_hash)
    err = _library().pegasus_scan_table(
        descs, len(blocks), k, partition_version & 0xFFFFFFFF,
        int(validate_hash), hash_filter.filter_type,
        hash_filter.pattern.data_ptr(), _pattern_len(hash_filter),
        sort_filter.filter_type, sort_filter.pattern.data_ptr(),
        _pattern_len(sort_filter), int(now is not None),
        0 if now is None else int(now) & 0xFFFFFFFF, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
        crc_table(dev).data_ptr() if hash_keys else 0)
    if err != 0:
        raise RuntimeError(f"scan_predicate launch failed: cuda error {err}")
    LAUNCHES["static" if now is None else "now"] += 1
    if hash_keys:
        LAUNCHES["keyhash"] += 1
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
    if any(b.device != dev for b in blocks):
        raise ValueError("a table's blocks share one device")
    if dev.type == "cuda":
        return _launch_table(blocks, pidxs, hash_filter, sort_filter,
                             validate_hash, partition_version, now)
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


@functools.lru_cache(maxsize=256)
def _pattern_buffer(device: torch.device, raws: Tuple[Tuple[bytes, bytes]],
                    hash_on: bool, sort_on: bool):
    """(device buffer, hpitch, spitch, need_hash, need_sort) of K flavours'
    patterns, as pegasus_scan_table_multi reads them: the hashkey patterns
    at a pitch of hpitch bytes, then the sortkey patterns at spitch (each
    a multiple of 4, zero-padded), then int32 lengths, K hashkey and K
    sortkey (0 under FT_NO_FILTER). One host-to-device copy; cached,
    since a flush re-sends the flavours of the last one."""
    k = len(raws)
    hlens = np.array([len(h) if hash_on else 0 for h, _s in raws],
                     dtype=np.int32)
    slens = np.array([len(s) if sort_on else 0 for _h, s in raws],
                     dtype=np.int32)
    hpitch = max(4, -(-int(hlens.max()) // 4) * 4)
    spitch = max(4, -(-int(slens.max()) // 4) * 4)
    buf = np.zeros(k * (hpitch + spitch) + 8 * k, dtype=np.uint8)
    for f, (h, s) in enumerate(raws):
        buf[f * hpitch:f * hpitch + hlens[f]] = np.frombuffer(
            h[:hlens[f]], dtype=np.uint8)
        so = k * hpitch + f * spitch
        buf[so:so + slens[f]] = np.frombuffer(s[:slens[f]], dtype=np.uint8)
    buf[k * (hpitch + spitch):] = np.concatenate([hlens, slens]).view(
        np.uint8)
    return (torch.from_numpy(buf).to(device), hpitch, spitch,
            int(hlens.any()), int(slens.any()))


def _launch_table_multi(blocks: Sequence[RecordBlock], pidxs: Sequence,
                        flavors, validate_hash: bool,
                        partition_version: int) -> torch.Tensor:
    dev = blocks[0].device
    hft, sft = _flavor_types(flavors)
    descs, k, row_bytes = _descriptors(blocks, pidxs, packed=True)
    n_flavors = len(flavors)
    out = torch.empty((n_flavors, row_bytes), dtype=torch.uint8, device=dev)
    if row_bytes == 0:
        return out
    buf, hpitch, spitch, need_hash, need_sort = _pattern_buffer(
        dev, tuple((hf.raw, sf.raw) for hf, sf in flavors),
        hft != FT_NO_FILTER, sft != FT_NO_FILTER)
    base = buf.data_ptr()
    hash_keys = _hashes_keys(blocks, validate_hash)
    err = _library().pegasus_scan_table_multi(
        descs, len(blocks), k, partition_version & 0xFFFFFFFF,
        int(validate_hash), hft, base, hpitch, sft,
        base + n_flavors * hpitch, spitch,
        base + n_flavors * (hpitch + spitch), n_flavors, need_hash,
        need_sort, row_bytes, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
        crc_table(dev).data_ptr() if hash_keys else 0)
    if err != 0:
        raise RuntimeError(f"scan_predicate multi launch failed: cuda error "
                           f"{err}")
    LAUNCHES["multi"] += 1
    if hash_keys:
        LAUNCHES["keyhash"] += 1
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
    if any(b.device != dev for b in blocks):
        raise ValueError("a table's blocks share one device")
    if dev.type == "cuda":
        return _launch_table_multi(blocks, pidxs, flavors, validate_hash,
                                   partition_version)
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
