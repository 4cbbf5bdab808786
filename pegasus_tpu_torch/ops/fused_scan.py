"""The scan-predicate kernel: counterpart of pegasus_tpu/ops/pallas_scan.py.

`scan_status` gives one status byte per record of a RecordBlock — PAD,
KEEP, EXPIRED, HASH_INVALID or FILTERED, in the reference's precedence
(validate_key_value_for_scan, pegasus_server_impl.cpp:2382). Both serving
predicates (ops/predicates.static_block_predicate without `now`,
scan_block_predicate with it) and the Pallas contract `fused_scan_block`
read their masks from it.

On a CUDA block it launches the hand-written kernel in
csrc/scan_predicate.cu, built with nvcc for sm_90a at first use into
`_build/` and bound through ctypes; on a CPU block it runs
`scan_status_plain`, the plain torch version the CPU tests and
chip_smoke.py hold the kernel against. A CUDA block either launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Optional, Tuple

import torch

from pegasus_tpu_torch.ops.predicates import (
    FT_MATCH_ANYWHERE,
    FT_MATCH_POSTFIX,
    FT_MATCH_PREFIX,
    FT_NO_FILTER,
    FilterSpec,
    match_filter,
    ttl_expired,
)
from pegasus_tpu_torch.ops.record_block import RecordBlock, u32

STATUS_PAD = 0
STATUS_KEEP = 1
STATUS_EXPIRED = 2
STATUS_HASH_INVALID = 3
STATUS_FILTERED = 4

# kernel launches by mode: "static" (no `now`) and "now"; a launch made by
# the wrapper adds one here, nothing else does
LAUNCHES = {"static": 0, "now": 0}

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG_DIR, "csrc", "scan_predicate.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_LIB_PATH = os.path.join(BUILD_DIR, "libscan_predicate.so")

_lib = None
_lib_lock = threading.Lock()


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
    missing, older than its source, or `force` is set. Returns the
    seconds spent and nvcc's output (ptxas' register and shared-memory
    report); raises when nvcc fails."""
    t0 = time.perf_counter()
    if (not force and os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SOURCE)):
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
            fn = lib.pegasus_scan_predicate
            p, u32, i32 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int
            fn.argtypes = [p, p, p, p, p, p, p, u32, u32, i32, i32, p, i32,
                           i32, p, i32, i32, u32, p, i32, i32, p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _pattern_len(spec: FilterSpec) -> int:
    return 0 if spec.filter_type == FT_NO_FILTER else spec.pattern_len


def _launch(block: RecordBlock, hash_filter: FilterSpec,
            sort_filter: FilterSpec, validate_hash: bool, pidx,
            partition_version: int, now: Optional[int]) -> torch.Tensor:
    dev = block.device
    b, k = block.keys.shape
    expected = ((block.keys, torch.uint8), (block.key_len, torch.int32),
                (block.hashkey_len, torch.int32),
                (block.expire_ts, torch.int32), (block.valid, torch.bool),
                (block.hash_lo, torch.int32))
    for t, dtype in expected:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"scan kernel needs contiguous {dtype} on {dev}, "
                             f"got {t.dtype} on {t.device}")
    if tuple(t.shape[0] for t, _ in expected) != (b,) * 6:
        raise ValueError("record block columns differ in length")
    for spec in (hash_filter, sort_filter):
        if spec.filter_type not in (FT_NO_FILTER, FT_MATCH_ANYWHERE,
                                    FT_MATCH_PREFIX, FT_MATCH_POSTFIX):
            raise ValueError(f"unknown filter type {spec.filter_type}")
        if spec.pattern.device != dev:
            raise ValueError(f"filter pattern on {spec.pattern.device}, "
                             f"block on {dev}")
    pidx_col = None
    pidx_scalar = 0
    if isinstance(pidx, torch.Tensor):
        pidx_col = pidx
        if (pidx.device != dev or pidx.dtype != torch.int32
                or pidx.shape != (b,) or not pidx.is_contiguous()):
            raise ValueError("per-record pidx must be int32[B] on the "
                             "block's device")
    else:
        pidx_scalar = int(pidx) & 0xFFFFFFFF
    if b == 0:
        # nothing to launch, so nothing to count
        return torch.empty(0, dtype=torch.uint8, device=dev)
    out = torch.empty(b, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().pegasus_scan_predicate(
        block.keys.data_ptr(), block.key_len.data_ptr(),
        block.hashkey_len.data_ptr(), block.expire_ts.data_ptr(),
        block.valid.data_ptr(), block.hash_lo.data_ptr(),
        None if pidx_col is None else pidx_col.data_ptr(),
        pidx_scalar, partition_version & 0xFFFFFFFF, int(validate_hash),
        hash_filter.filter_type, hash_filter.pattern.data_ptr(),
        _pattern_len(hash_filter), sort_filter.filter_type,
        sort_filter.pattern.data_ptr(), _pattern_len(sort_filter),
        int(now is not None), 0 if now is None else int(now) & 0xFFFFFFFF,
        out.data_ptr(), b, k, stream)
    if err != 0:
        raise RuntimeError(f"scan_predicate launch failed: cuda error {err}")
    LAUNCHES["static" if now is None else "now"] += 1
    return out


def scan_status_plain(block: RecordBlock, hash_filter: FilterSpec,
                      sort_filter: FilterSpec, validate_hash: bool, pidx,
                      partition_version: int,
                      now: Optional[int] = None) -> torch.Tensor:
    """Plain torch version of the kernel, on any device: uint8[B]."""
    valid = block.valid
    if now is None:
        expired = torch.zeros_like(valid)
    else:
        expired = ttl_expired(block.expire_ts, now) & valid
    if validate_hash:
        owner = (u32(pidx) if isinstance(pidx, torch.Tensor)
                 else int(pidx) & 0xFFFFFFFF)
        hash_ok = ((u32(block.hash_lo) & (partition_version & 0xFFFFFFFF))
                   == owner)
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


def scan_status(block: RecordBlock, hash_filter: FilterSpec,
                sort_filter: FilterSpec, validate_hash: bool, pidx,
                partition_version: int,
                now: Optional[int] = None) -> torch.Tensor:
    """uint8[B] record status on the block's device: the kernel on CUDA,
    the plain version on the CPU. `pidx` is an int or an int32[B]
    column; `now=None` evaluates the static (`now`-free) predicate."""
    if block.keys.is_cuda:
        return _launch(block, hash_filter, sort_filter, validate_hash, pidx,
                       partition_version, now)
    if block.keys.device.type != "cpu":
        raise ValueError(f"no scan predicate for device {block.device}")
    return scan_status_plain(block, hash_filter, sort_filter, validate_hash,
                             pidx, partition_version, now)


def fused_scan_block(block: RecordBlock, now: int,
                     sort_filter: Optional[FilterSpec] = None,
                     pidx: int = 0, partition_version: int = -1,
                     validate_hash: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keep, expired) bool masks: the Pallas kernel's contract
    (pallas_scan.fused_scan_block), sortkey filter only, with its
    reject-all gate for an invalid ownership state."""
    dev = block.device
    if validate_hash and (partition_version < 0 or pidx > partition_version):
        expired = ttl_expired(block.expire_ts, now) & block.valid
        return torch.zeros_like(block.valid), expired
    status = scan_status(block, FilterSpec.none(dev),
                         sort_filter or FilterSpec.none(dev), validate_hash,
                         pidx, partition_version, now=now)
    return status == STATUS_KEEP, status == STATUS_EXPIRED
