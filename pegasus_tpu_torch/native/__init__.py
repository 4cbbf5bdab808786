"""Native host runtime of the port (C++ via ctypes).

`packer.cpp` holds the port's copy of the host functions of
pegasus_tpu/native/packer.cpp that the port's paths call: crc64 columns,
the bloom and perfect-hash sidecars, the dcz/dcz2 codec's key rebuild,
region filter and encoded subset, and the batched scan path's response
assembly. The library is built with g++ at first use into the
git-ignored `_build/` directory of the package, and rebuilt when the
source is newer. A failed build raises: there is no Python fallback on
a serving path. The scalar twins (`server/page._gather_python`,
`storage/phash._build_once_py`, `ops/predicates.region_filter_plain`,
`storage/block_codec.key_matrix_plain`) are the plain versions the
tests hold the native functions against.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
from typing import Tuple

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG_DIR, "native", "packer.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_LIB_PATH = os.path.join(BUILD_DIR, "libpegasus_native.so")

_lib = None
_lib_lock = threading.Lock()


def build(force: bool = False) -> Tuple[float, str]:
    """Compile packer.cpp into _build/ when the library is missing, older
    than its source, or `force` is set. Returns the seconds spent and
    g++'s output; raises when g++ fails."""
    t0 = time.perf_counter()
    if (not force and os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SOURCE)):
        return 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    # per-process temporary: concurrent builds never share a file
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SOURCE,
           "-o", tmp, "-ldl"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except OSError as e:
        raise RuntimeError(f"g++ not runnable: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, _LIB_PATH)
    return time.perf_counter() - t0, proc.stdout + proc.stderr


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(_LIB_PATH)
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
            u32, u64 = ctypes.c_uint32, ctypes.c_uint64
            lib.pegasus_crc32.restype = u32
            lib.pegasus_crc32.argtypes = [ctypes.c_char_p, i64, u32]
            lib.pegasus_crc64_rows.restype = None
            lib.pegasus_crc64_rows.argtypes = [p, p, i64, i64, p]
            lib.pegasus_bloom_probe_multi.restype = None
            lib.pegasus_bloom_probe_multi.argtypes = [p, p, p, i64, p, i64,
                                                      p]
            lib.pegasus_phash_build.restype = i32
            lib.pegasus_phash_build.argtypes = [p, p, i64, u64, i64, i64, p,
                                                p]
            lib.pegasus_phash_probe_multi.restype = None
            lib.pegasus_phash_probe_multi.argtypes = [p, p, p, p, p, i64, p,
                                                      i64, p, p]
            lib.pegasus_cblock_decode_keys.restype = None
            lib.pegasus_cblock_decode_keys.argtypes = [p, p, p, p, p, p, i64,
                                                       i64, p]
            lib.pegasus_region_filter.restype = None
            lib.pegasus_region_filter.argtypes = [p, p, i64, p, i64, i32, p]
            lib.pegasus_cblock_subset.restype = i64
            lib.pegasus_cblock_subset.argtypes = [p, i64, p, p, i32, p, i64,
                                                  p, p, p]
            lib.pegasus_gather_page.restype = None
            lib.pegasus_gather_page.argtypes = [
                p, i64, p, p, p, p, i64, i32, p, p, p, p]
            lib.pegasus_scan_serve_batch.restype = None
            lib.pegasus_scan_serve_batch.argtypes = [
                p, p, p, p, p, p, p, i64, p, p, p, p, p, p, i64, i32, p,
                i64, p, i64, p, p, p, p, p, p, p]
            _lib = lib
        return _lib


def gather_page_fn():
    """The page-gather entry point (packer.cpp pegasus_gather_page);
    server/page.py owns the calling convention."""
    return _library().pegasus_gather_page


def scan_serve_fn():
    """The whole-batch scan-assembly entry point (packer.cpp
    pegasus_scan_serve_batch); server/page.py owns the calling
    convention."""
    return _library().pegasus_scan_serve_batch


def crc32_fn():
    """CRC-32C of a buffer (packer.cpp pegasus_crc32): fn(data,
    init_crc=0) -> int."""
    lib = _library()

    def crc32_native(data, init_crc: int = 0) -> int:
        return int(lib.pegasus_crc32(bytes(data), len(data),
                                     init_crc & 0xFFFFFFFF))

    return crc32_native


def crc64_rows_fn():
    """crc64 over zero-padded rows: fn(rows uint8[n, width] C-contiguous,
    lens int64[n], out uint64[n]) fills `out` in place."""
    lib = _library()

    def crc64_rows_native(rows, lens, out) -> None:
        lib.pegasus_crc64_rows(rows.ctypes.data, lens.ctypes.data,
                               rows.shape[0], rows.shape[1],
                               out.ctypes.data)

    return crc64_rows_native


def bloom_probe_multi_fn():
    """The multi-filter bloom probe (storage/bloom.MultiProbe)."""
    lib = _library()

    def probe(addrs, masks, ks, n_filters, hashes, n_keys, out) -> None:
        # addrs/masks uint64[n_filters], ks int32[n_filters],
        # hashes uint64[n_keys], out uint8[n_keys * n_filters]
        lib.pegasus_bloom_probe_multi(
            addrs.ctypes.data, masks.ctypes.data, ks.ctypes.data,
            n_filters, hashes.ctypes.data, n_keys, out.ctypes.data)

    return probe


def phash_build_fn():
    """The CHD perfect-hash build (packer.cpp pegasus_phash_build):
    fn(hashes, locs, seed, ts, nb) -> (slots uint32[ts], disp
    uint16[nb]), or None when this seed cannot place every bucket."""
    lib = _library()

    def build(hashes, locs, seed: int, ts: int, nb: int):
        slots = np.empty(ts, dtype=np.uint32)
        disp = np.empty(nb, dtype=np.uint16)
        rc = lib.pegasus_phash_build(
            hashes.ctypes.data, locs.ctypes.data, hashes.shape[0],
            seed, ts, nb, disp.ctypes.data, slots.ctypes.data)
        if rc != 0:
            return None
        return slots, disp

    return build


def phash_probe_multi_fn():
    """The multi-index perfect-hash probe (storage/phash.PHashMultiProbe)."""
    lib = _library()

    def probe(fixed_ptrs, n_tables, hashes, n_keys, out, hit_out) -> None:
        # fixed_ptrs: slots/disp addresses, ts, nb, seeds (uint64 columns
        # of n_tables, pointers resolved once by the caller); hashes
        # uint64[n_keys]; out uint32 / hit_out uint8 [n_keys * n_tables]
        lib.pegasus_phash_probe_multi(
            *fixed_ptrs, n_tables, hashes.ctypes.data, n_keys,
            out.ctypes.data, hit_out.ctypes.data)

    return probe


def cblock_decode_keys_fn():
    """Key-matrix rebuild of a dcz/dcz2 block (block_codec.key_matrix)."""
    lib = _library()

    def decode_keys(dict_heap, dict_offs, hk_idx, sk_heap, sk_offs,
                    key_len, n, width, out) -> None:
        lib.pegasus_cblock_decode_keys(
            dict_heap.ctypes.data if dict_heap.size else None,
            dict_offs.ctypes.data, hk_idx.ctypes.data,
            sk_heap.ctypes.data if sk_heap.size else None,
            sk_offs.ctypes.data, key_len.ctypes.data, n, width,
            out.ctypes.data)

    return decode_keys


def region_filter_fn():
    """Ragged-region pattern filter (the encoded-probe primitive of
    ops/predicates._region_filter_host)."""
    lib = _library()

    def region_filter(heap, offs, n, pattern: bytes, ftype: int,
                      out) -> None:
        lib.pegasus_region_filter(
            heap.ctypes.data if heap.size else None, offs.ctypes.data,
            n, pattern, len(pattern), ftype, out.ctypes.data)

    return region_filter


def cblock_subset_fn():
    """Encoded-domain block subsetting (packer.cpp pegasus_cblock_subset):
    fn(raw, raw_heap_len, key_width, keep, new_ets, patch_value_headers,
    want_hashes) -> (encoded bytes, crc64 hashes | None, kept n, subset
    raw heap length, first key, last key), or None when the kernel
    cannot take the block (a compressed heap with no zlib/zstd)."""
    lib = _library()

    def subset(raw, raw_heap_len: int, key_width: int, keep, new_ets,
               patch_value_headers: bool, want_hashes: bool):
        a = raw if isinstance(raw, np.ndarray) \
            else np.frombuffer(raw, dtype=np.uint8)
        a = np.ascontiguousarray(a)
        keep_u8 = np.ascontiguousarray(keep, dtype=np.uint8)
        if new_ets is not None:
            new_ets = np.ascontiguousarray(new_ets, dtype=np.uint32)
        # margin covers v2 column growth: a subset can widen a FOR
        # expire_ts section back to raw u32 (up to +4 bytes a row)
        out = np.empty(a.size + raw_heap_len + 4 * keep_u8.size + 4096,
                       dtype=np.uint8)
        hashes = (np.empty(keep_u8.size, dtype=np.uint64)
                  if want_hashes else None)
        out_keys = np.zeros(2 * key_width, dtype=np.uint8)
        out_meta = np.zeros(4, dtype=np.int64)
        rc = lib.pegasus_cblock_subset(
            a.ctypes.data, a.size, keep_u8.ctypes.data,
            new_ets.ctypes.data if new_ets is not None else None,
            1 if patch_value_headers else 0, out.ctypes.data, out.size,
            hashes.ctypes.data if hashes is not None else None,
            out_keys.ctypes.data, out_meta.ctypes.data)
        if rc < 0:
            return None
        m, vsub, fkl, lkl = (int(x) for x in out_meta)
        return (out[:rc].tobytes(),
                hashes[:m].copy() if hashes is not None else None,
                m, vsub, out_keys[:fkl].tobytes(),
                out_keys[key_width:key_width + lkl].tobytes())

    return subset
