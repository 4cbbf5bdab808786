"""Native host runtime of the port (C++ via ctypes).

`packer.cpp` holds the port's copy of the two response-assembly
functions of pegasus_tpu/native/packer.cpp that the batched scan path
calls (pegasus_gather_page, pegasus_scan_serve_batch). The library is
built with g++ at first use into the git-ignored `_build/` directory of
the package, and rebuilt when the source is newer. A failed build
raises: there is no Python fallback on the serving path (server/page.py
keeps `_gather_python` only as the plain twin the tests hold the native
gather against).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
from typing import Tuple

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
           "-o", tmp]
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
