"""ctypes loader + thin wrapper for the native C++ wire client.

Parity role: a second-language client (the reference ships Go/Java/C++
clients over one wire format). The C ABI (wire_client.cpp, the JAX
package's source as it is) is the bindable surface; this module is the
Python convenience binding and the build-on-first-use loader. As with
packer.cpp (native/__init__.py), the library is built with g++ into the
package's git-ignored `_build/` when it is missing or older than its
source, and a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

from pegasus_tpu_torch.native import BUILD_DIR

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "wire_client.cpp")
_SO = os.path.join(BUILD_DIR, "libpegasus_wire_client.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build() -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # per-process temporary: concurrent builds never share a file
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        result = subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC,
             "-o", tmp],
            capture_output=True, text=True, timeout=180)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ not runnable: {e}") from e
    if result.returncode != 0:
        raise RuntimeError(f"g++ failed ({result.returncode}):\n"
                           f"{result.stdout}{result.stderr}")
    os.replace(tmp, _SO)


def load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO) or (
                os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            _build()
        lib = ctypes.CDLL(_SO)
        lib.pegc_open.restype = ctypes.c_void_p
        lib.pegc_open.argtypes = [ctypes.c_char_p] * 6
        lib.pegc_close.argtypes = [ctypes.c_void_p]
        lib.pegc_refresh.argtypes = [ctypes.c_void_p]
        lib.pegc_partition_count.restype = ctypes.c_long
        lib.pegc_partition_count.argtypes = [ctypes.c_void_p]
        lib.pegc_set.restype = ctypes.c_int
        lib.pegc_set.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_long]
        lib.pegc_del.restype = ctypes.c_int
        lib.pegc_del.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int]
        lib.pegc_get.restype = ctypes.c_int
        lib.pegc_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        lib.pegc_last_error.restype = ctypes.c_char_p
        lib.pegc_last_error.argtypes = [ctypes.c_void_p]
        lib.pegc_crc64.restype = ctypes.c_uint64
        lib.pegc_crc64.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.pegc_multi_get.restype = ctypes.c_int
        lib.pegc_multi_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_long)]
        lib.pegc_scan_open.restype = ctypes.c_void_p
        lib.pegc_scan_open.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_long]
        lib.pegc_scan_next.restype = ctypes.c_int
        lib.pegc_scan_next.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        lib.pegc_scan_close.argtypes = [ctypes.c_void_p]
        lib.pegc_check_and_set.restype = ctypes.c_int
        lib.pegc_check_and_set.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int)]
        lib.pegc_check_and_mutate.restype = ctypes.c_int
        lib.pegc_check_and_mutate.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        _lib = lib
        return _lib


class NativeClient:
    """The C client, bound: set/get/del over the live cluster wire."""

    def __init__(self, name: str, address_book: dict, metas: list,
                 app_name: str,
                 auth: Optional[Tuple[str, str]] = None) -> None:
        lib = load()
        self._lib = lib
        book = ";".join(f"{n}={h}:{p}" for n, (h, p) in
                        address_book.items())
        user, token = auth if auth else ("", "")
        self._h = lib.pegc_open(
            name.encode(), book.encode(), ",".join(metas).encode(),
            app_name.encode(), user.encode(), token.encode())

    def refresh(self) -> bool:
        return self._lib.pegc_refresh(self._h) == 0

    @property
    def partition_count(self) -> int:
        return self._lib.pegc_partition_count(self._h)

    def set(self, hk: bytes, sk: bytes, value: bytes,
            expire_ts: int = 0) -> int:
        return self._lib.pegc_set(self._h, hk, len(hk), sk, len(sk),
                                  value, len(value), expire_ts)

    def get(self, hk: bytes, sk: bytes) -> Tuple[int, bytes]:
        cap = 1 << 20
        buf = ctypes.create_string_buffer(cap)
        out_len = ctypes.c_int(0)
        status = self._lib.pegc_get(self._h, hk, len(hk), sk, len(sk),
                                    buf, cap, ctypes.byref(out_len))
        if status != 0:
            return status, b""
        return 0, buf.raw[:out_len.value]

    def delete(self, hk: bytes, sk: bytes) -> int:
        return self._lib.pegc_del(self._h, hk, len(hk), sk, len(sk))

    def multi_get(self, hk: bytes) -> Tuple[int, dict]:
        """All (sort_key, value) pairs of one hash key."""
        import struct

        cap = 1 << 20
        while True:
            buf = ctypes.create_string_buffer(cap)
            out_len = ctypes.c_long(0)
            st = self._lib.pegc_multi_get(self._h, hk, len(hk), buf, cap,
                                          ctypes.byref(out_len))
            if st == -2:
                cap = out_len.value + 16
                continue
            if st != 0:
                return st, {}
            blob = buf.raw[:out_len.value]
            (n,) = struct.unpack_from("<I", blob, 0)
            pos = 4
            out = {}
            for _ in range(n):
                (kl,) = struct.unpack_from("<I", blob, pos)
                pos += 4
                k = blob[pos:pos + kl]
                pos += kl
                (vl,) = struct.unpack_from("<I", blob, pos)
                pos += 4
                out[k] = blob[pos:pos + vl]
                pos += vl
            return 0, out

    def scan(self, hk: bytes, batch_size: int = 100):
        """Iterate (sort_key, value) for one hash key via the native
        paging scanner (get_scanner -> scan -> clear_scanner)."""
        s = self._lib.pegc_scan_open(self._h, hk, len(hk), batch_size)
        if not s:
            raise RuntimeError("scan_open failed")
        sk_cap, v_cap = 1 << 16, 1 << 20
        sk_buf = ctypes.create_string_buffer(sk_cap)
        v_buf = ctypes.create_string_buffer(v_cap)
        sk_len = ctypes.c_int(0)
        v_len = ctypes.c_int(0)
        try:
            while True:
                rc = self._lib.pegc_scan_next(
                    s, sk_buf, sk_cap, ctypes.byref(sk_len),
                    v_buf, v_cap, ctypes.byref(v_len))
                if rc == 1:
                    return
                if rc == -3:
                    # row larger than the buffers: grow to the exact
                    # reported sizes and re-read (row not consumed)
                    sk_cap = max(sk_cap, sk_len.value)
                    v_cap = max(v_cap, v_len.value)
                    sk_buf = ctypes.create_string_buffer(sk_cap)
                    v_buf = ctypes.create_string_buffer(v_cap)
                    continue
                if rc != 0:
                    raise RuntimeError(f"scan error {rc}")
                yield (sk_buf.raw[:sk_len.value],
                       v_buf.raw[:v_len.value])
        finally:
            self._lib.pegc_scan_close(s)

    def check_and_set(self, hk: bytes, check_sk: bytes, check_type: int,
                      operand: bytes, set_sk: bytes, set_value: bytes,
                      ttl_seconds: int = 0) -> Tuple[int, bool]:
        exist = ctypes.c_int(0)
        st = self._lib.pegc_check_and_set(
            self._h, hk, len(hk), check_sk, len(check_sk), check_type,
            operand, len(operand), set_sk, len(set_sk),
            set_value, len(set_value), ttl_seconds, ctypes.byref(exist))
        return st, bool(exist.value)

    def check_and_mutate(self, hk: bytes, check_sk: bytes,
                         check_type: int, operand: bytes, mutate_op: int,
                         m_sk: bytes, m_value: bytes = b""
                         ) -> Tuple[int, bool]:
        exist = ctypes.c_int(0)
        st = self._lib.pegc_check_and_mutate(
            self._h, hk, len(hk), check_sk, len(check_sk), check_type,
            operand, len(operand), mutate_op, m_sk, len(m_sk),
            m_value, len(m_value), ctypes.byref(exist))
        return st, bool(exist.value)

    def last_error(self) -> str:
        return self._lib.pegc_last_error(self._h).decode()

    def close(self) -> None:
        if self._h:
            self._lib.pegc_close(self._h)
            self._h = None
