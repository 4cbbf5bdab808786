"""crc64 / crc32, bit-compatible with the reference's hashing.

The reference (src/utils/crc.cpp) uses reflected table-driven CRCs with
~init/~final conventions:
- crc32: the Castagnoli polynomial (CRC-32C).
- crc64: a custom rDSN polynomial given as the bit set of x^(63-n)
  coefficients in reflected order (src/utils/crc.cpp:289-295).

crc64(hashkey) is the routing hash: clients map records to partitions with
`crc64(hashkey) % partition_count` and servers validate ownership with
`crc64 & partition_version` (src/base/pegasus_key_schema.h:176-183), so it
must be bit-identical everywhere. crc32 frames every WAL record and the
SST index.

Because ~init is applied on entry and ~crc on exit, chaining
crc(b, init=crc(a)) equals crc(a+b).
"""

from __future__ import annotations

import numpy as np

_M64 = (1 << 64) - 1
_M32 = (1 << 32) - 1

_CRC64_BITS = (63, 61, 59, 58, 56, 55, 52, 49, 48, 47, 46, 44, 41, 37, 36, 34,
               32, 31, 28, 26, 23, 22, 19, 16, 13, 12, 10, 9, 6, 4, 3, 0)
CRC64_POLY = 0
for _n in _CRC64_BITS:
    CRC64_POLY |= 1 << (63 - _n)

_CRC32_BITS = (28, 27, 26, 25, 23, 22, 20, 19, 18, 14, 13, 11, 10, 9, 8, 6, 0)
CRC32_POLY = 0
for _n in _CRC32_BITS:
    CRC32_POLY |= 1 << (31 - _n)


def _make_table(poly: int) -> list[int]:
    table = []
    for i in range(256):
        k = i
        for _ in range(8):
            k = (k >> 1) ^ poly if k & 1 else k >> 1
        table.append(k)
    return table


_TABLE64 = _make_table(CRC64_POLY)
_TABLE32 = _make_table(CRC32_POLY)
TABLE64_NP = np.array(_TABLE64, dtype=np.uint64)
TABLE32_NP = np.array(_TABLE32, dtype=np.uint32)


def crc64(data: bytes, init_crc: int = 0) -> int:
    """Scalar crc64, parity: dsn::utils::crc64_calc (src/utils/crc.cpp:464)."""
    crc = ~init_crc & _M64
    for b in data:
        crc = _TABLE64[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return ~crc & _M64


def crc64_batch(data: np.ndarray, lengths: np.ndarray,
                start: np.ndarray | int = 0) -> np.ndarray:
    """Vectorized crc64 over a batch of byte rows.

    data:    uint8[B, K] padded byte rows
    lengths: int[B] number of valid bytes per row (from `start`)
    start:   int or int[B] byte offset where each row's region begins

    Returns uint64[B]. Iterates over byte positions, each step vectorized
    across the batch.
    """
    data = np.ascontiguousarray(data, dtype=np.uint8)
    b, k = data.shape
    lengths = np.asarray(lengths, dtype=np.int64)
    starts = np.broadcast_to(np.asarray(start, dtype=np.int64), (b,))
    crc = np.full(b, _M64, dtype=np.uint64)
    max_len = int(lengths.max()) if b else 0
    cols = np.arange(b)
    eight = np.uint64(8)
    for j in range(max_len):
        active = j < lengths
        pos = np.minimum(starts + j, k - 1)
        byte = data[cols, pos].astype(np.uint64)
        idx = ((crc ^ byte) & np.uint64(0xFF)).astype(np.int64)
        nxt = TABLE64_NP[idx] ^ (crc >> eight)
        crc = np.where(active, nxt, crc)
    return ~crc


def crc64_rows(data: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """crc64 of each zero-padded byte row, uint64[B]: one native call
    (packer.cpp pegasus_crc64_rows) hashes every row of a block or every
    probe key of a point-read flush for the bloom and perfect-hash
    sidecars. `crc64_batch` is its plain twin (bit-identical)."""
    global _crc64_rows_native
    if _crc64_rows_native is None:
        from pegasus_tpu_torch.native import crc64_rows_fn

        _crc64_rows_native = crc64_rows_fn()
    rows = np.ascontiguousarray(data, dtype=np.uint8)
    lens = np.ascontiguousarray(lengths, dtype=np.int64)
    out = np.empty(rows.shape[0], dtype=np.uint64)
    if rows.shape[0]:
        _crc64_rows_native(rows, lens, out)
    return out


_crc64_rows_native = None


def _crc32_register(data, reg: int) -> int:
    for b in data:
        reg = _TABLE32[(reg ^ b) & 0xFF] ^ (reg >> 8)
    return reg


# Long buffers (WAL frames of a bulk load, SST indexes) are hashed in
# parallel lanes: the register update is linear over GF(2), so
# reg(A || B, r) = shift_len(B)(reg(A, r)) ^ reg(B, 0). The lanes run as
# one numpy loop over _LANE byte positions; the lane registers are then
# folded in order through the shift-by-_LANE-zero-bytes operator, kept as
# four byte-indexed tables.
_LANE = 512
_CHUNKED_MIN = 8 * _LANE
_shift_tables: np.ndarray | None = None


def _lane_shift_tables() -> np.ndarray:
    global _shift_tables
    if _shift_tables is None:
        basis = (np.arange(256, dtype=np.uint32)[None, :]
                 << (8 * np.arange(4, dtype=np.uint32))[:, None])
        reg = basis.copy()
        for _ in range(_LANE):
            reg = TABLE32_NP[reg & 0xFF] ^ (reg >> np.uint32(8))
        _shift_tables = reg
    return _shift_tables


def _crc32_lanes(data: bytes, reg: int) -> int:
    n_lanes = len(data) // _LANE
    head = len(data) - n_lanes * _LANE
    reg = _crc32_register(data[:head], reg)
    rows = np.frombuffer(data, dtype=np.uint8, offset=head).reshape(
        n_lanes, _LANE)
    lanes = np.zeros(n_lanes, dtype=np.uint32)
    eight = np.uint32(8)
    for j in range(_LANE):
        lanes = TABLE32_NP[(lanes ^ rows[:, j]) & 0xFF] ^ (lanes >> eight)
    s0, s1, s2, s3 = (t.tolist() for t in _lane_shift_tables())
    for lane in lanes.tolist():
        reg = (s0[reg & 0xFF] ^ s1[(reg >> 8) & 0xFF]
               ^ s2[(reg >> 16) & 0xFF] ^ s3[reg >> 24] ^ lane)
    return reg


def crc32(data: bytes, init_crc: int = 0) -> int:
    """Scalar crc32 (CRC-32C), parity: dsn::utils::crc32_calc: one native
    call (packer.cpp pegasus_crc32). The WAL frames and SST indexes of
    every write go through it, where the Python table loop of
    `crc32_plain` cost more than the rest of a multi_put."""
    global _crc32_native
    if _crc32_native is None:
        from pegasus_tpu_torch.native import crc32_fn

        _crc32_native = crc32_fn()
    return _crc32_native(data, init_crc)


_crc32_native = None


def crc32_plain(data: bytes, init_crc: int = 0) -> int:
    """Plain twin of `crc32` (a table loop, lanes for long buffers), the
    version the tests hold the native function against."""
    reg = ~init_crc & _M32
    if len(data) >= _CHUNKED_MIN:
        reg = _crc32_lanes(bytes(data), reg)
    else:
        reg = _crc32_register(data, reg)
    return ~reg & _M32
