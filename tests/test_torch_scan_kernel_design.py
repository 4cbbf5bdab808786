"""The scan kernel's arithmetic, rehearsed on the CPU.

No CUDA code runs here, so the arithmetic that csrc/key_hash.cuh and the
flavour axis of csrc/scan_predicate.cu carry out is modelled in numpy,
step for step, and held against the JAX package, bit for bit:

- the slicing tables the key hash reads (ops/fused_scan.crc_slices):
  entry [i][b] is the crc64 step of byte b followed by i zero bytes, and
  row 0 is TABLE64;
- a numpy model of `key_hash_lo` (bytes 2 and 3 one at a time, whole
  words of 4 bytes through the tables, a partial last word a byte at a
  time, the malformed-row tail reading row[K - 1]) equals
  pegasus_tpu.ops.device_crc.key_hash_device on seeded rows at K = 32, 64
  and 256, malformed headers and key lengths under 2 included;
- a numpy model of the flavour axis' 8-byte sortkey window (three staged
  words funnel-shifted where the window lies in the row, else gathered
  byte by byte at clip(i, 0, K - 1); the bytes outside the region set, so
  that one masked xor decides a flavour of up to 8 bytes, its length
  check included; the exact matcher for longer ones) equals the JAX
  package's
  `match_filter` for PREFIX and POSTFIX patterns of 0 to 12 bytes over
  regions that are short, negative or past K; the staged tile's padding
  is random, so a mask that let a byte outside the pattern through would
  show;
- the flavour axis' pattern buffer (ops/fused_scan._pattern_buffer)
  decodes back to the flavours, in its staged order (the sortkey
  window's short patterns first) with each flavour's output row;
- the launch path's checked-block cache (ops/fused_scan._descriptors)
  packs the kernel's BlockDesc layout, and still refuses a block of the
  wrong dtype, device or width, also under a reused id.
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import random_block_columns
from pegasus_tpu.base.crc import TABLE64_NP as JTABLE64
from pegasus_tpu.ops import device_crc as jcrc
from pegasus_tpu.ops import predicates as jpred
from pegasus_tpu_torch.ops import fused_scan
from pegasus_tpu_torch.ops.predicates import (
    FT_MATCH_ANYWHERE,
    FT_MATCH_POSTFIX,
    FT_MATCH_PREFIX,
    FT_NO_FILTER,
)
from pegasus_tpu_torch.ops.record_block import RecordBlock, block_from_columns

M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1


# ---- the slicing tables --------------------------------------------------

def _crc_step(crc: int, byte: int) -> int:
    return int(JTABLE64[(crc ^ byte) & 0xFF]) ^ (crc >> 8)


@pytest.mark.parametrize("i", range(fused_scan.CRC_SLICES))
def test_slicing_table_is_a_byte_then_zero_bytes(i):
    tables = fused_scan.crc_slices()
    assert tables.shape == (fused_scan.CRC_SLICES, 256)
    assert np.array_equal(tables[0], JTABLE64)
    assert fused_scan.crc_tables(torch.device("cpu")).numpy().view(
        np.uint64).tolist() == tables.ravel().tolist()
    for b in range(256):
        crc = _crc_step(0, b)
        for _ in range(i):
            crc = _crc_step(crc, 0)
        assert int(tables[i, b]) == crc, (i, b)


# ---- the word-at-a-time key hash -----------------------------------------

def key_hash_model(row: np.ndarray, klen: int, hkl: int,
                   tables: np.ndarray) -> int:
    """key_hash_lo (and key_hash_lo32, its K = 32 row unrolled over
    eight words) of csrc/key_hash.cuh over one padded row, step for step:
    the lo lane of the crc64 of bytes [2, 2 + n)."""
    k = row.shape[0]
    t = [[int(v) for v in tables[i]] for i in range(4)]
    words = [int(w) for w in row.view("<u4")]

    def byte(crc, b):
        return t[0][(crc ^ b) & 0xFF] ^ (crc >> 8)

    def word(crc, w):
        a = (crc ^ w) & M32
        return ((crc >> 32) ^ t[3][a & 0xFF] ^ t[2][(a >> 8) & 0xFF]
                ^ t[1][(a >> 16) & 0xFF] ^ t[0][a >> 24])

    n = min(max(hkl if hkl > 0 else klen - 2, 0), k)
    end = 2 + min(n, k - 2)
    crc = M64
    if end > 2:
        crc = byte(crc, (words[0] >> 16) & 0xFF)
    if end > 3:
        crc = byte(crc, words[0] >> 24)
    pos = 4
    while pos + 4 <= end:
        crc = word(crc, words[pos // 4])
        pos += 4
    if pos < end:
        w = words[pos // 4]
        for i in range(3):
            if pos + i < end:
                crc = byte(crc, (w >> (8 * i)) & 0xFF)
    for _ in range(end - 2, n):
        crc = byte(crc, int(row[k - 1]))
    return ~crc & M32


def _hash_rows(k: int, seed: int):
    """Seeded rows of width k: random_block_columns' (padding, headers
    shorter than 2 bytes, malformed headers up to 40 bytes past the row),
    and random bytes with hashkey lengths at and past K and key lengths
    of 0 to K + 3."""
    rng = np.random.default_rng(1000 * seed + k)
    keys, key_len, _ets, _hl = random_block_columns(rng, 160, k)
    hkl = np.where(key_len >= 2, (keys[:, 0].astype(np.int32) << 8)
                   | keys[:, 1], 0).astype(np.int32)
    raw = rng.integers(0, 256, (64, k), dtype=np.uint8)
    rlen = rng.integers(0, k + 4, 64).astype(np.int32)
    rhkl = (rng.random(64) * np.maximum(rlen - 1, 1)).astype(np.int32)
    rhkl[::4] = 0
    rhkl[1:9] = [k - 2, k - 1, k, k + 7, 1, 2, 3, 6]
    rlen[9:14] = [0, 1, 2, k, k + 3]
    return (np.concatenate([keys, raw]), np.concatenate([key_len, rlen]),
            np.concatenate([hkl, rhkl]))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("k", [32, 64, 256])
def test_word_at_a_time_key_hash_matches_jax(k, seed):
    keys, key_len, hkl = _hash_rows(k, seed)
    _hi, want = jcrc.key_hash_device(jnp.asarray(keys), jnp.asarray(key_len),
                                     jnp.asarray(hkl))
    want = np.asarray(want).astype(np.int64)
    tables = fused_scan.crc_slices()
    got = np.array([key_hash_model(keys[i], int(key_len[i]), int(hkl[i]),
                                   tables)
                    for i in range(keys.shape[0])], dtype=np.int64)
    assert np.array_equal(got, want)


# ---- the 8-byte sortkey window -------------------------------------------

def _funnel_r(lo: int, hi: int, sh: int) -> int:
    return (((hi << 32) | lo) >> sh) & M32


def _fixed_model(row: np.ndarray, offs: int, pattern: bytes) -> bool:
    """match_fixed: the pattern at offs, bytes read at clip(offs + j, 0,
    K - 1)."""
    k = row.shape[0]
    return all(int(row[min(max(offs + j, 0), k - 1)]) == c
               for j, c in enumerate(pattern))


def window_match_model(tile: np.ndarray, r: int, k: int, hkl: int,
                       klen: int, pattern: bytes, ftype: int):
    """(match, decided by the window) of staged row r for one sortkey
    flavour, as scan_table_multi_kernel<*, kSortWindow> decides it for a
    record that passed the ownership check: `tile` holds the staged rows
    at a stride of k + 4, with nothing after the last."""
    base = r * (k + 4)
    row = tile[base:base + k]
    sstart, slen = 2 + hkl, klen - 2 - hkl
    p = len(pattern)
    ws = klen - 8 if ftype == FT_MATCH_POSTFIX else sstart
    if 0 <= ws and ws + 8 <= k:
        at = base + (ws & ~3)
        w0, w1, w2 = (int(v) for v in tile[at:at + 12].view("<u4"))
        sh = (ws & 3) * 8
        win = (_funnel_r(w1, w2, sh) << 32) | _funnel_r(w0, w1, sh)
    else:
        win = 0
        for i in range(7, -1, -1):
            win = (win << 8) | int(row[min(max(ws + i, 0), k - 1)])
    # the window's bytes outside the region: a pattern reaching them is
    # longer than the region
    c = min(max(slen, 0), 8)
    region = 0 if c == 0 else ((1 << 8 * c) - 1) << (
        8 * (8 - c) if ftype == FT_MATCH_POSTFIX else 0)
    outside = ~region & M64
    if p <= 8:
        pat, mask = fused_scan._window(pattern, ftype)
        return (((win ^ pat) | outside) & mask) == 0, True
    offs = sstart if ftype == FT_MATCH_PREFIX else klen - p
    return slen >= p and _fixed_model(row, offs, pattern), False


def _window_rows(rng, n: int, k: int):
    """Rows over a two-letter alphabet (so that short patterns match),
    with sortkey regions that are empty, short (klen under 8: the
    POSTFIX window shifted up), in range, ending at K, negative
    (malformed headers, negative hashkey lengths) and past K (key lengths
    beyond the row)."""
    keys = rng.choice(np.frombuffer(b"ab", dtype=np.uint8), (n, k))
    klen = rng.integers(2, k + 1, n).astype(np.int32)
    hkl = (rng.random(n) * (klen - 1)).astype(np.int32)
    klen[:12] = [2, 3, 4, 5, 6, 7, 8, 9, k, k, k + 3, k + 9]
    hkl[:12] = [0, 0, 1, 0, 2, 0, 3, 0, 0, k - 3, 4, 0]
    hkl[12:18] = [k, k + 6, -1, -3, 40, -2]
    klen[18:22] = [0, 1, k + 1, k + 2]
    return keys, klen, hkl


@pytest.mark.parametrize("plen", range(13))
@pytest.mark.parametrize("ftype", [FT_MATCH_PREFIX, FT_MATCH_POSTFIX])
def test_sortkey_window_matches_jax(ftype, plen):
    k, n = 32, 240
    rng = np.random.default_rng(100 * ftype + plen)
    keys, klen, hkl = _window_rows(rng, n, k)
    # the staged tile: rows at a stride of k + 4, garbage in between
    tile = rng.integers(0, 256, n * (k + 4), dtype=np.uint8)
    for r in range(n):
        tile[r * (k + 4):r * (k + 4) + k] = keys[r]
    # the pattern is cut from a row whose region holds it, so that some
    # rows match
    fit = np.nonzero((klen - 2 - hkl >= plen) & (klen <= k)
                     & (hkl >= 0))[0]
    r0 = int(fit[int(rng.integers(0, len(fit)))])
    region = keys[r0, 2 + hkl[r0]:klen[r0]]
    pattern = (region[:plen] if ftype == FT_MATCH_PREFIX
               else region[len(region) - plen:]).tobytes()
    got, took = zip(*(window_match_model(tile, r, k, int(hkl[r]),
                                         int(klen[r]), pattern, ftype)
                      for r in range(n)))
    pat = np.zeros(max(plen, 1), dtype=np.uint8)
    pat[:plen] = np.frombuffer(pattern, dtype=np.uint8)
    start = (2 + hkl).astype(np.int32)
    want = jpred.match_filter(jnp.asarray(keys), jnp.asarray(start),
                              jnp.asarray(klen - start), jnp.asarray(pat),
                              jnp.int32(plen), ftype)
    assert np.array_equal(np.array(got), np.asarray(want))
    assert all(took) == (plen <= 8)
    assert all(got) if plen == 0 else any(got) and not all(got)


# ---- the pattern buffer --------------------------------------------------

@pytest.mark.parametrize("sft", range(4))
@pytest.mark.parametrize("hft", range(4))
def test_pattern_buffer_decodes_to_the_flavours(hft, sft):
    rng = np.random.default_rng(16 * hft + sft)
    raws = tuple((rng.choice(np.frombuffer(b"abcd", np.uint8),
                             int(rng.integers(0, 14))).tobytes(),
                  rng.choice(np.frombuffer(b"abcd", np.uint8),
                             int(rng.integers(0, 14))).tobytes())
                 for _ in range(int(rng.integers(1, 12))))
    buf, hpitch, spitch, n_short, need_hash, need_sort = \
        fused_scan._pattern_buffer(torch.device("cpu"), raws, hft, sft)
    buf = buf.numpy()
    k = len(raws)
    windows = buf[:16 * k].view("<u8").reshape(k, 2)
    lens = buf[16 * k:24 * k].view("<i4").reshape(k, 2)
    rows = buf[24 * k:28 * k].view("<i4")
    at = 28 * k
    hpats = buf[at:at + k * hpitch].reshape(k, hpitch)
    spats = buf[at + k * hpitch:].reshape(k, spitch)
    assert hpitch % 4 == 0 and spitch % 4 == 0
    assert buf.shape[0] == at + k * (hpitch + spitch)
    # the staged order: every flavour once; for the sortkey window's
    # pairs the flavours of at most 8 sortkey bytes first, each group in
    # the callers' order
    assert sorted(rows) == list(range(k))
    window_pair = hft == FT_NO_FILTER and sft in (FT_MATCH_PREFIX,
                                                  FT_MATCH_POSTFIX)
    short = [f for f in range(k) if len(raws[f][1]) <= 8]
    want_rows = (short + [f for f in range(k) if f not in short]
                 if window_pair else list(range(k)))
    assert rows.tolist() == want_rows
    assert n_short == (len(short) if window_pair else 0)
    for f, row in enumerate(rows):
        h, s = raws[row]
        hl = len(h) if hft != FT_NO_FILTER else 0
        sl = len(s) if sft != FT_NO_FILTER else 0
        assert tuple(lens[f]) == (hl, sl)
        assert hpats[f, :hl].tobytes() == h[:hl] and not hpats[f, hl:].any()
        assert spats[f, :sl].tobytes() == s[:sl] and not spats[f, sl:].any()
        pat, mask = (int(v) for v in windows[f])
        if sft in (FT_MATCH_PREFIX, FT_MATCH_POSTFIX) and 0 < sl <= 8:
            shown = [(pat >> (8 * i)) & 0xFF for i in range(8)
                     if (mask >> (8 * i)) & 0xFF == 0xFF]
            assert bytes(shown) == s
            low = (mask & 0xFF) == 0xFF
            assert low == (sft == FT_MATCH_PREFIX or sl == 8)
        else:
            assert pat == mask == 0
    assert need_hash == int(any(lens[:, 0]))
    assert need_sort == int(any(lens[:, 1]))
    assert sft != FT_MATCH_ANYWHERE or not windows.any()


# ---- the launch path's checked blocks ------------------------------------

_OLD_DESC = struct.Struct("<7QIiqii")  # BlockDesc, one struct


def _cpu_block(rng, n: int, k: int = 32, hash_lo: bool = True):
    keys, key_len, ets, hl = random_block_columns(rng, n, k)
    return block_from_columns(keys, key_len, ets,
                              hash_lo=hl if hash_lo else None, capacity=n)


@pytest.fixture
def fresh_cache(monkeypatch):
    monkeypatch.setattr(fused_scan, "_CHECKED", type(fused_scan._CHECKED)())
    return fused_scan._CHECKED


def test_descriptors_pack_the_blockdesc_layout(fresh_cache):
    rng = np.random.default_rng(1)
    blocks = [_cpu_block(rng, n) for n in (100, 0, 257)]
    blocks[2] = blocks[2]._replace(hash_lo=None)
    col = torch.zeros(257, dtype=torch.int32)
    pidxs = [5, 3, col]
    want = []
    offset = 0
    for block, pidx in zip(blocks, pidxs):
        ptrs = [0 if t is None else t.data_ptr() for t in block]
        pc, sc = (pidx.data_ptr(), 0) if isinstance(pidx, torch.Tensor) \
            else (0, pidx)
        want.append(_OLD_DESC.pack(*ptrs, pc, sc, block.capacity, offset,
                                   0, 0))
        offset += -(-block.capacity // 8)
    for _ in range(2):  # the first call checks, the second hits
        descs, k, out_bytes, hashed = fused_scan._descriptors(
            blocks, pidxs, packed=True)
        assert descs == b"".join(want)
        assert (k, out_bytes, hashed) == (32, offset, True)
    assert len(fresh_cache) == 3
    _d, _k, _o, hashed = fused_scan._descriptors(blocks[:2], [5, 3], True)
    assert not hashed


@pytest.mark.parametrize("bad", ["dtype", "device", "length", "contiguous"])
def test_cached_descriptors_still_refuse_a_bad_block(fresh_cache, bad):
    rng = np.random.default_rng(2)
    good = _cpu_block(rng, 64)
    fused_scan._descriptors([good], [0], True)
    if bad == "dtype":
        block = good._replace(expire_ts=good.expire_ts.to(torch.int64))
    elif bad == "device":
        block = good._replace(key_len=torch.empty(64, dtype=torch.int32,
                                                  device="meta"))
    elif bad == "length":
        block = good._replace(valid=good.valid[:63])
    else:
        block = good._replace(hashkey_len=torch.zeros(
            (64, 2), dtype=torch.int32)[:, 0])
    for _ in range(2):  # a refused block is not cached
        with pytest.raises(ValueError):
            fused_scan._descriptors([block], [0], True)
    # the same block under the id of a checked one: its columns differ
    fresh_cache[id(block)] = fresh_cache[id(good)]
    with pytest.raises(ValueError):
        fused_scan._descriptors([block], [0], True)


def test_cached_block_in_a_table_of_another_width(fresh_cache):
    rng = np.random.default_rng(3)
    narrow, wide = _cpu_block(rng, 64, 32), _cpu_block(rng, 64, 64)
    fused_scan._descriptors([narrow], [0], True)
    fused_scan._descriptors([wide], [0], True)
    for blocks in ([narrow, wide], [wide, narrow]):
        with pytest.raises(ValueError, match="key width"):
            fused_scan._descriptors(blocks, [0, 0], True)
    odd = RecordBlock(torch.zeros((64, 48), dtype=torch.uint8),
                      *narrow[1:])
    with pytest.raises(ValueError, match="power of two"):
        fused_scan._descriptors([odd], [0], True)


def test_cached_block_in_a_table_on_another_device(fresh_cache):
    rng = np.random.default_rng(5)
    block = _cpu_block(rng, 64)
    fused_scan._descriptors([block], [0], True)
    meta = RecordBlock(*(torch.empty_like(t, device="meta") for t in block))
    for blocks in ([meta, block], [block, meta]):
        with pytest.raises(ValueError, match="one device"):
            fused_scan._descriptors(blocks, [0, 0], True)


def test_checked_block_cache_is_bounded_and_rechecks_rebuilt_blocks(
        fresh_cache, monkeypatch):
    monkeypatch.setattr(fused_scan, "_CHECKED_MAX", 4)
    rng = np.random.default_rng(4)
    blocks = [_cpu_block(rng, 40) for _ in range(6)]
    for block in blocks:
        fused_scan._descriptors([block], [0], True)
    assert len(fresh_cache) == 4
    assert id(blocks[-1]) in fresh_cache and id(blocks[0]) not in fresh_cache
    # a block rebuilt around a new column of the same values is checked
    # anew and packs the new column's pointer
    rebuilt = blocks[-1]._replace(expire_ts=blocks[-1].expire_ts.clone())
    fresh_cache[id(rebuilt)] = fresh_cache[id(blocks[-1])]
    descs, *_ = fused_scan._descriptors([rebuilt], [0], True)
    assert struct.unpack_from("<6Q", descs)[3] == rebuilt.expire_ts.data_ptr()
