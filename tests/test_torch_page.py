"""The port's response-page assembly against the JAX package.

One SST file, written by the JAX package's writer under the slice's
flags (`block_codec = none`), is opened by both packages' readers, and
the same row takes and masks go through
- `build_page` (native pegasus_gather_page) of both packages, and the
  port's native gather against its plain twin `_gather_python`;
- `serve_batch` (native pegasus_scan_serve_batch) of both packages over
  flushes of request windows (mixed wants, masks, no_value, expire_ts).
  The port takes the serving path's 8-tuples (plan, want, no_value,
  want_ets, live masks, plan_geometry, plan_nat, live-mask pointers),
  as prepare_serve builds them; the JAX side takes the same 8-tuples
  or its ad-hoc 6-tuples. Also the five edge cases of
  tests/test_serve_batch_edges.py: byte-budget truncation, row count
  and exhaustion, arena overflow (None), no_value with expire_ts, and
  cached against ad-hoc windows (windows sharing blocks under
  different masks);
- the ScanPage sequence protocol.
Pages are compared blob by blob, with sizes, last keys and truncation
flags: exact. The port builds its native library with g++ at first use.
"""

import numpy as np
import pytest

from pegasus_tpu.server import page as jpage
from pegasus_tpu.server.types import ScanPage as JScanPage
from pegasus_tpu.storage import sstable as jsst
from pegasus_tpu.utils.flags import FLAGS as JFLAGS
from pegasus_tpu_torch.utils.flags import FLAGS as TFLAGS
from pegasus_tpu_torch.base.key_schema import generate_key
from pegasus_tpu_torch.server import page as tpage
from pegasus_tpu_torch.server.types import ScanPage
from pegasus_tpu_torch.storage import sstable as tsst

SLICE_FLAGS = (("pegasus.storage", "block_codec", "none"),
               ("pegasus.server", "bloom_bits_per_key", 0),
               ("pegasus.server", "phash_index", False))
HDR = 4  # value header bytes a page strips


def _set_flags(values, registries=(JFLAGS, TFLAGS)):
    """Set flags in both packages' process-wide registries."""
    for section, name, value in values:
        for reg in registries:
            reg.set(section, name, value, force=True)


@pytest.fixture
def tables(tmp_path):
    """(JAX SSTable, port SSTable) of one file: 300 records in blocks of
    64, keys of mixed widths, values of 0..70 user bytes behind a
    HDR-byte header, a few of them shorter than the header."""
    saved = [[(s, n, reg.get(s, n)) for s, n, _v in SLICE_FLAGS]
             for reg in (JFLAGS, TFLAGS)]
    _set_flags(SLICE_FLAGS)
    rng = np.random.default_rng(3)
    path = str(tmp_path / "t.sst")
    w = jsst.SSTableWriter(path, block_capacity=64)
    keys = sorted({generate_key(b"user%0*d" % (int(rng.integers(4, 40)), i),
                                b"s%02d" % int(rng.integers(0, 10)))
                   for i in range(300)})
    for i, key in enumerate(keys):
        n = int(rng.integers(0, 71))
        value = (b"\x00" * HDR + rng.bytes(n) if i % 13
                 else b"\x00" * (i % HDR))
        w.add(key, value, int(rng.choice([0, 100, 0x80000005])))
    w.finish()
    pair = (jsst.SSTable(path), tsst.SSTable(path))
    yield pair
    for t in pair:
        t.close()
    _set_flags(saved[0], (JFLAGS,))
    _set_flags(saved[1], (TFLAGS,))


def _blocks(tables, i):
    jt, tt = tables
    return jt.read_block(i), tt.read_block(i)


def _page_fields(p):
    return (p.key_offs, p.key_blob, p.val_offs, p.val_blob, p.ets)


def _same_served(got, want):
    assert (got is None) == (want is None)
    if got is None:
        return
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is None:
            continue
        (gp, gs, gk, gt), (wp, ws, wk, wt) = g, w
        assert isinstance(gp, ScanPage)
        assert _page_fields(gp) == _page_fields(wp)
        assert (gs, gk, gt) == (ws, wk, wt)


@pytest.mark.parametrize("no_value", [False, True])
@pytest.mark.parametrize("want_ets", [False, True])
def test_build_page_matches_jax(tables, no_value, want_ets):
    rng = np.random.default_rng(10 + 2 * no_value + want_ets)
    jchunks, tchunks = [], []
    for i in range(len(tables[0].blocks)):
        jb, tb = _blocks(tables, i)
        take = np.flatnonzero(rng.random(tb.count) < 0.4).astype(np.int64)
        jchunks.append((jb, take))
        tchunks.append((tb, take))
    want = jpage.build_page(jchunks, HDR, no_value=no_value,
                            want_ets=want_ets)
    got = tpage.build_page(tchunks, HDR, no_value=no_value,
                           want_ets=want_ets)
    assert _page_fields(got[0]) == _page_fields(want[0])
    assert got[1:] == want[1:]
    assert len(got[0]) == sum(len(t) for _b, t in tchunks)


def test_build_page_of_nothing():
    page, size, last = tpage.build_page([], HDR)
    assert len(page) == 0 and not page and size == 0 and last is None
    assert list(page) == []


@pytest.mark.parametrize("no_value", [False, True])
def test_native_gather_matches_python_twin(tables, no_value):
    rng = np.random.default_rng(20 + no_value)
    _jb, blk = _blocks(tables, 1)
    take = np.flatnonzero(rng.random(blk.count) < 0.5).astype(np.int64)
    n = len(take)
    key_cap = n * blk.keys.shape[1]
    val_cap = int(blk.value_offs[-1])
    outs = []
    for native in (True, False):
        kb = np.zeros(key_cap, np.uint8)
        vb = np.zeros(val_cap, np.uint8)
        ko = np.zeros(n + 1, np.uint32)
        vo = np.zeros(n + 1, np.uint32)
        if native:
            tpage.native.gather_page_fn()(
                blk.keys.ctypes.data, blk.keys.shape[1],
                blk.key_len.ctypes.data, blk.value_offs.ctypes.data,
                np.frombuffer(blk.value_heap, np.uint8).ctypes.data,
                take.ctypes.data, n, HDR, kb.ctypes.data, ko.ctypes.data,
                None if no_value else vb.ctypes.data, vo.ctypes.data)
        else:
            tpage._gather_python(blk, take, HDR, no_value, kb, ko, vb, vo, 0)
        outs.append((kb.tobytes(), vb.tobytes(), ko.tobytes(), vo.tobytes()))
    assert outs[0] == outs[1]
    page, _s, _l = tpage.build_page([(blk, take)], HDR, no_value=no_value)
    kb, vb, ko, vo = outs[1]
    assert page.key_offs == ko and page.val_offs == vo
    assert page.key_blob == kb[:int(np.frombuffer(ko, "<u4")[-1])]


def _full_window(mod, plan, want, no_value, want_ets, masks, geom=None):
    """The serving path's 8-tuple, as prepare_serve builds it."""
    return (plan, want, no_value, want_ets, masks,
            geom or mod.plan_geometry(plan), mod.plan_nat(plan),
            {k: m.ctypes.data for k, m in masks.items()})


def _windows(tables, rng, n_reqs, jax_cached, first_of=None):
    """n_reqs windows over whole blocks of the file, a mask each, as
    (JAX window, port window) pairs. The port's are the serving path's
    8-tuples; the JAX side's too, or its ad-hoc 6-tuples when not
    `jax_cached`. `first_of(r)` picks window r's first block."""
    jt, tt = tables
    out = []
    for r in range(n_reqs):
        first = (int(rng.integers(0, len(tt.blocks))) if first_of is None
                 else first_of(r))
        jplan, tplan, jmasks, tmasks = [], [], {}, {}
        for i in range(first, min(first + int(rng.integers(1, 4)),
                                  len(tt.blocks))):
            jb, tb = _blocks(tables, i)
            ckey = (tt.path, tt.blocks[i].offset)
            lo = int(rng.integers(0, tb.count)) if i == first else 0
            jplan.append((ckey, jb, lo, jb.count))
            tplan.append((ckey, tb, lo, tb.count))
            mask = rng.random(tb.count) < 0.7
            jmasks[ckey] = mask
            tmasks[ckey] = mask.copy()
        want = int(rng.integers(1, 120))
        no_value, want_ets = bool(r % 3 == 1), bool(r % 2)
        jwin = (_full_window(jpage, jplan, want, no_value, want_ets, jmasks)
                if jax_cached else
                (jplan, want, no_value, want_ets, jmasks,
                 jpage.plan_geometry(jplan)))
        out.append((jwin, _full_window(tpage, tplan, want, no_value,
                                       want_ets, tmasks)))
    return out


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("byte_cap", [1 << 20, 300])
def test_serve_batch_matches_jax(tables, cached, byte_cap):
    rng = np.random.default_rng(30 + cached + (byte_cap == 300))
    wins = _windows(tables, rng, 12, cached)
    want = jpage.serve_batch([j for j, _t in wins], None, byte_cap, HDR)
    got = tpage.serve_batch([t for _j, t in wins], byte_cap, HDR)
    _same_served(got, want)
    assert got and all(g is not None for g in got)
    if byte_cap == 300:
        assert any(g[3] for g in got)  # some page cut by the byte budget


def _window(tables, mod, t, want, no_value=False, want_ets=False,
            geom=None):
    """One 8-tuple window over the whole of block 0 with an all-true
    mask."""
    blk = _blocks(tables, 0)[0 if mod is jpage else 1]
    ckey = (t.path, t.blocks[0].offset)
    plan = [(ckey, blk, 0, blk.count)]
    masks = {ckey: np.ones(blk.count, dtype=bool)}
    return _full_window(mod, plan, want, no_value, want_ets, masks, geom)


def _serve_both(tables, byte_cap, **kw):
    jt, tt = tables
    want = jpage.serve_batch([_window(tables, jpage, jt, **kw)], None,
                             byte_cap, HDR)
    got = tpage.serve_batch([_window(tables, tpage, tt, **kw)], byte_cap,
                            HDR)
    _same_served(got, want)
    return got[0]


def test_serve_batch_byte_budget_truncates(tables):
    page, size, last_key, truncated = _serve_both(tables, 200, want=64)
    assert truncated and 1 <= len(page) < 64
    assert last_key == page.key_at(len(page) - 1)


def test_serve_batch_row_count_and_exhaustion(tables):
    page, _s, _lk, truncated = _serve_both(tables, 1 << 20, want=7)
    assert len(page) == 7 and not truncated
    page, _s, _lk, truncated = _serve_both(tables, 1 << 20, want=1000)
    assert len(page) == 64 and not truncated


def test_serve_batch_arena_overflow_returns_none(tables):
    """A value arena forged too small: the request comes back as None
    (state 3), for the caller to re-serve with numpy."""
    assert _serve_both(tables, 1 << 20, want=64,
                       geom=(64, 10, 64)) is None


def test_serve_batch_no_value_and_ets(tables):
    page, size, _lk, _tr = _serve_both(tables, 1 << 20, want=5,
                                       no_value=True, want_ets=True)
    assert len(page) == 5 and page.ets
    assert all(page.value_at(i) == b"" for i in range(5))
    assert size == sum(len(page.key_at(i)) for i in range(5))


def test_serve_batch_cached_windows_match_ad_hoc(tables):
    """Windows that share blocks under different masks (filter flavours
    of one block): the port's cached windows against the JAX package's
    ad-hoc ones."""
    wins = _windows(tables, np.random.default_rng(40), 8, False,
                    first_of=lambda r: r % 2)
    got = tpage.serve_batch([t for _j, t in wins], 1 << 20, HDR)
    _same_served(got, jpage.serve_batch([j for j, _t in wins], None,
                                        1 << 20, HDR))
    assert all(g is not None for g in got)


def test_scan_page_sequence_protocol_matches_jax(tables):
    _jb, blk = _blocks(tables, 2)
    page, _s, _l = tpage.build_page(
        [(blk, np.arange(9, dtype=np.int64))], HDR, want_ets=True)
    twin = JScanPage(*_page_fields(page))
    assert len(page) == len(twin) == 9 and bool(page)

    def rows(kvs):
        return [(kv.key, kv.value, kv.expire_ts_seconds) for kv in kvs]

    assert rows(page) == rows(twin)
    assert rows(page[2:7:2]) == rows(twin[2:7:2])
    assert rows([page[-1], page[0]]) == rows([twin[-1], twin[0]])
    assert page[3].key == blk.key_at(3)
    assert page.ets_at(4) == int(blk.expire_ts[4])
    with pytest.raises(IndexError):
        page[9]
    bare = ScanPage(page.key_offs, page.key_blob, page.val_offs,
                    page.val_blob)
    assert bare[0].expire_ts_seconds is None and bare.ets_at(0) is None
