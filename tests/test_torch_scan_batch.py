"""The port's batched scan path against the JAX package.

Four partitions of one table are served by JAX PartitionServers and by
the port's PartitionServer(device="cpu"), loaded with the same seeded
records under the slice's flags (`block_codec = none`, no bloom, no
phash). Partitions 0 and 1 were compacted as two partitions of a
2-partition table and reopened as partitions of 4, so their L1 runs hold
the records a split left behind (hash % 4 = pidx + 2); records expire at
`now + 30`, which the scans' `now` (load time + 60) passes.

Held equal, field by field (kvs through the sequence protocol as (key,
value, expire_ts)): `scan_coordinator.scan_multi` over the four
partitions with mixed filter flavours, validation, one_page, no_value,
expire_ts, start/stop bounds, before and after a write overlay (updates,
inserts, tombstones, foreign rows, L0 and memtable), every context paged
to its end through on_scan; `on_get_scanner_batch`; the fall-backs off
the fast path; the expired counts of the batched path; and the
MaskPrefresher's warming (tests/test_mask_prefresher.py's cases). The
JAX side runs its own CPU path; its process-wide drift gauge is reset
after each test and its servers use app ids off the sim clusters'.
"""

import time

import numpy as np
import pytest

from pegasus_tpu.base.key_schema import key_hash_parts
from pegasus_tpu.base.value_schema import epoch_now
from pegasus_tpu.server import scan_coordinator as jsc
from pegasus_tpu.server import types as jtypes
from pegasus_tpu.server.partition_server import (
    PartitionServer as JaxPartitionServer,
)
from pegasus_tpu.server.workload import DRIFT as JDRIFT
from pegasus_tpu.storage.engine import WriteBatchItem as JItem
from pegasus_tpu.utils.flags import FLAGS as JFLAGS
from pegasus_tpu_torch.utils.flags import FLAGS as TFLAGS
from pegasus_tpu_torch.base.key_schema import generate_key
from pegasus_tpu_torch.base.value_schema import generate_value
from pegasus_tpu_torch.server import page as tpage
from pegasus_tpu_torch.server import scan_coordinator as tsc
from pegasus_tpu_torch.server import types as ttypes
from pegasus_tpu_torch.server.partition_server import PartitionServer
from pegasus_tpu_torch.storage.engine import WriteBatchItem as TItem
from pegasus_tpu_torch.storage.wal import OP_PUT

SLICE_FLAGS = (("pegasus.storage", "block_codec", "none"),
               ("pegasus.server", "bloom_bits_per_key", 0),
               ("pegasus.server", "phash_index", False))
P = 4
FAR = 10 ** 7
BLOCK = 16  # records an SST block holds
SORTKEYS = [b"s%02d" % i for i in range(10)]
FILTERS = ([(0, b"", 0, b"")] * 4
           + [(0, b"", 3, b"1"), (0, b"", 3, b"2"), (0, b"", 3, b"3"),
              (0, b"", 2, b"s0"), (0, b"", 1, b"5"), (2, b"user00", 0, b""),
              (2, b"user01", 0, b""), (1, b"3", 3, b"4"), (0, b"", 1, b"")])


def _set_flags(values, registries=(JFLAGS, TFLAGS)):
    """Set flags in both packages' process-wide registries."""
    for section, name, value in values:
        for reg in registries:
            reg.set(section, name, value, force=True)


@pytest.fixture(autouse=True)
def _jax_state():
    saved = [[(s, n, reg.get(s, n)) for s, n, _v in SLICE_FLAGS]
             for reg in (JFLAGS, TFLAGS)]
    _set_flags(SLICE_FLAGS)
    yield
    _set_flags(saved[0], (JFLAGS,))
    _set_flags(saved[1], (TFLAGS,))
    # the JAX mask waves feed its process-wide cost-model drift gauge
    JDRIFT.reset()


class Node:
    """The four partitions in both packages: jax[p], port[p]."""

    def __init__(self, root, app_id, seed, hashkeys=160):
        self.root = root
        self.app_id = app_id
        self.rng = np.random.default_rng(seed)
        self.now = epoch_now()
        self.jax, self.port = [], []
        self.hashkeys = [b"user%04d" % i for i in range(hashkeys)]
        records = {p: [] for p in range(P)}
        for hk in self.hashkeys:
            owner = key_hash_parts(hk) % P
            # a third of the records of partitions 2 and 3 are also left
            # behind in 0 and 1, their 2-partition parents
            leftover = owner >= 2 and self.rng.random() < 0.3
            for sk in sorted(self.rng.choice(
                    SORTKEYS, int(self.rng.integers(1, 9)), replace=False)):
                draw = self.rng.random()
                ets = (0 if draw < 0.7 else self.now + FAR if draw < 0.9
                       else self.now + 30)
                rec = (generate_key(hk, sk), b"v-%s-%s" % (hk, sk), ets)
                records[owner].append(rec)
                if leftover:
                    records[owner - 2].append(rec)
        for p in range(P):
            count = 2 if p < 2 else P
            pair = self._open(p, count)
            for srv, item in ((pair[0], JItem), (pair[1], TItem)):
                srv.engine.write_batch(
                    [item(OP_PUT, k, generate_value(1, v, e), e)
                     for k, v, e in sorted(records[p])], 1)
                srv.manual_compact()
            if count != P:
                for srv in pair:
                    srv.close()
                pair = self._open(p, P)
            self.jax.append(pair[0])
            self.port.append(pair[1])
        self.scan_now = self.now + 60

    def _open(self, p, count):
        pair = (JaxPartitionServer(f"{self.root}/j{p}", app_id=self.app_id,
                                   pidx=p, partition_count=count),
                PartitionServer(f"{self.root}/t{p}", app_id=self.app_id,
                                pidx=p, partition_count=count, device="cpu"))
        for srv in pair:
            # small SST blocks: a scan's plan spans several, so plan
            # budgets, frontiers and tables of many blocks come into play
            srv.engine.lsm._block_capacity = BLOCK
        return pair

    def both(self):
        return zip(self.jax, self.port)

    def write_overlay(self):
        """The same overlay in both: updates over base rows, inserts,
        tombstones and foreign rows, part flushed to L0, part in the
        memtable."""
        for step in range(2):
            for p, (js, ts) in enumerate(self.both()):
                for _ in range(12):
                    hk = self.hashkeys[int(self.rng.integers(0, len(
                        self.hashkeys)))]
                    key = generate_key(hk, SORTKEYS[int(
                        self.rng.integers(0, 10))])
                    draw = self.rng.random()
                    for srv in (js, ts):
                        if draw < 0.2:
                            assert srv.on_remove(key) == 0
                        else:
                            assert srv.on_put(key, b"ov%d-%d" % (step, p)) \
                                == 0
                if step == 0:
                    js.engine.flush()
                    ts.engine.flush()

    def close(self):
        for s in self.jax + self.port:
            s.close()


@pytest.fixture
def node(tmp_path, request):
    n = Node(str(tmp_path), 9101, getattr(request, "param", 1))
    yield n
    n.close()


def _request_args(rng, hashkeys):
    hk = hashkeys[int(rng.integers(0, len(hashkeys)))]
    f = FILTERS[int(rng.integers(0, len(FILTERS)))]
    start = (b"", generate_key(hk, b""),
             generate_key(hk, SORTKEYS[int(rng.integers(0, 10))]))[
        int(rng.integers(0, 3))]
    stop = b""
    if rng.random() < 0.25:
        stop = generate_key(hashkeys[min(len(hashkeys) - 1, hashkeys.index(
            hk) + int(rng.integers(1, 40)))], b"")
    return dict(start_key=start, stop_key=stop,
                start_inclusive=bool(rng.random() < 0.8),
                stop_inclusive=bool(rng.random() < 0.5),
                batch_size=int(rng.integers(1, 60)) if rng.random() < 0.95
                else 0,
                no_value=bool(rng.random() < 0.2),
                hash_key_filter_type=f[0], hash_key_filter_pattern=f[1],
                sort_key_filter_type=f[2], sort_key_filter_pattern=f[3],
                validate_partition_hash=bool(rng.random() < 0.8),
                return_expire_ts=bool(rng.random() < 0.3),
                one_page=bool(rng.random() < 0.5))


def _flush(rng, hashkeys, per_partition):
    args = [[_request_args(rng, hashkeys) for _ in range(per_partition)]
            for _p in range(P)]
    return ([[jtypes.GetScannerRequest(**a) for a in lst] for lst in args],
            [[ttypes.GetScannerRequest(**a) for a in lst] for lst in args])


def _rows(kvs):
    return [(kv.key, kv.value, kv.expire_ts_seconds) for kv in kvs]


def _same(jresp, tresp):
    assert _rows(tresp.kvs) == _rows(jresp.kvs)
    for name in ("error", "context_id", "kv_count", "pushdown_applied"):
        assert getattr(tresp, name) == getattr(jresp, name), name


def _page_to_end(jsrv, tsrv, jresp, tresp):
    pages = 0
    while jresp.context_id >= 0 and pages < 100:
        jresp, tresp = jsrv.on_scan(jresp.context_id), \
            tsrv.on_scan(tresp.context_id)
        _same(jresp, tresp)
        pages += 1
    assert tresp.context_id == jresp.context_id


def _expired(node):
    return ([s._abnormal_reads.value() for s in node.jax],
            [s.abnormal_read_count for s in node.port])


def _scan_multi_both(node, jreqs, treqs, page=True):
    before = _expired(node)
    jout = jsc.scan_multi(list(zip(node.jax, jreqs)), node.scan_now)
    tout = tsc.scan_multi(list(zip(node.port, treqs)), node.scan_now)
    after = _expired(node)
    assert [a - b for a, b in zip(after[1], before[1])] == \
        [a - b for a, b in zip(after[0], before[0])]
    kinds = set()
    for p, (js, ts) in enumerate(node.both()):
        for jr, tr in zip(jout[p], tout[p]):
            _same(jr, tr)
            kinds.add(type(tr.kvs).__name__)
            if page:
                _page_to_end(js, ts, jr, tr)
    return kinds


@pytest.mark.parametrize("node", [1, 2, 3], indirect=True)
def test_scan_multi_matches_jax(node):
    rng = np.random.default_rng(50)
    served = tpage.SERVE_STATS["served"]
    for _round in range(2):  # cold masks, then every mask cached
        kinds = _scan_multi_both(node, *_flush(rng, node.hashkeys, 8))
        assert "ScanPage" in kinds
    assert tpage.SERVE_STATS["served"] > served
    node.write_overlay()
    for _round in range(2):
        kinds = _scan_multi_both(node, *_flush(rng, node.hashkeys, 8))
        assert {"ScanPage", "list"} <= kinds  # native pages and merges


def test_on_get_scanner_batch_matches_jax(node):
    rng = np.random.default_rng(51)
    for p, (js, ts) in enumerate(node.both()):
        for f in (FILTERS[0], FILTERS[4], FILTERS[9]):
            args = [_request_args(rng, node.hashkeys) for _ in range(6)]
            for a in args:
                a.update(hash_key_filter_type=f[0],
                         hash_key_filter_pattern=f[1],
                         sort_key_filter_type=f[2],
                         sort_key_filter_pattern=f[3],
                         validate_partition_hash=True)
            jout = js.on_get_scanner_batch(
                [jtypes.GetScannerRequest(**a) for a in args])
            tout = ts.on_get_scanner_batch(
                [ttypes.GetScannerRequest(**a) for a in args])
            for jr, tr in zip(jout, tout):
                _same(jr, tr)
                _page_to_end(js, ts, jr, tr)
            assert isinstance(tout[0].kvs, ttypes.ScanPage)


def test_batches_off_the_fast_path_match_jax(node):
    """Mixed flavours in one partition batch, a count-only request, a
    store with no L1 run and an overlay past OVERLAY_MERGE_LIMIT: the
    batch is served request by request, in both packages."""
    rng = np.random.default_rng(52)
    js, ts = node.jax[0], node.port[0]
    args = [_request_args(rng, node.hashkeys) for _ in range(6)]
    for a, f in zip(args, FILTERS[3:]):
        a.update(hash_key_filter_type=f[0], hash_key_filter_pattern=f[1],
                 sort_key_filter_type=f[2], sort_key_filter_pattern=f[3])
    count_only = dict(args[0], only_return_count=True)
    for batch in (args, [count_only, args[1]]):
        treqs = [ttypes.GetScannerRequest(**a) for a in batch]
        assert ts.plan_scan_batch(treqs) is None
        for jr, tr in zip(js.on_get_scanner_batch(
                [jtypes.GetScannerRequest(**a) for a in batch]),
                ts.on_get_scanner_batch(treqs)):
            _same(jr, tr)
            _page_to_end(js, ts, jr, tr)
    # an overlay past the limit
    node.write_overlay()
    for srv in (js, ts):
        srv.OVERLAY_MERGE_LIMIT = 3
    batch = [dict(a, **dict(zip(
        ("hash_key_filter_type", "hash_key_filter_pattern",
         "sort_key_filter_type", "sort_key_filter_pattern"), FILTERS[0])))
        for a in args]
    treqs = [ttypes.GetScannerRequest(**a) for a in batch]
    assert ts.plan_scan_batch(treqs) is None
    for jr, tr in zip(js.on_get_scanner_batch(
            [jtypes.GetScannerRequest(**a) for a in batch]),
            ts.on_get_scanner_batch(treqs)):
        _same(jr, tr)
    # a fresh store: memtable only, no L1 run
    fresh = (JaxPartitionServer(f"{node.root}/jf", app_id=9102),
             PartitionServer(f"{node.root}/tf", app_id=9102, device="cpu"))
    try:
        for i in range(50):
            for srv in fresh:
                srv.on_put(generate_key(b"hk", b"s%02d" % i), b"v%d" % i)
        treqs = [ttypes.GetScannerRequest(start_key=b"", batch_size=100),
                 ttypes.GetScannerRequest(start_key=b"", batch_size=100,
                                          sort_key_filter_type=2,
                                          sort_key_filter_pattern=b"s0")]
        assert fresh[1].plan_scan_batch(treqs) is None
        out = fresh[1].on_get_scanner_batch(treqs)
        for jr, tr in zip(fresh[0].on_get_scanner_batch(
                [jtypes.GetScannerRequest(**vars(r)) for r in treqs]), out):
            _same(jr, tr)
        assert [len(r.kvs) for r in out] == [50, 10]
    finally:
        for srv in fresh:
            srv.close()


def test_pushdown_requests_are_served_per_request(node):
    """A request carrying a pushdown aggregate leaves the batched path
    and is served per request (its reply is a partial, not a page), with
    pushdown_applied set and the partial the JAX package computes,
    without knocking its neighbours off the batched path."""
    from pegasus_tpu.ops.pushdown import PushdownSpec as JSpec
    from pegasus_tpu_torch.ops.pushdown import PushdownSpec as TSpec

    js, ts = node.jax[1], node.port[1]
    plain = dict(start_key=b"", batch_size=20, validate_partition_hash=True)
    spec = dict(value_filter_type=3, value_filter_pattern=b"1",
                aggregate="count")
    tplain = ttypes.GetScannerRequest(**plain)
    pushed = ttypes.GetScannerRequest(**plain, pushdown=TSpec(**spec))
    assert ts.plan_scan_batch([tplain, pushed]) is None
    out = tsc.scan_multi([(ts, [tplain, pushed])], node.scan_now)[0]
    jout = jsc.scan_multi([(js, [jtypes.GetScannerRequest(**plain),
                                 jtypes.GetScannerRequest(
                                     **plain, pushdown=JSpec(**spec))])],
                          node.scan_now)[0]
    assert isinstance(out[0].kvs, ttypes.ScanPage)
    assert out[1].pushdown_applied and out[1].agg == jout[1].agg
    assert out[1].agg is not None and _rows(out[1].kvs) == []
    for jr, tr in zip(jout, out):
        _same(jr, tr)


@pytest.mark.parametrize("cap", [2, 64])
def test_flavour_slabs_match_jax(node, monkeypatch, cap):
    """More flavours than MULTI_FLAVOR_MAX are evaluated in halves."""
    monkeypatch.setattr(tsc, "MULTI_FLAVOR_MAX", cap)
    monkeypatch.setattr(jsc, "MULTI_FLAVOR_MAX", cap)
    rng = np.random.default_rng(53)
    args = [[dict(_request_args(rng, node.hashkeys),
                  hash_key_filter_type=0, hash_key_filter_pattern=b"",
                  sort_key_filter_type=3, sort_key_filter_pattern=b"%d" % i,
                  one_page=True)
             for i in range(7)] for _p in range(P)]
    _scan_multi_both(node,
                     [[jtypes.GetScannerRequest(**a) for a in lst]
                      for lst in args],
                     [[ttypes.GetScannerRequest(**a) for a in lst]
                      for lst in args])


def _whole(mod, pat):
    return mod.GetScannerRequest(
        start_key=b"", batch_size=1000, validate_partition_hash=True,
        sort_key_filter_type=1 if pat else 0, sort_key_filter_pattern=pat)


def test_mixed_flavours_equal_solo_and_warm_siblings(node):
    """tests/test_scan_page.py:160 and :188 in both packages: each
    flavour of a mixed flush pages to what per-request serving returns,
    and the flavour-axis wave leaves every sibling (flavour, block) mask
    cached."""
    pats = (b"s01", b"s05", b"", b"s09")
    now = epoch_now()  # per-request serving reads the clock
    for js, ts in node.both():
        jout = jsc.scan_multi([(js, [_whole(jtypes, p) for p in pats])],
                              now)[0]
        tout = tsc.scan_multi([(ts, [_whole(ttypes, p) for p in pats])],
                              now)[0]
        for p, jr, tr in zip(pats, jout, tout):
            _same(jr, tr)
            solo = ts.on_get_scanner(_whole(ttypes, p))
            assert _rows(tr.kvs) == _rows(solo.kvs), p
        for p in (b"s02", b"s03"):
            for srv, mod, sc in ((js, jtypes, jsc), (ts, ttypes, tsc)):
                sc.scan_multi([(srv, [_whole(mod, b"s02"),
                                      _whole(mod, b"s03")])], node.scan_now)
                state = srv.plan_scan_batch([_whole(mod, p)],
                                            now=node.scan_now)
                assert state is not None and not srv.planned_misses(state)


def _scan_batch(srv, mod, now, filters=(0, b"")):
    reqs = [mod.GetScannerRequest(start_key=b"", batch_size=1000,
                                  validate_partition_hash=True,
                                  hash_key_filter_type=filters[0],
                                  hash_key_filter_pattern=filters[1])]
    state = srv.plan_scan_batch(reqs, now=now)
    assert state is not None
    return srv.finish_scan_batch(state, srv.eval_planned_masks(state))


def test_prefresher_warms_like_jax(node):
    """tests/test_mask_prefresher.py in both packages: a served scan
    leaves nothing to warm; compaction replaces the blocks; one pass
    warms them (as many masks as the JAX warmer), a second has nothing
    left; warmed masks serve what a cold evaluation serves; TTL needs no
    re-warm; a recurring filtered flavour warms too; flavours age out."""
    now = node.scan_now
    for mod, servers, sc in ((jtypes, node.jax, jsc),
                             (ttypes, node.port, tsc)):
        for srv in servers:
            _scan_batch(srv, mod, now)
            _scan_batch(srv, mod, now, (2, b"user00"))
            _scan_batch(srv, mod, now, (2, b"user00"))
            assert srv.hot_block_entries(0.0, 60.0) == []
    node.write_overlay()
    for srv in node.jax + node.port:
        srv.manual_compact()
        assert srv.hot_block_entries(0.0, 60.0)
    warmed = [jsc.MaskPrefresher(node.jax).refresh_once(),
              tsc.MaskPrefresher(node.port).refresh_once()]
    assert warmed[1] == warmed[0] > 0
    assert tsc.MaskPrefresher(node.port).refresh_once() == 0
    for js, ts in node.both():
        state = ts.plan_scan_batch([_whole(ttypes, b"")], now=now)
        assert ts.planned_misses(state) == {}
        # TTL is applied on the host: a later second plans no misses
        state = ts.plan_scan_batch([_whole(ttypes, b"")], now=now + 10 ** 6)
        assert ts.planned_misses(state) == {}
        for filters in ((0, b""), (2, b"user00")):
            warm = _scan_batch(ts, ttypes, now + 100, filters)[0]
            assert _rows(warm.kvs) == _rows(
                _scan_batch(js, jtypes, now + 100, filters)[0].kvs)
            with ts._mask_lock:
                ts._mask_cache.clear()
            cold = _scan_batch(ts, ttypes, now + 100, filters)[0]
            assert _rows(cold.kvs) == _rows(warm.kvs)
        # every flavour idle past the horizon ages out
        assert ts.hot_block_entries(1e12, 15.0) == []
        assert not ts._warm_flavors


def test_prefresher_thread_smoke(node):
    for ts in node.port:
        _scan_batch(ts, ttypes, node.scan_now)
        ts.manual_compact()
    pre = tsc.MaskPrefresher(node.port, poll_s=0.05).start()
    try:
        deadline = time.monotonic() + 10
        while pre.refreshed == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert pre.refreshed > 0
    finally:
        pre.stop()
