"""The encoded scan probe and scan pushdown against the JAX package.

Four partitions of one table are served by JAX PartitionServers and by
the port's PartitionServer(device="cpu"); each partition is compacted
under its own codec (dcz2, none, dcz, dcz2), with bloom and perfect-hash
sidecars on, set in both packages and restored after each test.
Partitions 0 and 2 also hold malformed keys (a 1-byte key and a key
whose hashkey length runs past its end), so some compressed blocks must
take the device path.

Held equal:
- `ops.predicates.encoded_static_keep` on every compressed block, for
  every filter flavour, validation on and off and the split gate
  (pv < 0, pidx > pv), to the JAX package's and to the port's decoded
  mask (plain torch `static_block_predicate`);
- which planned blocks each package sends to the device
  (`planned_misses`), and the masks it keeps on the host;
- `scan_multi` with pushdown specs (value filters, count / sum / top_k /
  sample aggregates) mixed with plain scans, before and after a write
  overlay, every context paged to its end: responses, `pushdown_applied`
  and the aggregate partials, and their finalized values.

The JAX drift gauge is reset after each test.
"""

import os

import numpy as np
import pytest
import torch

from pegasus_tpu.base.key_schema import key_hash_parts
from pegasus_tpu.base.value_schema import epoch_now
from pegasus_tpu.ops import predicates as jpred
from pegasus_tpu.ops import pushdown as jpd
from pegasus_tpu.server import scan_coordinator as jsc
from pegasus_tpu.server import types as jtypes
from pegasus_tpu.server.partition_server import (
    PartitionServer as JaxPartitionServer,
)
from pegasus_tpu.server.workload import DRIFT as JDRIFT
from pegasus_tpu.storage.engine import WriteBatchItem as JItem
from pegasus_tpu.utils.flags import FLAGS as JFLAGS
from pegasus_tpu_torch import convert
from pegasus_tpu_torch.base.key_schema import generate_key
from pegasus_tpu_torch.base.value_schema import generate_value
from pegasus_tpu_torch.ops import predicates as tpred
from pegasus_tpu_torch.ops import pushdown as tpd
from pegasus_tpu_torch.ops.record_block import block_from_columns
from pegasus_tpu_torch.server import scan_coordinator as tsc
from pegasus_tpu_torch.server import types as ttypes
from pegasus_tpu_torch.server.partition_server import PartitionServer
from pegasus_tpu_torch.storage.engine import WriteBatchItem as TItem
from pegasus_tpu_torch.storage.wal import OP_PUT
from pegasus_tpu_torch.utils.flags import FLAGS as TFLAGS

P = 4
CODECS = ("dcz2", "none", "dcz", "dcz2")
BLOCK = 32
SORTKEYS = [b"s%02d" % i for i in range(10)]
MALFORMED = (b"\x00", b"\x00\x09ab")
FLAG_NAMES = (("pegasus.storage", "block_codec"),
              ("pegasus.server", "bloom_bits_per_key"),
              ("pegasus.server", "phash_index"))
FILTERS = [(0, b"", 0, b""), (0, b"", 3, b"1"), (0, b"", 2, b"s0"),
           (0, b"", 1, b"5"), (2, b"user00", 0, b""), (1, b"3", 3, b"4"),
           (3, b"7", 1, b"s"), (0, b"", 1, b"")]
# value filters on the user bytes "v<hashkey>-<sortkey>-<n>"
VALUE_FILTERS = [(0, b""), (2, b"vuser00"), (1, b"-s0"), (3, b"7"),
                 (1, b"")]
AGGREGATES = [("", 0, 0), ("count", 0, 0), ("sum", 0, 0),
              ("top_k", 5, 0), ("sample", 4, 7)]


def _set(values):
    for (section, name), value in zip(FLAG_NAMES, values):
        for reg in (JFLAGS, TFLAGS):
            reg.set(section, name, value, force=True)


@pytest.fixture
def node(tmp_path):
    saved = [[reg.get(s, n) for s, n in FLAG_NAMES]
             for reg in (JFLAGS, TFLAGS)]
    n = Node(str(tmp_path))
    yield n
    n.close()
    for reg, values in zip((JFLAGS, TFLAGS), saved):
        for (section, name), value in zip(FLAG_NAMES, values):
            reg.set(section, name, value, force=True)
    JDRIFT.reset()


class Node:
    def __init__(self, root, app_id=9103, seed=21):
        self.rng = np.random.default_rng(seed)
        self.root = root
        self.now = epoch_now()
        self.scan_now = self.now + 60
        self.hashkeys = [b"user%04d" % i for i in range(150)]
        records = {p: [] for p in range(P)}
        for hk in self.hashkeys:
            for sk in SORTKEYS:
                if self.rng.random() < 0.3:
                    continue
                draw = self.rng.random()
                ets = (0 if draw < 0.8 else self.now + 10 ** 6
                       if draw < 0.9 else self.now + 30)
                n = int(self.rng.integers(0, 1000))
                records[key_hash_parts(hk) % P].append(
                    (generate_key(hk, sk), b"v%s-%s-%d" % (hk, sk, n), ets))
        for p in (0, 2):
            records[p] += [(k, b"vmal-%d" % len(k), 0) for k in MALFORMED]
        self.jax, self.port = [], []
        for p in range(P):
            _set((CODECS[p], 10, True))
            pair = (JaxPartitionServer(f"{root}/j{p}", app_id=app_id,
                                       pidx=p, partition_count=P),
                    PartitionServer(f"{root}/t{p}", app_id=app_id, pidx=p,
                                    partition_count=P, device="cpu"))
            for srv, item in ((pair[0], JItem), (pair[1], TItem)):
                srv.engine.lsm._block_capacity = BLOCK
                srv.engine.write_batch(
                    [item(OP_PUT, k, generate_value(1, v, e), e)
                     for k, v, e in sorted(records[p])], 1)
                srv.manual_compact(now=self.now)
            self.jax.append(pair[0])
            self.port.append(pair[1])

    def both(self):
        return zip(self.jax, self.port)

    def write_overlay(self):
        for p, (js, ts) in enumerate(self.both()):
            for i in range(10):
                hk = self.hashkeys[int(self.rng.integers(0, 150))]
                key = generate_key(hk, SORTKEYS[int(self.rng.integers(0,
                                                                      10))])
                for srv in (js, ts):
                    if i % 4 == 0:
                        srv.on_remove(key)
                    else:
                        srv.on_put(key, b"vov%d-%d-7" % (p, i))

    def close(self):
        for srv in self.jax + self.port:
            srv.close()


def _decoded_keep(blk, validate, pidx, pv, filter_key):
    """The port's decoded-path static mask of one block (plain torch)."""
    rb = block_from_columns(blk.keys, blk.key_len, blk.expire_ts,
                            hash_lo=blk.hash_lo, capacity=blk.count,
                            device=torch.device("cpu"))
    hft, hfp, sft, sfp = filter_key
    return tpred.static_block_predicate(
        rb, tpred.FilterSpec.make(hft, hfp, torch.device("cpu")),
        tpred.FilterSpec.make(sft, sfp, torch.device("cpu")),
        validate, pidx, pv).numpy()


def test_encoded_static_keep_matches_jax_and_the_decoded_mask(node):
    checked = malformed = 0
    for p, ts in enumerate(node.port):
        jt_runs = node.jax[p].engine.lsm.l1_runs
        for tr, jr in zip(ts.engine.lsm.l1_runs, jt_runs):
            if tr.codec is None:
                assert tr.read_block_encoded(0) is None
                continue
            for i in range(len(tr.blocks)):
                tenc, jenc = tr.read_block_encoded(i), \
                    jr.read_block_encoded(i)
                blk = tr.read_block(i)
                for fk in FILTERS:
                    for validate, pidx, pv in ((False, p, 3), (True, p, 3),
                                               (True, p, -1),
                                               (True, 3, 1)):
                        keep = tpred.encoded_static_keep(tenc, validate,
                                                         pidx, pv, fk)
                        want = jpred.encoded_static_keep(jenc, validate,
                                                         pidx, pv, fk)
                        if want is None:
                            assert keep is None and tenc.has_malformed
                            malformed += 1
                            continue
                        assert np.array_equal(keep, want)
                        assert np.array_equal(
                            keep, _decoded_keep(blk, validate, pidx, pv,
                                                fk))
                        checked += 1
    assert checked > 500 and malformed > 0


def _plan_both(js, ts, reqs_args, now):
    jstate = js.plan_scan_batch([jtypes.GetScannerRequest(**a)
                                 for a in reqs_args], now=now)
    tstate = ts.plan_scan_batch([ttypes.GetScannerRequest(**a)
                                 for a in reqs_args], now=now)
    assert (jstate is None) == (tstate is None)
    return jstate, tstate


def _ckeys(misses):
    return sorted((os.path.basename(c[0]), c[1]) for c in misses)


def test_planned_misses_route_blocks_like_jax(node):
    """The same planned blocks go to the device in both packages: every
    block of the `none` partition, and the compressed blocks holding
    malformed rows; the rest are masked on the host, equal masks."""
    for p, (js, ts) in enumerate(node.both()):
        for fk in FILTERS:
            args = [dict(start_key=b"", batch_size=10 ** 4,
                         hash_key_filter_type=fk[0],
                         hash_key_filter_pattern=fk[1],
                         sort_key_filter_type=fk[2],
                         sort_key_filter_pattern=fk[3],
                         validate_partition_hash=True)]
            jstate, tstate = _plan_both(js, ts, args, node.scan_now)
            jm, tm = js.planned_misses(jstate), ts.planned_misses(tstate)
            assert _ckeys(tm) == _ckeys(jm)
            jkeep = {(os.path.basename(c[0]), c[1]): np.asarray(m)
                     for c, m in jstate["cached_keep"].items()}
            for c, m in tstate["cached_keep"].items():
                assert np.array_equal(
                    m, jkeep[(os.path.basename(c[0]), c[1])])
            # masked on the device by both, then cached: no miss left
            js.finish_scan_batch(jstate, js.eval_planned_masks(jstate))
            ts.finish_scan_batch(tstate, ts.eval_planned_masks(tstate))
    routes = {}
    for ts in node.port:
        for k, v in ts.mask_routes.items():
            routes[k] = routes.get(k, 0) + v
    assert routes["encoded"] > 0 and routes["device_raw"] > 0
    assert routes["device_malformed"] > 0


def _args(rng, hashkeys, pushdown):
    hk = hashkeys[int(rng.integers(0, len(hashkeys)))]
    f = FILTERS[int(rng.integers(0, len(FILTERS)))]
    start = (b"", generate_key(hk, b""))[int(rng.integers(0, 2))]
    stop = b""
    if rng.random() < 0.3:
        stop = generate_key(hashkeys[min(len(hashkeys) - 1, hashkeys.index(
            hk) + int(rng.integers(1, 40)))], b"")
    return dict(start_key=start, stop_key=stop,
                batch_size=int(rng.integers(1, 80)),
                no_value=bool(rng.random() < 0.15),
                hash_key_filter_type=f[0], hash_key_filter_pattern=f[1],
                sort_key_filter_type=f[2], sort_key_filter_pattern=f[3],
                validate_partition_hash=bool(rng.random() < 0.8),
                return_expire_ts=bool(rng.random() < 0.3),
                one_page=bool(rng.random() < 0.4)), pushdown


def _pushdown(rng):
    if rng.random() < 0.4:
        return None
    vf = VALUE_FILTERS[int(rng.integers(0, len(VALUE_FILTERS)))]
    agg, k, seed = AGGREGATES[int(rng.integers(0, len(AGGREGATES)))]
    return dict(value_filter_type=vf[0], value_filter_pattern=vf[1],
                aggregate=agg, k=k, seed=seed)


def _rows(kvs):
    return [(kv.key, kv.value, kv.expire_ts_seconds) for kv in kvs]


def _same(jr, tr):
    assert _rows(tr.kvs) == _rows(jr.kvs)
    for name in ("error", "context_id", "kv_count", "pushdown_applied",
                 "agg"):
        assert getattr(tr, name) == getattr(jr, name), name


def _scan_multi_both(node, rng, per_partition):
    reqs = [[_args(rng, node.hashkeys, _pushdown(rng))
             for _ in range(per_partition)] for _p in range(P)]
    jreqs = [[jtypes.GetScannerRequest(
        **a, pushdown=jpd.PushdownSpec(**pd) if pd else None)
        for a, pd in lst] for lst in reqs]
    treqs = [[ttypes.GetScannerRequest(
        **vars(jr) | {"pushdown": convert.pushdown_spec(jr.pushdown)
                      if jr.pushdown is not None else None})
        for jr in lst] for lst in jreqs]
    jout = jsc.scan_multi(list(zip(node.jax, jreqs)), node.scan_now)
    tout = tsc.scan_multi(list(zip(node.port, treqs)), node.scan_now)
    applied = aggs = 0
    for p, (js, ts) in enumerate(node.both()):
        for jr, tr, treq in zip(jout[p], tout[p], treqs[p]):
            _same(jr, tr)
            applied += tr.pushdown_applied
            while jr.context_id >= 0:
                jr, tr = js.on_scan(jr.context_id), ts.on_scan(
                    tr.context_id)
                _same(jr, tr)
            if tr.agg is not None:
                aggs += 1
                spec = treq.pushdown
                assert tpd.finalize(spec, tr.agg) == jpd.finalize(
                    jpd.PushdownSpec(**vars(spec)), jr.agg)
    return applied, aggs


def test_scan_multi_with_pushdown_matches_jax(node):
    rng = np.random.default_rng(60)
    totals = [0, 0]
    for _round in range(2):  # cold masks, then cached
        for i, v in enumerate(_scan_multi_both(node, rng, 10)):
            totals[i] += v
    node.write_overlay()
    for _round in range(2):
        for i, v in enumerate(_scan_multi_both(node, rng, 10)):
            totals[i] += v
    assert totals[0] > 20 and totals[1] > 5


def test_merge_partials_and_finalize_match_jax(node):
    """Per-partition partials of one aggregate scan over all partitions,
    merged and finalized by each package."""
    for agg, k, seed in AGGREGATES[1:]:
        spec = dict(value_filter_type=2, value_filter_pattern=b"vuser0",
                    aggregate=agg, k=k, seed=seed)
        jparts, tparts = [], []
        for js, ts in node.both():
            jr = js.on_get_scanner(jtypes.GetScannerRequest(
                pushdown=jpd.PushdownSpec(**spec), batch_size=1000))
            tr = ts.on_get_scanner(ttypes.GetScannerRequest(
                pushdown=tpd.PushdownSpec(**spec), batch_size=1000))
            _same(jr, tr)
            jparts.append(jr.agg)
            tparts.append(tr.agg)
        tspec, jspec = tpd.PushdownSpec(**spec), jpd.PushdownSpec(**spec)
        merged = tpd.merge_partials(tspec, tparts)
        assert merged == jpd.merge_partials(jspec, jparts)
        assert tpd.finalize(tspec, merged) == jpd.finalize(
            jspec, jpd.merge_partials(jspec, jparts))
