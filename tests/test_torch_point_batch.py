"""The port's batched point-read path against the JAX package.

Four partitions of one table are served by JAX PartitionServers and by
the port's PartitionServer(device="cpu"), loaded with the same seeded
records at each codec (`none`, `dcz`, `dcz2`) with the bloom and
perfect-hash sidecars on and off, set in both packages and restored
after each test. Partitions 0 and 1 were compacted as partitions of a
2-partition table and reopened as partitions of 4, so their L1 runs hold
split leftovers; the stores carry L1 runs, two L0 flushes and a
memtable; records expire at `now + 30`, which the reads' `now` (load
time + 60) passes; and every hashkey holds trailing-zero twins (sort
keys `t`, `t\\x00`, `t\\x00\\x00`), which pad to one key row.

Held equal: `read_coordinator.point_read_multi` responses (get, ttl,
multi_get with sort keys, narrow and wide, batch_get, misses, gated
stale-partition reads) over three rounds (the later ones read through
the location cache, and the third through the row cache, which admits a
row on its second miss), the deadline error, and the partitions' index
memory gauges (bloom and phash bytes) after a flush. The JAX
servers run at app ids off the sim clusters', and the JAX drift gauge is
reset after each test.
"""

import time

import numpy as np
import pytest

from pegasus_tpu.base import value_schema as jvs
from pegasus_tpu.base.key_schema import key_hash_parts
from pegasus_tpu.base.value_schema import epoch_now
from pegasus_tpu.server import read_coordinator as jrc
from pegasus_tpu.server import types as jtypes
from pegasus_tpu.server.partition_server import (
    PartitionServer as JaxPartitionServer,
)
from pegasus_tpu.server.workload import DRIFT as JDRIFT
from pegasus_tpu.storage.engine import WriteBatchItem as JItem
from pegasus_tpu.utils.errors import PegasusError as JPegasusError
from pegasus_tpu.utils.flags import FLAGS as JFLAGS
from pegasus_tpu_torch.base import value_schema as tvs
from pegasus_tpu_torch.base.key_schema import generate_key
from pegasus_tpu_torch.base.value_schema import generate_value
from pegasus_tpu_torch.server import read_coordinator as trc
from pegasus_tpu_torch.server import types as ttypes
from pegasus_tpu_torch.server.partition_server import PartitionServer
from pegasus_tpu_torch.storage.engine import WriteBatchItem as TItem
from pegasus_tpu_torch.storage.wal import OP_DEL, OP_PUT
from pegasus_tpu_torch.utils.errors import ErrorCode, PegasusError
from pegasus_tpu_torch.utils.flags import FLAGS as TFLAGS

P = 4
FAR = 10 ** 7
BLOCK = 32  # records an SST block holds
SORTKEYS = [b"s%02d" % i for i in range(12)] + [b"t", b"t\x00", b"t\x00\x00"]
FLAG_NAMES = (("pegasus.storage", "block_codec"),
              ("pegasus.server", "bloom_bits_per_key"),
              ("pegasus.server", "phash_index"))
STORE_FLAGS = [(codec, sidecars) for codec in ("none", "dcz", "dcz2")
               for sidecars in (False, True)]


def set_store_flags(codec: str, sidecars: bool) -> None:
    """The store format in both packages' process-wide registries."""
    values = (codec, 10 if sidecars else 0, sidecars)
    for (section, name), value in zip(FLAG_NAMES, values):
        for reg in (JFLAGS, TFLAGS):
            reg.set(section, name, value, force=True)


@pytest.fixture
def store_flags(request):
    saved = [[(s, n, reg.get(s, n)) for s, n in FLAG_NAMES]
             for reg in (JFLAGS, TFLAGS)]
    set_store_flags(*request.param)
    yield request.param
    for reg, values in zip((JFLAGS, TFLAGS), saved):
        for section, name, value in values:
            reg.set(section, name, value, force=True)
    JDRIFT.reset()


class Node:
    """Four partitions in both packages: jax[p], port[p]."""

    def __init__(self, root, seed, app_id=9002, hashkeys=120):
        self.rng = np.random.default_rng(seed)
        self.root = root
        self.app_id = app_id
        self.now = epoch_now()
        self.read_now = self.now + 60
        self.hashkeys = [b"user%04d" % i for i in range(hashkeys)]
        records = {p: [] for p in range(P)}
        for hk in self.hashkeys:
            owner = key_hash_parts(hk) % P
            leftover = owner >= 2 and self.rng.random() < 0.3
            for sk in SORTKEYS:
                if self.rng.random() < 0.3:
                    continue
                draw = self.rng.random()
                ets = (0 if draw < 0.7 else self.now + FAR if draw < 0.9
                       else self.now + 30)
                rec = (generate_key(hk, sk), b"v-%s-%s" % (hk, sk), ets)
                records[owner].append(rec)
                if leftover:
                    records[owner - 2].append(rec)
        self.jax, self.port = [], []
        for p in range(P):
            count = 2 if p < 2 else P
            pair = self._open(p, count)
            self._write(pair, sorted(records[p]), 1)
            for srv in pair:
                srv.manual_compact()
            if count != P:
                for srv in pair:
                    srv.close()
                pair = self._open(p, P)
            self.jax.append(pair[0])
            self.port.append(pair[1])
        # two L0 flushes (updates, tombstones, new keys) and a memtable
        decree = 2
        for step in range(3):
            for p, pair in enumerate(zip(self.jax, self.port)):
                items = []
                for hk in self.rng.choice(self.hashkeys, 12, replace=False):
                    if key_hash_parts(bytes(hk)) % P != p:
                        continue
                    sk = SORTKEYS[int(self.rng.integers(0, len(SORTKEYS)))]
                    key = generate_key(bytes(hk), sk)
                    if self.rng.random() < 0.25:
                        items.append((OP_DEL, key, b"", 0))
                    else:
                        ets = self.now + 30 if self.rng.random() < 0.2 else 0
                        items.append((OP_PUT, key, generate_value(
                            1, b"u%d-%s" % (step, key), ets), ets))
                self._write_items(pair, items, decree)
                if step < 2:
                    for srv in pair:
                        srv.flush()
            decree += 1

    def _open(self, p, count):
        pair = (JaxPartitionServer(f"{self.root}/j{p}", app_id=self.app_id,
                                   pidx=p, partition_count=count),
                PartitionServer(f"{self.root}/t{p}", app_id=self.app_id,
                                pidx=p, partition_count=count, device="cpu"))
        for srv in pair:
            srv.engine.lsm._block_capacity = BLOCK
        return pair

    @staticmethod
    def _write(pair, records, decree):
        items = [(OP_PUT, k, generate_value(1, v, e), e)
                 for k, v, e in records]
        Node._write_items(pair, items, decree)

    @staticmethod
    def _write_items(pair, items, decree):
        if not items:
            return
        # last write of a key in the batch wins in both
        for srv, item in ((pair[0], JItem), (pair[1], TItem)):
            srv.engine.write_batch([item(op, k, v, e)
                                    for op, k, v, e in items], decree)

    def close(self):
        for srv in self.jax + self.port:
            srv.close()

    def ops(self, n_ops, wide_every=9):
        """Per partition [(op, jax args, port args, partition hash)]."""
        rng = self.rng
        out = {p: [] for p in range(P)}
        for i in range(n_ops):
            hk = self.hashkeys[int(rng.integers(0, len(self.hashkeys)))]
            owner = key_hash_parts(hk) % P
            # one in twelve reads goes to the wrong partition: the split
            # gate answers it (ERR_PARENT_PARTITION_MISUSED)
            p = (owner + 1) % P if rng.random() < 1 / 12 else owner
            ph = key_hash_parts(hk)
            draw = rng.random()
            sk = (SORTKEYS[int(rng.integers(0, len(SORTKEYS)))]
                  if rng.random() < 0.8 else b"absent%d" % i)
            key = generate_key(hk, sk)
            if draw < 0.45:
                out[p].append(("get", key, key, ph))
            elif draw < 0.6:
                out[p].append(("ttl", key, key, ph))
            elif draw < 0.85:
                wide = i % wide_every == 0
                sks = (list(SORTKEYS) + [b"zz%d" % j for j in range(6)]
                       if wide else
                       [SORTKEYS[int(j)] for j in rng.integers(
                           0, len(SORTKEYS), 3)])
                no_value = rng.random() < 0.2
                out[p].append(("multi_get",
                               jtypes.MultiGetRequest(hash_key=hk,
                                                      sort_keys=sks,
                                                      no_value=no_value),
                               ttypes.MultiGetRequest(hash_key=hk,
                                                      sort_keys=sks,
                                                      no_value=no_value),
                               ph))
            else:
                n = 20 if i % wide_every == 0 else 3
                pairs = [(hk, SORTKEYS[int(rng.integers(0, len(SORTKEYS)))])
                         for _ in range(n)]
                if rng.random() < 0.2:
                    # a key of another hashkey: stale when it maps away
                    other = self.hashkeys[int(rng.integers(
                        0, len(self.hashkeys)))]
                    pairs.append((other, b"s01"))
                out[p].append((
                    "batch_get",
                    jtypes.BatchGetRequest(keys=[jtypes.FullKey(h, s)
                                                 for h, s in pairs]),
                    ttypes.BatchGetRequest(keys=[ttypes.FullKey(h, s)
                                                 for h, s in pairs]),
                    ph))
        return out

    def read(self, ops, **kw):
        """(JAX results, port results) of one point_read_multi flush."""
        jout = jrc.point_read_multi(
            [(self.jax[p], [(o, ja, ph) for o, ja, _ta, ph in ops[p]])
             for p in range(P)], now=self.read_now, **kw)
        tout = trc.point_read_multi(
            [(self.port[p], [(o, ta, ph) for o, _ja, ta, ph in ops[p]])
             for p in range(P)], now=self.read_now, **kw)
        return jout, tout


class FrozenTime:
    """Stands in for a module's `time`: `time()` is frozen at `t`."""

    def __init__(self, t: float) -> None:
        self.t = t

    def time(self) -> float:
        return self.t

    def __getattr__(self, name):
        return getattr(time, name)


def normal(res):
    """A comparable form of one point-read result of either package."""
    if isinstance(res, tuple):
        return res
    if hasattr(res, "kvs"):
        return ("multi_get", res.error, res.resume_sort_key,
                [(kv.key, kv.value) for kv in res.kvs])
    return ("batch_get", res.error,
            [(d.hash_key, d.sort_key, d.value) for d in res.data])


@pytest.mark.parametrize("store_flags", STORE_FLAGS, indirect=True,
                         ids=[f"{c}-{'sidecars' if s else 'bare'}"
                              for c, s in STORE_FLAGS])
def test_point_read_multi_matches_jax(tmp_path, store_flags):
    codec, sidecars = store_flags
    node = Node(str(tmp_path), seed=11)
    try:
        for t in node.port[0].engine.lsm.l1_runs:
            assert t.codec == (None if codec == "none" else codec)
            assert (t.phash is not None) == sidecars
            assert (t.bloom is not None) == sidecars
        ops = node.ops(300)
        kinds = {"found": 0, "missing": 0, "gated": 0}
        for _round in range(3):
            jout, tout = node.read(ops)
            assert len(jout) == len(tout) == P
            for p in range(P):
                assert [normal(r) for r in tout[p]] == \
                    [normal(r) for r in jout[p]]
                for r in tout[p]:
                    if isinstance(r, tuple):
                        kinds["found" if r[0] == 0 else "gated"
                              if r[0] == int(
                                  ErrorCode.ERR_PARENT_PARTITION_MISUSED)
                              else "missing"] += 1
        assert min(kinds.values()) > 0, kinds
        # the solo-node form, one partition's ops; it reads the wall
        # clock for `now`, so both packages read the same second (a ttl
        # answer is expire_ts - now)
        jops = [(o, ja, ph) for o, ja, _ta, ph in ops[0]]
        tops = [(o, ta, ph) for o, _ja, ta, ph in ops[0]]
        with pytest.MonkeyPatch.context() as mp:
            frozen = FrozenTime(time.time())
            for mod in (jvs, tvs):
                mp.setattr(mod, "time", frozen)
            assert [normal(r) for r in
                    node.port[0].on_point_read_batch(tops)] \
                == [normal(r) for r in node.jax[0].on_point_read_batch(jops)]
        stats = [s.point_stats for s in node.port]
        located = sum(st["phash_located"] for st in stats)
        pruned = sum(st["phash_pruned"] + st["bloom_pruned"]
                     for st in stats)
        assert (located > 0 and pruned > 0) == sidecars
        # the rows the second round admitted served the third
        assert sum(st["row_cache_hit"] for st in stats) > 0
    finally:
        node.close()


@pytest.mark.parametrize("store_flags", [("dcz2", True)], indirect=True)
def test_point_read_multi_after_compaction_and_flag_flip(tmp_path,
                                                         store_flags):
    """A store compacted under dcz2 with sidecars, then read with the
    sidecar probes switched off, then compacted again under `none`: the
    same answers in both packages at every step."""
    node = Node(str(tmp_path), seed=12)
    try:
        ops = node.ops(150)
        steps = [{}, {("pegasus.server", "bloom_probe"): False,
                      ("pegasus.server", "phash_probe"): False}]
        for step in steps:
            saved = {k: JFLAGS.get(*k) for k in step}
            for (section, name), value in step.items():
                for reg in (JFLAGS, TFLAGS):
                    reg.set(section, name, value, force=True)
            jout, tout = node.read(ops)
            for p in range(P):
                assert [normal(r) for r in tout[p]] == \
                    [normal(r) for r in jout[p]]
            for (section, name), value in saved.items():
                for reg in (JFLAGS, TFLAGS):
                    reg.set(section, name, value, force=True)
        set_store_flags("none", False)
        for srv in node.jax + node.port:
            srv.manual_compact(now=node.now)
        jout, tout = node.read(ops)
        for p in range(P):
            assert [normal(r) for r in tout[p]] == \
                [normal(r) for r in jout[p]]
    finally:
        node.close()


@pytest.mark.parametrize("store_flags", [("dcz2", True)], indirect=True)
def test_point_read_multi_deadline(tmp_path, store_flags):
    node = Node(str(tmp_path), seed=13, hashkeys=20)
    try:
        ops = node.ops(20)
        with pytest.raises(JPegasusError) as jerr:
            node.read(ops, deadline=1.0, clock=lambda: 2.0)
        jout = jrc.point_read_multi(
            [(node.jax[p], [(o, ja, ph) for o, ja, _t, ph in ops[p]])
             for p in range(P)], now=node.read_now, deadline=3.0,
            clock=lambda: 2.0)
        with pytest.raises(PegasusError) as terr:
            trc.point_read_multi(
                [(node.port[p], [(o, ta, ph) for o, _j, ta, ph in ops[p]])
                 for p in range(P)], now=node.read_now, deadline=1.0,
                clock=lambda: 2.0)
        assert terr.value.code == ErrorCode.ERR_TIMEOUT
        assert int(jerr.value.code) == int(terr.value.code)
        tout = trc.point_read_multi(
            [(node.port[p], [(o, ta, ph) for o, _j, ta, ph in ops[p]])
             for p in range(P)], now=node.read_now, deadline=3.0,
            clock=lambda: 2.0)
        for p in range(P):
            assert [normal(r) for r in tout[p]] == \
                [normal(r) for r in jout[p]]
    finally:
        node.close()


@pytest.mark.parametrize("store_flags", [("dcz2", True)], indirect=True)
@pytest.mark.parametrize("phash_probe", [True, False])
def test_index_memory_gauges_match_jax(tmp_path, store_flags, phash_probe):
    """The partition entity's `index_bloom_bytes` and `index_phash_bytes`
    gauges equal the JAX server's after a point-read flush over dcz2
    runs with sidecars, with phash probing on and off."""
    key = ("pegasus.server", "phash_probe")
    saved = [(reg, reg.get(*key)) for reg in (JFLAGS, TFLAGS)]
    for reg in (JFLAGS, TFLAGS):
        reg.set(*key, phash_probe, force=True)
    node = Node(str(tmp_path), seed=14, hashkeys=40)
    try:
        jout, tout = node.read(node.ops(60))
        for p in range(P):
            assert [normal(r) for r in tout[p]] == \
                [normal(r) for r in jout[p]]
        names = ("index_bloom_bytes", "index_phash_bytes")
        got = [[srv.metrics.gauge(n).value() for n in names]
               for srv in node.port]
        assert got == [[srv.metrics.gauge(n).value() for n in names]
                       for srv in node.jax]
        assert all(b > 0 and h > 0 for b, h in got), got
    finally:
        node.close()
        for reg, value in saved:
            reg.set(*key, value, force=True)


def test_is_point_read_matches_jax():
    cases = [("get", b"k"), ("get", "k"), ("ttl", bytearray(b"k")),
             ("multi_get", ttypes.MultiGetRequest(hash_key=b"h",
                                                  sort_keys=[b"s"])),
             ("multi_get", ttypes.MultiGetRequest(hash_key=b"h")),
             ("batch_get", ttypes.BatchGetRequest(keys=[])),
             ("batch_get", b"x"), ("scan", b"k")]
    for op, args in cases:
        assert trc.is_point_read(op, args) == jrc.is_point_read(op, args)


def test_point_batch_phase_runs_on_the_cpu():
    """chip_smoke's phase 6 (BASELINE config #1 at the default store
    flags) at a small size on the CPU: every answer equal to its oracle,
    no clean encoded block's planned mask on the device."""
    import torch

    import chip_smoke

    saved = [(s, n, TFLAGS.get(s, n)) for s, n in FLAG_NAMES]
    try:
        out = chip_smoke.run_point_batch(torch.device("cpu"), 4000,
                                         n_ops=400)
    finally:
        for section, name, value in saved:
            TFLAGS.set(section, name, value, force=True)
    assert out["gets"] > 0 and out["scans"] > 0
    assert out["mask_routes"]["device_raw"] == 0
    assert out["mask_routes"]["device_malformed"] == 0
