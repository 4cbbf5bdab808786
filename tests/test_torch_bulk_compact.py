"""Bulk and merge compaction: the port's StorageEngine against the JAX
package's on the same store, exact.

- one store (L0 flushes written by the JAX engine) compacted by both
  packages, first through the merge path (L0s -> L1), then through the
  bulk block-level path (pure L1), at `block_codec` none, dcz and dcz2,
  with and without bloom and perfect-hash sidecars, with and without a
  ruleset, always with a default TTL (value headers patched) and a
  stale split (partition 1 of 2): after each step the two stores'
  records and SST bytes are identical (tests/test_compact_pipeline.py's
  `_digest` reading; the L1 index's compaction time stamp is pinned by
  patching both engines' clocks);
- the routing: without a ruleset, blocks of compressed runs are masked on
  the host (no chunk submitted), as in the JAX package;
- pipelined and serial output are identical, and equal the JAX
  package's; a crash mid-pipeline keeps the old store;
- the merge path's default-TTL rewrite wraps at 2^32 (the JAX merge path
  computes it without a mask; parity cases stay below 2^32);
- the governor's AIMD backoff, floor and grant lease; the env trigger
  through `update_app_envs` on a `PartitionServer(device="cpu")`; an
  auto-compaction runs the partition's env rules.

The JAX package's process-wide state these tests touch (its compaction
flags, GOVERNOR, the placement probe, the drift gauge) is restored after
each test, and so is the port's.
"""

import hashlib
import os
import shutil
import time

import numpy as np
import pytest

from pegasus_tpu.base.key_schema import generate_key
from pegasus_tpu.base.value_schema import generate_value
from pegasus_tpu.ops import compaction as jcomp
from pegasus_tpu.ops import placement as jplacement
from pegasus_tpu.ops.compaction_rules import compile_rules as j_compile
from pegasus_tpu.server.partition_server import PartitionServer as JServer
from pegasus_tpu.server.workload import DRIFT as JDRIFT
from pegasus_tpu.storage import compact_governor as jgov
from pegasus_tpu.storage import engine as jeng
from pegasus_tpu.storage.wal import OP_PUT as J_OP_PUT
from pegasus_tpu.utils.flags import FLAGS as JFLAGS
from pegasus_tpu_torch import convert
from pegasus_tpu_torch.ops.compaction_rules import compile_rules
from pegasus_tpu_torch.server.partition_server import PartitionServer
from pegasus_tpu_torch.storage import compact_governor as tgov
from pegasus_tpu_torch.storage import engine as teng
from pegasus_tpu_torch.storage import sstable as tsst
from pegasus_tpu_torch.storage.compact_governor import CompactionGovernor
from pegasus_tpu_torch.storage.wal import OP_PUT
from pegasus_tpu_torch.utils.flags import FLAGS as TFLAGS

NOW = 334_000_000
BLOCK = 64

FLAG_NAMES = (("pegasus.storage", "block_codec"),
              ("pegasus.storage", "compact_pipeline"),
              ("pegasus.storage", "compact_pipeline_window"),
              ("pegasus.server", "bloom_bits_per_key"),
              ("pegasus.server", "phash_index"))

RULES = [
    {"op": "delete_key", "rules": [
        {"type": "hashkey_pattern", "match": "prefix", "pattern": "hk0001"}]},
    {"op": "update_ttl", "update_ttl_type": "from_now", "value": 900,
     "rules": [{"type": "sortkey_pattern", "match": "postfix",
                "pattern": "7"}]},
    {"op": "delete_key", "rules": [
        {"type": "hashkey_pattern", "match": "anywhere", "pattern": "3"},
        {"type": "ttl_range", "start_ttl": 0, "stop_ttl": 0}]},
]


def _set(values, registries=(JFLAGS, TFLAGS)):
    for (section, name), value in values:
        for reg in registries:
            reg.set(section, name, value, force=True)


@pytest.fixture
def state(monkeypatch):
    """Pins both engines' clocks; restores both packages' flags and the
    process-wide compaction state after the test."""
    saved = [(reg, s, n, reg.get(s, n)) for reg in (JFLAGS, TFLAGS)
             for s, n in FLAG_NAMES]
    govs = [(g, dict(vars(g))) for g in (jgov.GOVERNOR, tgov.GOVERNOR)]
    monkeypatch.setattr(jeng, "epoch_now", lambda: NOW)
    monkeypatch.setattr(teng, "epoch_now", lambda: NOW)
    yield
    for reg, s, n, v in saved:
        reg.set(s, n, v, force=True)
    for g, attrs in govs:
        g.__dict__.update(attrs)
    jplacement.reset_probe()
    JDRIFT.reset()


def _items(lo, hi, rng):
    """Write-batch rows: 25 sortkeys a hashkey, pegasus-encoded values
    whose header carries the TTL; a quarter expired, a quarter expiring
    between the two compactions, the rest without a TTL."""
    out = []
    for i in range(lo, hi):
        key = generate_key(b"hk%05d" % (i // 25), b"s%03d" % (i % 25))
        r = rng.random()
        ets = NOW - 40 if r < 0.25 else NOW + 30 if r < 0.5 else 0
        out.append((key, generate_value(1, b"value-%06d|" % i * 3, ets),
                    ets))
    return out


def _build_store(d, codecs, rng, n_flushes=3, rows=300):
    """L0 flushes written by the JAX engine, one codec each in turn (a
    rolling-upgrade store mixes them)."""
    eng = jeng.StorageEngine(d, block_capacity=BLOCK,
                             values_carry_expire_header=True)
    dec = 0
    for f in range(n_flushes):
        _set([(("pegasus.storage", "block_codec"), codecs[f % len(codecs)])],
             (JFLAGS,))
        items = [jeng.WriteBatchItem(J_OP_PUT, k, v, e)
                 for k, v, e in _items(f * rows, (f + 1) * rows, rng)]
        dec += 1
        eng.write_batch(items, dec)
        eng.flush()
    eng.close()


def _digest(eng) -> str:
    """Records, then every SST file's name and bytes and the manifest."""
    h = hashlib.sha256()
    for k, v, e in eng.iterate():
        h.update(k)
        h.update(v)
        h.update(b"%d" % e)
    sst = os.path.join(eng.data_dir, "sst")
    for name in sorted(os.listdir(sst)):
        if name.endswith(".sst") or name == "MANIFEST.json":
            h.update(name.encode())
            with open(os.path.join(sst, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def _engines(tmp_path, src):
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(src, jd)
    shutil.copytree(src, td)
    return (jeng.StorageEngine(jd, block_capacity=BLOCK,
                               values_carry_expire_header=True),
            teng.StorageEngine(td, block_capacity=BLOCK,
                               values_carry_expire_header=True,
                               device="cpu"))


_J_RULES = j_compile(RULES)
_T_RULES = compile_rules(convert.rules_spec(_J_RULES.operations),
                         device="cpu")


@pytest.mark.parametrize("rules", [False, True])
@pytest.mark.parametrize("sidecars", [False, True])
@pytest.mark.parametrize("codec", ["none", "dcz", "dcz2"])
def test_merge_then_bulk_digests_match_jax(tmp_path, state, codec,
                                           sidecars, rules):
    _set([(("pegasus.server", "bloom_bits_per_key"), 10 if sidecars else 0),
          (("pegasus.server", "phash_index"), sidecars),
          (("pegasus.storage", "compact_pipeline"), True),
          (("pegasus.storage", "compact_pipeline_window"), 4)])
    src = str(tmp_path / "src")
    _build_store(src, [codec], np.random.default_rng(3))
    _set([(("pegasus.storage", "block_codec"), codec)])
    j, t = _engines(tmp_path, src)
    try:
        for step, now in (("merge", NOW), ("bulk", NOW + 60)):
            for eng, rf in ((j, _J_RULES if rules else None),
                            (t, _T_RULES if rules else None)):
                if step == "bulk":
                    assert eng.lsm.bulk_compact_eligible()
                eng.manual_compact(default_ttl=500, pidx=1,
                                   partition_version=1, validate_hash=True,
                                   rules_filter=rf, now=now)
            assert _digest(t) == _digest(j), step
        assert t.lsm.l1_runs  # something survived
    finally:
        j.close()
        t.close()


@pytest.mark.parametrize("codec", ["none", "dcz2"])
def test_ruleless_compressed_blocks_are_masked_on_the_host(
        tmp_path, state, monkeypatch, codec):
    """The routing of both packages: a ruleless bulk compaction submits
    no block of a compressed run to the device program; `none` runs, and
    every run under a ruleset, are submitted whole."""
    _set([(("pegasus.storage", "block_codec"), codec),
          (("pegasus.storage", "compact_pipeline"), False)])
    src = str(tmp_path / "src")
    _build_store(src, [codec], np.random.default_rng(4), n_flushes=2)
    counts = {"j": 0, "t": 0}

    def counting(name, fn):
        def wrapper(blocks, *a, **kw):
            counts[name] += len(blocks)
            return fn(blocks, *a, **kw)
        return wrapper

    monkeypatch.setattr(jcomp, "compaction_eval_submit",
                        counting("j", jcomp.compaction_eval_submit))
    monkeypatch.setattr(teng, "compaction_eval_submit",
                        counting("t", teng.compaction_eval_submit))
    j, t = _engines(tmp_path, src)
    try:
        for eng in (j, t):
            eng.manual_compact(now=NOW)  # merge: L0s -> L1
        n_blocks = sum(len(r.blocks) for r in t.lsm.l1_runs)
        for eng in (j, t):
            eng.manual_compact(now=NOW + 60)  # bulk, no ruleset
        want = 0 if codec == "dcz2" else n_blocks
        assert counts == {"j": want, "t": want}
        assert _digest(t) == _digest(j)
        n_blocks = sum(len(r.blocks) for r in t.lsm.l1_runs)
        j.manual_compact(now=NOW + 60, rules_filter=_J_RULES)
        t.manual_compact(now=NOW + 60, rules_filter=_T_RULES)
        assert counts == {"j": want + n_blocks, "t": want + n_blocks}
        assert _digest(t) == _digest(j)
    finally:
        j.close()
        t.close()


def test_pipelined_identical_to_serial_and_to_jax(tmp_path, state):
    """Over a store mixing none, dcz and dcz2 runs, through the merge and
    then the bulk shape: the port's pipelined and serial runs and the JAX
    package's give the same bytes."""
    src = str(tmp_path / "src")
    _build_store(src, ["none", "dcz", "dcz2"], np.random.default_rng(11),
                 n_flushes=6)
    _set([(("pegasus.storage", "block_codec"), "dcz2"),
          (("pegasus.storage", "compact_pipeline_window"), 8)])
    digs = {}
    for mode in ("serial", "pipelined", "jax"):
        _set([(("pegasus.storage", "compact_pipeline"),
               mode != "serial")])
        d = str(tmp_path / mode)
        shutil.copytree(src, d)
        eng = (jeng.StorageEngine(d, block_capacity=BLOCK)
               if mode == "jax" else
               teng.StorageEngine(d, block_capacity=BLOCK, device="cpu"))
        eng.manual_compact(default_ttl=100, now=NOW)
        assert eng.lsm.bulk_compact_eligible()
        eng.manual_compact(default_ttl=100, now=NOW + 60)
        digs[mode] = _digest(eng)
        if mode == "pipelined" and os.cpu_count() >= 4:
            assert eng.last_pipeline is not None
        eng.close()
    assert digs["serial"] == digs["pipelined"] == digs["jax"]


def test_concurrent_bulk_compactions_equal_serial_ones(tmp_path, state):
    """Stress: 12 partitions compact at once on threads, with a short
    switch interval, through the pipelined bulk path with a ruleset; they
    share the governor and the evaluation cache, and each must write
    exactly the bytes its serial compaction writes."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    _set([(("pegasus.storage", "block_codec"), "dcz2"),
          (("pegasus.storage", "compact_pipeline_window"), 2)])
    n = 12
    for p in range(n):
        _build_store(str(tmp_path / f"src{p}"), ["dcz2"],
                     np.random.default_rng(100 + p), n_flushes=1)
    want = []
    _set([(("pegasus.storage", "compact_pipeline"), False)])
    for p in range(n):
        d = str(tmp_path / f"serial{p}")
        shutil.copytree(str(tmp_path / f"src{p}"), d)
        eng = teng.StorageEngine(d, block_capacity=BLOCK, device="cpu")
        eng.manual_compact(now=NOW)
        eng.manual_compact(default_ttl=50, rules_filter=_T_RULES,
                           now=NOW + 60)
        want.append(_digest(eng))
        eng.close()
    _set([(("pegasus.storage", "compact_pipeline"), True)])
    engines = []
    for p in range(n):
        d = str(tmp_path / f"conc{p}")
        shutil.copytree(str(tmp_path / f"src{p}"), d)
        eng = teng.StorageEngine(d, block_capacity=BLOCK, device="cpu")
        eng.manual_compact(now=NOW)
        engines.append(eng)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(n) as ex:
            futures = [ex.submit(e.manual_compact, default_ttl=50,
                                 rules_filter=_T_RULES, now=NOW + 60)
                       for e in engines]
            for f in futures:
                f.result(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert [_digest(e) for e in engines] == want
    for e in engines:
        e.close()


def test_crash_mid_pipeline_keeps_old_store(tmp_path, state, monkeypatch):
    """A write fault mid-compaction aborts the pipeline: the error
    propagates, nothing of the half-built output is adopted, the store
    reopens with the old runs and serves identically, and a retry
    completes."""
    src = str(tmp_path / "s")
    _build_store(src, ["dcz2"], np.random.default_rng(5), n_flushes=4)
    _set([(("pegasus.storage", "block_codec"), "dcz2"),
          (("pegasus.storage", "compact_pipeline"), True),
          (("pegasus.storage", "compact_pipeline_window"), 4)])
    eng = teng.StorageEngine(src, block_capacity=BLOCK, device="cpu")
    eng.manual_compact(now=NOW)  # pure L1 now
    before = _digest(eng)
    runs_before = [os.path.basename(t.path) for t in eng.lsm.l1_runs]
    gen = eng.lsm.generation
    real_append = tsst.SSTableWriter._append
    calls = [0]

    def failing_append(self, *a, **kw):
        calls[0] += 1
        if calls[0] > 3:
            raise OSError(5, "injected write fault")
        return real_append(self, *a, **kw)

    monkeypatch.setattr(tsst.SSTableWriter, "_append", failing_append)
    with pytest.raises(OSError):
        eng.manual_compact(default_ttl=100, now=NOW + 60)
    monkeypatch.setattr(tsst.SSTableWriter, "_append", real_append)
    assert eng.lsm.generation == gen
    assert [os.path.basename(t.path)
            for t in eng.lsm.l1_runs] == runs_before
    eng.close()
    eng2 = teng.StorageEngine(src, block_capacity=BLOCK, device="cpu")
    assert [os.path.basename(t.path)
            for t in eng2.lsm.l1_runs] == runs_before
    assert _digest(eng2) == before
    eng2.manual_compact(default_ttl=100, now=NOW + 60)
    eng2.close()


def test_merge_path_default_ttl_wraps_past_2_32(tmp_path, state):
    """now + default_ttl >= 2^32 wraps in the port's merge path, as in
    both packages' bulk paths (the JAX merge path computes np.uint32(now
    + default_ttl) unmasked, so the parity cases stay below 2^32): the
    wrapped TTL lies before `now`, so the rewritten records drop, and a
    record with its own TTL keeps it."""
    _set([(("pegasus.storage", "block_codec"), "none")])
    now, dttl = 0xFFFFFF00, 0x300
    outs = []
    for bulk in (False, True):
        d = str(tmp_path / ("b" if bulk else "m"))
        eng = teng.StorageEngine(d, block_capacity=BLOCK, device="cpu")
        eng.write_batch([teng.WriteBatchItem(
            OP_PUT, generate_key(b"h", b"s%d" % i), b"v",
            now + 100 if i == 2 else 0) for i in range(5)], 1)
        eng.flush()
        if bulk:
            eng.manual_compact(now=now - 1000)  # to a pure L1 first
            assert eng.lsm.bulk_compact_eligible()
        eng.manual_compact(default_ttl=dttl, now=now)
        outs.append([(k, e) for k, _v, e in eng.iterate()])
        eng.close()
    assert outs[0] == outs[1] == [(generate_key(b"h", b"s2"), now + 100)]


# ---- the governor ----------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _governor(clock, pressure):
    sleeps = []

    def sleep(s):
        sleeps.append(s)
        clock.t += s

    g = CompactionGovernor(clock=clock, sleep=sleep,
                           pressure_source=lambda: pressure[0])
    return g, sleeps


def test_governor_backs_off_under_pressure_and_recovers():
    clock = _Clock()
    pressure = [0]
    g, sleeps = _governor(clock, pressure)
    step = 1 << 20
    for _ in range(40):
        g.acquire(step)
        clock.t += 0.05
    assert g.throttle_mbps == 0
    assert not sleeps
    pressure[0] = 10
    clock.t += 1.1
    g.acquire(step)
    t1 = g.throttle_mbps
    assert t1 > 0
    pressure[0] = 25
    clock.t += 1.1
    g.acquire(step)
    t2 = g.throttle_mbps
    assert t2 == pytest.approx(max(t1 / 2, TFLAGS.get(
        "pegasus.storage", "compact_min_mbps")))
    assert g.backoff_count >= 2
    n_sleeps = len(sleeps)
    for _ in range(30):
        g.acquire(step)
    assert len(sleeps) > n_sleeps and g.stall_ms > 0
    for _ in range(30):
        clock.t += 1.1
        g.acquire(step)
        if g.throttle_mbps == 0:
            break
    assert g.throttle_mbps == 0


def test_governor_floor_guarantees_progress():
    clock = _Clock()
    pressure = [0]
    g, _sleeps = _governor(clock, pressure)
    g.acquire(1 << 20)
    for _ in range(12):
        pressure[0] += 5
        clock.t += 1.1
        g.acquire(1 << 20)
    floor = float(TFLAGS.get("pegasus.storage", "compact_min_mbps"))
    assert g.throttle_mbps == pytest.approx(floor)


def test_governor_grant_lease():
    clock = _Clock()
    g, _ = _governor(clock, [0])
    assert g.heavy_allowed()
    g.set_cluster_grant(False)
    assert not g.heavy_allowed()
    g.set_cluster_grant(True)
    assert g.heavy_allowed()
    g.set_cluster_grant(False)
    lease = float(TFLAGS.get("pegasus.storage", "compact_grant_lease_s"))
    clock.t += lease + 1
    assert g.heavy_allowed()  # an expired denial fails open


def test_port_flags_default_to_the_jax_packages():
    for name in ("compact_pipeline", "compact_pipeline_window",
                 "compact_pipeline_depth", "compact_max_mbps",
                 "compact_min_mbps", "compact_feedback_interval_s",
                 "compact_grant_lease_s"):
        assert TFLAGS._flags[("pegasus.storage", name)].default == \
            JFLAGS._flags[("pegasus.storage", name)].default, name


# ---- the server --------------------------------------------------------------


def test_env_trigger_defers_until_granted(tmp_path, state):
    """Denied: the trigger defers (demand recorded, not consumed).
    Granted: the same re-delivered env starts the compaction."""
    gov = tgov.GOVERNOR
    server = PartitionServer(str(tmp_path / "p0"), device="cpu")
    try:
        for i in range(40):
            server.engine.write_batch(
                [teng.WriteBatchItem(OP_PUT, generate_key(b"gk%02d" % i,
                                                          b"s"),
                                     b"v%d" % i, 0)],
                server.engine.last_committed_decree + 1)
        lsm = server.engine.lsm
        assert not lsm.l1_runs
        trigger = {"manual_compact.once.trigger_time":
                   str(int(time.time()))}
        gov.set_cluster_grant(False)
        d0 = gov.defer_count
        server.update_app_envs(trigger)
        assert not server._mc_running
        assert gov.defer_count == d0 + 1
        assert gov.report()["waiting"] is True
        assert not lsm.l1_runs
        gov.set_cluster_grant(True)
        server.update_app_envs(trigger)
        deadline = time.monotonic() + 30
        while server._mc_running and time.monotonic() < deadline:
            time.sleep(0.02)
        assert not server._mc_running
        assert lsm.l1_runs and not len(lsm.memtable)
        # a re-delivery of the satisfied trigger does nothing
        gen = lsm.generation
        server.update_app_envs(trigger)
        assert not server._mc_running and lsm.generation == gen
    finally:
        server.close()


def test_auto_compaction_runs_the_partition_rules(tmp_path, state):
    """A write that fills the memtable flushes it, and a deep L0
    auto-compacts with the partition's env rules, in both packages."""
    _set([(("pegasus.storage", "block_codec"), "dcz2")])
    env = {"user_specified_compaction":
           '[{"op": "delete_key", "rules": [{"type": "hashkey_pattern", '
           '"match": "prefix", "pattern": "tmp"}]}]'}
    j = JServer(str(tmp_path / "j"), app_id=9001)
    t = PartitionServer(str(tmp_path / "t"), device="cpu")
    try:
        for s in (j, t):
            s.update_app_envs(env)
            s.engine.memtable_flush_trigger = 20
            for i in range(100):
                hk = b"tmp%02d" % (i % 7) if i % 3 == 0 else b"keep%02d" % i
                s.on_put(generate_key(hk, b"s%03d" % i), b"v%d" % i)
        assert t.engine.compact_count == 1
        compacted = [k for run in t.engine.lsm.l1_runs
                     for k, *_ in run.iterate()]
        assert compacted and not any(k[2:5] == b"tmp" for k in compacted)
        assert [k for k, *_ in t.engine.iterate()] == \
            [k for k, *_ in j.engine.iterate()]
    finally:
        j.close()
        t.close()
