"""The resident image sharded over a mesh of logical CPU shards: the
port's MESH_SERVING and sharded_scan_step against the JAX package's on
its eight forced host devices, exact, and the sharded round against the
one-shard round.

- MESH_SERVING over make_mesh(devices=[cpu] * 8) (dp = 8) against the
  JAX MESH_SERVING on 8 host devices (dp = 8), on the seeded 8-partition
  tables of tests/test_torch_mesh_serving.py: scan waves at the none,
  dcz and dcz2 codecs, the count, sum, top_k and sample aggregates, a
  bulk compaction of every partition (with and without a default TTL
  and a ruleset: the same SST bytes and rows), and an incremental
  refresh that restages the changed partition's shard alone;
- 5 partitions over dp = 4: P pads to 8 and the last shards hold no
  partition; the same answers as the host arm and the JAX package;
- sharded_scan_step over make_mesh(dp=4, devices=[cpu] * 8) (dp = 4,
  sp = 2) against the JAX one over make_mesh(dp=4), in
  __graft_entry__.dryrun_multichip's shape (8 partitions x 16 records),
  validate_hash off and on, partition_version -1, 0 and 3;
- the sharded round and compaction round (MeshServing._run_program,
  _compact_round) against the one-shard image's at P in {1, 5, 64},
  B in {8, 1024}, dp in {1, 2, 4, 8}, sp 2 where a shard keeps 8 rows:
  packed masks, counts, lane sums, drop masks and TTLs equal.
"""

import numpy as np
import pytest
import torch
from test_torch_mesh_cards import (
    assert_same_image_results,
    image_results,
    random_slabs,
)
from test_torch_mesh_compact import RULES, build_store, digest
from test_torch_mesh_serving import (
    PKGS,
    REQS,
    agg_wires,
    all_rows,
    attach_all,
    build_pair,
    clear_mask_caches,
    close,
    force_mesh_pays,
)
from torch_mesh_helpers import T0
from torch_mesh_helpers import mesh_guard as guard

from pegasus_tpu.base.key_schema import generate_key, key_hash
from pegasus_tpu.client import Table as JTable
from pegasus_tpu.ops import placement as jplacement
from pegasus_tpu.ops.compaction_rules import compile_rules as j_compile
from pegasus_tpu.ops.predicates import FilterSpec as JFilterSpec
from pegasus_tpu.ops.record_block import build_record_block as j_build
from pegasus_tpu.parallel import make_mesh as j_make_mesh
from pegasus_tpu.parallel import sharded_scan_step as j_sharded
from pegasus_tpu.parallel.mesh_resident import MESH_SERVING as JMESH
from pegasus_tpu.parallel.partition_mesh import stack_blocks as j_stack
from pegasus_tpu.storage import engine as jeng
from pegasus_tpu_torch.client import Table
from pegasus_tpu_torch.ops import placement
from pegasus_tpu_torch.ops.compaction_rules import compile_rules
from pegasus_tpu_torch.ops.predicates import FT_MATCH_PREFIX, FilterSpec
from pegasus_tpu_torch.ops.record_block import build_record_block as t_build
from pegasus_tpu_torch.parallel import make_mesh, sharded_scan_step
from pegasus_tpu_torch.parallel.mesh_resident import MESH_SERVING, _build_stack
from pegasus_tpu_torch.parallel.partition_mesh import stack_blocks
from pegasus_tpu_torch.storage import engine as teng

CPU = torch.device("cpu")
FLAG_NAMES = (("pegasus.storage", "block_codec"),
              ("pegasus.storage", "compact_pipeline"),
              ("pegasus.mesh", "serving_enabled"),
              ("pegasus.server", "rocksdb_max_iteration_count"))


def shards(dp: int, sp: int = 1):
    return make_mesh(dp=dp, devices=[CPU] * (dp * sp))


@pytest.fixture
def mesh_guard(monkeypatch):
    """Frozen clocks and compaction time stamps in both packages; both
    MESH_SERVINGs (the port's mesh included) detached, DRIFTs and METRICS
    zeroed, before and after; flags restored."""
    for mod in (jeng, teng):
        monkeypatch.setattr(mod, "epoch_now", lambda: 400_000_000)
    with guard(monkeypatch, FLAG_NAMES) as clk:
        yield clk


def test_jax_mesh_is_dp8_over_host_devices(mesh_guard, tmp_path):
    """The reference this file holds the port to: the JAX MESH_SERVING
    spans the 8 forced host devices as dp = 8."""
    tables, _c = build_pair(tmp_path, rows=60)
    try:
        attach_all(tables)
        JMESH.ensure_current()
        assert (JMESH._pmesh.dp, JMESH._pmesh.sp) == (8, 1)
        MESH_SERVING.use_mesh(shards(8))
        MESH_SERVING.ensure_current()
        st, jst = MESH_SERVING.status(), JMESH.status()
        assert st["devices"] == jst["devices"] == 8
        assert st["platform"] == jst["platform"] == "cpu"
        stack = MESH_SERVING._tables[tables[1].app_id].stack
        jstack = JMESH._tables[tables[0].app_id].stack
        assert (stack.P, stack.B, stack.K) == (jstack.P, jstack.B, jstack.K)
        assert len(stack.shards) == 8
        assert [sh.slot0 for sh in stack.shards] == list(range(8))
    finally:
        close(tables)


@pytest.mark.parametrize("codec", ["none", "dcz", "dcz2"])
def test_waves_over_8_shards_match_jax(tmp_path, mesh_guard, monkeypatch,
                                       codec):
    tables, _c = build_pair(tmp_path, compact_codec=codec)
    try:
        host = {name: all_rows(tables[1], PKGS[1], f) for name, f in REQS}
        for t in tables:
            clear_mask_caches(t)
        force_mesh_pays(monkeypatch)
        MESH_SERVING.use_mesh(shards(8))
        attach_all(tables)
        for name, f in REQS:
            assert all_rows(tables[1], PKGS[1], f) == host[name], name
            assert all_rows(tables[0], PKGS[0], f) == host[name], name
        assert MESH_SERVING.wave_dispatches > 0
        assert MESH_SERVING.wave_dispatches == JMESH.wave_dispatches
    finally:
        close(tables)


@pytest.mark.parametrize("n_parts,dp", [(8, 8), (5, 4)])
def test_aggregates_over_shards_match_jax(tmp_path, mesh_guard, n_parts,
                                          dp):
    """5 partitions over dp = 4 pad P to 8: the last shards hold no
    partition, and every answer stays the host arm's and the JAX
    package's."""
    tables, _c = build_pair(tmp_path, compact_codec="dcz2",
                            n_parts=n_parts)
    kinds = ("count", "sum", "top_k", "sample")
    try:
        host = {kind: agg_wires(tables[1], PKGS[1], kind) for kind in kinds}
        assert sum(w["count"] for w in host["count"].values()) > 0
        MESH_SERVING.use_mesh(shards(dp))
        attach_all(tables)
        for kind in kinds:
            assert agg_wires(tables[1], PKGS[1], kind) == host[kind], kind
            assert agg_wires(tables[0], PKGS[0], kind) == host[kind], kind
        assert MESH_SERVING.agg_dispatches == 2 == JMESH.agg_dispatches
        stack = MESH_SERVING._tables[tables[1].app_id].stack
        assert stack.P == max(dp, -(-n_parts // dp) * dp)
        empty = [sh for sh in stack.shards if not sh.slabs]
        assert len(empty) == (stack.P - n_parts) // (stack.P // dp)
    finally:
        close(tables)


def test_refresh_restages_one_shard(tmp_path, mesh_guard, monkeypatch):
    tables, clients = build_pair(tmp_path, rows=120, compact_codec="dcz")
    try:
        force_mesh_pays(monkeypatch)
        MESH_SERVING.use_mesh(shards(8))
        attach_all(tables)
        make = REQS[0][1]
        before = all_rows(tables[1], PKGS[1], make)
        stack0 = MESH_SERVING._tables[tables[1].app_id].stack
        assert MESH_SERVING.shard_stages == 8
        builds0 = MESH_SERVING.stack_builds
        # the smallest partition takes 3 rows: the geometry holds
        hk = min((b"hk%02d" % i for i in range(13)),
                 key=lambda h: len(before[tables[1].resolve(h).pidx]))
        for t, c in zip(tables, clients):
            target = t.resolve(hk)
            for j in range(3):
                assert c.set(hk, b"z%03d" % j, b"blue-new-%d" % j) == 0
            target.engine.flush()
            target.engine.manual_compact()
            clear_mask_caches(t)
        after = all_rows(tables[1], PKGS[1], make)
        assert after == all_rows(tables[0], PKGS[0], make)
        pidx = tables[1].resolve(hk).pidx
        assert {p for p in after if after[p] != before[p]} == {pidx}
        stack1 = MESH_SERVING._tables[tables[1].app_id].stack
        assert (stack1.P, stack1.B, stack1.K) == (stack0.P, stack0.B,
                                                   stack0.K)
        # every restack (the flush's, the compaction's) staged the
        # changed partition's shard and carried the other 7 over
        restacks = MESH_SERVING.stack_builds - builds0
        assert restacks >= 1
        st = MESH_SERVING.status()
        assert st["shard_stages"] == 8 + restacks
        assert st["shard_reuses"] == 7 * restacks
        slot = [p for p, _s in stack1.slots].index(pidx)
        for i, (new, old) in enumerate(zip(stack1.shards, stack0.shards)):
            assert (new is old) == (i != slot)
    finally:
        close(tables)


def compact_all(base, name, now, *, port, dp=None, default_ttl=0,
                rules=None):
    """Copy the base store, compact every partition at `now` through one
    package's resident image (the port's over `dp` logical shards), and
    return (SST digests, rows, that package's serving status)."""
    import shutil

    d = base + "_" + name
    shutil.copytree(base, d)
    serving = MESH_SERVING if port else JMESH
    serving.reset()
    if port:
        serving.use_mesh(shards(dp))
        t = Table(d, app_id=9111, partition_count=8, device="cpu")
        rf = compile_rules(rules, device="cpu") if rules else None
    else:
        t = JTable(d, app_id=9111, partition_count=8)
        rf = j_compile(rules) if rules else None
    try:
        for s in t.partitions.values():
            serving.attach(s)
        for s in t.partitions.values():
            s.manual_compact(default_ttl=default_ttl, rules_filter=rf,
                             now=now)
        st = serving.status()
        rows = {p: list(s.engine.lsm.iterate())
                for p, s in sorted(t.partitions.items())}
        return digest(d), rows, st
    finally:
        t.close()
        serving.reset()


@pytest.mark.parametrize("default_ttl,rules", [(0, None), (500, RULES)])
def test_bulk_compaction_over_8_shards_matches_jax(tmp_path, mesh_guard,
                                                   monkeypatch, default_ttl,
                                                   rules):
    base = build_store(tmp_path, final_codec="dcz2")
    now = int(T0) + 3600
    for mod in (jplacement, placement):
        monkeypatch.setattr(mod, "mesh_compact_pays", lambda *_a, **_k: True)
    got, rows, st = compact_all(base, "port", now, port=True, dp=8,
                                default_ttl=default_ttl, rules=rules)
    want, jrows, jst = compact_all(base, "jax", now, port=False,
                                   default_ttl=default_ttl, rules=rules)
    assert got == want and rows == jrows
    assert any(rows.values()), "degenerate fixture: nothing survived"
    assert st["compact_dispatches"] == 1 == jst["compact_dispatches"]
    assert st["compact_mask_serves"] == 8 == jst["compact_mask_serves"]


def dryrun_parts(n_parts, per_part):
    """__graft_entry__.dryrun_multichip's partitions: keys that hash to
    their partition, every other one expired."""
    parts = []
    for p in range(n_parts):
        keys, ets, i = [], [], 0
        while len(keys) < per_part:
            hk = b"user_%d" % i
            i += 1
            if key_hash(generate_key(hk, b"")) % n_parts != p:
                continue
            keys.append(generate_key(hk, b"sk_%03d" % len(keys)))
            ets.append(0 if len(keys) % 2 else 1)
        parts.append((keys, ets))
    return parts


@pytest.mark.parametrize("validate", [False, True])
@pytest.mark.parametrize("pv", [-1, 0, 3])
def test_sharded_scan_step_dp4_sp2_matches_jax(validate, pv):
    parts = dryrun_parts(8, 16)
    # two partitions' blocks swapped: their rows are foreign
    parts[2], parts[5] = parts[5], parts[2]
    pidx = list(range(8))
    jb = [j_build(k, e, capacity=16, key_width=32) for k, e in parts]
    tb = [t_build(k, e, capacity=16, key_width=32, device="cpu")
          for k, e in parts]
    jpm = j_make_mesh(dp=4)
    assert (jpm.dp, jpm.sp) == (4, 2)
    pm = make_mesh(dp=4, devices=[CPU] * 8)
    assert (pm.dp, pm.sp) == (4, 2)
    jout = j_sharded(jpm, j_stack(jb, pidx), now=100,
                     sort_filter=JFilterSpec.make(FT_MATCH_PREFIX, b"sk_"),
                     partition_version=pv, validate_hash=validate)
    tout = sharded_scan_step(pm, stack_blocks(tb, pidx), now=100,
                             sort_filter=FilterSpec.make(FT_MATCH_PREFIX,
                                                         b"sk_"),
                             partition_version=pv, validate_hash=validate)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    for t, j in zip(tout[1:], jout[1:]):
        np.testing.assert_array_equal(np.asarray(t.numpy(), np.int64),
                                      np.asarray(j, np.int64))
    one = sharded_scan_step(make_mesh(devices=[CPU]), stack_blocks(tb, pidx),
                            now=100,
                            sort_filter=FilterSpec.make(FT_MATCH_PREFIX,
                                                        b"sk_"),
                            partition_version=pv, validate_hash=validate)
    for t, o in zip(tout, one):
        assert torch.equal(t, o)


def test_sharded_scan_step_needs_whole_tiles():
    parts = dryrun_parts(6, 16)
    tb = [t_build(k, e, capacity=16, key_width=32, device="cpu")
          for k, e in parts]
    with pytest.raises(ValueError, match="not divisible"):
        sharded_scan_step(make_mesh(dp=4, devices=[CPU] * 8),
                          stack_blocks(tb), now=100)


CASES = [(p, b, dp, sp) for p in (1, 5, 64) for b in (8, 1024)
         for dp in (1, 2, 4, 8) for sp in (1, 2) if b // sp >= 8]


@pytest.mark.parametrize("p,b,dp,sp", CASES)
def test_sharded_round_matches_one_shard(p, b, dp, sp):
    rng = np.random.default_rng(p * 100 + b + dp * 7 + sp)
    slabs = random_slabs(rng, p, b)
    one = _build_stack(make_mesh(devices=[CPU]), slabs)
    sharded = _build_stack(shards(dp, sp), slabs)
    assert (one.P, one.B) == (p, b)
    assert sharded.P == max(dp, -(-p // dp) * dp) and sharded.B == b
    assert len(sharded.shards) == dp * sp
    assert all(sh.B == b // sp for sh in sharded.shards)
    assert_same_image_results(image_results(one, CPU),
                              image_results(sharded, CPU), p)


def test_sp_must_be_a_power_of_two():
    slabs = random_slabs(np.random.default_rng(0), 2, 64)
    with pytest.raises(ValueError, match="power of two"):
        _build_stack(make_mesh(dp=1, devices=[CPU] * 3), slabs)


def test_a_mesh_of_another_device_type_raises(tmp_path, mesh_guard):
    """No shard of a table quietly runs elsewhere than its servers'
    device type."""
    tables, _c = build_pair(tmp_path, rows=30)
    try:
        MESH_SERVING.use_mesh(make_mesh(devices=[torch.device("meta")] * 2))
        for s in tables[1].partitions.values():
            MESH_SERVING.attach(s)
        with pytest.raises(ValueError, match="servers are on cpu"):
            MESH_SERVING.ensure_current()
        MESH_SERVING.use_mesh(None)
        assert MESH_SERVING.ensure_current()
        assert MESH_SERVING.status()["devices"] == 1
    finally:
        close(tables)
