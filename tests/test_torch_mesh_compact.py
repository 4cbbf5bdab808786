"""The bulk compaction's filter over the resident image: the port's
`mesh_compact_step` and MESH_SERVING.try_compact_masks against the JAX
package's, exact.

- `ops/compaction.mesh_compact_step` (the compaction kernel's slot-gate
  instance on the card, eval_block_plain with the same gate here)
  against the JAX package's on seeded [P, B, K] images, at P in {1, 3,
  8} and K in {32, 64}: validation off and on with pv < 0, a pv that
  switches the stale-split drop off for some slots and one that keeps
  it for all, a default TTL, a ruleset, want_ets on and off: packed
  drop masks and rewritten TTLs equal;
- the compaction gate only switches the stale drop off: a slot above
  the version keeps its foreign rows (the scan gate would reject them);
- one store (tests/test_mesh_compact.py's: three codec generations,
  TTL'd rows, empty-hashkey rows, compacted to pure L1 at none, dcz or
  dcz2) compacted by all 8 partitions at a fixed `now` in the port
  host-serial, host-pipelined and resident, and in the JAX package
  resident: every arm publishes the same SST bytes (both engines' L1
  index time stamp pinned) and the same rows, and the resident arms
  serve the table from ONE round (compact_dispatches 1, mask serves 8);
  with a default TTL and a ruleset too;
- a resident compaction's publish refreshes the image by survivor
  gather (reuse 8, rebuild 0, no slab built), and a publish the image
  did not filter rebuilds;
- the gate's shape under the card's constants, the counters in
  status().

The JAX package's watchdog test has no counterpart (the port has no
watchdog). Both packages' MESH_SERVING, flags, DRIFT and METRICS are
reset and restored around every test.
"""

import hashlib
import os
import shutil

import numpy as np
import pytest
import torch
from torch_mesh_helpers import T0, set_flags
from torch_mesh_helpers import mesh_guard as guard

from pegasus_tpu.client import PegasusClient as JClient
from pegasus_tpu.client import Table as JTable
from pegasus_tpu.ops import compaction as jcomp
from pegasus_tpu.ops import placement as jplacement
from pegasus_tpu.ops.compaction_rules import compile_rules as j_compile
from pegasus_tpu.parallel.mesh_resident import MESH_SERVING as JMESH
from pegasus_tpu.storage import engine as jeng
from pegasus_tpu_torch.client import Table
from pegasus_tpu_torch.ops import placement
from pegasus_tpu_torch.ops.compaction import mesh_compact_step
from pegasus_tpu_torch.ops.compaction_rules import compile_rules
from pegasus_tpu_torch.parallel.mesh_resident import MESH_SERVING
from pegasus_tpu_torch.parallel.partition_mesh import partition_allowed
from pegasus_tpu_torch.server.workload import DRIFT as TDRIFT
from pegasus_tpu_torch.storage import engine as teng

N_PARTS = 8
# an app id no other test uses: the JAX servers register process-wide
# metric entities under it
APP_ID = 9111
FROZEN_FINISH = 400_000_000  # the L1 index's compaction time stamp
FLAG_NAMES = (("pegasus.storage", "block_codec"),
              ("pegasus.storage", "compact_pipeline"),
              ("pegasus.mesh", "serving_enabled"))

RULES = ('[{"op":"delete_key","rules":[{"type":"hashkey_pattern",'
         '"match":"prefix","pattern":"hk01"}]},'
         '{"op":"update_ttl","update_ttl_type":"from_now","value":1234,'
         '"rules":[{"type":"sortkey_pattern","match":"anywhere",'
         '"pattern":"s001"}]}]')


@pytest.fixture
def mesh_guard(monkeypatch):
    """Frozen clocks and compaction time stamps in both packages; both
    MESH_SERVINGs detached, DRIFTs and METRICS zeroed, before and
    after; flags restored."""
    for mod in (jeng, teng):
        monkeypatch.setattr(mod, "epoch_now", lambda: FROZEN_FINISH)
    with guard(monkeypatch, FLAG_NAMES) as clk:
        yield clk


def force_compact_pays(monkeypatch):
    """Tiny fixtures never amortize a round: the identity tests pin both
    gates open (the gate has its own test, and chip_smoke.py phase 10
    runs the measured one)."""
    for mod in (jplacement, placement):
        monkeypatch.setattr(mod, "mesh_compact_pays",
                            lambda *_a, **_k: True)


# -- the step ------------------------------------------------------------

def image(rng, pc, b, k, now):
    """A seeded [P, B, K] image, numpy: keys in the rules' alphabet with
    a valid u16 hashkey prefix, TTLs around `now` (some 0 for the
    default TTL), hash_lo matching the slot's pidx for most rows."""
    keys = np.zeros((pc, b, k), np.uint8)
    key_len = np.zeros((pc, b), np.int32)
    ets = np.zeros((pc, b), np.uint32)
    present = np.zeros((pc, b), bool)
    hash_lo = np.zeros((pc, b), np.uint32)
    pidx = rng.permutation(pc).astype(np.uint32)
    for s in range(pc):
        n = int(rng.integers(0, b + 1)) if s else b
        present[s, :n] = True
        for r in range(n):
            hk = b"hk%02d" % int(rng.integers(0, 4))
            sk = b"s%03d" % int(rng.integers(0, 12))
            key = len(hk).to_bytes(2, "big") + hk + sk
            keys[s, r, :len(key)] = np.frombuffer(key, np.uint8)
            key_len[s, r] = len(key)
        ets[s, :n] = rng.choice(
            np.array([0, 0, 1, now - 1, now, now + 1, now + 2000,
                      0xFFFFFFFF], np.uint32), n)
        own = rng.random(n) < 0.7
        noise = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        hash_lo[s, :n] = np.where(own, (noise & ~np.uint32(7)) | pidx[s],
                                  noise)
    hkl = np.where(key_len >= 2,
                   (keys[..., 0].astype(np.int32) << 8) | keys[..., 1], 0)
    return keys, key_len, hkl.astype(np.int32), ets, present, hash_lo, pidx


def run_step(img, validate, pv, default_ttl, rules, want_ets, now):
    keys, key_len, hkl, ets, present, hash_lo, pidx = img
    allowed = partition_allowed(pidx, validate, max(pv, 0))
    j = jcomp.mesh_compact_step(
        keys, key_len, hkl, ets, present, hash_lo, pidx, allowed,
        np.uint32(now), np.uint32(default_ttl),
        np.uint32(max(pv, 0)),
        operations=j_compile(rules).operations if rules else None,
        validate_hash=validate, want_ets=want_ets)

    def t(a, dtype=None):
        a = np.ascontiguousarray(a)
        return torch.from_numpy(a.view(dtype) if dtype else a)

    p = mesh_compact_step(
        t(keys), t(key_len), t(hkl), t(ets, np.int32), t(present),
        t(hash_lo, np.int32), t(pidx, np.int32), t(allowed), now,
        default_ttl, pv,
        operations=(compile_rules(rules, device="cpu").operations
                    if rules else None),
        validate_hash=validate, want_ets=want_ets)
    return [np.asarray(x) for x in j], [x.numpy() for x in p]


@pytest.mark.parametrize("pc", [1, 3, 8])
@pytest.mark.parametrize("width", [32, 64])
@pytest.mark.parametrize("validate,pv", [(False, -1), (True, -1),
                                         (True, 2), (True, 7)])
def test_mesh_compact_step_matches_jax(pc, width, validate, pv):
    rng = np.random.default_rng(pc * 1000 + width * 10 + pv)
    now = 5000
    img = image(rng, pc, 64, width, now)
    for default_ttl, rules, want_ets in ((0, None, False), (300, None, True),
                                         (0, RULES, True),
                                         (0xFFFFFF00, RULES, False)):
        want, got = run_step(img, validate, pv, default_ttl, rules,
                             want_ets, now)
        assert len(got) == len(want) == (2 if want_ets else 1)
        np.testing.assert_array_equal(got[0], want[0])
        if want_ets:
            np.testing.assert_array_equal(got[1].view(np.uint32), want[1])


def test_compaction_gate_only_switches_the_stale_drop_off():
    """A slot above the version keeps its foreign rows (check_if_stale_
    split_data's keep for mid-split children); a slot at or below it
    drops them. The scan gate, by contrast, rejects the whole slot."""
    pc, b, now = 2, 8, 5000
    keys = np.zeros((pc, b, 32), np.uint8)
    key_len = np.full((pc, b), 4, np.int32)
    hkl = np.zeros((pc, b), np.int32)
    ets = np.zeros((pc, b), np.int32)
    present = np.ones((pc, b), bool)
    hash_lo = np.full((pc, b), 2, np.int32)  # (2 & pv=1) = 0: foreign to 1
    pidx = np.array([1, 3], np.int32)
    allowed = partition_allowed(pidx, True, 1)
    assert allowed.tolist() == [True, False]
    (packed,) = mesh_compact_step(
        *(torch.from_numpy(a) for a in (keys, key_len, hkl, ets, present,
                                        hash_lo, pidx, allowed)),
        now, 0, 1, validate_hash=True, want_ets=False)
    assert packed.tolist() == [[0xFF], [0x00]]


# -- whole compactions ---------------------------------------------------

def build_store(tmp_path, final_codec="none"):
    """tests/test_mesh_compact.py's store, written by the JAX package:
    rows under three codec generations, TTL'd rows (expired at the arms'
    `now`), empty-hashkey rows, compacted to pure L1 under
    `final_codec`."""
    base = str(tmp_path / "base")
    table = JTable(base, app_id=APP_ID, partition_count=N_PARTS)
    c = JClient(table)
    i = 0
    for codec in ("none", "dcz", "dcz2"):
        set_flags("pegasus.storage", "block_codec", codec)
        for _ in range(200):
            assert c.set(b"hk%03d" % (i % 40), b"s%05d" % i, b"v%05d" % i,
                         ttl_seconds=7 if i % 3 == 0 else 0) == 0
            i += 1
        assert c.set(b"", b"osk%02d" % (i % 7), b"ovf-%d" % i) == 0
        i += 1
        table.flush_all()
    set_flags("pegasus.storage", "block_codec", final_codec)
    for s in table.partitions.values():
        s.engine.flush()
        s.engine.manual_compact()
    for s in table.partitions.values():
        assert s.engine.lsm.bulk_compact_eligible()
    table.close()
    return base


def digest(d):
    """(relpath, sha256) of every published SST under the table dir."""
    out = []
    for root, _dirs, files in os.walk(d):
        for f in sorted(files):
            if f.endswith(".sst"):
                p = os.path.join(root, f)
                with open(p, "rb") as fh:
                    out.append((os.path.relpath(p, d),
                                hashlib.sha256(fh.read()).hexdigest()))
    return sorted(out)


def compact_arm(base, name, now, *, port=True, mesh=False, pipelined=True,
                default_ttl=0, rules=None):
    """Copy the base store, compact every partition at `now` in one
    package, return (SST digests, rows, that package's serving
    status)."""
    d = base + "_" + name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(base, d)
    serving = MESH_SERVING if port else JMESH
    serving.reset()
    set_flags("pegasus.storage", "compact_pipeline", pipelined)
    if port:
        t = Table(d, app_id=APP_ID, partition_count=N_PARTS, device="cpu")
        rf = compile_rules(rules, device="cpu") if rules else None
    else:
        t = JTable(d, app_id=APP_ID, partition_count=N_PARTS)
        rf = j_compile(rules) if rules else None
    try:
        if mesh:
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


@pytest.mark.parametrize("codec", ["none", "dcz", "dcz2"])
def test_identity_host_serial_pipelined_mesh(tmp_path, mesh_guard,
                                             monkeypatch, codec):
    base = build_store(tmp_path, final_codec=codec)
    now = int(T0) + 3600  # every ttl_seconds=7 row has expired
    serial, s_rows, _ = compact_arm(base, "serial", now, pipelined=False)
    piped, p_rows, _ = compact_arm(base, "piped", now)
    force_compact_pays(monkeypatch)
    meshed, m_rows, st = compact_arm(base, "mesh", now, mesh=True)
    jmeshed, j_rows, jst = compact_arm(base, "jmesh", now, port=False,
                                       mesh=True)
    assert serial == piped == meshed == jmeshed
    assert s_rows == p_rows == m_rows == j_rows
    assert any(s_rows.values()), "degenerate fixture: nothing survived"
    assert st["compact_dispatches"] == 1 == jst["compact_dispatches"]
    assert st["compact_mask_serves"] == N_PARTS
    assert st["compact_mesh_fallback_count"] == 0
    assert st["compact_mesh_dispatch_count"] == 1
    assert TDRIFT.status()["classes"]["mesh_compact"]["samples"] == 1


def test_identity_default_ttl_and_rules(tmp_path, mesh_guard, monkeypatch):
    """The want_ets leg: a default-TTL rewrite and a ruleset (delete_key,
    update_ttl) patch TTL headers the same whether the rewritten TTLs
    came off the resident round or the host stages."""
    base = build_store(tmp_path, final_codec="dcz2")
    now = int(T0) + 3600
    host, h_rows, _ = compact_arm(base, "host", now, default_ttl=500,
                                  rules=RULES)
    force_compact_pays(monkeypatch)
    meshed, m_rows, st = compact_arm(base, "mesh", now, mesh=True,
                                     default_ttl=500, rules=RULES)
    jmeshed, j_rows, _ = compact_arm(base, "jmesh", now, port=False,
                                     mesh=True, default_ttl=500,
                                     rules=RULES)
    assert host == meshed == jmeshed
    assert h_rows == m_rows == j_rows
    assert st["compact_dispatches"] == 1
    assert st["compact_mask_serves"] == N_PARTS


def test_publish_refresh_reuses_survivor_masks(tmp_path, mesh_guard,
                                               monkeypatch):
    """A resident compaction's publish refreshes the image by survivor
    gather (reuse counter, no slab built); a publish the image did not
    filter rebuilds."""
    from pegasus_tpu_torch.client import PegasusClient

    base = build_store(tmp_path)
    now = int(T0) + 3600
    force_compact_pays(monkeypatch)
    d = base + "_refresh"
    shutil.copytree(base, d)
    t = Table(d, app_id=APP_ID, partition_count=N_PARTS, device="cpu")
    try:
        for s in t.partitions.values():
            MESH_SERVING.attach(s)
        assert MESH_SERVING.ensure_current()
        builds0 = MESH_SERVING.slab_builds
        for s in t.partitions.values():
            s.manual_compact(now=now)
        assert MESH_SERVING.ensure_current()
        st = MESH_SERVING.status()
        assert st["compact_dispatches"] == 1
        assert st["refresh_reuses"] == N_PARTS
        assert st["mesh_refresh_reuse_count"] == N_PARTS
        assert st["refresh_rebuilds"] == 0
        assert MESH_SERVING.slab_builds == builds0
        for pidx, s in t.partitions.items():
            slab = MESH_SERVING._tables[s.app_id].slabs[pidx]
            assert slab.generation == s.engine.lsm.generation
            assert slab.n_rows == sum(
                int(bm.count) for run in s.engine.lsm.l1_runs
                for bm in run.blocks)
        c = PegasusClient(t)
        assert c.set(b"hk000", b"snew", b"fresh") == 0
        for s in t.partitions.values():
            s.engine.flush()
            s.engine.manual_compact()  # the merge path: no resident masks
        assert MESH_SERVING.ensure_current()
        st2 = MESH_SERVING.status()
        assert st2["refresh_rebuilds"] >= 1
        assert st2["mesh_refresh_rebuild_count"] == st2["refresh_rebuilds"]
    finally:
        t.close()


def test_compact_gate_and_breakdown(monkeypatch):
    """The gate's shape under the card's constants: a lone one-window
    compaction of one small partition stays on the host stages; a
    64-partition image of 2^20 rows, 64 windows, pays."""
    monkeypatch.setattr(placement, "_PROBE_RTT", 3e-5)
    monkeypatch.setattr(placement, "_PROBE_DEVICE", torch.device("cuda", 0))
    assert not placement.mesh_compact_pays(1, 64 * 1024)
    rows = 1 << 20
    assert placement.mesh_compact_pays(64, rows * 41, rows // 8)
    bd = placement.offload_breakdown("rules", 1 << 20)
    c = bd["compact"]
    assert c["workload"] == "mesh_compact"
    assert {"n_windows", "mask_bytes", "mesh_pays", "mesh_batch_s_est",
            "host_batch_s_est"} <= set(c)
    c64 = placement.compact_breakdown(1 << 28, n_windows=64)
    assert c64["n_windows"] == 64
    assert c64["host_batch_s_est"] > c["host_batch_s_est"]


def test_compact_counters_in_status(mesh_guard):
    st = MESH_SERVING.status()
    for key in ("compact_mesh_dispatch_count", "compact_mesh_fallback_count",
                "mesh_refresh_reuse_count", "mesh_refresh_rebuild_count",
                "compact_dispatches", "compact_mask_serves",
                "refresh_reuses", "refresh_rebuilds"):
        assert st[key] == 0, key
    assert "watchdog" not in st and "tunnel_wedged" not in st
