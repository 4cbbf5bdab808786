"""crc64 of key regions as torch ops (ops/device_crc.py) against the JAX
package's device functions, exact, and a PGT1 store (blocks without a
hash_lo column) served by both packages.

- `crc64_device`, `key_hash_device` and `check_partition_hash_device`
  on seeded rows: empty hashkeys (the sortkey region is hashed), regions
  that reach and pass the padded width K (the byte loop reads K - 1
  there), zero-length and negative regions, scalar and per-row starts
  (tests/test_ops_predicates.py:53-75 in the JAX package's suite);
- a `none` store rewritten as PGT1 (chip_smoke.write_pgt1) is scanned by
  both packages through the batched path and per request, partition 3
  of 8 with foreign rows in it: the port hashes the keys
  (key_hash_device on the CPU), the JAX package on its device, and the
  static masks and the pages are equal.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pegasus_tpu.base.crc import crc64
from pegasus_tpu.ops import device_crc as jcrc
from pegasus_tpu.server import types as jtypes
from pegasus_tpu.server.partition_server import PartitionServer as JServer
from pegasus_tpu.server.workload import DRIFT as JDRIFT
from pegasus_tpu.utils.flags import FLAGS as JFLAGS
from pegasus_tpu_torch.base.key_schema import generate_key, key_hash
from pegasus_tpu_torch.ops import device_crc as tcrc
from pegasus_tpu_torch.ops.record_block import build_record_block
from pegasus_tpu_torch.server import types as ttypes
from pegasus_tpu_torch.server.partition_server import PartitionServer
from pegasus_tpu_torch.utils.flags import FLAGS as TFLAGS

FLAG_NAMES = (("pegasus.storage", "block_codec"),
              ("pegasus.server", "bloom_bits_per_key"),
              ("pegasus.server", "phash_index"))


def _rows(seed: int, b: int, k: int):
    """Seeded padded rows with every region edge: hashkey lengths of 0,
    in range, at K - 2 and past it; key lengths of 0, 1, 2, in range, at
    K and past it."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 256, (b, k), dtype=np.uint8)
    key_len = rng.integers(0, k + 1, b).astype(np.int32)
    key_len[:6] = [0, 1, 2, k, k + 3, k - 1]
    hkl = (rng.random(b) * np.maximum(key_len - 1, 1)).astype(np.int32)
    hkl[::5] = 0                       # empty hashkey: the sortkey region
    hkl[6:10] = [k - 2, k, k + 5, 1]   # at and past the row
    return keys, key_len, hkl


def _jax(fn, *args, **kw):
    hi, lo = fn(*(jnp.asarray(a) for a in args), **kw)
    return (np.asarray(hi).view(np.int32), np.asarray(lo).view(np.int32))


def _torch(fn, *args, **kw):
    hi, lo = fn(*(torch.from_numpy(np.ascontiguousarray(a))
                  for a in args), **kw)
    return hi.numpy(), lo.numpy()


@pytest.mark.parametrize("k", [32, 64, 256])
def test_key_hash_device_matches_jax(k):
    keys, key_len, hkl = _rows(k, 97, k)
    want = _jax(jcrc.key_hash_device, keys, key_len, hkl)
    got = _torch(tcrc.key_hash_device, keys, key_len, hkl)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("start", [0, 2, 5, "rows"])
def test_crc64_device_matches_jax(start):
    keys, key_len, _hkl = _rows(7, 61, 32)
    lengths = key_len - 3            # some negative, some past the row
    if start == "rows":
        st = np.random.default_rng(8).integers(0, 34, 61).astype(np.int32)
        want = _jax(jcrc.crc64_device, keys, lengths, st)
        got = _torch(tcrc.crc64_device, keys, lengths, st)
    else:
        want = _jax(jcrc.crc64_device, keys, lengths, start=start)
        got = _torch(tcrc.crc64_device, keys, lengths, start=start)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


def test_crc64_device_matches_host_crc64():
    """As the JAX suite checks its own: the full crc64 of each key body,
    and pegasus_key_hash of each key (the sortkey when the hashkey is
    empty)."""
    rng = np.random.default_rng(2)
    keys = []
    for _ in range(33):
        hk = bytes(rng.integers(97, 123, int(rng.integers(0, 12)),
                                dtype=np.uint8))
        sk = bytes(rng.integers(97, 123, int(rng.integers(0, 20)),
                                dtype=np.uint8))
        keys.append(generate_key(hk, sk))
    keys.append(generate_key(b"", b"sortonly"))
    block = build_record_block(keys, [0] * len(keys), capacity=64)
    hi, lo = tcrc.crc64_device(block.keys, block.key_len - 2, start=2)
    khi, klo = tcrc.key_hash_device(block.keys, block.key_len,
                                    block.hashkey_len)
    for i, key in enumerate(keys):
        full = ((int(hi[i]) & 0xFFFFFFFF) << 32) | (int(lo[i]) & 0xFFFFFFFF)
        assert full == crc64(key[2:])
        got = ((int(khi[i]) & 0xFFFFFFFF) << 32) | (int(klo[i])
                                                     & 0xFFFFFFFF)
        assert got == key_hash(key)


@pytest.mark.parametrize("pidx,pv", [(0, 7), (3, 7), (5, 15), (1, 1)])
def test_check_partition_hash_device_matches_jax(pidx, pv):
    keys, key_len, hkl = _rows(pidx * 31 + pv, 128, 64)
    want = np.asarray(jcrc.check_partition_hash_device(
        jnp.asarray(keys), jnp.asarray(key_len), jnp.asarray(hkl), pidx,
        pv))
    got = tcrc.check_partition_hash_device(
        torch.from_numpy(keys), torch.from_numpy(key_len),
        torch.from_numpy(hkl), pidx, pv).numpy()
    assert np.array_equal(got, want)
    assert 0 < got.sum() < got.size


@pytest.fixture
def none_store():
    saved = [[(s, n, reg.get(s, n)) for s, n in FLAG_NAMES]
             for reg in (JFLAGS, TFLAGS)]
    for (section, name), value in zip(FLAG_NAMES, ("none", 0, False)):
        for reg in (JFLAGS, TFLAGS):
            reg.set(section, name, value, force=True)
    yield
    for reg, values in zip((JFLAGS, TFLAGS), saved):
        for section, name, value in values:
            reg.set(section, name, value, force=True)
    JDRIFT.reset()


def _scan_req(types, hk, n, **kw):
    return types.GetScannerRequest(start_key=generate_key(hk, b""),
                                   batch_size=n,
                                   validate_partition_hash=True, **kw)


def test_pgt1_store_scans_equal_in_both_packages(tmp_path, none_store):
    root = tmp_path / "store"
    rng = np.random.default_rng(13)
    hashkeys = [b"k%05d" % int(i) for i in rng.permutation(6000)[:2000]]
    src = PartitionServer(str(root), pidx=3, partition_count=8,
                          device="cpu")
    for hk in hashkeys:           # every partition's keys: 7 in 8 foreign
        for j in range(6):
            src.on_put(generate_key(hk, b"s%d" % j), b"v-%s-%d" % (hk, j))
    src.on_put(generate_key(b"", b"sortonly"), b"empty hashkey")
    src.manual_compact()
    src.close()
    ssts = [os.path.join(d, f) for d, _s, fs in os.walk(root) for f in fs
            if f.endswith(".sst")]
    assert ssts
    for p in ssts:
        assert chip_smoke.write_pgt1(p, p) >= 1

    servers = (JServer(str(root), pidx=3, partition_count=8),
               PartitionServer(str(root), pidx=3, partition_count=8,
                               device="cpu"))
    try:
        assert all(not r._has_hash_lo
                   for s in servers for r in s.engine.lsm.l1_runs)
        masks = []
        pages = []
        for srv, types in zip(servers, (jtypes, ttypes)):
            reqs = [_scan_req(types, hashkeys[i], 40, one_page=True)
                    for i in range(0, 2000, 97)]
            state = srv.plan_scan_batch(reqs)
            keep = srv.eval_planned_masks(state)
            masks.append({(os.path.basename(c[0]), c[1]): np.asarray(m)
                          for c, m in keep.items()})
            out = [[(kv.key, kv.value) for kv in r.kvs]
                   for r in srv.finish_scan_batch(state, keep)]
            resp = srv.on_get_scanner(_scan_req(types, b"", 50))
            while True:
                out.append([(kv.key, kv.value) for kv in resp.kvs])
                if resp.context_id < 0:
                    break
                resp = srv.on_scan(resp.context_id)
            pages.append(out)
        assert masks[0].keys() == masks[1].keys() and len(masks[1]) > 1
        for ck in masks[0]:
            n = len(masks[1][ck])
            assert np.array_equal(masks[0][ck][:n], masks[1][ck]), ck
        assert pages[1] == pages[0]
        served = sum(len(p) for p in pages[1])
        owned = sum(m.sum() for m in masks[1].values())
        assert 0 < owned < sum(m.size for m in masks[1].values())
        assert served > 0
    finally:
        for s in servers:
            s.close()
