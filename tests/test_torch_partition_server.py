"""The port's PartitionServer(device="cpu") against the JAX PartitionServer.

The same seeded writes (puts with and without TTLs, multi_puts, removes,
records a split left behind), a flush, a manual compaction and a
post-compaction overlay go into both servers under the slice's flags
(`block_codec = none`, no bloom, no phash; set and then restored on the
JAX FLAGS). Every on_get, on_multi_get, on_get_scanner and on_scan
response, with and without filters, must be equal field by field. TTLs
are far from `now`, so no second boundary can split the two servers.
"""

import dataclasses

import numpy as np
import pytest

from pegasus_tpu.base.key_schema import generate_key, key_hash_parts
from pegasus_tpu.server import types as jtypes
from pegasus_tpu.server.partition_server import (
    PartitionServer as JaxPartitionServer,
)
from pegasus_tpu.server.workload import DRIFT as JDRIFT
from pegasus_tpu.utils.flags import FLAGS as JFLAGS
from pegasus_tpu_torch.utils.flags import FLAGS as TFLAGS
from pegasus_tpu_torch.server import types as ttypes
from pegasus_tpu_torch.server.partition_server import PartitionServer

SLICE_FLAGS = (("pegasus.storage", "block_codec", "none"),
               ("pegasus.server", "bloom_bits_per_key", 0),
               ("pegasus.server", "phash_index", False))

PARTITION_COUNT = 4
PIDX = 1
# an app id no sim-cluster test uses: the JAX server registers its
# workload metric entity (`app.pidx`) in a process-wide registry
APP_ID = 9001
FAR_TTL = 10 ** 7           # seconds: never expires during a test
HASHKEYS = [b"user%04d" % i for i in range(160)]
SORTKEYS = [b"s%02d" % i for i in range(12)]


def _set_flags(values, registries=(JFLAGS, TFLAGS)):
    """Set flags in both packages' process-wide registries."""
    for section, name, value in values:
        for reg in registries:
            reg.set(section, name, value, force=True)


@pytest.fixture
def servers(tmp_path):
    saved = [[(s, n, reg.get(s, n)) for s, n, _v in SLICE_FLAGS]
             for reg in (JFLAGS, TFLAGS)]
    _set_flags(SLICE_FLAGS)
    pair = (JaxPartitionServer(str(tmp_path / "jax"), app_id=APP_ID,
                               pidx=PIDX, partition_count=PARTITION_COUNT),
            PartitionServer(str(tmp_path / "torch"), app_id=APP_ID,
                            pidx=PIDX, partition_count=PARTITION_COUNT,
                            device="cpu"))
    yield pair
    for s in pair:
        s.close()
    _set_flags(saved[0], (JFLAGS,))
    _set_flags(saved[1], (TFLAGS,))
    # the JAX server's mask waves feed the process-wide cost-model drift
    # gauge, which would fire the JAX health rule in later tests
    JDRIFT.reset()


def _owned(hk: bytes) -> bool:
    return key_hash_parts(hk) % PARTITION_COUNT == PIDX


def _write_phase(servers, rng, hashkeys, value_tag):
    """Seeded writes into both servers. Most hashkeys route here; the
    others are records a split left behind (written without a routing
    hash, as a replica applying an old log would)."""
    for hk in hashkeys:
        kind = rng.random()
        ttl = FAR_TTL if rng.random() < 0.3 else 0
        if kind < 0.5:
            sks = rng.choice(len(SORTKEYS), int(rng.integers(1, 8)),
                             replace=False)
            for s in servers:
                mod = jtypes if isinstance(s, JaxPartitionServer) else ttypes
                req = mod.MultiPutRequest(
                    hk, [mod.KeyValue(SORTKEYS[i], b"%s-%s-%d" % (
                        value_tag, hk, i)) for i in sorted(sks)], ttl)
                assert s.on_multi_put(req) == 0
        else:
            sk = SORTKEYS[int(rng.integers(0, len(SORTKEYS)))]
            value = b"%s-%s" % (value_tag, sk) * int(rng.integers(1, 4))
            for s in servers:
                assert s.on_put(generate_key(hk, sk), value, ttl) == 0
        if rng.random() < 0.15:
            key = generate_key(hk, SORTKEYS[int(rng.integers(0, 4))])
            for s in servers:
                assert s.on_remove(key) == 0


def _fields(obj, names):
    out = {}
    for name in names:
        v = getattr(obj, name)
        if name == "kvs":
            v = [(kv.key, kv.value, kv.expire_ts_seconds) for kv in v]
        out[name] = v
    return out


def _same(jresp, tresp):
    names = [f.name for f in dataclasses.fields(tresp)]
    want, got = _fields(jresp, names), _fields(tresp, names)
    assert got == want
    return got


SCAN_FILTERS = [(0, b"", 0, b""), (0, b"", 2, b"s0"), (0, b"", 3, b"1"),
                (0, b"", 1, b"0"), (2, b"user00", 0, b""),
                (1, b"1", 3, b"2"), (3, b"7", 2, b""), (1, b"zz", 0, b"")]


def _check_reads(servers, rng):
    jsrv, tsrv = servers
    for hk in HASHKEYS[::3] + [b"", b"nosuch"]:
        for sk in SORTKEYS[:6]:
            key = generate_key(hk, sk)
            assert tsrv.on_get(key) == jsrv.on_get(key)
        # point and range multi_gets, filtered and limited
        reqs = [dict(sort_keys=list(SORTKEYS[::2]) + [b"missing"]),
                dict(),
                dict(start_sortkey=b"s03", stop_sortkey=b"s09",
                     stop_inclusive=True, sort_key_filter_type=3,
                     sort_key_filter_pattern=b"5"),
                dict(max_kv_count=3, no_value=True),
                dict(reverse=True, max_kv_count=4,
                     sort_key_filter_type=1, sort_key_filter_pattern=b"1")]
        for kw in reqs:
            _same(jsrv.on_multi_get(jtypes.MultiGetRequest(hk, **kw)),
                  tsrv.on_multi_get(ttypes.MultiGetRequest(hk, **kw)))
    starts = [b""] + [generate_key(HASHKEYS[int(i)], b"")
                      for i in rng.integers(0, len(HASHKEYS), 6)]
    for validate in (False, True):
        for f in SCAN_FILTERS:
            for start in starts[:4]:
                kw = dict(start_key=start, batch_size=int(rng.integers(
                    1, 60)), validate_partition_hash=validate,
                    hash_key_filter_type=f[0], hash_key_filter_pattern=f[1],
                    sort_key_filter_type=f[2], sort_key_filter_pattern=f[3],
                    return_expire_ts=True)
                jr = jsrv.on_get_scanner(jtypes.GetScannerRequest(**kw))
                tr = tsrv.on_get_scanner(ttypes.GetScannerRequest(**kw))
                got = _same(jr, tr)
                pages = 0
                while got["context_id"] >= 0 and pages < 30:
                    got = _same(jsrv.on_scan(jr.context_id),
                                tsrv.on_scan(tr.context_id))
                    jr_id = got["context_id"]
                    jr.context_id = tr.context_id = jr_id
                    pages += 1
                if got["context_id"] >= 0:
                    jsrv.on_clear_scanner(got["context_id"])
                    tsrv.on_clear_scanner(got["context_id"])
    # bounded ranges, exclusive starts, one-page and count-only scans
    for start, stop in zip(starts[1:4], starts[4:7]):
        lo, hi = min(start, stop), max(start, stop)
        for kw in (dict(start_inclusive=False, stop_inclusive=True),
                   dict(one_page=True, batch_size=7, no_value=True),
                   dict(only_return_count=True,
                        validate_partition_hash=True)):
            _same(jsrv.on_get_scanner(jtypes.GetScannerRequest(
                      start_key=lo, stop_key=hi, **kw)),
                  tsrv.on_get_scanner(ttypes.GetScannerRequest(
                      start_key=lo, stop_key=hi, **kw)))
    _same(jsrv.on_scan(12345), tsrv.on_scan(12345))


def test_responses_match_jax_through_flush_compaction_and_overlay(servers):
    rng = np.random.default_rng(31)
    owned = [hk for hk in HASHKEYS if _owned(hk)]
    assert 20 < len(owned) < len(HASHKEYS)
    _write_phase(servers, rng, HASHKEYS[:80], b"a")
    _check_reads(servers, rng)                    # memtable only
    for s in servers:
        assert s.flush()
    _write_phase(servers, rng, HASHKEYS[60:120], b"b")
    _check_reads(servers, rng)                    # L0 + memtable
    for s in servers:
        s.manual_compact()
    assert servers[1].engine.lsm.sorted_runs() is not None
    _check_reads(servers, rng)                    # pure L1: columnar path
    _write_phase(servers, rng, HASHKEYS[100:], b"c")
    _check_reads(servers, rng)                    # overlay: merge path
    counts = [servers[1].on_get_scanner(ttypes.GetScannerRequest(
        only_return_count=True, validate_partition_hash=v)).kv_count
        for v in (False, True)]
    assert counts[0] > counts[1] > 0              # split leftovers hidden
    for s in servers:
        s.manual_compact()
    _check_reads(servers, rng)


def test_routing_gate_matches_jax(servers):
    for hk in HASHKEYS[:40]:
        h = key_hash_parts(hk)
        key = generate_key(hk, b"s00")
        assert (servers[1].on_put(key, b"v", partition_hash=h)
                == servers[0].on_put(key, b"v", partition_hash=h))
        assert (servers[1].on_get(key, partition_hash=h)
                == servers[0].on_get(key, partition_hash=h))
        assert (servers[1].on_remove(key, partition_hash=h)
                == servers[0].on_remove(key, partition_hash=h))


def test_default_device_is_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PartitionServer(str(tmp_path / "p"))
