"""The port stands alone: it imports torch, never jax or pegasus_tpu, and
its entry points refuse to run on the card where there is none."""

import os
import pkgutil
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# the modules of slices 6(b)(4) and 6(b)(5)
SERVICE_MODULES = (
    "pegasus_tpu_torch.storage.block_service",
    "pegasus_tpu_torch.storage.blob_server",
    "pegasus_tpu_torch.server.backup",
    "pegasus_tpu_torch.server.bulk_load",
    "pegasus_tpu_torch.server.duplication",
    "pegasus_tpu_torch.replica.duplication_cluster",
    "pegasus_tpu_torch.meta.backup_service",
    "pegasus_tpu_torch.meta.bulk_load_service",
    "pegasus_tpu_torch.meta.duplication_service",
    "pegasus_tpu_torch.client.cluster_client",
    "pegasus_tpu_torch.tools.cluster",
    "pegasus_tpu_torch.tools.kill_test",
    "pegasus_tpu_torch.runtime.act",
)


def _port_modules():
    import pegasus_tpu_torch

    names = ["pegasus_tpu_torch"]
    for info in pkgutil.walk_packages(pegasus_tpu_torch.__path__,
                                      "pegasus_tpu_torch."):
        names.append(info.name)
    return names


def test_port_modules_are_found():
    names = _port_modules()
    for want in ("pegasus_tpu_torch.ops.fused_scan",
                 "pegasus_tpu_torch.server.partition_server",
                 "pegasus_tpu_torch.server.page",
                 "pegasus_tpu_torch.server.scan_coordinator",
                 "pegasus_tpu_torch.native",
                 "pegasus_tpu_torch.storage.lsm",
                 "pegasus_tpu_torch.storage.block_codec",
                 "pegasus_tpu_torch.storage.bloom",
                 "pegasus_tpu_torch.storage.phash",
                 "pegasus_tpu_torch.ops.pushdown",
                 "pegasus_tpu_torch.server.row_cache",
                 "pegasus_tpu_torch.server.read_coordinator",
                 "pegasus_tpu_torch.ops.compaction_rules",
                 "pegasus_tpu_torch.ops.fused_compaction",
                 "pegasus_tpu_torch.storage.compact_governor",
                 "pegasus_tpu_torch.storage.compact_pipeline",
                 "pegasus_tpu_torch.convert",
                 "pegasus_tpu_torch.client.table",
                 "pegasus_tpu_torch.client.client",
                 "pegasus_tpu_torch.geo.cells",
                 "pegasus_tpu_torch.geo.geo_client",
                 "pegasus_tpu_torch.ops.geo",
                 "pegasus_tpu_torch.redis_proxy.resp",
                 "pegasus_tpu_torch.redis_proxy.proxy",
                 # the observability and integrity layer
                 "pegasus_tpu_torch.utils.metrics",
                 "pegasus_tpu_torch.utils.fail_point",
                 "pegasus_tpu_torch.utils.profiler",
                 "pegasus_tpu_torch.utils.tracing",
                 "pegasus_tpu_torch.utils.perf_context",
                 "pegasus_tpu_torch.utils.latency_tracer",
                 "pegasus_tpu_torch.server.tenancy",
                 "pegasus_tpu_torch.server.capacity_units",
                 "pegasus_tpu_torch.server.hotkey",
                 "pegasus_tpu_torch.server.workload",
                 "pegasus_tpu_torch.server.explain",
                 "pegasus_tpu_torch.security.kms",
                 "pegasus_tpu_torch.storage.efile",
                 "pegasus_tpu_torch.storage.vfs",
                 "pegasus_tpu_torch.storage.scrub",
                 "pegasus_tpu_torch.ops.device_crc",
                 "pegasus_tpu_torch.ops.placement",
                 "pegasus_tpu_torch.ops.fused_mesh",
                 "pegasus_tpu_torch.parallel",
                 "pegasus_tpu_torch.parallel.partition_mesh",
                 "pegasus_tpu_torch.parallel.mesh_resident",
                 # the wire, the simulated runtime and the replica
                 "pegasus_tpu_torch.utils.backoff",
                 "pegasus_tpu_torch.utils.thread_check",
                 "pegasus_tpu_torch.utils.command_manager",
                 "pegasus_tpu_torch.utils.cpu_isolation",
                 "pegasus_tpu_torch.meta.meta_storage",
                 "pegasus_tpu_torch.meta.server_state",
                 "pegasus_tpu_torch.rpc.codec",
                 "pegasus_tpu_torch.rpc.message",
                 "pegasus_tpu_torch.rpc.fault",
                 "pegasus_tpu_torch.rpc.transport",
                 "pegasus_tpu_torch.runtime.sim",
                 "pegasus_tpu_torch.replica.mutation",
                 "pegasus_tpu_torch.replica.prepare_list",
                 "pegasus_tpu_torch.replica.mutation_log",
                 "pegasus_tpu_torch.replica.group_commit",
                 "pegasus_tpu_torch.replica.fs_manager",
                 "pegasus_tpu_torch.replica.file_transfer",
                 "pegasus_tpu_torch.replica.replica",
                 # meta, health and the stub
                 "pegasus_tpu_torch.utils.timeseries",
                 "pegasus_tpu_torch.utils.health",
                 "pegasus_tpu_torch.security.auth",
                 "pegasus_tpu_torch.security.negotiation",
                 "pegasus_tpu_torch.replica.dup_governor",
                 "pegasus_tpu_torch.meta.failure_detector",
                 "pegasus_tpu_torch.meta.election",
                 "pegasus_tpu_torch.meta.balancer",
                 "pegasus_tpu_torch.meta.cluster_health",
                 "pegasus_tpu_torch.meta.compaction_scheduler",
                 "pegasus_tpu_torch.meta.split_service",
                 "pegasus_tpu_torch.meta.elasticity",
                 "pegasus_tpu_torch.meta.meta_service",
                 "pegasus_tpu_torch.replica.stub",
                 # backup, bulk load, duplication; SimCluster
                 *SERVICE_MODULES):
        assert want in names


def test_bulk_compaction_runs_without_jax(tmp_path):
    """A PartitionServer on the CPU compacts with env rules and a default
    TTL through the merge path, then through the pipelined bulk path of a
    dcz2 store, with JAX blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from pegasus_tpu_torch.base.key_schema import generate_key\n"
        "from pegasus_tpu_torch.server.partition_server import "
        "PartitionServer\n"
        "from pegasus_tpu_torch.storage import compact_pipeline\n"
        "import pegasus_tpu_torch.client, pegasus_tpu_torch.geo\n"
        "import pegasus_tpu_torch.redis_proxy, pegasus_tpu_torch.ops.geo\n"
        "import pegasus_tpu_torch.ops.placement, pegasus_tpu_torch.parallel\n"
        "from pegasus_tpu_torch.parallel.mesh_resident import "
        "MESH_SERVING\n"
        f"s = PartitionServer({str(tmp_path)!r}, device='cpu')\n"
        "s.update_app_envs({'default_ttl': '3600',\n"
        "    'user_specified_compaction': '[{\"op\": \"delete_key\", '\n"
        "    '\"rules\": [{\"type\": \"hashkey_pattern\", '\n"
        "    '\"match\": \"prefix\", \"pattern\": \"tmp\"}]}]'})\n"
        "for i in range(40):\n"
        "    hk = b'tmp' if i % 4 == 0 else b'hk%02d' % i\n"
        "    s.on_put(generate_key(hk, b's%02d' % i), b'v%d' % i)\n"
        "s.manual_compact()\n"
        "assert s.engine.lsm.bulk_compact_eligible()\n"
        "MESH_SERVING.attach(s)\n"
        "s.manual_compact()\n"
        "MESH_SERVING.reset()\n"
        "rows = list(s.engine.iterate())\n"
        "assert len(rows) == 30 and all(e > 0 for _k, _v, e in rows)\n"
        "assert s.engine.compact_count == 2\n"
        "s.close()\n"
        "bad = sorted(m for m in sys.modules if m == 'pegasus_tpu'\n"
        "             or m.startswith('pegasus_tpu.')\n"
        "             or m.startswith('jax.') or m == 'jaxlib')\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "clean" in proc.stdout


def test_batched_path_runs_without_jax(tmp_path):
    """scan_multi and point_read_multi over a CPU partition compacted at
    the default store flags (dcz2, bloom, phash), through the native
    library (built with g++ at first use), then GEO commands through the
    Redis handler over a split, compacted geo index, with JAX blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from pegasus_tpu_torch.base.key_schema import generate_key\n"
        "from pegasus_tpu_torch.base.value_schema import epoch_now\n"
        "from pegasus_tpu_torch.server import page\n"
        "from pegasus_tpu_torch.server.partition_server import "
        "PartitionServer\n"
        "from pegasus_tpu_torch.server.scan_coordinator import scan_multi\n"
        "from pegasus_tpu_torch.server.types import GetScannerRequest, "
        "ScanPage\n"
        f"s = PartitionServer({str(tmp_path)!r}, device='cpu')\n"
        "for i in range(20):\n"
        "    s.on_put(generate_key(b'hk', b's%02d' % i), b'v%d' % i)\n"
        "s.manual_compact()\n"
        "(out,), = scan_multi([(s, [GetScannerRequest(batch_size=7)])],\n"
        "                     epoch_now())\n"
        "assert isinstance(out.kvs, ScanPage) and len(out.kvs) == 7\n"
        "assert page.SERVE_STATS['calls'] == 1\n"
        "t = s.engine.lsm.l1_runs[0]\n"
        "assert t.codec == 'dcz2' and t.bloom and t.phash\n"
        "from pegasus_tpu_torch.server.read_coordinator import "
        "point_read_multi\n"
        "(res,), = point_read_multi([(s, [('get', generate_key(b'hk', "
        "b's03'), None)])])\n"
        "assert res == (0, b'v3'), res\n"
        "assert s.point_stats['phash_located'] == 1\n"
        "s.close()\n"
        "from pegasus_tpu_torch.client import PegasusClient, Table\n"
        "from pegasus_tpu_torch.geo import GeoClient\n"
        "from pegasus_tpu_torch.redis_proxy import RedisHandler\n"
        f"raw = Table({str(tmp_path / 'raw')!r}, app_id=1, "
        "partition_count=2, device='cpu')\n"
        f"idx = Table({str(tmp_path / 'idx')!r}, app_id=2, "
        "partition_count=2, device='cpu')\n"
        "geo = GeoClient(PegasusClient(raw), PegasusClient(idx))\n"
        "h = RedisHandler(PegasusClient(raw), geo=geo).handle\n"
        "assert h([b'GEOADD', b'g', b'-74', b'40', b'a', b'-74', "
        "b'40.001', b'b']) == b':2\\r\\n'\n"
        "idx.split(); idx.manual_compact_all()\n"
        "assert h([b'GEORADIUS', b'g', b'-74', b'40', b'50', b'm']) == "
        "b'*1\\r\\n$1\\r\\na\\r\\n'\n"
        "assert h([b'INCRBY', b'n', b'3']) == b':3\\r\\n'\n"
        "raw.close(); idx.close()\n"
        "bad = sorted(m for m in sys.modules if m == 'pegasus_tpu'\n"
        "             or m.startswith('pegasus_tpu.')\n"
        "             or m.startswith('jax.') or m == 'jaxlib')\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "clean" in proc.stdout


def test_observability_and_integrity_run_without_jax(tmp_path):
    """An encrypted CPU partition serves a batched read and a scan under
    PerfContexts, a sampled span and the slow log at 0 ms, explains an
    op, bills capacity units to a tenant, passes a scrub, and hashes a
    PGT1-style block with the plain key hash, with JAX blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import torch\n"
        "from pegasus_tpu_torch.base.key_schema import generate_key\n"
        "from pegasus_tpu_torch.ops import fused_scan\n"
        "from pegasus_tpu_torch.ops.predicates import FilterSpec\n"
        "from pegasus_tpu_torch.ops.record_block import build_record_block\n"
        "from pegasus_tpu_torch.security.kms import KeyProvider, "
        "LocalKmsClient\n"
        "from pegasus_tpu_torch.server import explain, tenancy\n"
        "from pegasus_tpu_torch.server.partition_server import "
        "PartitionServer\n"
        "from pegasus_tpu_torch.server.read_coordinator import "
        "point_read_multi\n"
        "from pegasus_tpu_torch.server.types import GetScannerRequest\n"
        "from pegasus_tpu_torch.storage import efile\n"
        "from pegasus_tpu_torch.storage.scrub import ReplicaScrubber\n"
        "from pegasus_tpu_torch.utils import tracing\n"
        "from pegasus_tpu_torch.utils.flags import FLAGS\n"
        f"d = {str(tmp_path / 'enc')!r}\n"
        "efile.enable_encryption(d, KeyProvider(d, LocalKmsClient(b'k' * "
        "32)))\n"
        "s = PartitionServer(d, device='cpu')\n"
        "for i in range(200):\n"
        "    s.on_put(generate_key(b'h%02d' % (i % 20), b's%03d' % i), "
        "b'v%d' % i)\n"
        "s.manual_compact()\n"
        "assert all(efile.is_encrypted(t.path) for t in "
        "s.engine.lsm.l1_runs)\n"
        "s.update_app_envs({'replica.slow_query_threshold_ms': '0'})\n"
        "FLAGS.set('pegasus.tracing', 'sample_ratio', 1.0)\n"
        "tenancy.TENANTS.configure_from_envs({'qos.tenants': 'gold:2:0'})\n"
        "assert tracing.maybe_sample()\n"
        "span = tracing.ring_for('n').start('op')\n"
        "with tracing.activate(span):\n"
        "    (res,), = point_read_multi([(s, [('get', generate_key(b'h03', "
        "b's003'), None)])], tenants=['gold'])\n"
        "    s.on_get_scanner(GetScannerRequest(batch_size=5))\n"
        "span.finish()\n"
        "assert res == (0, b'v3'), res\n"
        "names = [e['name'] for e in s.slow_log.dump()]\n"
        "assert names == ['point_get_batch.1.0', 'scan.1.0'], names\n"
        "assert all('perf' in e for e in s.slow_log.dump())\n"
        "ann = [a for a, _t in span.annotations]\n"
        "assert 'block_probe' in ann and 'coord_finish' in ann, ann\n"
        "assert tenancy.TENANTS.snapshot()['gold']['cu_total'] == 1\n"
        "rep = explain.explain_op(s, *explain.op_from_spec({'op': 'scan', "
        "'hash_key': 'h04'}))\n"
        "assert rep['perf']['rows_survived'] == 10, rep\n"
        "rep_ns = type('R', (), {'server': s})()\n"
        "res = ReplicaScrubber(lambda: {(1, 0): rep_ns}, print).scrub_now("
        "(1, 0), rep_ns)\n"
        "assert res['state'] == 'clean' and res['blocks_scanned'] > 0\n"
        "s.close()\n"
        "blk = build_record_block([generate_key(b'h%d' % i, b's') for i in "
        "range(64)], [0] * 64)\n"
        "none = FilterSpec.none('cpu')\n"
        "want = fused_scan.scan_table([blk], [1], none, none, True, 3)\n"
        "got = fused_scan.scan_table([blk._replace(hash_lo=None)], [1], "
        "none, none, True, 3)\n"
        "assert torch.equal(got, want) and 0 < int(want.sum())\n"
        "bad = sorted(m for m in sys.modules if m == 'pegasus_tpu'\n"
        "             or m.startswith('pegasus_tpu.')\n"
        "             or m.startswith('jax.') or m == 'jaxlib')\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "clean" in proc.stdout


REPLICATION = ("rpc", "runtime", "meta", "replica")


def _replication_modules():
    return [m for m in _port_modules()
            if m.split(".")[1:2] and m.split(".")[1] in REPLICATION]


def test_replication_runs_without_jax(tmp_path):
    """A three-replica group of the port over SimNetwork, every replica
    with a group-commit window, on the CPU with JAX blocked: writes
    commit on every member and a scan answers the same everywhere; a
    frame of the wire codec round-trips."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from pegasus_tpu_torch.base.key_schema import generate_key\n"
        "from pegasus_tpu_torch.replica import (Replica, ReplicaConfig, "
        "WriteFlushWindow, WriteOp)\n"
        "from pegasus_tpu_torch.rpc.codec import OP_PUT\n"
        "from pegasus_tpu_torch.rpc.message import decode_message, "
        "encode_message, read_frames\n"
        "from pegasus_tpu_torch.runtime import SimLoop, SimNetwork\n"
        "from pegasus_tpu_torch.server.types import GetScannerRequest\n"
        "from pegasus_tpu_torch.utils.metrics import METRICS\n"
        "loop = SimLoop(seed=1)\n"
        "net = SimNetwork(loop)\n"
        "reps, wins = {}, {}\n"
        "for n in ('a', 'b', 'c'):\n"
        f"    r = Replica(n, {str(tmp_path)!r} + '/' + n, net, "
        "device='cpu', clock=lambda: 1.7e9 + loop.now)\n"
        "    w = WriteFlushWindow(net, n, METRICS.entity('write', n))\n"
        "    r.plog_sink = w\n"
        "    def dispatch(s, mt, p, r=r, w=w):\n"
        "        with w:\n"
        "            r.on_message(s, mt, p)\n"
        "    net.register(n, dispatch)\n"
        "    reps[n], wins[n] = r, w\n"
        "cfg = ReplicaConfig(1, 'a', ['b', 'c'])\n"
        "for r in reps.values():\n"
        "    r.assign_config(cfg)\n"
        "acks = []\n"
        "for i in range(20):\n"
        "    with wins['a']:\n"
        "        reps['a'].client_write([WriteOp(OP_PUT, (generate_key("
        "b'h%02d' % i, b's'), b'v%d' % i, 0))], acks.append)\n"
        "    loop.run_until_idle()\n"
        "reps['a'].broadcast_group_check()\n"
        "loop.run_until_idle()\n"
        "assert acks == [[0]] * 20, acks\n"
        "req = GetScannerRequest(start_key=b'', batch_size=100, "
        "one_page=True)\n"
        "frames = {encode_message('a', 'b', 't', r.server.on_get_scanner("
        "req)) for r in reps.values()}\n"
        "assert len(frames) == 1\n"
        "buf = bytearray(frames.pop())\n"
        "resp = decode_message(read_frames(buf)[0])[3]\n"
        "assert len(resp.kvs) == 20 and not buf\n"
        "assert all(r.last_committed_decree == 20 for r in reps.values())\n"
        "for r in reps.values():\n"
        "    r.close()\n"
        "bad = sorted(m for m in sys.modules if m == 'pegasus_tpu'\n"
        "             or m.startswith('pegasus_tpu.')\n"
        "             or m.startswith('jax.') or m == 'jaxlib')\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "clean" in proc.stdout


def test_cluster_runs_without_jax(tmp_path):
    """A port meta and three port stubs on the CPU over SimNetwork, with
    JAX blocked: a table of 2 partitions x 3 replicas, a write and a
    batched scan over the network, a silenced node cured by the meta,
    and the scan again on the cured primary."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from pegasus_tpu_torch.base.key_schema import generate_key\n"
        "from pegasus_tpu_torch.meta import MetaService\n"
        "from pegasus_tpu_torch.replica.stub import ReplicaStub\n"
        "from pegasus_tpu_torch.rpc.codec import OP_PUT\n"
        "from pegasus_tpu_torch.runtime import SimLoop, SimNetwork\n"
        "from pegasus_tpu_torch.server.types import GetScannerRequest\n"
        f"d = {str(tmp_path)!r}\n"
        "loop = SimLoop(seed=2)\n"
        "net = SimNetwork(loop)\n"
        "meta = MetaService('meta', d + '/meta', net, lambda: loop.now)\n"
        "stubs = {}\n"
        "for i in range(4):\n"
        "    s = ReplicaStub(f'n{i}', f'{d}/n{i}', net, device='cpu',\n"
        "                    clock=lambda: 1.7e9 + loop.now)\n"
        "    s.meta_addr = 'meta'\n"
        "    stubs[s.name] = s\n"
        "def beacons(rounds, skip=None):\n"
        "    for _ in range(rounds):\n"
        "        for n, s in stubs.items():\n"
        "            if n != skip:\n"
        "                s.send_beacon()\n"
        "        loop.run_for(3.0)\n"
        "        meta.tick()\n"
        "    loop.run_until_idle()\n"
        "beacons(2)\n"
        "app = meta.create_app('t', partition_count=2, replica_count=3)\n"
        "loop.run_until_idle()\n"
        "got = []\n"
        "net.register('c', lambda src, mt, p: got.append(p))\n"
        "def scan():\n"
        "    pc = meta.state.get_partition(app, 0)\n"
        "    net.send('c', pc.primary, 'client_scan_multi', {'rid': 2, \n"
        "        'groups': [((app, 0), [GetScannerRequest(batch_size=9, \n"
        "        one_page=True)])]})\n"
        "    loop.run_until_idle()\n"
        "    return [(kv.key, kv.value) for kv in got[-1]['result'][0][1][0]"
        ".kvs]\n"
        "pc = meta.state.get_partition(app, 0)\n"
        "net.send('c', pc.primary, 'client_write', {'gpid': (app, 0), \n"
        "    'rid': 1, 'ops': [(OP_PUT, (generate_key(b'h', b's%d' % i), \n"
        "    b'v', 0)) for i in range(5)]})\n"
        "loop.run_until_idle()\n"
        "assert got[-1]['err'] == 0 and got[-1]['results'] == [0] * 5\n"
        "before = scan()\n"
        "assert len(before) == 5\n"
        "net.partition(pc.primary)\n"
        "beacons(9, skip=pc.primary)\n"
        "pc2 = meta.state.get_partition(app, 0)\n"
        "assert pc2.primary != pc.primary and len(pc2.members()) == 3\n"
        "assert scan() == before\n"
        "for s in stubs.values():\n"
        "    s.close()\n"
        "bad = sorted(m for m in sys.modules if m == 'pegasus_tpu'\n"
        "             or m.startswith('pegasus_tpu.')\n"
        "             or m.startswith('jax.') or m == 'jaxlib')\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "clean" in proc.stdout


@pytest.mark.parametrize("target", ["package", "chip_smoke", "replication",
                                    "services"])
def test_imports_without_jax_or_the_jax_package(target):
    names = (_port_modules() if target == "package" else
             _replication_modules() if target == "replication" else
             list(SERVICE_MODULES) if target == "services" else
             ["chip_smoke"])
    if target == "replication":
        assert len(names) == 33, names   # 4 packages, 29 modules
    if target == "services":
        assert len(names) == 13
        assert "pegasus_tpu_torch.meta.pending_services" not in \
            _port_modules()
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'pegasus_tpu'\n"
        "             or m.startswith('pegasus_tpu.')\n"
        "             or m.startswith('jax.') or m == 'jaxlib')\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "clean" in proc.stdout


def test_services_run_without_jax(tmp_path):
    """A port SimCluster on the CPU with JAX blocked: a bulk load staged
    by SSTGenerator and ingested by the meta's verb, reads and a batched
    scan through ClusterClient, a backup and a restore into a new table,
    a duplication to a second cluster on the same loop, the kill test's
    DataVerifier, and one .act case on the port's ActRunner."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import random\n"
        "from pegasus_tpu_torch.runtime.act import ActRunner\n"
        "from pegasus_tpu_torch.server.bulk_load import SSTGenerator\n"
        "from pegasus_tpu_torch.server.types import GetScannerRequest\n"
        "from pegasus_tpu_torch.storage.block_service import "
        "LocalBlockService\n"
        "from pegasus_tpu_torch.tools.cluster import SimCluster\n"
        "from pegasus_tpu_torch.tools.kill_test import DataVerifier\n"
        f"d = {str(tmp_path)!r}\n"
        "a = SimCluster(d + '/A', n_nodes=3, device='cpu')\n"
        "b = SimCluster(d + '/B', n_nodes=3, name_prefix='b-', loop=a.loop,\n"
        "               net=a.net, cluster_id=2, device='cpu')\n"
        "a.create_table('t', partition_count=2, replica_count=3)\n"
        "SSTGenerator(LocalBlockService(d + '/stage'), 't', 2).generate(\n"
        "    [(b'k%02d' % i, b's', b'v%d' % i, 0) for i in range(30)])\n"
        "a.meta.bulk_load.start_bulk_load('t', d + '/stage')\n"
        "for _ in range(10):\n"
        "    a.step()\n"
        "assert a.meta.bulk_load.bulk_load_status('t')['complete']\n"
        "c = a.client('t')\n"
        "assert c.get(b'k07', b's') == (0, b'v7')\n"
        "out = c.scan_multi({0: [GetScannerRequest(batch_size=100, "
        "one_page=True)], 1: [GetScannerRequest(batch_size=100, "
        "one_page=True)]})\n"
        "assert sum(len(r[0].kvs) for r in out.values()) == 30\n"
        "bid = a.meta.backup.start_backup('t', d + '/bk')\n"
        "for _ in range(5):\n"
        "    a.step()\n"
        "assert a.meta.backup.backup_status(bid)['complete']\n"
        "a.meta.backup.create_app_from_backup('r', d + '/bk', 'manual', "
        "bid)\n"
        "for _ in range(5):\n"
        "    a.step()\n"
        "assert a.client('r').get(b'k11', b's') == (0, b'v11')\n"
        "b.create_table('t', partition_count=2, replica_count=3)\n"
        "a.meta.duplication.add_duplication('t', 'b-meta', 't')\n"
        "v = DataVerifier(c, random.Random(1))\n"
        "for _ in range(20):\n"
        "    v.step()\n"
        "assert not v.violations and v.write_ok == 20\n"
        "for _ in range(6):\n"
        "    a.step()\n"
        "    b.step(advance=False)\n"
        "assert b.client('t').get(b'kt000020', b's') == (0, b'v20')\n"
        "a.close(); b.close()\n"
        "r = ActRunner(d + '/act', n_nodes=4, seed=7, device='cpu')\n"
        f"r.run_file({os.path.join(REPO, 'tests', 'cases', 'case-604-bulkload-failover.act')!r})\n"
        "r.close()\n"
        "bad = sorted(m for m in sys.modules if m == 'pegasus_tpu'\n"
        "             or m.startswith('pegasus_tpu.')\n"
        "             or m.startswith('jax.') or m == 'jaxlib')\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "clean" in proc.stdout


def test_sim_cluster_serves_on_the_card_by_default(tmp_path, monkeypatch):
    """`SimCluster(device=None)` hands the card to every stub: without
    CUDA it raises before any node starts; ActRunner likewise."""
    import torch

    from pegasus_tpu_torch.runtime.act import ActRunner
    from pegasus_tpu_torch.tools.cluster import SimCluster

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SimCluster(str(tmp_path / "c"), n_nodes=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ActRunner(str(tmp_path / "a"), n_nodes=1)
    c = SimCluster(str(tmp_path / "cpu"), n_nodes=1, device="cpu")
    try:
        assert {s.device.type for s in c.stubs.values()} == {"cpu"}
    finally:
        c.close()


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env=env)


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
