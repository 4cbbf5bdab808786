"""The node's integrity layer: the port against the JAX package, exact.

- at-rest encryption: a store the JAX package wrote under an encryption
  zone (security/kms.py, storage/efile.py, opened through storage/vfs.py)
  serves the same rows through the port, and the reverse, at the `none`
  and `dcz2` codecs; the encrypted files are byte-identical after
  decryption to the plaintext files each package writes;
- `SSTable.verify_block` and `verify_index_consistency` on clean files
  and on files with a flipped data byte or a flipped perfect-hash byte:
  the same answers and the same typed errors;
- the scrubber's clean pass and its planted flip, and its restart after
  a flush, as tests/test_integrity.py runs them;
- the vfs fault sites: the same seeded bit flip, the same typed EIO /
  ENOSPC errors and the same torn prefix in both packages;
- `replica.slow_query_threshold_ms` set through `update_app_envs`
  changes the slow log as in the JAX package.

Both packages' fail-point registries are seeded alike and torn down
after every test; encryption zones are registered in both and removed.
"""

import errno
import json
import os
import time

import numpy as np
import pytest

from pegasus_tpu.base import value_schema as jvs
from pegasus_tpu.security import kms as jkms
from pegasus_tpu.server import types as jtypes
from pegasus_tpu.server import write_service as jws
from pegasus_tpu.server.partition_server import PartitionServer as JServer
from pegasus_tpu.storage import efile as jefile
from pegasus_tpu.storage import scrub as jscrub
from pegasus_tpu.storage import sstable as jsst
from pegasus_tpu.storage import vfs as jvfs
from pegasus_tpu.storage.engine import StorageEngine as JEngine
from pegasus_tpu.storage.engine import WriteBatchItem as JItem
from pegasus_tpu.utils import errors as jerrors
from pegasus_tpu.utils import metrics as jmetrics
from pegasus_tpu.utils.fail_point import FAIL_POINTS as JFP
from pegasus_tpu.utils.flags import FLAGS as JFLAGS
from pegasus_tpu_torch.base import value_schema as tvs
from pegasus_tpu_torch.base.key_schema import generate_key
from pegasus_tpu_torch.security import kms as tkms
from pegasus_tpu_torch.server import types as ttypes
from pegasus_tpu_torch.server import write_service as tws
from pegasus_tpu_torch.server.partition_server import PartitionServer
from pegasus_tpu_torch.storage import efile as tefile
from pegasus_tpu_torch.storage import scrub as tscrub
from pegasus_tpu_torch.storage import sstable as tsst
from pegasus_tpu_torch.storage import vfs as tvfs
from pegasus_tpu_torch.storage.engine import StorageEngine as TEngine
from pegasus_tpu_torch.storage.engine import WriteBatchItem as TItem
from pegasus_tpu_torch.storage.wal import OP_PUT
from pegasus_tpu_torch.utils import errors as terrors
from pegasus_tpu_torch.utils import metrics as tmetrics
from pegasus_tpu_torch.utils.fail_point import FAIL_POINTS as TFP
from pegasus_tpu_torch.utils.flags import FLAGS as TFLAGS

T0 = 1_790_000_000.25
ROOT_KEY = bytes(range(32))
FLAG_NAMES = (("pegasus.storage", "block_codec"),
              ("pegasus.server", "bloom_bits_per_key"),
              ("pegasus.server", "phash_index"))
# one package's modules, in the same order for each
JAX = dict(kms=jkms, efile=jefile, vfs=jvfs, sst=jsst, scrub=jscrub,
           errors=jerrors, metrics=jmetrics, fp=JFP, engine=JEngine,
           item=JItem, server=JServer, types=jtypes)
PORT = dict(kms=tkms, efile=tefile, vfs=tvfs, sst=tsst, scrub=tscrub,
            errors=terrors, metrics=tmetrics, fp=TFP, engine=TEngine,
            item=TItem, server=PartitionServer, types=ttypes)


class Clock:
    """Stands in for a module's `time`: `time()` is frozen at `t`."""

    def __init__(self, t: float) -> None:
        self.t = t

    def time(self) -> float:
        return self.t

    def __getattr__(self, name):
        return getattr(time, name)


def set_flags(codec, sidecars) -> None:
    values = (codec, 10 if sidecars else 0, sidecars)
    for (section, name), value in zip(FLAG_NAMES, values):
        for reg in (JFLAGS, TFLAGS):
            reg.set(section, name, value, force=True)


@pytest.fixture
def env(monkeypatch):
    """Frozen clocks, store flags restored, fail points and encryption
    zones cleared in both packages."""
    clk = Clock(T0)
    for mod in (jvs, tvs, jws, tws):
        monkeypatch.setattr(mod, "time", clk)
    saved = [[(s, n, reg.get(s, n)) for s, n in FLAG_NAMES]
             for reg in (JFLAGS, TFLAGS)]
    yield clk
    for reg, values in zip((JFLAGS, TFLAGS), saved):
        for section, name, value in values:
            reg.set(section, name, value, force=True)
    for fp in (JFP, TFP):
        fp.teardown()
    for ef in (jefile, tefile):
        ef._zones.clear()


def encrypt_zone(root) -> None:
    """The same data root is an encryption zone in both packages, with
    one data key (wrapped on disk under ROOT_KEY)."""
    os.makedirs(root, exist_ok=True)
    for pkg in (JAX, PORT):
        prov = pkg["kms"].KeyProvider(str(root),
                                      pkg["kms"].LocalKmsClient(ROOT_KEY))
        pkg["efile"].enable_encryption(str(root), prov)


def fill(server, types, rng, n_hash=30):
    for i in range(n_hash):
        hk = b"user%03d" % i
        for j in range(12):
            ttl = 50 if (i + j) % 9 == 0 else 0
            val = b"v%d.%d-" % (i, j) + b"z" * int(rng.integers(0, 60))
            server.on_put(generate_key(hk, b"s%02d" % j), val, ttl)
    server.manual_compact()
    for i in range(40):
        server.on_put(generate_key(b"user%03d" % int(rng.integers(0, n_hash)),
                                   b"late%02d" % i), b"l%d" % i, 0)
    server.flush()
    for i in range(10):
        server.on_put(generate_key(b"mem", b"%02d" % i), b"m%d" % i, 0)


def all_rows(server, types):
    """Every row through paged scans, and a few point reads."""
    rows = []
    resp = server.on_get_scanner(types.GetScannerRequest(batch_size=50))
    while True:
        rows.extend((kv.key, kv.value) for kv in resp.kvs)
        if resp.context_id < 0:
            break
        resp = server.on_scan(resp.context_id)
    gets = [server.on_get(generate_key(b"user%03d" % i, b"s%02d" % j))
            for i in range(0, 30, 7) for j in range(0, 12, 5)]
    return rows, gets


@pytest.mark.parametrize("codec,sidecars", [("none", False),
                                            ("dcz2", True)])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_encrypted_store_opens_in_the_other_package(tmp_path, env, codec,
                                                    sidecars, writer):
    set_flags(codec, sidecars)
    plain = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        root = tmp_path / f"plain-{name}"
        kw = {} if name == "jax" else {"device": "cpu"}
        srv = pkg["server"](str(root), **kw)
        fill(srv, pkg["types"], np.random.default_rng(1))
        plain[name] = all_rows(srv, pkg["types"])
        srv.close()
    assert plain["port"] == plain["jax"]
    assert len(plain["port"][0]) > 300

    root = tmp_path / "enc"
    encrypt_zone(root)
    w = JAX if writer == "jax" else PORT
    srv = (w["server"](str(root)) if writer == "jax"
           else w["server"](str(root), device="cpu"))
    fill(srv, w["types"], np.random.default_rng(1))
    srv.close()
    ssts = [os.path.join(d, f) for d, _s, fs in os.walk(root) for f in fs
            if f.endswith(".sst")]
    assert ssts and all(tefile.is_encrypted(p) for p in ssts)
    assert tefile.is_encrypted(str(root / "wal.log"))
    for name, pkg in (("jax", JAX), ("port", PORT)):
        kw = {} if name == "jax" else {"device": "cpu"}
        r = pkg["server"](str(root), **kw)
        assert all_rows(r, pkg["types"]) == plain["jax"]
        r.close()


def test_encrypted_sst_bytes_decrypt_to_the_plain_file(tmp_path, env):
    set_flags("dcz2", True)
    paths = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        for enc in (False, True):
            d = tmp_path / f"{name}-{enc}"
            if enc:
                encrypt_zone(d)
            os.makedirs(d, exist_ok=True)
            p = str(d / "t.sst")
            w = pkg["sst"].SSTableWriter(p, block_capacity=16)
            for i in range(300):
                w.add(generate_key(b"h%03d" % (i // 7), b"s%03d" % i),
                      b"value-%d" % i)
            w.finish()
            paths[name, enc] = p
    plain = open(paths["jax", False], "rb").read()
    assert open(paths["port", False], "rb").read() == plain
    for name in ("jax", "port"):
        with tefile.open_data_file(paths[name, True], "rb") as f:
            assert f.read() == plain
        assert tefile.logical_size(paths[name, True]) == len(plain)


def _write_sst(sst_mod, path, n=40, block_capacity=8):
    w = sst_mod.SSTableWriter(path, block_capacity=block_capacity)
    for i in range(n):
        w.add(generate_key(b"h%04d" % i, b"s"), b"value-%04d" % i)
    w.finish()
    return path


def _index(path):
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        f.seek(f.tell() - jsst.FOOTER.size)
        off, size, _crc, _magic = jsst.FOOTER.unpack(
            f.read(jsst.FOOTER.size))
        f.seek(off)
        return json.loads(f.read(size))


def _flip(path, pos, bit=3):
    with open(path, "r+b") as f:
        f.seek(pos)
        byte = f.read(1)
        f.seek(pos)
        f.write(bytes([byte[0] ^ (1 << bit)]))


def _verify_all(sst_mod, errors_mod, path):
    """Each block's verify_block outcome and the structural pass's, as
    plain values (an error's message without the file's path)."""
    t = sst_mod.SSTable(path)
    out = []
    for i in range(len(t.blocks)):
        try:
            out.append(t.verify_block(i))
        except errors_mod.StorageCorruptionError as e:
            out.append(("corrupt", str(e).replace(path, "")))
    try:
        t.verify_index_consistency()
        out.append("consistent")
    except errors_mod.StorageCorruptionError as e:
        out.append(("corrupt", str(e).replace(path, "")))
    t.close()
    return out


@pytest.mark.parametrize("damage", ["clean", "block", "phash", "legacy"])
def test_verify_block_and_index_consistency_match_jax(tmp_path, env,
                                                      damage):
    set_flags("none", True)
    outs = []
    for name, pkg in (("jax", JAX), ("port", PORT)):
        p = str(tmp_path / f"{name}.sst")
        if damage == "legacy":
            for reg in (JFLAGS, TFLAGS):
                reg.set("pegasus.storage", "block_crc", False)
        try:
            _write_sst(pkg["sst"], p)
        finally:
            for reg in (JFLAGS, TFLAGS):
                reg.set("pegasus.storage", "block_crc", True)
        index = _index(p)
        if damage == "block":
            b = index["blocks"][2]
            _flip(p, b["off"] + 7 % b["size"])
        elif damage == "phash":
            ph = index["phash"]
            # a slot word of the perfect-hash blob: the index now
            # mislocates (or denies) a resident key
            _flip(p, ph["off"] + ph["size"] // 2, bit=5)
        outs.append(_verify_all(pkg["sst"], pkg["errors"], p))
    assert outs[1] == outs[0]
    if damage == "block":
        assert outs[1][2][0] == "corrupt"
    if damage == "legacy":
        assert outs[1][0] is False


def _mini_engine(pkg, root, n=64):
    from types import SimpleNamespace

    eng = (pkg["engine"](str(root)) if pkg is JAX
           else pkg["engine"](str(root), device="cpu"))
    eng.write_batch([pkg["item"](OP_PUT, generate_key(b"h%03d" % i, b"s"),
                                 b"v%03d" % i) for i in range(n)],
                    decree=1)
    eng.flush()
    return eng, SimpleNamespace(server=SimpleNamespace(engine=eng))


def _scrub_result(res):
    return {k: v for k, v in res.items() if k not in ("started",
                                                      "finished")}


def test_scrubber_clean_pass_then_finds_planted_flip(tmp_path, env):
    set_flags("none", False)
    results = []
    for name, pkg in (("jax", JAX), ("port", PORT)):
        eng, rep = _mini_engine(pkg, tmp_path / name)
        hits = []
        sc = pkg["scrub"].ReplicaScrubber(
            lambda rep=rep: {(1, 0): rep},
            lambda gpid, exc, hits=hits: hits.append((gpid, exc)))
        clean = _scrub_result(sc.scrub_now((1, 0), rep))
        sst = sorted(os.path.join(eng.lsm.data_dir, f)
                     for f in os.listdir(eng.lsm.data_dir)
                     if f.endswith(".sst"))
        b = _index(sst[0])["blocks"][0]
        _flip(sst[0], b["off"] + 7 % b["size"])
        counter = pkg["metrics"].METRICS.entity(
            "storage", "node").counter("scrub_corrupt_blocks")
        before = counter.value()
        corrupt = _scrub_result(sc.scrub_now((1, 0), rep))
        corrupt["detail"] = corrupt["detail"].replace(sst[0], "")
        assert isinstance(hits[0][1], pkg["errors"].StorageCorruptionError)
        results.append((clean, corrupt, [g for g, _e in hits],
                        counter.value() - before))
        eng.close()
    assert results[1] == results[0]
    assert results[1][0]["state"] == "clean"
    assert results[1][0]["blocks_scanned"] > 0
    assert results[1][1]["state"] == "corrupt"
    assert results[1][3] == 1


def test_scrubber_paced_tick_restarts_on_generation_change(tmp_path, env):
    set_flags("none", False)
    cursors = []
    for name, pkg in (("jax", JAX), ("port", PORT)):
        eng, rep = _mini_engine(pkg, tmp_path / name)
        sc = pkg["scrub"].ReplicaScrubber(lambda rep=rep: {(1, 0): rep},
                                          lambda *_: None,
                                          blocks_per_tick=1)
        sc.tick()
        first = dict(sc._cursor[(1, 0)])
        eng.write_batch([pkg["item"](OP_PUT, generate_key(b"zzz", b"s"),
                                     b"v")], decree=2)
        eng.flush()
        sc.tick()
        cur = sc._cursor[(1, 0)]
        assert cur["gen"] == eng.lsm.generation
        cursors.append(([first[k] for k in ("table_i", "block_i",
                                            "scanned")],
                        [cur[k] for k in ("table_i", "block_i", "scanned")],
                        [st["blocks_scanned"] if "blocks_scanned" in st
                         else None for st in sc.results.values()]))
        eng.close()
    assert cursors[1] == cursors[0]


def _armed(fp, points, seed=42):
    fp.teardown()
    fp.setup()
    fp.seed(seed)
    for name, action in points.items():
        fp.cfg(name, action)


@pytest.mark.parametrize("seed", [7, 8])
def test_vfs_bit_flip_read_matches_jax(tmp_path, env, seed):
    p = str(tmp_path / "f.bin")
    with open(p, "wb") as f:
        f.write(bytes(range(256)) * 4)
    reads = []
    for pkg in (JAX, PORT):
        _armed(pkg["fp"], {"vfs::read": "return(bit_flip)"}, seed=seed)
        try:
            with pkg["vfs"].open_data_file(p, "rb") as f:
                reads.append(f.read())
        finally:
            pkg["fp"].teardown()
    clean = open(p, "rb").read()
    assert reads[1] == reads[0] != clean
    diff = [(x, y) for x, y in zip(reads[1], clean) if x != y]
    assert len(diff) == 1 and bin(diff[0][0] ^ diff[0][1]).count("1") == 1


@pytest.mark.parametrize("site,action,code", [
    ("vfs::read", "return(eio)", errno.EIO),
    ("vfs::write", "return(enospc)", errno.ENOSPC),
    ("vfs::write", "return(eio)", errno.EIO),
    ("vfs::fsync", "return(eio)", errno.EIO),
    ("vfs::open", "return(eio)", errno.EIO),
])
def test_vfs_typed_errors_match_jax(tmp_path, env, site, action, code):
    got = []
    for name, pkg in (("jax", JAX), ("port", PORT)):
        p = str(tmp_path / f"{name}.bin")
        with open(p, "wb") as f:
            f.write(b"x" * 64)
        _armed(pkg["fp"], {site: action})
        try:
            with pytest.raises(OSError) as ei:
                if site == "vfs::read":
                    pkg["vfs"].open_data_file(p, "rb").read()
                elif site == "vfs::write":
                    pkg["vfs"].open_data_file(p + ".w", "wb").write(b"y")
                elif site == "vfs::open":
                    pkg["vfs"].open_data_file(p, "rb")
                else:
                    f = pkg["vfs"].open_data_file(p + ".s", "wb")
                    f.write(b"z")
                    pkg["vfs"].fsync_file(f)
            got.append((type(ei.value), ei.value.errno, ei.value.strerror))
        finally:
            pkg["fp"].teardown()
    assert got[1] == got[0]
    assert got[1][1] == code


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_vfs_torn_write_prefix_matches_jax(tmp_path, env, seed):
    payload = bytes(range(200))
    on_disk = []
    for name, pkg in (("jax", JAX), ("port", PORT)):
        p = str(tmp_path / f"{name}.bin")
        _armed(pkg["fp"], {"vfs::write": "return(torn_write)"}, seed=seed)
        try:
            f = pkg["vfs"].open_data_file(p, "wb")
            with pytest.raises(OSError) as ei:
                f.write(payload)
            assert ei.value.errno == errno.EIO
            f.close()
        finally:
            pkg["fp"].teardown()
        on_disk.append(open(p, "rb").read())
    assert on_disk[1] == on_disk[0]
    assert len(on_disk[1]) < len(payload)
    assert on_disk[1] == payload[:len(on_disk[1])]


def test_wal_torn_tail_recovers_in_both_packages(tmp_path, env):
    """A torn append through the armed vfs leaves the port's WAL as the
    JAX package's: the valid prefix replays, the torn tail is cut at
    reopen, and the store reopens with the same rows."""
    set_flags("none", False)
    rows = []
    for name, pkg in (("jax", JAX), ("port", PORT)):
        root = tmp_path / name
        kw = {} if name == "jax" else {"device": "cpu"}
        srv = pkg["server"](str(root), **kw)
        for i in range(20):
            srv.on_put(generate_key(b"h", b"%02d" % i), b"v%d" % i)
        srv.close()
        _armed(pkg["fp"], {"vfs::write": "return(torn_write)"}, seed=9)
        try:
            srv = pkg["server"](str(root), **kw)
            with pytest.raises(OSError):
                srv.on_put(generate_key(b"h", b"torn"), b"x" * 100)
        finally:
            pkg["fp"].teardown()
        srv = pkg["server"](str(root), **kw)
        rows.append(all_rows(srv, pkg["types"])[0])
        srv.close()
    assert rows[1] == rows[0]
    assert len(rows[1]) == 20


def test_slow_query_threshold_env_changes_the_log(tmp_path, env):
    set_flags("none", False)
    servers = (JServer(str(tmp_path / "j")),
               PartitionServer(str(tmp_path / "t"), device="cpu"))
    try:
        for srv in servers:
            for i in range(50):
                srv.on_put(generate_key(b"h%02d" % (i % 5), b"%02d" % i),
                           b"v%d" % i)
        counts = []
        for threshold in ("0", "100000", "0"):
            for s in servers:
                s.update_app_envs(
                    {"replica.slow_query_threshold_ms": threshold})
            before = [len(s.slow_log.dump()) for s in servers]
            for srv, types in zip(servers, (jtypes, ttypes)):
                srv.on_get(generate_key(b"h01", b"01"))
                srv.on_multi_get(types.MultiGetRequest(hash_key=b"h02"))
                srv.on_get_scanner(types.GetScannerRequest(batch_size=5))
                srv.on_point_read_batch(
                    [("get", generate_key(b"h03", b"03"), None)])
            counts.append([[e["name"] for e in s.slow_log.dump()[b:]]
                           for s, b in zip(servers, before)])
        assert counts[0][1] == counts[0][0] and len(counts[0][0]) == 4
        assert counts[1] == [[], []]
        assert counts[2] == counts[0]
        # a full env set without the key restores the default (20 ms)
        for s in servers:
            s.update_app_envs({}, full_set=True)
        assert [s.slow_log.threshold_ms for s in servers] == [20.0, 20.0]
    finally:
        for s in servers:
            s.close()
