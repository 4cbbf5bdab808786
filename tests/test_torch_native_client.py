"""The port's wire clients against its process onebox, on the CPU: the
C++ wire client (native/wire_client.{cpp,py}), the Perl client and the
async facade (client/aio.py).

- tests/test_native_client.py, tests/test_perl_client.py and
  tests/test_aio_client.py run on the port through `load_spec` (node
  processes started with `device="cpu"`);
- a JAX onebox and a port onebox, both of processes on the CPU, get one
  seeded stream of set / multi_set / del / get / multi_get / scan /
  sortkey_count / check_and_set and give equal answers (the C++ client
  speaks to both; multi_set and sortkey_count, which it lacks, go
  through each package's ClusterClient);
- a port onebox started on the data directory and cluster.json of the
  stopped JAX onebox (the SST, plog and meta-storage bytes are the JAX
  package's) answers a probe exactly as the JAX onebox did, and takes
  new writes.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from pegasus_tpu.tools import onebox_cluster as job
from pegasus_tpu_torch.native import wire_client
from pegasus_tpu_torch.tools import onebox_cluster as tob
from pegasus_tpu_torch.utils.errors import PegasusError
from torch_mesh_helpers import load_spec, restore_process_state

SPEC = (load_spec("test_native_client.py", globals(), "native_spec")
        + load_spec("test_perl_client.py", globals(), "perl_spec")
        + load_spec("test_aio_client.py", globals(), "aio_spec"))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_REPLICA = 2
TABLE = "diff"
N_HASHKEYS = 12   # the stream's key space: 12 hashkeys x 4 sortkeys


@pytest.fixture(autouse=True)
def _isolated():
    with restore_process_state():
        yield


def test_every_spec_case_was_taken():
    assert len(SPEC) == 6, SPEC


def test_wire_client_build_failure_raises(tmp_path, monkeypatch):
    """A failed g++ build raises: there is no silent path without the
    library."""
    monkeypatch.setattr(wire_client, "_lib", None)
    monkeypatch.setattr(wire_client, "_SO", str(tmp_path / "lib.so"))
    monkeypatch.setattr(wire_client, "_SRC", str(tmp_path / "bad.cpp"))
    (tmp_path / "bad.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        wire_client.load()


def _wait_nodes(admin, n, timeout=90.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if len(admin.call("list_nodes", timeout=6)) == n:
                return
        except PegasusError:
            pass
        time.sleep(0.5)
    raise AssertionError("nodes did not register")


def _wait_gone(pids, timeout=30.0):
    """Every pid exited (a zombie counts as exited)."""
    deadline = time.monotonic() + timeout
    for pid in pids:
        while time.monotonic() < deadline:
            try:
                with open(f"/proc/{pid}/stat") as f:
                    if f.read().split(") ", 1)[1][0] == "Z":
                        break
            except (FileNotFoundError, ProcessLookupError):
                break
            time.sleep(0.1)
        else:
            raise AssertionError(f"pid {pid} still running")


def _native(d):
    with open(os.path.join(d, "cluster.json")) as f:
        cfg = json.load(f)
    book = {n: (c["host"], c["port"]) for n, c in cfg["nodes"].items()}
    metas = [n for n, c in cfg["nodes"].items() if c["role"] == "meta"]
    nc = wire_client.NativeClient("cpp-diff", book, metas, TABLE)
    deadline = time.monotonic() + 60
    while not (nc.refresh() and nc.partition_count):
        assert time.monotonic() < deadline, nc.last_error()
        time.sleep(0.5)
    # settle: 32 warm keys, so every partition's primary took a write
    for i in range(32):
        while nc.set(b"warm%02d" % i, b"s", b"w") != 0:
            assert time.monotonic() < deadline, nc.last_error()
            time.sleep(0.5)
    return nc


def _stream(nc, cc, seed, n_ops=240):
    """One seeded stream of ops; returns every answer in order."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_ops):
        hk = b"h%03d" % rng.integers(0, N_HASHKEYS)
        sk = b"s%02d" % rng.integers(0, 4)
        op = rng.choice(["set", "set", "multi_set", "del", "get", "get",
                         "multi_get", "scan", "sortkey_count", "cas"])
        if op == "set":
            out.append((op, nc.set(hk, sk, b"v%d" % i)))
        elif op == "multi_set":
            kvs = {b"m%02d" % j: b"mv%d.%d" % (i, j)
                   for j in range(int(rng.integers(1, 5)))}
            out.append((op, cc.multi_set(hk, kvs)))
        elif op == "del":
            out.append((op, nc.delete(hk, sk)))
        elif op == "get":
            out.append((op, nc.get(hk, sk)))
        elif op == "multi_get":
            out.append((op, nc.multi_get(hk)))
        elif op == "scan":
            out.append((op, list(nc.scan(hk, batch_size=3))))
        elif op == "sortkey_count":
            out.append((op, cc.sortkey_count(hk)))
        else:
            out.append((op, nc.check_and_set(hk, sk, 3, b"", b"cas",
                                             b"c%d" % i)))
    return out


def _probe(nc):
    out = []
    for h in range(N_HASHKEYS):
        hk = b"h%03d" % h
        out.append(nc.multi_get(hk))
        out.append(list(nc.scan(hk, batch_size=4)))
        out.append(nc.get(hk, b"s01"))
    return out


def _serve_port_on(d):
    """Port node processes on the cluster.json and data of `d`, on the
    CPU; pids.json names them, so onebox_cluster.stop ends them."""
    path = os.path.join(d, "cluster.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["device"] = "cpu"
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    pids = {}
    for name in cfg["nodes"]:
        log = open(os.path.join(d, "logs", f"{name}.port.log"), "ab")
        pids[name] = subprocess.Popen(
            [sys.executable, "-m", "pegasus_tpu_torch.server.node_main",
             "--config", path, "--name", name],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO).pid
    with open(os.path.join(d, "pids.json"), "w") as f:
        json.dump(pids, f)


def test_jax_and_port_oneboxes_answer_alike_and_share_state(tmp_path):
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    job.start(dj, n_replica=N_REPLICA)
    tob.start(dt, n_replica=N_REPLICA, device="cpu")
    clients = []
    try:
        answers, probes = {}, {}
        for name, ob, d in (("jax", job, dj), ("port", tob, dt)):
            admin = ob.OneboxAdmin(d)
            _wait_nodes(admin, N_REPLICA)
            admin.create_table(TABLE, partition_count=4,
                               replica_count=N_REPLICA)
            admin.close()
            nc = _native(d)
            cc = ob.connect(TABLE, d)
            clients += [nc, cc]
            answers[name] = _stream(nc, cc, seed=7)
            probes[name] = _probe(nc)
        assert answers["jax"] == answers["port"]
        assert probes["jax"] == probes["port"]
        assert sum(1 for op, a in answers["port"] if op == "scan" and a) > 5
        assert sum(1 for op, a in answers["port"]
                   if op == "get" and a[0] == 0) > 5

        # the JAX onebox stops; the port serves its directory
        with open(os.path.join(dj, "pids.json")) as f:
            jax_pids = list(json.load(f).values())
        job.stop(dj)
        _wait_gone(jax_pids)
        _serve_port_on(dj)
        admin = tob.OneboxAdmin(dj)
        _wait_nodes(admin, N_REPLICA)
        admin.close()
        nc = _native(dj)
        clients.append(nc)
        deadline = time.monotonic() + 60
        while True:
            try:
                got = _probe(nc)
            except RuntimeError:   # a scan met a partition still opening
                got = None
            if got == probes["jax"] or time.monotonic() > deadline:
                break
            time.sleep(1)
        assert got == probes["jax"]
        assert nc.set(b"after", b"s", b"port") == 0
        assert nc.get(b"after", b"s") == (0, b"port")
    finally:
        for c in clients:
            c.close() if hasattr(c, "close") else c.net.close()
        job.stop(dj)
        tob.stop(dt)


def _resp_call(sock, *words):
    out = b"*%d\r\n" % len(words) + b"".join(
        b"$%d\r\n%s\r\n" % (len(w), w) for w in words)
    sock.sendall(out)
    buf = b""
    while not buf.endswith(b"\r\n") or (
            buf.startswith(b"$") and buf.count(b"\r\n") < 2
            and not buf.startswith(b"$-1")):
        chunk = sock.recv(4096)
        assert chunk, buf
        buf += chunk
    return buf


def test_redis_proxy_main_serves_a_onebox(tmp_path):
    """`python -m pegasus_tpu_torch.redis_proxy --cluster D --table T`
    dials a port onebox (its node processes on the CPU) and answers RESP
    on its port, with the GEO verbs over a second table."""
    import socket

    d = str(tmp_path / "ob")
    tob.start(d, n_replica=1, device="cpu")
    proxy = None
    try:
        admin = tob.OneboxAdmin(d)
        _wait_nodes(admin, 1)
        for name in ("kv", "geoidx"):
            admin.create_table(name, partition_count=2, replica_count=1)
        admin.close()
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        proxy = subprocess.Popen(
            [sys.executable, "-m", "pegasus_tpu_torch.redis_proxy",
             "--cluster", d, "--table", "kv", "--port", str(port),
             "--geo-index", "geoidx", "--device", "cpu"],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        assert "serving kv on port" in proxy.stdout.readline()
        with socket.create_connection(("127.0.0.1", port), timeout=60) as c:
            assert _resp_call(c, b"PING") == b"+PONG\r\n"
            deadline = time.monotonic() + 60
            while _resp_call(c, b"SET", b"k", b"v") != b"+OK\r\n":
                assert time.monotonic() < deadline
                time.sleep(0.5)
            assert _resp_call(c, b"GET", b"k") == b"$1\r\nv\r\n"
            assert _resp_call(c, b"GET", b"nope") == b"$-1\r\n"
            assert _resp_call(c, b"INCR", b"n") == b":1\r\n"
            assert _resp_call(c, b"GEOADD", b"places", b"-74.0", b"40.7",
                              b"nyc") == b":1\r\n"
    finally:
        if proxy is not None:
            proxy.kill()
            proxy.wait()
        tob.stop(d)
