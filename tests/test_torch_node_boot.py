"""A node process's boot against its first frames (server/node_main.py,
rpc/message.py, tools/onebox_cluster.py), on the CPU.

- (i) The message registry is filled once, under a lock: with
  `register_message_type` slowed down, a thread that decodes a frame
  carrying a `PartitionConfig` and a `ScanResponse` while another
  encodes one never meets a partial registry, whichever starts first.
- (ii) `node_main.run_node` imports its role's modules and fills the
  registry before its `TcpTransport` opens the port, for a meta and for
  a replica: no reader or dispatch thread imports a package then.
- (ii') A meta node whose peer connects the moment its port opens and
  sends frames from then on answers `list_nodes`, and its log holds no
  traceback.
- (iii) A node whose boot raises after its port opened exits non-zero,
  and `onebox_cluster.start` raises with that node's log tail.

Each case runs in a process of its own (a fresh registry, fresh
imports).
"""

import json
import os
import socket
import subprocess
import sys
import time

import pytest

from pegasus_tpu.rpc import message as jmessage
from pegasus_tpu_torch.meta.server_state import PartitionConfig
from pegasus_tpu_torch.rpc import message
from pegasus_tpu_torch.server.types import KeyValue, ScanResponse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _default_types() -> list:
    """The message types the JAX package registers by default: the
    port's registry must hold exactly these."""
    jmessage._register_defaults()
    return sorted(jmessage._REGISTRY)


def _payload() -> dict:
    return {"config": PartitionConfig(7, "node1", ["node0", "node2"]),
            "scan": ScanResponse(0, [KeyValue(b"s1", b"v1", 3),
                                     KeyValue(b"s2", b"")], 5, 2)}


def _run(script: str, *args, timeout: float = 120) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", script, *args],
                          capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=timeout)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


RACE = r"""
import json, sys, threading, time

# the modules that define the types are imported up front: the race
# under test is the registry's, not an import
import pegasus_tpu_torch.meta.server_state
import pegasus_tpu_torch.ops.pushdown
import pegasus_tpu_torch.server.types as t
from pegasus_tpu_torch.meta.server_state import PartitionConfig
from pegasus_tpu_torch.rpc import message

frame, first = bytes.fromhex(sys.argv[1]), sys.argv[2]
started = threading.Event()
register = message.register_message_type


def slow(cls):
    out = register(cls)
    started.set()
    time.sleep(0.02)
    return out


message.register_message_type = slow
payload = {"config": PartitionConfig(7, "node1", ["node0", "node2"]),
           "scan": t.ScanResponse(0, [t.KeyValue(b"s1", b"v1", 3),
                                      t.KeyValue(b"s2", b"")], 5, 2)}
out = {}


def decode():
    try:
        got = message.decode_message(frame[12:])
        out["decoded"] = got[3] == payload and got[:3] == ("a", "b", "t")
    except Exception as e:
        out["decode_error"] = repr(e)


def encode():
    try:
        out["encoded"] = message.encode_message(
            "a", "b", "t", payload) == frame
    except Exception as e:
        out["encode_error"] = repr(e)


a, b = (decode, encode) if first == "decode" else (encode, decode)
ta = threading.Thread(target=a)
ta.start()
assert started.wait(30)
tb = threading.Thread(target=b)
tb.start()
ta.join()
tb.join()
print(json.dumps(out))
"""


@pytest.mark.parametrize("first", ["decode", "encode"])
def test_registry_is_never_seen_partial(first):
    frame = message.encode_message("a", "b", "t", _payload())
    out = _run(RACE, frame.hex(), first)
    assert out == {"decoded": True, "encoded": True}, out


PROBE = r"""
import json, sys

from pegasus_tpu_torch.rpc import message, transport
from pegasus_tpu_torch.server import node_main

cfg, name, want = json.loads(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
seen = {}


class Opened(Exception):
    pass


class Probe:
    def __init__(self, listen, book):
        seen["missing"] = [m for m in want if m not in sys.modules]
        seen["registry"] = sorted(message._REGISTRY)
        raise Opened


transport.TcpTransport = Probe
try:
    node_main.run_node(cfg, name)
except Opened:
    pass
print(json.dumps(seen))
"""

ROLE_MODULES = {
    "meta": ["pegasus_tpu_torch.meta.meta_service",
             "pegasus_tpu_torch.http.http_server"],
    "node0": ["pegasus_tpu_torch.replica.stub",
              "pegasus_tpu_torch.replica.replica",
              "pegasus_tpu_torch.server.scan_coordinator",
              "pegasus_tpu_torch.http.http_server"],
}
TRANSPORT_THREAD_MODULES = ["pegasus_tpu_torch.server.tenancy",
                            "pegasus_tpu_torch.utils.profiler"]


def _cluster(tmp_path) -> dict:
    return {"data_root": str(tmp_path / "data"), "device": "cpu",
            "nodes": {"meta": {"host": "127.0.0.1", "port": 1,
                               "role": "meta"},
                      "node0": {"host": "127.0.0.1", "port": 2,
                                "role": "replica"}}}


@pytest.mark.parametrize("name", ["meta", "node0"])
def test_role_is_imported_before_the_port_opens(tmp_path, name):
    want = ROLE_MODULES[name] + TRANSPORT_THREAD_MODULES
    seen = _run(PROBE, json.dumps(_cluster(tmp_path)), name,
                json.dumps(want))
    assert seen == {"missing": [], "registry": _default_types()}, seen


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_meta_takes_frames_from_its_first_moment(tmp_path):
    """The peer dials from before the node starts and, once connected,
    sends an admin `list_nodes` (its payload carrying a PartitionConfig
    and a ScanResponse) every 10 ms until one is answered."""
    port = _free_port()
    cfg = {"data_root": str(tmp_path / "data"),
           "nodes": {"meta": {"host": "127.0.0.1", "port": port,
                              "role": "meta"}}}
    path = tmp_path / "cluster.json"
    path.write_text(json.dumps(cfg))
    log_path = tmp_path / "meta.log"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    with open(log_path, "wb") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "pegasus_tpu_torch.server.node_main",
             "--config", str(path), "--name", "meta"],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO)
    try:
        deadline = time.monotonic() + 60
        while True:
            assert proc.poll() is None, log_path.read_text()
            assert time.monotonic() < deadline, "the port never opened"
            try:
                sock = socket.create_connection(("127.0.0.1", port),
                                                timeout=1.0)
                break
            except OSError:
                time.sleep(0.002)
        sock.settimeout(0.01)
        buf = bytearray()
        reply = None
        rid = 0
        deadline = time.monotonic() + 60
        while reply is None:
            assert proc.poll() is None, log_path.read_text()
            assert time.monotonic() < deadline, log_path.read_text()
            rid += 1
            sock.sendall(message.encode_message(
                "peer", "meta", "admin",
                {"rid": rid, "cmd": "list_nodes", "args": {},
                 "carry": _payload()}))
            try:
                chunk = sock.recv(1 << 16)
            except socket.timeout:
                continue
            assert chunk, log_path.read_text()
            buf.extend(chunk)
            for body in message.read_frames(buf):
                _src, _dst, msg_type, payload = message.decode_message(body)
                if msg_type == "admin_reply":
                    reply = payload
        sock.close()
        assert reply["err"] == 0 and reply["result"] == [], reply
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    assert "Traceback" not in log_path.read_text()


def test_a_failed_boot_raises_from_start(tmp_path):
    """The data root is a file: every node's boot raises once its port
    is open (the meta's storage and the replica's data directories are
    made after it)."""
    from pegasus_tpu_torch.tools import onebox_cluster as ob

    d = tmp_path / "ob"
    d.mkdir()
    (d / "data").write_text("not a directory")
    try:
        with pytest.raises(RuntimeError) as info:
            ob.start(str(d), n_replica=1, device="cpu")
        assert ob.status(str(d)) == {}  # start stopped what it started
    finally:
        ob.stop(str(d))  # nodes a start that returned left running
    text = str(info.value)
    assert "exited with 1 during boot" in text, text
    assert "Traceback" in text and "Error" in text, text
