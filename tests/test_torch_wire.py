"""The port's wire and simulated runtime (rpc/, runtime/sim, meta's store,
utils/{backoff,command_manager,thread_check,cpu_isolation}) on the CPU,
and against the JAX package's, exact.

- `encode_message` gives the same bytes in both packages for every
  registered message type, and each package decodes the other's frames;
  both registries hold the same names and fields;
- frames reassemble from pieces, a corrupt frame raises; the write codec
  encodes and decodes every op to the same bytes;
- FaultPlan and SimNetwork make the same drop / delay / duplicate /
  partition decisions from the same seed;
- the port's TcpTransport passes tests/test_transport.py's request /
  reply, expired-deadline, read-shedding and fault-plan cases;
- backoff jitter, the command manager and the thread checkers behave as
  the JAX package's; `MetaStorage` / `ServerState` round-trip
  `PartitionConfig` to the same file; `client_write_units` bills the
  same units.

Every flag a test sets is put back in the registry it set it in; every
transport is closed and the fail points torn down.
"""

import dataclasses
import json
import subprocess
import sys
import threading
import time
import typing

import numpy as np
import pytest

from pegasus_tpu.meta.meta_storage import MetaStorage as JMetaStorage
from pegasus_tpu.meta.server_state import AppState as JAppState
from pegasus_tpu.meta.server_state import PartitionConfig as JPartitionConfig
from pegasus_tpu.meta.server_state import ServerState as JServerState
from pegasus_tpu.rpc import codec as jcodec
from pegasus_tpu.rpc import fault as jfault
from pegasus_tpu.rpc import message as jmsg
from pegasus_tpu.runtime import sim as jsim
from pegasus_tpu.server import capacity_units as jcu
from pegasus_tpu.server import types as jtypes
from pegasus_tpu.utils.backoff import Backoff as JBackoff
from pegasus_tpu_torch.meta import (
    AppState,
    MetaStorage,
    PartitionConfig,
    ServerState,
)
from pegasus_tpu_torch.rpc import codec as tcodec
from pegasus_tpu_torch.rpc import fault as tfault
from pegasus_tpu_torch.rpc import message as tmsg
from pegasus_tpu_torch.rpc.message import (
    decode_message,
    encode_message,
    read_frames,
)
from pegasus_tpu_torch.runtime import sim as tsim
from pegasus_tpu_torch.server import capacity_units as tcu
from pegasus_tpu_torch.server import types as ttypes
from pegasus_tpu_torch.utils.backoff import Backoff
from pegasus_tpu_torch.utils.command_manager import CommandManager
from pegasus_tpu_torch.utils.errors import ErrorCode
from pegasus_tpu_torch.utils.fail_point import FAIL_POINTS
from pegasus_tpu_torch.utils.flags import FLAGS
from pegasus_tpu_torch.utils.thread_check import (
    SerialAccessChecker,
    ThreadAccessChecker,
)


@pytest.fixture(autouse=True)
def no_new_metric_entities():
    """Remove the metric entities a test created (transports, replicas)
    from both registries."""
    from pegasus_tpu.utils import metrics as jmetrics
    from pegasus_tpu_torch.utils import metrics as tmetrics

    regs = (jmetrics.METRICS, tmetrics.METRICS)
    before = [set(reg._entities) for reg in regs]
    yield
    for reg, keys in zip(regs, before):
        with reg._lock:
            for key in set(reg._entities) - keys:
                del reg._entities[key]


# ---- the message codec -----------------------------------------------------


def _registry(msg):
    if not msg._REGISTRY:
        msg._register_defaults()
    return msg._REGISTRY


def _value(ann: str, registry, rng, depth=0):
    """A seeded value of a field's annotation (a string: the dataclasses
    carry `from __future__ import annotations`)."""
    ann = ann.strip()
    if ann.startswith("Optional["):
        if rng.random() < 0.25:
            return None
        return _value(ann[9:-1], registry, rng, depth)
    if ann.startswith("List["):
        return [_value(ann[5:-1], registry, rng, depth + 1)
                for _ in range(int(rng.integers(0, 4)))]
    if ann.startswith("Dict["):
        return {"count": int(rng.integers(0, 1 << 40)),
                "sum": [int(rng.integers(0, 9)), b"\x00\xff"]}
    if ann == "bytes":
        return bytes(rng.integers(0, 256, int(rng.integers(0, 24)),
                                  dtype=np.uint8))
    if ann == "int":
        return int(rng.choice([0, -1, 7, 1 << 33, (1 << 64) - 5,
                               -(1 << 40), 1 << 70]))
    if ann == "bool":
        return bool(rng.integers(0, 2))
    if ann == "str":
        return "s%d" % int(rng.integers(0, 1000))
    if ann == "float":
        return float(rng.random())
    if ann == "Any":
        return None if depth else _build("PushdownSpec", registry, rng, 1)
    if ann in registry:
        return _build(ann, registry, rng, depth + 1)
    raise AssertionError(f"no value for annotation {ann!r}")


def _build(name, registry, rng, depth=0):
    cls = registry[name]
    return cls(**{f.name: _value(f.type, registry, rng, depth)
                  for f in dataclasses.fields(cls)})


def test_registries_hold_the_same_types():
    jreg, treg = _registry(jmsg), _registry(tmsg)
    assert list(jreg) == list(treg)
    assert jmsg._FIELDS == tmsg._FIELDS


@pytest.mark.parametrize("name", sorted(_registry(tmsg)))
def test_encode_message_matches_jax(name):
    """Ten seeded instances of each registered type, alone and inside a
    payload: the same frame bytes; each package decodes the other's
    frame back to an equal value."""
    for seed in range(10):
        j = _build(name, _registry(jmsg), np.random.default_rng(seed))
        t = _build(name, _registry(tmsg), np.random.default_rng(seed))
        for jp, tp in ((j, t), ({"ops": [(3, j)], "rid": seed},
                                {"ops": [(3, t)], "rid": seed})):
            jf = jmsg.encode_message("node0", "node1", "client_write", jp)
            tf = tmsg.encode_message("node0", "node1", "client_write", tp)
            assert jf == tf, (name, seed)
            jbuf, tbuf = bytearray(jf), bytearray(tf)
            (jbody,), (tbody,) = jmsg.read_frames(jbuf), tmsg.read_frames(tbuf)
            assert not jbuf and not tbuf
            assert tmsg.decode_message(jbody)[3] == tp
            assert jmsg.decode_message(tbody)[3] == jp


def roundtrip(payload):
    frame = encode_message("a", "b", "t", payload)
    buf = bytearray(frame)
    bodies = read_frames(buf)
    assert len(bodies) == 1 and not buf
    src, dst, mt, out = decode_message(bodies[0])
    assert (src, dst, mt) == ("a", "b", "t")
    return out


def test_message_roundtrip_primitives():
    for v in (None, True, False, 0, -1, 2**40, -(2**40), 2**63,
              0xFFFFFFFFFFFFFFFF, 2**100, -(2**100), 3.5, b"", b"bytes",
              "str", [1, [2, 3]], (4, (5,)), {"k": b"v", 1: None}):
        out = roundtrip(v)
        assert out == v and type(out) is type(v)
        assert encode_message("a", "b", "t", v) == \
            jmsg.encode_message("a", "b", "t", v)


def test_partial_frames_reassemble():
    frame = encode_message("x", "y", "z", {"big": b"A" * 10_000})
    buf = bytearray()
    out = []
    for i in range(0, len(frame), 997):
        buf.extend(frame[i:i + 997])
        out.extend(read_frames(buf))
    assert len(out) == 1
    assert decode_message(out[0])[3] == {"big": b"A" * 10_000}


def test_corrupt_frame_raises():
    frame = bytearray(encode_message("x", "y", "z", b"payload"))
    frame[-1] ^= 0xFF
    with pytest.raises(ValueError):
        read_frames(frame)
    bad = bytearray(encode_message("x", "y", "z", b"payload"))
    bad[0:4] = b"XXXX"
    with pytest.raises(ValueError):
        read_frames(bad)


def _write_ops(types, codec, rng):
    """One seeded request of every op the write codec carries."""
    def b(n=8):
        return bytes(rng.integers(0, 256, n, dtype=np.uint8))

    return [
        (codec.OP_PUT, (b(12), b(30), int(rng.integers(0, 1 << 32)))),
        (codec.OP_REMOVE, (b(12),)),
        (codec.OP_MULTI_PUT, types.MultiPutRequest(
            b(5), [types.KeyValue(b(3), b(9)) for _ in range(3)], 77)),
        (codec.OP_MULTI_REMOVE, types.MultiRemoveRequest(b(5), [b(2), b(4)])),
        (codec.OP_INCR, types.IncrRequest(b(10), -(1 << 40), -1)),
        (codec.OP_CAS, types.CheckAndSetRequest(
            b(5), b(3), 4, b(2), True, b(3), b(7), 99, True)),
        (codec.OP_CAM, types.CheckAndMutateRequest(
            b(5), b(3), 2, b(2), [types.Mutate(0, b(3), b(4), 5),
                                  types.Mutate(1, b(2))], True)),
        (codec.OP_INGEST, ("/data/bulk", "app", 7)),
    ]


def test_write_codec_matches_jax():
    for seed in range(20):
        jops = _write_ops(jtypes, jcodec, np.random.default_rng(seed))
        tops = _write_ops(ttypes, tcodec, np.random.default_rng(seed))
        for (jop, jreq), (top, treq) in zip(jops, tops):
            raw = tcodec.encode_write(top, treq)
            assert raw == jcodec.encode_write(jop, jreq)
            op, req, end = tcodec.decode_write(raw + b"tail")
            assert (op, end) == (top, len(raw))
            assert tcodec.encode_write(op, req) == raw
            assert jcodec.decode_write(raw)[2] == end


def test_client_write_units_match_jax():
    for seed in range(20):
        rng = np.random.default_rng(seed)
        jops = _write_ops(jtypes, jcodec, np.random.default_rng(seed))
        tops = _write_ops(ttypes, tcodec, np.random.default_rng(seed))
        # a value past one capacity unit
        big = (tcodec.OP_PUT, (b"k", b"v" * int(rng.integers(4000, 9000)), 0))
        assert tcu.client_write_units(tops + [big]) == \
            jcu.client_write_units(jops + [big])
    assert tcu.client_write_units([]) == 0


# ---- faults: FaultPlan and SimNetwork ---------------------------------------


def _plan_decisions(mod):
    plan = mod.FaultPlan(seed=3)
    out = []
    plan.set_drop(0.5, "a", "b")
    plan.set_delay(0.25, "a", None)
    plan.set_duplicate(0.5, None, "c")
    for i in range(200):
        src, dst = ("a", "b") if i % 3 == 0 else ("a", "c") if i % 3 == 1 \
            else ("x", "c")
        mt = "client_write" if i % 7 == 0 else "prepare"
        out.append(plan.outbound(src, dst, mt))
        if i == 120:
            plan.partition("c")
        if i == 160:
            plan.heal("c")
    return out, plan.dropped, plan.duplicated


def test_fault_plan_decisions_match_jax():
    assert _plan_decisions(tfault) == _plan_decisions(jfault)
    cfg = {"seed": 7, "drop": [{"prob": .1, "src": "n0", "dst": None}],
           "delay": [{"extra_s": .02}], "duplicate": [{"prob": .05}],
           "partition": ["n2"]}
    t, j = tfault.FaultPlan.from_config(cfg), jfault.FaultPlan.from_config(cfg)
    assert [t.outbound("n0", "n1", "prepare") for _ in range(50)] == \
        [j.outbound("n0", "n1", "prepare") for _ in range(50)]
    assert t.is_partitioned("n2") and j.is_partitioned("n2")


def _sim_trace(sim):
    loop = sim.SimLoop(seed=9)
    net = sim.SimNetwork(loop)
    got = []
    for name in ("a", "b", "c"):
        net.register(name, lambda s, mt, p, name=name: got.append(
            (round(loop.now, 12), s, name, mt, p)))
    net.set_drop(0.3, "a", "b")
    net.set_delay(0.01, "b", None)
    net.set_duplicate(0.5, None, "c")
    for i in range(60):
        src, dst = "abc"[i % 3], "abc"[(i + 1) % 3]
        net.send(src, dst, "client_write" if i % 5 == 0 else "prepare", i)
        if i == 30:
            net.partition("c")
        if i == 45:
            net.heal("c")
        if i % 10 == 9:
            loop.run_for(0.002)
    loop.run_until_idle()
    return got, net.delivered, net.dropped, loop.now


def test_sim_network_schedule_matches_jax():
    assert _sim_trace(tsim) == _sim_trace(jsim)


# ---- the TCP transport (tests/test_transport.py's cases) -------------------


def _pair():
    from pegasus_tpu_torch.rpc.transport import TcpTransport

    server = TcpTransport(("127.0.0.1", 0), {})
    host, port = server.listen_addr
    client = TcpTransport(None, {"srv": (host, port)})
    return server, client


def _wait_for(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


def test_tcp_transport_request_reply():
    server, client = _pair()
    got, replies = [], []
    try:
        def srv_handler(src, msg_type, payload):
            got.append((src, msg_type, payload))
            server.send("srv", src, "pong", payload["n"] + 1)

        server.register("srv", srv_handler)
        client.register("cli", lambda s, mt, p: replies.append((s, mt, p)))
        client.send("cli", "srv", "ping", {"n": 41})
        assert _wait_for(lambda: replies)
        assert got == [("cli", "ping", {"n": 41})]
        assert replies == [("srv", "pong", 42)]
    finally:
        client.close()
        server.close()


def test_dispatcher_fast_fails_expired_deadline():
    server, client = _pair()
    served, replies = [], []
    try:
        server.register("srv", lambda s, mt, p: served.append(p))
        client.register("cli", lambda s, mt, p: replies.append((mt, p)))
        client.send("cli", "srv", "client_read", {
            "rid": 7, "gpid": (1, 0), "op": "get", "args": b"k",
            "deadline": time.time() - 1.0})
        assert _wait_for(lambda: replies)
        mt, p = replies[0]
        assert mt == "client_read_reply"
        assert p == {"rid": 7, "err": int(ErrorCode.ERR_TIMEOUT),
                     "result": None}
        assert served == []
        client.send("cli", "srv", "client_read", {
            "rid": 8, "gpid": (1, 0), "op": "get", "args": b"k",
            "deadline": time.time() + 30.0})
        assert _wait_for(lambda: served)
    finally:
        client.close()
        server.close()


def test_read_shedding_err_busy():
    server, client = _pair()
    served, replies = [], []
    old = FLAGS.get("pegasus.rpc", "read_shed_queue_age_ms")
    FLAGS.set("pegasus.rpc", "read_shed_queue_age_ms", 50)
    try:
        server.register("srv", lambda s, mt, p: served.append((mt, p)))
        client.register("cli", lambda s, mt, p: replies.append((mt, p)))
        with server.lock:
            for i in range(6):
                client.send("cli", "srv", "client_read",
                            {"rid": i, "op": "get", "args": b"k"})
            client.send("cli", "srv", "client_write",
                        {"rid": 100, "gpid": (1, 0), "ops": []})
            time.sleep(0.4)
        assert _wait_for(lambda: len(replies) >= 4)
        assert all(mt == "client_read_reply"
                   and p["err"] == int(ErrorCode.ERR_BUSY)
                   for mt, p in replies), replies
        assert _wait_for(lambda: ("client_write", {
            "rid": 100, "gpid": (1, 0), "ops": []}) in served)
        client.send("cli", "srv", "client_read",
                    {"rid": 200, "op": "get", "args": b"k"})
        assert _wait_for(lambda: any(mt == "client_read"
                                     and p.get("rid") == 200
                                     for mt, p in served))
    finally:
        FLAGS.set("pegasus.rpc", "read_shed_queue_age_ms", old)
        client.close()
        server.close()


def test_fault_plan_on_the_tcp_transport():
    server, client = _pair()
    got = []
    try:
        server.register("srv", lambda s, mt, p: got.append(p))
        plan = tfault.FaultPlan(seed=3)
        client.install_fault_plan(plan)  # arms FAIL_POINTS too
        plan.set_drop(1.0, "cli", "srv")
        client.send("cli", "srv", "ping", 1)
        time.sleep(0.3)
        assert got == [] and plan.dropped == 1
        plan.set_drop(0.0, "cli", "srv")
        plan.set_delay(0.25, "cli", "srv")
        t0 = time.monotonic()
        client.send("cli", "srv", "ping", 2)
        assert _wait_for(lambda: 2 in got)
        assert time.monotonic() - t0 >= 0.25
        plan.set_delay(0.0, "cli", "srv")
        plan.set_duplicate(1.0, "cli", "srv")
        client.send("cli", "srv", "ping", 3)
        assert _wait_for(lambda: got.count(3) == 2)
        plan.set_duplicate(0.0, "cli", "srv")
        plan.partition("srv")
        client.send("cli", "srv", "ping", 4)
        time.sleep(0.2)
        assert 4 not in got
        plan.heal("srv")
        client.send("cli", "srv", "ping", 5)
        assert _wait_for(lambda: 5 in got)
        FAIL_POINTS.teardown()
        plan.set_drop(1.0, "cli", "srv")
        client.send("cli", "srv", "ping", 6)
        assert _wait_for(lambda: 6 in got)
    finally:
        FAIL_POINTS.teardown()
        client.close()
        server.close()


# ---- utils --------------------------------------------------------------


def test_backoff_jitter_bounds_and_determinism():
    slept = []
    b = Backoff(base_ms=20, max_ms=1000, seed=7,
                sleep=lambda s: slept.append(s))
    for attempt in range(1, 12):
        d = b.sleep(attempt)
        ceiling = min(1.0, 0.020 * 2 ** (attempt - 1))
        assert ceiling / 2 <= d <= ceiling, (attempt, d)
    assert slept == b.slept and len(slept) == 11
    b2 = Backoff(base_ms=20, max_ms=1000, seed=7, sleep=lambda s: None)
    assert [b2.delay(a) for a in range(1, 12)] != \
        [b2.delay(a) for a in range(1, 12)]
    b3 = Backoff(base_ms=20, max_ms=1000, seed=7, sleep=lambda s: None)
    b4 = Backoff(base_ms=20, max_ms=1000, seed=7, sleep=lambda s: None)
    assert [b3.delay(a) for a in range(1, 12)] == \
        [b4.delay(a) for a in range(1, 12)]


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_backoff_jitter_matches_jax(seed):
    t = Backoff(base_ms=15, max_ms=700, seed=seed, sleep=lambda s: None)
    j = JBackoff(base_ms=15, max_ms=700, seed=seed, sleep=lambda s: None)
    assert [t.sleep(a) for a in range(1, 20)] == \
        [j.sleep(a) for a in range(1, 20)]
    t.reset()
    j.reset()
    assert t.slept == j.slept == []
    # the defaults come from each package's own flags, which agree
    assert Backoff(seed=seed).delay(3) == JBackoff(seed=seed).delay(3)


def test_command_manager_verbs():
    mgr = CommandManager()
    mgr.register("echo", lambda args: list(args), "echo args")
    assert mgr.call("echo", ["a", "b"]) == ["a", "b"]
    assert "echo" in mgr.call("help", [])
    with pytest.raises(KeyError):
        mgr.call("nope", [])
    with pytest.raises(ValueError):
        mgr.register("echo", lambda a: a)


def test_serial_checker_allows_reentrancy():
    c = SerialAccessChecker("x")
    with c:
        with c:
            pass
    with c:
        pass


def test_serial_checker_detects_concurrency():
    c = SerialAccessChecker("replica 1.0@node0")
    inside = threading.Event()
    release = threading.Event()

    def holder():
        with c:
            inside.set()
            release.wait(5)

    t = threading.Thread(target=holder)
    t.start()
    assert inside.wait(5)
    with pytest.raises(RuntimeError, match="concurrent access"):
        with c:
            pass
    release.set()
    t.join()
    with c:
        pass


def test_thread_checker_pins_first_thread():
    c = ThreadAccessChecker("parser")
    c.check()
    c.check()
    err = []

    def other():
        try:
            c.check()
        except RuntimeError as e:
            err.append(e)

    t = threading.Thread(target=other)
    t.start()
    t.join()
    assert err and "owned by" in str(err[0])


def test_replica_guard_is_wired(tmp_path):
    from pegasus_tpu_torch.replica.replica import Replica

    class _NullTransport:
        def register(self, *a):
            pass

        def send(self, *a, **kw):
            pass

    r = Replica("n0", str(tmp_path), _NullTransport(), device="cpu")
    with r._access:
        errs = []

        def intruder():
            try:
                r.client_write([])
            except RuntimeError as e:
                errs.append(str(e))

        t = threading.Thread(target=intruder)
        t.start()
        t.join()
    assert errs and "concurrent access" in errs[0]
    r.close()


def test_force_cpu_hides_the_card():
    """`force_cpu(verify=True)` in a fresh process: torch sees no CUDA
    device afterwards."""
    code = ("import torch\n"
            "from pegasus_tpu_torch.utils.cpu_isolation import force_cpu\n"
            "force_cpu(verify=True)\n"
            "assert not torch.cuda.is_available()\n"
            "print('isolated')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(__import__("pathlib").Path(
                             __file__).resolve().parent.parent))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "isolated"


# ---- meta: MetaStorage / ServerState ----------------------------------------


def _meta_ops(storage_cls, state_cls, app_cls, config_cls, path):
    ms = storage_cls(path)
    st = state_cls(ms)
    app = app_cls(app_id=st.next_app_id(), app_name="t", partition_count=4,
                  max_replica_count=3)
    st.put_app(app, [config_cls() for _ in range(4)])
    st.update_partition(app.app_id, 1, config_cls(
        ballot=3, primary="node1", secondaries=["node2", "node0"]))
    st.set_partition_raw(app.app_id, 6, config_cls(ballot=1, primary="n"))
    ms.set_batch({"/x/1": {"a": 1}, "/x/2": [1, 2]})
    ms.delete("/x/1")
    st2 = state_cls(storage_cls(path))
    out = (st2.get_partition(app.app_id, 1).to_json(),
           st2.get_partition(app.app_id, 6).to_json(),
           st2.get_partition(app.app_id, 0).to_json(),
           st2.find_app("t").to_json(), ms.children("/x"),
           st2.get_partition(app.app_id, 1).members())
    with open(path) as f:
        return out, json.load(f)


def test_meta_state_round_trips_partition_config_as_jax(tmp_path):
    t = _meta_ops(MetaStorage, ServerState, AppState, PartitionConfig,
                  str(tmp_path / "t" / "meta.json"))
    j = _meta_ops(JMetaStorage, JServerState, JAppState, JPartitionConfig,
                  str(tmp_path / "j" / "meta.json"))
    assert t == j
    cfg = PartitionConfig(ballot=4, primary="a", secondaries=["b"])
    assert PartitionConfig.from_json(cfg.to_json()) == cfg
    assert roundtrip(cfg) == cfg
    assert encode_message("a", "b", "t", cfg) == jmsg.encode_message(
        "a", "b", "t", JPartitionConfig(ballot=4, primary="a",
                                         secondaries=["b"]))


def test_annotations_are_strings():
    """The value factory above reads the dataclasses' string
    annotations."""
    f = dataclasses.fields(ttypes.KeyValue)[0]
    assert isinstance(f.type, str)
    assert typing.get_type_hints(ttypes.KeyValue)["key"] is bytes
