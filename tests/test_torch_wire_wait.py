"""The wire client's wait for its reply (client/cluster_client.py
`reply_wait_s`, tools/onebox_cluster.connect and OneboxAdmin).

A client over TcpTransport gets its replies on the transport's dispatch
thread. Its wait blocks on an event that the stored reply sets, at most
one 10 ms slice at a time, so a write acknowledged in 1 ms is not held
for the rest of the slice; a reply that never comes still costs the
reference's retry window (pump_rounds slices of 10 ms) before the retry.

- in process, on a stand-in transport: a reply that lands after 2 ms
  ends the wait in well under a slice; a reply to another pending
  request wakes the wait without ending it or shortening its window; a
  lost reply costs pump_rounds x reply_wait_s; a client takes a pump or
  `reply_wait_s`, not both;
- on a process onebox (1 meta, 1 replica, the CPU): a `set` takes well
  under one slice at the median, and a reply dropped by the replica's
  FaultPlan costs the whole 400 x 10 ms window before the client gives
  up on it, while the write itself applied.
"""

import statistics
import threading
import time

import pytest

from torch_mesh_helpers import restore_process_state

from pegasus_tpu_torch.client.cluster_client import ClusterClient

WAIT_S = 0.01


class StandInNet:
    """Delivers a reply to every request `delay_s` later on a thread of
    its own, as TcpTransport's dispatch thread does; `drop` rids get
    none."""

    def __init__(self, delay_s: float) -> None:
        self.delay_s = delay_s
        self.handler = None
        self.drop = set()

    def register(self, name, handler) -> None:
        self.handler = handler

    def send(self, src, dst, msg_type, payload) -> None:
        rid = payload["rid"]
        if rid in self.drop:
            return
        threading.Timer(self.delay_s, self.handler, args=(
            dst, "client_write_reply", {"rid": rid, "err": 0})).start()


def client(net, rounds=400):
    return ClusterClient(net, "c", "meta", "app", pump=None,
                         reply_wait_s=WAIT_S, pump_rounds=rounds)


def test_wait_ends_when_the_reply_lands():
    net = StandInNet(0.002)
    c = client(net)
    took = []
    for _ in range(20):
        t0 = time.perf_counter()
        rid = c._send_request("node0", "client_write", {})
        assert c._await(rid)["rid"] == rid
        took.append(time.perf_counter() - t0)
    assert statistics.median(took) < WAIT_S / 2, took
    assert not c._pending and not c._replies


def test_lost_reply_costs_the_window_and_other_replies_do_not_end_it():
    net = StandInNet(0.002)
    net.drop = {1}  # the first request's reply never comes
    c = client(net, rounds=30)
    t0 = time.perf_counter()
    lost = c._send_request("node0", "client_write", {})
    assert lost == 1
    # replies to another pending request wake the wait while it lasts
    c._pending.add(10_000)
    for i in range(5):
        threading.Timer(0.005 * (i + 1), c._on_message, args=(
            "node0", "client_write_reply", {"rid": 10_000})).start()
    assert c._await(lost) is None
    took = time.perf_counter() - t0
    assert 30 * WAIT_S <= took < 30 * WAIT_S + 0.25, took
    assert lost not in c._pending


def test_a_client_takes_a_pump_or_a_reply_wait():
    with pytest.raises(ValueError):
        ClusterClient(StandInNet(0), "c", "meta", "app", pump=None)
    with pytest.raises(ValueError):
        ClusterClient(StandInNet(0), "c", "meta", "app",
                      pump=lambda: None, reply_wait_s=WAIT_S)


@pytest.fixture(scope="module")
def onebox(tmp_path_factory):
    from pegasus_tpu_torch.tools import onebox_cluster as ob
    from pegasus_tpu_torch.utils.errors import PegasusError

    d = str(tmp_path_factory.mktemp("wirewait") / "ob")
    with restore_process_state():
        ob.start(d, n_replica=1, device="cpu", fault_plan={
            "seed": 1,
            "drop": [{"prob": 1.0, "src": "node0", "dst": "drop-client"}]})
        try:
            admin = ob.OneboxAdmin(d)
            deadline = time.monotonic() + 90
            while True:
                try:
                    if len(admin.call("list_nodes", timeout=6)) == 1:
                        break
                except PegasusError:
                    pass
                assert time.monotonic() < deadline
                time.sleep(0.5)
            admin.create_table("ww", partition_count=2, replica_count=1)
            admin.close()
            yield d
        finally:
            ob.stop(d)


def test_onebox_set_takes_under_a_slice(onebox):
    from pegasus_tpu_torch.tools import onebox_cluster as ob

    c = ob.connect("ww", onebox, client_name="fast-client")
    try:
        assert c.set(b"warm", b"s", b"v") == 0
        took = []
        for i in range(60):
            t0 = time.perf_counter()
            assert c.set(b"k%03d" % i, b"s", b"v%d" % i) == 0
            took.append(time.perf_counter() - t0)
        # the sleeping pump held every set for at least one whole slice
        assert statistics.median(took) < WAIT_S / 2, sorted(took)
        assert c.get(b"k059", b"s") == (0, b"v59")
    finally:
        c.net.close()


def test_onebox_dropped_reply_costs_the_retry_window(onebox):
    from pegasus_tpu_torch.base.key_schema import generate_key, key_hash_parts
    from pegasus_tpu_torch.replica.mutation import OP_PUT
    from pegasus_tpu_torch.tools import onebox_cluster as ob

    fast = ob.connect("ww", onebox, client_name="fast-client")
    slow = ob.connect("ww", onebox, client_name="drop-client")
    try:
        slow._ensure_config()  # the meta's replies are not dropped
        ph = key_hash_parts(b"lost", b"s")
        pidx = ph % slow.partition_count
        t0 = time.perf_counter()
        rid = slow._send_request(slow._primary_of(pidx), "client_write", {
            "gpid": (slow.app_id, pidx),
            "ops": [(OP_PUT, (generate_key(b"lost", b"s"), b"v", 0))],
            "auth": None, "partition_hash": ph})
        assert slow._await(rid) is None
        took = time.perf_counter() - t0
        assert 400 * WAIT_S <= took < 400 * WAIT_S + 2.0, took
        # the write applied; only its acknowledgement was lost
        assert fast.get(b"lost", b"s") == (0, b"v")
    finally:
        fast.net.close()
        slow.net.close()
