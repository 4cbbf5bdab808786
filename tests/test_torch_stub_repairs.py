"""Two hooks the replica stub needs from the layers below it, held to the
JAX package:

- the compaction governor's default foreground-pressure source is the
  node's ("rpc", "dispatch") counters: a shed on that entity halves the
  allowance, and quiet intervals recover it, alike in both packages;
- the range-read time budget runs on the partition's `clock_ns` (a stub
  under a simulated loop sets its virtual clock there): a ranged read
  whose clock passes `rocksdb_iteration_threshold_time_ms` stops at the
  same row in both packages; the partition entity carries the
  follower-read counters the stub's consistency gate increments.
"""

import pytest

from pegasus_tpu.base.key_schema import generate_key as jkey
from pegasus_tpu.server import types as jtypes
from pegasus_tpu.server.partition_server import (
    PartitionServer as JServer,
)
from pegasus_tpu.storage import compact_governor as jgov
from pegasus_tpu.utils.flags import FLAGS as JFLAGS
from pegasus_tpu.utils.metrics import MetricRegistry as JRegistry
from pegasus_tpu_torch.base.key_schema import generate_key as tkey
from pegasus_tpu_torch.server import types as ttypes
from pegasus_tpu_torch.server.partition_server import PartitionServer
from pegasus_tpu_torch.storage import compact_governor as tgov
from pegasus_tpu_torch.utils.flags import FLAGS as TFLAGS
from pegasus_tpu_torch.utils.metrics import MetricRegistry as TRegistry
from tests.test_torch_meta import frozen, isolated_state  # noqa: F401


class _Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _throttle(gov) -> float:
    # the JAX governor keeps it private, the port's as an attribute
    if hasattr(gov, "_throttle_mbps"):
        return gov._throttle_mbps
    return gov.throttle_mbps


def test_governor_backs_off_on_dispatch_sheds_like_jax(monkeypatch):
    """Each package's governor over a registry of its own: its default
    pressure source reads that registry's ("rpc", "dispatch") counters.
    A shed engages a cap at half the measured read rate, each further
    shed or deadline expiry halves it, and quiet feedback intervals
    recover it until the cap disengages — step for step alike."""
    regs = [JRegistry(), TRegistry()]
    monkeypatch.setattr(jgov, "METRICS", regs[0])
    monkeypatch.setattr(tgov, "METRICS", regs[1])
    clocks = [_Clock(), _Clock()]
    govs = [jgov.CompactionGovernor(clock=clocks[0], sleep=lambda s: None),
            tgov.CompactionGovernor(clock=clocks[1], sleep=lambda s: None)]
    flags = [JFLAGS, TFLAGS]
    saved = [f.get("pegasus.storage", "compact_min_mbps") for f in flags]
    for f in flags:
        f.set("pegasus.storage", "compact_min_mbps", 8, force=True)
    try:
        trace = [[], []]

        def feed(counter=None, n=0):
            for i, (reg, clock, gov) in enumerate(zip(regs, clocks, govs)):
                if counter:
                    reg.entity("rpc", "dispatch", {}).counter(
                        counter).increment(n)
                clock.t += 1.5
                gov.poke()
                trace[i].append(_throttle(gov))

        for clock, gov in zip(clocks, govs):
            gov.acquire(200_000_000)  # 200 MB read in the first second
            clock.t += 1.0
            gov.acquire(1)
        feed()                        # first look: the baseline
        feed("read_shed_count", 3)    # a shed: back off
        feed("read_shed_count", 1)    # another: again
        feed("deadline_expired_count", 2)
        for _ in range(9):
            feed()                    # quiet: recover
        assert trace[0] == trace[1]
        port = trace[1]
        assert port[0] == 0.0              # uncapped before any pressure
        assert port[1:4] == pytest.approx([100.0, 50.0, 25.0])
        assert port[-1] == 0.0             # recovered until uncapped
        assert govs[1].backoff_count == 3
        backoffs = [reg.entity("storage", "node").counter(
            "compact_backoff_count").value() for reg in regs]
        assert backoffs == [3, 3]
    finally:
        for f, v in zip(flags, saved):
            f.set("pegasus.storage", "compact_min_mbps", v, force=True)


def test_governor_keeps_an_injected_pressure_source():
    clock = _Clock()
    level = [0]
    gov = tgov.CompactionGovernor(clock=clock, sleep=lambda s: None,
                                  pressure_source=lambda: level[0])
    clock.t += 2.0
    gov.poke()
    level[0] = 5
    clock.t += 2.0
    gov.poke()
    assert gov.throttle_mbps > 0 and gov.backoff_count == 1


def _ticking_ns(step_ms: float):
    """A nanosecond clock that moves `step_ms` on every read."""
    t = [0]

    def clock():
        t[0] += int(step_ms * 1e6)
        return t[0]

    return clock


@pytest.mark.parametrize("step_ms", [1.0, 3.5])
def test_range_read_stops_on_the_partition_clock_like_jax(tmp_path, frozen,
                                                          step_ms):
    flags = [JFLAGS, TFLAGS]
    saved = [f.get("pegasus.server", "rocksdb_iteration_threshold_time_ms")
             for f in flags]
    for f in flags:
        f.set("pegasus.server", "rocksdb_iteration_threshold_time_ms", 20,
              force=True)
    servers = [JServer(str(tmp_path / "j"), app_id=9121),
               PartitionServer(str(tmp_path / "t"), app_id=9121,
                               device="cpu")]
    try:
        out = []
        for srv, key, types in zip(servers, (jkey, tkey),
                                   (jtypes, ttypes)):
            for i in range(300):
                assert srv.on_put(key(b"hk", b"s%04d" % i),
                                  b"v%d" % i) == 0
            srv.clock_ns = _ticking_ns(step_ms)
            resp = srv.on_multi_get(types.MultiGetRequest(b"hk"))
            srv.clock_ns = _ticking_ns(step_ms)
            count = srv.on_sortkey_count(b"hk")
            srv.clock_ns = None
            wall = srv.on_multi_get(types.MultiGetRequest(b"hk"))
            out.append(([(kv.key, kv.value) for kv in resp.kvs],
                        resp.error, resp.resume_sort_key, count,
                        len(wall.kvs)))
        assert out[0] == out[1]
        kvs, error, _resume, count, wall_rows = out[1]
        assert error != 0 and 0 < len(kvs) < 300   # stopped early
        assert count[0] != 0                       # incomplete count
        assert wall_rows == 300                    # the wall clock: whole
    finally:
        for s in servers:
            s.close()
        for f, v in zip(flags, saved):
            f.set("pegasus.server", "rocksdb_iteration_threshold_time_ms",
                  v, force=True)


def test_partition_entity_carries_the_follower_read_counters(tmp_path):
    srv = PartitionServer(str(tmp_path), app_id=9121, pidx=3, device="cpu")
    try:
        for name in ("follower_read_count", "stale_bounce_count",
                     "read_lease_reject_count"):
            assert srv.metrics.counter(name).value() == 0
        srv._follower_reads.increment()
        srv._stale_bounces.increment(2)
        srv._lease_rejects.increment(3)
        assert [srv.metrics.counter(n).value() for n in (
            "follower_read_count", "stale_bounce_count",
            "read_lease_reject_count")] == [1, 2, 3]
    finally:
        srv.close()
