"""The Redis proxy: the port's RESP codec and RedisHandler against the JAX
package's, byte for byte.

- RESP parsing (multibulk, inline, split feeds, pipelining, a negative
  bulk length refused) and the reply serializers;
- the command semantics and GEO commands of tests/test_redis_proxy.py
  (every case but the cluster ones), sent to a JAX handler and a port
  handler over their own Tables: every reply byte-identical, both
  packages' clocks frozen so TTL replies agree;
- a cluster-side failure becomes an -ERR reply;
- one RESP session over a localhost socket through the port's
  RedisProxy.
"""

import socket
import time

import pytest

from pegasus_tpu.base import value_schema as jvs
from pegasus_tpu.client import PegasusClient as JClient
from pegasus_tpu.client import Table as JTable
from pegasus_tpu.geo import GeoClient as JGeo
from pegasus_tpu.ops import placement as jplacement
from pegasus_tpu.redis_proxy import RedisHandler as JHandler
from pegasus_tpu.redis_proxy import resp as jresp
from pegasus_tpu.server.workload import DRIFT as JDRIFT
from pegasus_tpu_torch.base import value_schema as tvs
from pegasus_tpu_torch.client import PegasusClient, Table
from pegasus_tpu_torch.geo import GeoClient
from pegasus_tpu_torch.redis_proxy import RedisHandler, RedisProxy
from pegasus_tpu_torch.redis_proxy import resp
from pegasus_tpu_torch.utils.errors import ErrorCode, PegasusError

FEEDS = [
    [b"*3\r\n$3\r\nSET\r\n$1\r\nk\r\n$1\r\nv\r\n"],
    [b"*2\r\n$3\r\nGET\r\n$", b"1\r\nk\r\n"],
    [b"PING\r\n", b"ECHO  hi\r\n"],
    [b"*1\r\n$4\r\nPING\r\n*1\r\n$4\r\nPING\r\n"],
    [b"*2\r\n$4\r\n", b"ECHO\r\n$0\r\n\r\n", b"*1\r", b"\n$4\r\nPI",
     b"NG\r\n"],
    [b"\r\n*0\r\n*1\r\n$3\r\nabc\r\n"],
]


def _feed_all(parser_cls, chunks):
    p = parser_cls()
    out = []
    for c in chunks:
        try:
            out.append(p.feed(c))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    return out


@pytest.mark.parametrize("case", range(len(FEEDS)))
def test_resp_parser_matches_jax(case):
    assert _feed_all(resp.RespParser, FEEDS[case]) == \
        _feed_all(jresp.RespParser, FEEDS[case])


def test_resp_parser_cases():
    p = resp.RespParser()
    assert p.feed(b"*3\r\n$3\r\nSET\r\n$1\r\nk\r\n$1\r\nv\r\n") == [
        [b"SET", b"k", b"v"]]
    assert p.feed(b"*2\r\n$3\r\nGET\r\n$") == []
    assert p.feed(b"1\r\nk\r\n") == [[b"GET", b"k"]]
    assert p.feed(b"PING\r\n") == [[b"PING"]]
    with pytest.raises(ValueError):
        resp.RespParser().feed(b"*1\r\n$-1\r\n*1\r\n$4\r\nPING\r\n")
    with pytest.raises(ValueError):
        resp.RespParser().feed(b"*x\r\n")


@pytest.mark.parametrize("value", [
    None, b"", b"ab", 0, -2, 12345678901234, [], [b"a", 1, [b"b"]],
    [None, b"x", [1, [2, None]]], "text", [3.5]])
def test_resp_serializers_match_jax(value):
    if isinstance(value, (bytes, type(None))):
        assert resp.bulk(value) == jresp.bulk(value)
    if isinstance(value, int):
        assert resp.integer(value) == jresp.integer(value)
    if isinstance(value, list) or value is None:
        assert resp.array(value) == jresp.array(value)
    if isinstance(value, str):
        assert resp.simple(value) == jresp.simple(value)
        assert resp.error(value) == jresp.error(value)


class Clock:
    """A module's `time` with `time()` frozen at `t`."""

    def __init__(self, t: float) -> None:
        self.t = t

    def time(self) -> float:
        return self.t

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture
def handlers(tmp_path, monkeypatch):
    """(JAX handler, port handler), each over a raw table and a geo
    index of 4 partitions; both clocks frozen."""
    clk = Clock(1_790_000_000.0)
    for mod in (jvs, tvs):
        monkeypatch.setattr(mod, "time", clk)
    jraw = JTable(str(tmp_path / "jraw"), app_id=1, partition_count=4)
    jidx = JTable(str(tmp_path / "jidx"), app_id=2, partition_count=4)
    traw = Table(str(tmp_path / "traw"), app_id=1, partition_count=4,
                 device="cpu")
    tidx = Table(str(tmp_path / "tidx"), app_id=2, partition_count=4,
                 device="cpu")
    pair = (JHandler(JClient(jraw), geo=JGeo(JClient(jraw), JClient(jidx))),
            RedisHandler(PegasusClient(traw),
                         geo=GeoClient(PegasusClient(traw),
                                       PegasusClient(tidx))))
    yield pair, clk
    for t in (jraw, jidx, traw, tidx):
        t.close()
    jplacement.reset_probe()
    JDRIFT.reset()


COMMANDS = [
    [b"PING"], [b"PING", b"hello"], [b"ECHO", b"x"], [b"COMMAND"],
    [b"SET", b"k", b"hello"], [b"GET", b"k"], [b"GET", b"missing"],
    [b"EXISTS", b"k", b"missing"], [b"DEL", b"k", b"missing"],
    [b"GET", b"k"], [b"SETEX", b"tk", b"100", b"v"], [b"TTL", b"tk"],
    [b"PTTL", b"tk"], [b"TTL", b"nope"], [b"PTTL", b"nope"],
    [b"SET", b"nt", b"v"], [b"TTL", b"nt"], [b"PTTL", b"nt"],
    [b"SET", b"ex", b"v", b"EX", b"50"], [b"TTL", b"ex"],
    [b"SET", b"px", b"v", b"PX", b"2500"], [b"TTL", b"px"],
    [b"SET", b"bad", b"v", b"NX"],
    [b"INCR", b"c"], [b"INCRBY", b"c", b"41"], [b"DECR", b"c"],
    [b"DECRBY", b"c", b"40"], [b"INCR", b"k2"], [b"SET", b"s", b"abc"],
    [b"INCR", b"s"], [b"INCRBY", b"c", b"x"],
    [b"NOPE"], [b"SET", b"only-key"], [], [b"GET"],
    [b"GEOADD", b"places", b"-74.0", b"40.0", b"center",
     b"-74.0", b"40.0018", b"north200m", b"-73.9953", b"40.0", b"east400m"],
    [b"GEORADIUS", b"places", b"-74.0", b"40.0", b"300", b"m"],
    [b"GEORADIUS", b"places", b"-74.0", b"40.0", b"1", b"km"],
    [b"GEORADIUS", b"places", b"-74.0", b"40.0", b"300", b"m",
     b"COUNT", b"1"],
    [b"GEORADIUS", b"places", b"-74.0", b"40.0", b"300", b"mi"],
    [b"GEODIST", b"places", b"center", b"north200m"],
    [b"GEODIST", b"places", b"center", b"east400m", b"km"],
    [b"GEODIST", b"places", b"center", b"missing"],
    [b"GEOPOS", b"places", b"center", b"missing", b"east400m"],
    [b"GEORADIUSBYMEMBER", b"places", b"north200m", b"300", b"m"],
    [b"GEORADIUSBYMEMBER", b"places", b"north200m", b"50", b"m"],
    [b"GEORADIUSBYMEMBER", b"places", b"center", b"1", b"km",
     b"COUNT", b"2"],
    [b"GEORADIUSBYMEMBER", b"places", b"missing", b"300", b"m"],
    [b"SET", b"center", b"not-a-point"],
    [b"GEOPOS", b"places", b"center"],
]


def test_commands_match_jax_byte_for_byte(handlers):
    (jh, th), clk = handlers
    for i, argv in enumerate(COMMANDS):
        if i == 22:
            clk.t += 7  # the TTL replies count down alike
        assert th.handle(list(argv)) == jh.handle(list(argv)), argv
    h = th.handle
    assert h([b"GET", b"k"]) == b"$-1\r\n"
    assert h([b"INCR", b"c"]) == b":2\r\n"
    assert h([b"GEORADIUS", b"places", b"-74.0", b"40.0", b"300", b"m",
              b"COUNT", b"1"]) == b"*1\r\n$6\r\ncenter\r\n"
    assert h([b"GEOADD", b"p"]) == b":0\r\n"


def test_geo_commands_need_a_geo_client(tmp_path):
    t = Table(str(tmp_path / "t"), partition_count=2, device="cpu")
    try:
        out = RedisHandler(PegasusClient(t)).handle(
            [b"GEOADD", b"k", b"1", b"2", b"m"])
        assert out == b"-ERR GEO commands need a geo-enabled proxy\r\n"
    finally:
        t.close()


def test_cluster_error_becomes_err_reply():
    class Boom:
        def set(self, *a, **k):
            raise PegasusError(ErrorCode.ERR_TIMEOUT, "retries exhausted")

    out = RedisHandler(Boom()).handle([b"SET", b"k", b"v"])
    assert out.startswith(b"-ERR cluster error")


def _recv_lines(s, n):
    got = b""
    while got.count(b"\r\n") < n:
        chunk = s.recv(100)
        if not chunk:
            break
        got += chunk
    return got


def test_proxy_over_a_localhost_socket(tmp_path):
    t = Table(str(tmp_path / "t"), partition_count=4, device="cpu")
    proxy = RedisProxy(PegasusClient(t)).start()
    try:
        s = socket.create_connection(("127.0.0.1", proxy.port), timeout=5)
        s.sendall(b"*3\r\n$3\r\nSET\r\n$2\r\nrk\r\n$3\r\nval\r\n")
        assert _recv_lines(s, 1) == b"+OK\r\n"
        s.sendall(b"*2\r\n$3\r\nGET\r\n$2\r\nrk\r\n")
        assert _recv_lines(s, 2) == b"$3\r\nval\r\n"
        s.sendall(b"*2\r\n$4\r\nINCR\r\n$1\r\nc\r\n"
                  b"*2\r\n$4\r\nINCR\r\n$1\r\nc\r\n")
        assert _recv_lines(s, 2) == b":1\r\n:2\r\n"
        s.sendall(b"*1\r\n$-1\r\n")
        assert _recv_lines(s, 1).startswith(b"-ERR protocol error")
        s.close()
    finally:
        proxy.stop()
        t.close()
