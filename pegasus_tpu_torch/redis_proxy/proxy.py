"""Redis proxy: a RESP front end over the Pegasus client API.

Parity: src/redis_protocol/ — the proxy maps Redis commands onto the KV
API (redis_parser.cpp:60-74: SET/GET/DEL/SETEX/TTL/PTTL/INCR(BY)/
DECR(BY) + GEO*): a Redis key becomes (hash_key=key, sort_key="");
GEO* commands ride a GeoClient over a dedicated index table.

Thread-per-connection TCP server (the proxy is stateless; each command
is one client call). Works over any object exposing the PegasusClient
API — the in-process Table client or the wire ClusterClient.
"""

from __future__ import annotations

import socket
import threading
from typing import List, Optional

from pegasus_tpu_torch.redis_proxy import resp
from pegasus_tpu_torch.utils.errors import PegasusError, StorageStatus

OK = int(StorageStatus.OK)
NOT_FOUND = int(StorageStatus.NOT_FOUND)
_EMPTY_SK = b""


class RedisHandler:
    """Command dispatch, transport-independent (testable without
    sockets)."""

    def __init__(self, client, geo=None) -> None:
        self.client = client
        self.geo = geo  # optional GeoClient for GEO* verbs

    def handle(self, argv: List[bytes]) -> bytes:
        if not argv:
            return resp.error("empty command")
        cmd = argv[0].upper().decode(errors="replace")
        fn = getattr(self, "cmd_" + cmd, None)
        if fn is None:
            return resp.error(f"unknown command '{cmd}'")
        try:
            return fn(argv[1:])
        except (ValueError, IndexError) as e:
            return resp.error(str(e) or "wrong number of arguments")
        except PegasusError as e:
            # cluster-side failures (failover retries exhausted, timeouts)
            # become -ERR replies, never dropped connections
            return resp.error(f"cluster error: {e}")

    # ---- connection & introspection ------------------------------------

    def cmd_PING(self, args):
        return resp.bulk(args[0]) if args else resp.simple("PONG")

    def cmd_COMMAND(self, _args):
        return resp.array([])  # redis-cli handshake compatibility

    def cmd_ECHO(self, args):
        return resp.bulk(args[0])

    # ---- strings -------------------------------------------------------

    def cmd_SET(self, args):
        if len(args) < 2:
            raise ValueError("wrong number of arguments for 'set'")
        key, value = args[0], args[1]
        ttl = 0
        i = 2
        while i < len(args):
            opt = args[i].upper()
            if opt == b"EX":
                ttl = int(args[i + 1])
                i += 2
            elif opt == b"PX":
                ttl = max(1, int(args[i + 1]) // 1000)
                i += 2
            else:
                raise ValueError(f"unsupported SET option {opt!r}")
        err = self.client.set(key, _EMPTY_SK, value, ttl_seconds=ttl)
        return resp.simple("OK") if err == OK else resp.error(
            f"storage error {err}")

    def cmd_SETEX(self, args):
        key, seconds, value = args[0], int(args[1]), args[2]
        err = self.client.set(key, _EMPTY_SK, value, ttl_seconds=seconds)
        return resp.simple("OK") if err == OK else resp.error(
            f"storage error {err}")

    def cmd_GET(self, args):
        err, value = self.client.get(args[0], _EMPTY_SK)
        if err == NOT_FOUND:
            return resp.bulk(None)
        if err != OK:
            return resp.error(f"storage error {err}")
        return resp.bulk(value)

    def cmd_DEL(self, args):
        n = 0
        for key in args:
            if self.client.exist(key, _EMPTY_SK):
                if self.client.delete(key, _EMPTY_SK) == OK:
                    n += 1
        return resp.integer(n)

    def cmd_EXISTS(self, args):
        return resp.integer(sum(
            1 for key in args if self.client.exist(key, _EMPTY_SK)))

    def cmd_TTL(self, args):
        err, ttl = self.client.ttl(args[0], _EMPTY_SK)
        if err == NOT_FOUND:
            return resp.integer(-2)
        if err != OK:
            return resp.error(f"storage error {err}")
        return resp.integer(-1 if ttl < 0 else ttl)

    def cmd_PTTL(self, args):
        err, ttl = self.client.ttl(args[0], _EMPTY_SK)
        if err == NOT_FOUND:
            return resp.integer(-2)
        if err != OK:
            return resp.error(f"storage error {err}")
        return resp.integer(-1 if ttl < 0 else ttl * 1000)

    # ---- counters ------------------------------------------------------

    def _incr(self, key: bytes, delta: int) -> bytes:
        r = self.client.incr(key, _EMPTY_SK, delta)
        if r.error != OK:
            return resp.error("value is not an integer or out of range")
        return resp.integer(r.new_value)

    def cmd_INCR(self, args):
        return self._incr(args[0], 1)

    def cmd_INCRBY(self, args):
        return self._incr(args[0], int(args[1]))

    def cmd_DECR(self, args):
        return self._incr(args[0], -1)

    def cmd_DECRBY(self, args):
        return self._incr(args[0], -int(args[1]))

    # ---- GEO (parity: the proxy's GEO* verbs over geo_client) ----------

    def _need_geo(self):
        if self.geo is None:
            raise ValueError("GEO commands need a geo-enabled proxy")
        return self.geo

    @staticmethod
    def _geo_unit_scale(unit: bytes) -> float:
        scale = {b"m": 1.0, b"km": 1000.0}.get(unit.lower())
        if scale is None:
            raise ValueError("unsupported unit")
        return scale

    @staticmethod
    def _geo_count(args, start: int) -> int:
        rest = [a.upper() for a in args[start:]]
        if b"COUNT" in rest:
            return int(args[start + rest.index(b"COUNT") + 1])
        return -1

    def cmd_GEOADD(self, args):
        geo = self._need_geo()
        key = args[0]
        added = 0
        for i in range(1, len(args), 3):
            lng, lat, member = (float(args[i]), float(args[i + 1]),
                                args[i + 2])
            value = b"%f|%f|" % (lat, lng)
            if geo.set(key, member, value) == OK:
                added += 1
        return resp.integer(added)

    def cmd_GEODIST(self, args):
        geo = self._need_geo()
        key, m1, m2 = args[0], args[1], args[2]
        d = geo.distance(key, m1, key, m2)
        if d is None:
            return resp.bulk(None)
        scale = self._geo_unit_scale(args[3] if len(args) > 3 else b"m")
        return resp.bulk(b"%.4f" % (d / scale))

    def cmd_GEORADIUS(self, args):
        """GEORADIUS key lng lat radius m|km [COUNT n] — member names
        within the radius (the reference proxy's search_radial front)."""
        geo = self._need_geo()
        _key = args[0]
        lng, lat, radius = float(args[1]), float(args[2]), float(args[3])
        scale = self._geo_unit_scale(args[4])
        count = self._geo_count(args, 5)
        hits = geo.search_radial(lat, lng, radius * scale, count=count)
        return resp.array([h.sort_key for h in hits])

    def cmd_GEOPOS(self, args):
        """GEOPOS key member [member ...] — (lng, lat) per member, a
        NIL ARRAY (*-1, the Redis wire shape) for absent ones
        (redis_parser g_geo_pos parity). Storage faults other than
        NOT_FOUND surface as -ERR, never as a silent nil."""
        geo = self._need_geo()
        key = args[0]
        parts = [b"*%d\r\n" % (len(args) - 1)]
        for member in args[1:]:
            err, value = geo.get(key, member)
            if err == NOT_FOUND:
                parts.append(b"*-1\r\n")
                continue
            if err != OK:
                raise ValueError(f"storage error {err}")
            coords = geo.codec.decode(value)
            if coords is None:
                parts.append(b"*-1\r\n")
                continue
            lat, lng = coords
            parts.append(resp.array([b"%.17g" % lng, b"%.17g" % lat]))
        return b"".join(parts)

    def cmd_GEORADIUSBYMEMBER(self, args):
        """GEORADIUSBYMEMBER key member radius m|km [COUNT n] — like
        GEORADIUS but centered on an EXISTING member
        (g_geo_radius_by_member parity). A missing / undecodable center
        is an ERROR, as in Redis ("could not decode requested zset
        member") — an empty array must mean 'nobody in radius', never
        'the center lookup failed'."""
        geo = self._need_geo()
        key, member = args[0], args[1]
        radius = float(args[2])
        scale = self._geo_unit_scale(args[3])
        count = self._geo_count(args, 4)
        err, value = geo.get(key, member)
        if err != OK or geo.codec.decode(value) is None:
            raise ValueError("could not decode requested member")
        lat, lng = geo.codec.decode(value)
        hits = geo.search_radial(lat, lng, radius * scale, count=count)
        return resp.array([h.sort_key for h in hits])


class RedisProxy:
    """TCP front (parity: proxy/main.cpp) — bind port 0 for ephemeral."""

    def __init__(self, client, host: str = "127.0.0.1", port: int = 0,
                 geo=None) -> None:
        self.handler = RedisHandler(client, geo=geo)
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(32)
        self.port = self._srv.getsockname()[1]
        self._closing = False
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "RedisProxy":
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._thread.start()
        return self

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        parser = resp.RespParser()
        try:
            while True:
                data = conn.recv(1 << 16)
                if not data:
                    return
                try:
                    commands = parser.feed(data)
                except ValueError as e:
                    conn.sendall(resp.error(f"protocol error: {e}"))
                    return
                for argv in commands:
                    conn.sendall(self.handler.handle(argv))
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def stop(self) -> None:
        self._closing = True
        try:
            self._srv.close()
        except OSError:
            pass


def main() -> None:
    """python -m pegasus_tpu_torch.redis_proxy.proxy --cluster DIR --table T
    [--port P] [--geo-index TABLE [--device cpu]]"""
    import argparse
    import time

    from pegasus_tpu_torch.tools import onebox_cluster as ob

    ap = argparse.ArgumentParser()
    ap.add_argument("--cluster", required=True)
    ap.add_argument("--table", required=True)
    ap.add_argument("--port", type=int, default=6379)
    ap.add_argument("--geo-index", default=None,
                    help="geo index table name enabling GEO* verbs")
    ap.add_argument("--device", default=None,
                    help="where the GEO verbs' distance filter runs: the "
                         "card (default) or cpu")
    args = ap.parse_args()
    client = ob.connect(args.table, args.cluster)
    geo = None
    if args.geo_index:
        from pegasus_tpu_torch.geo import GeoClient

        geo = GeoClient(client, ob.connect(args.geo_index, args.cluster),
                        device=args.device)
    proxy = RedisProxy(client, port=args.port, geo=geo).start()
    print(f"redis proxy serving {args.table} on port {proxy.port}",
          flush=True)
    while True:
        time.sleep(1)


if __name__ == "__main__":
    main()
