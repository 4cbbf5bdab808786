"""TCP transport: the real inter-node network layer.

Parity: the reference's network provider (src/rpc/asio_net_provider.*,
rpc_engine.h:146) — every node listens on one port, outbound connections
are cached per peer, replies to non-listening peers (clients) ride the
inbound connection they arrived on, and messages are framed binary
(rpc/message.py, the rpc_message.h analogue). Same interface as the
deterministic SimNetwork (`register`/`send`), so MetaService /
ReplicaStub / ClusterClient run unchanged over either.

Threading model (replaces rDSN's task engine for this path):
- one accept thread; one reader thread per inbound connection;
- ONE dispatcher thread delivers every inbound message serially under
  `self.lock` — preserving the single-threaded access the replica state
  machine asserts (the reference pins a replica's work to one thread by
  gpid thread-hash, task_engine.h:53);
- timer callbacks (beacons, group checks, config-sync) must take the
  same lock; `run_timer` does.

Loss semantics match SimNetwork: a send to an unreachable peer is
dropped (the 2PC/FD/learning protocols already tolerate loss and the
client retries) — no backpressure, no delivery guarantee beyond TCP's
per-connection FIFO.
"""

from __future__ import annotations

import logging
import queue
import socket
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple

from pegasus_tpu_torch.rpc.message import (
    decode_message,
    encode_message,
    fill_registry,
    read_frames,
)
from pegasus_tpu_torch.utils import tracing
from pegasus_tpu_torch.utils.flags import FLAGS, define_flag

Addr = Tuple[str, int]

_LOG = logging.getLogger("pegasus.rpc")


class _RateLimitedLog:
    """Structured transport-failure logging with per-site rate limiting:
    a dead peer's reconnect loop must produce one countable line per
    interval, not a stdout traceback per queued frame."""

    def __init__(self, interval_s: float = 1.0) -> None:
        self._interval = interval_s
        self._last: Dict[str, float] = {}
        self._suppressed: Dict[str, int] = {}
        self._lock = threading.Lock()

    def log(self, site: str, exc: BaseException) -> None:
        with self._lock:
            now = time.monotonic()
            self._suppressed[site] = self._suppressed.get(site, 0) + 1
            if now - self._last.get(site, float("-inf")) < self._interval:
                return
            n = self._suppressed.pop(site, 1)
            self._last[site] = now
        _LOG.error("transport site=%s err=%s.%s msg=%r count=%d",
                   site, type(exc).__module__, type(exc).__name__,
                   str(exc), n,
                   exc_info=not isinstance(exc, OSError))


_RL_LOG = _RateLimitedLog()

import itertools as _itertools
_SESSION_IDS = _itertools.count(1)

define_flag("pegasus.rpc", "connect_timeout_ms", 2000,
            "outbound TCP dial timeout", mutable=True)
define_flag("pegasus.rpc", "reconnect_backoff_base_ms", 50,
            "first pause after a failed peer dial/write (doubles per "
            "consecutive failure)", mutable=True)
define_flag("pegasus.rpc", "reconnect_backoff_max_ms", 2000,
            "cap on the reconnect pause", mutable=True)
define_flag("pegasus.rpc", "read_shed_queue_depth", 2000,
            "inbox depth beyond which NEW client reads are shed with "
            "ERR_BUSY (writes/replication exempt)", mutable=True)
define_flag("pegasus.rpc", "read_shed_queue_age_ms", 5000,
            "queueing age beyond which a client read is shed with "
            "ERR_BUSY", mutable=True)

# client request types the dispatcher may fast-fail without consulting
# the handler: reply envelope (type, result field, empty value). Writes
# get deadline fast-fail only — shedding exempts them (and every
# replication/meta message) so a read storm cannot reject mutations.
_CLIENT_REQS: Dict[str, Tuple[str, str, Any]] = {
    "client_read": ("client_read_reply", "result", None),
    "client_read_batch": ("client_read_reply", "result", None),
    "client_scan_multi": ("client_read_reply", "result", None),
    "client_write": ("client_write_reply", "results", []),
    "client_write_batch": ("client_write_reply", "result", None),
}

# mutation-path requests: exempt from overload shedding (availability
# of writes degrades last) and from chaos duplication (no rid dedup —
# a duplicated atomic write would double-apply)
WRITE_REQS = ("client_write", "client_write_batch")


class TcpTransport:
    def __init__(self, listen: Optional[Addr],
                 address_book: Dict[str, Addr]) -> None:
        """`listen`: (host, port) to serve on, or None for a client-only
        transport. `address_book`: name -> (host, port) for every peer
        this node may dial (the static onebox topology; a dns_resolver
        analogue can replace it later). Peers NOT in the book (clients)
        are reachable once they have dialed us — replies use the learned
        inbound route."""
        # before any reader thread starts: decoding never imports
        fill_registry()
        self.address_book = dict(address_book)
        self.lock = threading.RLock()  # node-wide handler serialization
        self._handlers: Dict[str, Callable[[str, str, Any], None]] = {}
        # (dst, msg_type) -> handler([(src, payload)]): flush-window
        # coalescing — the dispatcher drains CONSECUTIVE queued messages
        # of the same type into one delivery (see _dispatch_loop). The
        # replica stub registers its point-read batch here so a burst of
        # independent client gets serves as one coordinator flush.
        self._batch_handlers: Dict[tuple, Callable] = {}
        self._current_session: str = ""
        self._session_closed_cbs: list = []
        # name -> (socket, write-lock); outbound dials and learned inbound
        # routes share this table (latest wins — a reconnecting peer's new
        # connection replaces the dead one)
        self._routes: Dict[str, Tuple[socket.socket, threading.Lock]] = {}
        self._routes_lock = threading.Lock()
        self._inbox: "queue.Queue[Optional[tuple]]" = queue.Queue()
        # outbound frames are written by PER-PEER sender threads: the
        # senders (dispatcher, timers) hold the node lock, and a blocking
        # dial/write there would stall every handler and timer; per-peer
        # queues additionally stop one blackholed peer from head-of-line
        # blocking beacons/prepares to healthy peers
        self._peer_outboxes: Dict[str, "queue.Queue[Optional[bytes]]"] = {}
        self._outboxes_lock = threading.Lock()
        self._closing = False
        # weighted-fair admission (dispatch thread ONLY — no locking):
        # shed-eligible client requests are re-queued per tenant and
        # drained by deficit-weighted round-robin, so one hot tenant's
        # backlog cannot head-of-line block everyone else's reads.
        # Writes/replication/meta take the strict-priority system queue
        # (the mutation path degrades last, exactly the old shed
        # exemption — and system traffic was never fair-queue fodder).
        self._tenant_queues: Dict[str, deque] = {}
        self._tenant_rr: list = []  # registration-ordered rotation
        self._rr_i = 0
        self._rr_fresh = True  # next rotation stop earns its quantum
        self._deficits: Dict[str, float] = {}
        self._system_queue: deque = deque()
        self._last_tenant: Optional[str] = None  # set by _sched_get
        self._last_queue: Optional[deque] = None
        self._tenancy = None  # lazily bound server/tenancy registry
        # chaos hook (rpc/fault.py): None = zero-overhead hot path; an
        # installed plan only acts while FAIL_POINTS is enabled
        self.fault_plan = None
        self._threads: list = []
        # transport failure observability (node rpc entity): failures
        # are countable instead of stdout traceback noise
        from pegasus_tpu_torch.utils.metrics import METRICS

        _rpc_ent = METRICS.entity("rpc", "dispatch", {})
        self._dispatch_errors = _rpc_ent.counter("dispatch_error_count")
        self._sender_errors = _rpc_ent.counter("sender_error_count")
        self._listener: Optional[socket.socket] = None
        self.listen_addr: Optional[Addr] = None
        if listen is not None:
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind(listen)
            srv.listen(64)
            self._listener = srv
            self.listen_addr = srv.getsockname()
            self._spawn(self._accept_loop)
        self._spawn(self._dispatch_loop)

    def _spawn(self, fn, *args) -> None:
        t = threading.Thread(target=fn, args=args, daemon=True)
        t.start()
        self._threads.append(t)

    # ---- public interface (SimNetwork-compatible) ----------------------

    def current_session(self) -> str:
        """The connection id of the message being dispatched (empty
        outside a dispatch). Security state keys on THIS, not on the
        frame's self-reported src."""
        return self._current_session

    def on_session_closed(self, cb) -> None:
        """Subscribe to connection teardown (sess id) — negotiated
        identities die with their connection."""
        self._session_closed_cbs.append(cb)

    def register(self, addr: str,
                 handler: Callable[[str, str, Any], None]) -> None:
        self._handlers[addr] = handler

    # messages drained into one batch delivery; bounds the latency a
    # deep queue can add to the first message of the window
    BATCH_DRAIN_MAX = 64

    def register_batch(self, addr: str, msg_type: str,
                       handler: Callable[[list], None]) -> None:
        """Register a flush-window batch handler: when the dispatcher
        pops a (addr, msg_type) message, it drains every CONSECUTIVE
        queued message with the same address and type (up to
        BATCH_DRAIN_MAX) and delivers them as handler([(src, payload)])
        in one call under the node lock. Only consecutive runs coalesce,
        so cross-type ordering is preserved exactly; a lone message
        costs one extra non-blocking queue poll."""
        self._batch_handlers[(addr, msg_type)] = handler

    def install_fault_plan(self, plan) -> None:
        """Arm chaos injection (rpc/fault.py FaultPlan). Also enables the
        fail-point registry — the plan's global gate — so a single
        FAIL_POINTS.teardown() later disarms every transport at once."""
        from pegasus_tpu_torch.utils.fail_point import FAIL_POINTS

        self.fault_plan = plan
        if plan is not None:
            FAIL_POINTS.setup()

    def send(self, src: str, dst: str, msg_type: str, payload: Any) -> None:
        plan = self.fault_plan
        verdict = (0.0, 1)
        if plan is not None and plan.active:
            verdict = plan.outbound(src, dst, msg_type)
            if verdict is None:
                return  # injected loss (same contract as real loss)
        if isinstance(payload, dict) and "trace" not in payload:
            # distributed-tracing context rides the payload envelope:
            # a send issued under an active span is causally part of it
            # (replies inherit the serving span, whose ctx() carries the
            # tail-keep bit upstream). One thread-local read when
            # untraced; an explicit payload["trace"] wins.
            ctx = tracing.current_ctx()
            if ctx is not None:
                payload["trace"] = ctx
        if dst in self._handlers:
            # loopback: still through the inbox so delivery stays serial
            for _ in range(verdict[1]):
                self._inbox.put((time.perf_counter(), src, dst, msg_type,
                                 payload, "loopback"))
            return
        # encode HERE so an unencodable payload raises at the caller (a
        # programming error, not network loss); network IO happens on the
        # peer's sender thread so a dead peer never stalls handlers/timers
        frame = encode_message(src, dst, msg_type, payload)
        with self._outboxes_lock:
            if self._closing:
                return  # late send: spawning a sender now would leak it
            box = self._peer_outboxes.get(dst)
            if box is None:
                box = queue.Queue()
                self._peer_outboxes[dst] = box
                self._spawn(self._send_loop, dst, box)
        box.put((verdict[0], frame))
        if verdict[1] > 1:
            box.put((0.0, frame))  # injected duplicate

    def _send_loop(self, dst: str, box: "queue.Queue") -> None:
        from pegasus_tpu_torch.utils.backoff import Backoff

        def nap(d: float) -> None:
            # closing-aware sleep: a pause must not delay shutdown
            t_end = time.monotonic() + d
            while not self._closing and time.monotonic() < t_end:
                time.sleep(min(0.05, max(0.0, t_end - time.monotonic())))

        # capped exponential full-jitter pause between reconnect
        # attempts — a dead peer must not be re-dialed at full speed
        # once per queued frame (each dial burns connect_timeout and
        # hammers the peer's accept queue as it restarts), and every
        # sender backing off the same dead peer must NOT wake in
        # lockstep (per-process jitter entropy from Backoff's default)
        backoff = Backoff(
            base_ms=FLAGS.get("pegasus.rpc", "reconnect_backoff_base_ms"),
            max_ms=FLAGS.get("pegasus.rpc", "reconnect_backoff_max_ms"),
            sleep=nap)
        fail_streak = 0
        while True:
            item = box.get()
            if item is None:
                return
            delay, frame = item
            if delay > 0:
                time.sleep(delay)  # injected link latency (fault plan)
            if fail_streak:
                backoff.sleep(fail_streak)
            try:
                sock, wlock = self._route(dst)
                with wlock:
                    sock.sendall(frame)
                fail_streak = 0
            except OSError as e:
                self._drop_route(dst)  # loss; protocols retry
                fail_streak += 1
                self._sender_errors.increment()
                _RL_LOG.log(f"sender.{dst}", e)

    def close(self) -> None:
        with self._outboxes_lock:
            # flag set under the lock: send() cannot race a new sender
            # thread into existence after the sentinels go out
            self._closing = True
            for box in self._peer_outboxes.values():
                box.put(None)
        self._inbox.put(None)
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        with self._routes_lock:
            for sock, _ in self._routes.values():
                try:
                    sock.close()
                except OSError:
                    pass
            self._routes.clear()

    def offload(self, fn: Callable[[], None]) -> None:
        """Run slow IO (block-service uploads/downloads) off the
        dispatcher: handlers run under the node lock, and a long upload
        there would stall beacons, prepares, and client traffic —
        demoting the node's primaries mid-backup (the reference runs
        these on THREAD_POOL_REPLICATION_LONG)."""

        def run() -> None:
            try:
                fn()
            except Exception as e:  # noqa: BLE001 - background op must
                # not kill silently (countable, rate-limited)
                self._dispatch_errors.increment()
                _RL_LOG.log("offload", e)

        self._spawn(run)

    # ---- timers --------------------------------------------------------

    def run_timer(self, interval: float, fn: Callable[[], None]) -> None:
        """Periodic callback under the node lock (parity: timer tasks)."""

        def loop() -> None:
            while not self._closing:
                time.sleep(interval)
                if self._closing:
                    return
                try:
                    with self.lock:
                        fn()
                except Exception as e:  # noqa: BLE001 - timers survive
                    self._dispatch_errors.increment()
                    _RL_LOG.log("timer", e)

        self._spawn(loop)

    # ---- internals -----------------------------------------------------

    def _route(self, dst: str) -> Tuple[socket.socket, threading.Lock]:
        with self._routes_lock:
            entry = self._routes.get(dst)
            if entry is not None:
                return entry
        addr = self.address_book.get(dst)
        if addr is None:
            raise OSError(f"no route to peer {dst!r}")
        sock = socket.create_connection(
            addr,
            timeout=FLAGS.get("pegasus.rpc", "connect_timeout_ms") / 1000.0)
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # our own reader on the outbound connection too: RPC replies come
        # back on the connection the request went out on
        self._spawn(self._read_loop, sock)
        with self._routes_lock:
            existing = self._routes.get(dst)
            if existing is not None:
                try:
                    sock.close()
                except OSError:
                    pass
                return existing
            entry = (sock, threading.Lock())
            self._routes[dst] = entry
            return entry

    def _drop_route(self, dst: str) -> None:
        with self._routes_lock:
            entry = self._routes.pop(dst, None)
        if entry is not None:
            try:
                entry[0].close()
            except OSError:
                pass

    def _learn_route(self, src: str, conn: socket.socket) -> None:
        with self._routes_lock:
            existing = self._routes.get(src)
            if existing is None or existing[0] is not conn:
                self._routes[src] = (conn, threading.Lock())

    def _accept_loop(self) -> None:
        assert self._listener is not None
        while not self._closing:
            try:
                conn, _peer_addr = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._spawn(self._read_loop, conn)

    def _read_loop(self, conn: socket.socket) -> None:
        # connection-scoped session id: security state (negotiated
        # identities) must bind to the CONNECTION, never to the
        # forgeable self-reported `src` name in the frame
        sess = f"conn-{id(conn)}-{_SESSION_IDS.__next__()}"
        buf = bytearray()
        while not self._closing:
            try:
                chunk = conn.recv(1 << 16)
            except OSError:
                break
            if not chunk:
                break
            buf.extend(chunk)
            try:
                bodies = read_frames(buf)
            except ValueError as e:
                # corrupt stream: drop the connection — countable, not
                # silent (a flapping peer shows up in the counter)
                self._dispatch_errors.increment()
                _RL_LOG.log("reader", e)
                break
            for body in bodies:
                try:
                    src, dst, msg_type, payload = decode_message(body)
                except (ValueError, TypeError):
                    continue
                self._learn_route(src, conn)
                self._inbox.put((time.perf_counter(), src, dst, msg_type,
                                 payload, sess))
        try:
            conn.close()
        except OSError:
            pass
        for cb in list(self._session_closed_cbs):
            try:
                cb(sess)
            except Exception:  # noqa: BLE001 - observer must not kill IO
                pass

    # ---- weighted-fair admission (dispatch thread only) ----------------

    def _registry(self):
        """The process-global tenant registry, bound lazily: importing
        server/tenancy at module scope would drag the server package
        into every transport user (and risk an import cycle through
        server/__init__); at first dispatch everything is loaded."""
        if self._tenancy is None:
            from pegasus_tpu_torch.server.tenancy import TENANTS

            self._tenancy = TENANTS
        return self._tenancy

    def _classify(self, item: Optional[tuple]) -> None:
        """File one inbox item into the fair-queue structure.
        Shed-eligible client work (non-write _CLIENT_REQS) queues per
        tenant — the tag resolves through the bounded registry, so
        unknown/forged tags fold into the default queue instead of
        minting queues; everything else (writes, replication, meta,
        the shutdown sentinel) takes the strict-priority system queue."""
        if item is None:
            self._system_queue.append(item)
            return
        msg_type, payload = item[3], item[4]
        if (msg_type in _CLIENT_REQS and msg_type not in WRITE_REQS
                and isinstance(payload, dict)):
            tenant = self._registry().resolve(payload.get("tenant")).name
            q = self._tenant_queues.get(tenant)
            if q is None:
                q = self._tenant_queues[tenant] = deque()
                self._tenant_rr.append(tenant)
                self._deficits.setdefault(tenant, 0.0)
            q.append(item)
        else:
            self._system_queue.append(item)

    def _queued_depth(self) -> int:
        return len(self._system_queue) + sum(
            len(q) for q in self._tenant_queues.values())

    def _drr_pick(self) -> tuple:
        """Deficit-weighted round-robin over the non-empty tenant
        queues (caller guarantees at least one). Each rotation stop
        earns the tenant ONE quantum (its clamped weight in message
        units); it then serves until the deficit runs dry, so relative
        drain rates converge on the weight ratios while every tenant
        keeps making progress. An observed-empty queue forfeits its
        banked credit — idle tenants cannot hoard a burst allowance."""
        reg = self._registry()
        rr = self._tenant_rr
        while True:
            name = rr[self._rr_i % len(rr)]
            q = self._tenant_queues[name]
            if not q:
                self._deficits[name] = 0.0
                self._rr_i += 1
                self._rr_fresh = True
                continue
            if self._rr_fresh:
                self._deficits[name] += reg.weight(name)
                self._rr_fresh = False
            if self._deficits[name] >= 1.0:
                self._deficits[name] -= 1.0
                self._last_tenant = name
                self._last_queue = q
                return q.popleft()
            # quantum spent: the next stop (possibly this same queue,
            # next rotation) earns a fresh one. min_weight > 0 bounds
            # the rotations before SOME queue accrues a full unit.
            self._rr_i += 1
            self._rr_fresh = True

    def _sched_get(self) -> Optional[tuple]:
        """The dispatcher's next item: drain whatever the reader
        threads queued, then serve system work first and tenant work
        by DRR. Blocks on the raw inbox only when everything is empty
        (single consumer, so emptiness cannot race)."""
        while True:
            try:
                self._classify(self._inbox.get_nowait())
            except queue.Empty:
                break
        while True:
            if self._system_queue:
                self._last_tenant = None
                self._last_queue = self._system_queue
                return self._system_queue.popleft()
            if self._tenant_queues and any(
                    self._tenant_queues.values()):
                return self._drr_pick()
            self._classify(self._inbox.get())
            while True:
                try:
                    self._classify(self._inbox.get_nowait())
                except queue.Empty:
                    break

    def _dispatch_loop(self) -> None:
        from pegasus_tpu_torch.utils.errors import ErrorCode
        from pegasus_tpu_torch.utils.metrics import METRICS

        # profiler toollet (parity: runtime/profiler.cpp:90-198 —
        # per-task-code execute latency/counts from engine join points;
        # here the join point is handler dispatch, keyed by message type)
        from pegasus_tpu_torch.utils.profiler import PROFILER

        prof = METRICS.entity("rpc", "dispatch", {})
        expired_cnt = prof.counter("deadline_expired_count")
        shed_cnt = prof.counter("read_shed_count")
        lat: Dict[str, Any] = {}
        cnt: Dict[str, Any] = {}
        while True:
            item = self._sched_get()
            if item is None:
                return
            t_enq, src, dst, msg_type, payload, sess = item
            handler = self._handlers.get(dst)
            if handler is None:
                continue
            plan = self.fault_plan
            if plan is not None and plan.active and (
                    plan.is_partitioned(src) or plan.is_partitioned(dst)):
                continue  # inbound half of an injected partition
            env = _CLIENT_REQS.get(msg_type) if isinstance(payload, dict) \
                else None
            if env is not None:
                # (1) end-to-end deadline: work whose deadline lapsed in
                # the queue (or on the wire) is abandoned — the client
                # stopped waiting, so serving it only adds load exactly
                # when the node is least able to afford it
                dl = payload.get("deadline")
                if dl is not None and time.time() > dl:
                    expired_cnt.increment()
                    self.send(dst, src, env[0], {
                        "rid": payload.get("rid"),
                        "err": int(ErrorCode.ERR_TIMEOUT), env[1]: env[2]})
                    continue
                # (2) overload shedding, reads only: the single
                # dispatcher thread drains an unbounded inbox, so under
                # a read storm queue depth (and thus latency) grows
                # without bound; shed NEW reads with ERR_BUSY while the
                # queue is deep or this message aged in it. Writes and
                # replication traffic are exempt — availability of the
                # mutation path degrades last.
                if msg_type not in WRITE_REQS:
                    depth = self._inbox.qsize() + self._queued_depth()
                    age_ms = (time.perf_counter() - t_enq) * 1000.0
                    tname = self._last_tenant
                    if tname is not None:
                        # per-tenant queueing-delay series: the signal
                        # `shell tenants` (and the QoS isolation gate)
                        # read to prove a victim stayed fast
                        self._registry().note_queue_age(tname, age_ms)
                    if (depth > FLAGS.get("pegasus.rpc",
                                          "read_shed_queue_depth")
                            or age_ms > FLAGS.get(
                                "pegasus.rpc", "read_shed_queue_age_ms")):
                        shed_cnt.increment()
                        if tname is not None:
                            # DRR already drained the victims first, so
                            # whoever queued deep enough to shed IS the
                            # aggressor — bill the shed to its tenant
                            self._registry().note_shed(tname)
                        self.send(dst, src, env[0], {
                            "rid": payload.get("rid"),
                            "err": int(ErrorCode.ERR_BUSY),
                            env[1]: env[2]})
                        continue
            batch = None
            bh = self._batch_handlers.get((dst, msg_type))
            if bh is not None:
                # flush-window coalescing: drain the CONSECUTIVE run of
                # same-typed queued messages from the SAME connection
                # into one delivery (the read coordinator's dispatch
                # unit; session-scoped so negotiated identities keep
                # binding to the right connection). The run comes off
                # the SAME scheduler queue the head item came from —
                # for a tenant queue that means one tenant's burst
                # coalesces, and fairness holds because every extra
                # item bills the tenant's deficit (it may go negative;
                # the debt is repaid before the next quantum serves).
                srcq = self._last_queue
                tname = self._last_tenant
                batch = [(src, payload)]
                while srcq and len(batch) < self.BATCH_DRAIN_MAX:
                    nxt = srcq[0]
                    if (nxt is None or nxt[2] != dst
                            or nxt[3] != msg_type or nxt[5] != sess):
                        break
                    srcq.popleft()
                    if tname is not None:
                        self._deficits[tname] -= 1.0
                    batch.append((nxt[1], nxt[4]))
            # distributed-tracing join point: an inbound request
            # carrying a sampled context opens a dispatch span (replies
            # and acks only pin tail-keep). Batch deliveries (bh) open
            # per-item spans at the stub seam instead — one item per
            # trace, never one carrier per item.
            span = None
            if isinstance(payload, dict):
                t_ctx = payload.get("trace")
                if t_ctx is not None and batch is None:
                    name = msg_type
                    if msg_type == "replica":
                        name = f"replica.{payload.get('type')}"
                    if tracing.is_reply_type(name):
                        tracing.on_inbound_ctx(dst, t_ctx)
                    else:
                        span = tracing.start_server_span(dst, name, t_ctx)
                        if span is not None:
                            span.tags["queue_ms"] = round(
                                (time.perf_counter() - t_enq) * 1000.0, 3)
            t0 = time.perf_counter()
            try:
                # the dispatcher is the node's single handler thread, so
                # a plain attribute safely exposes the CONNECTION the
                # in-flight message arrived on (see current_session())
                self._current_session = sess
                with self.lock, tracing.activate(span):
                    if batch is not None:
                        bh(batch)
                    else:
                        handler(src, msg_type, payload)
            except Exception as e:  # noqa: BLE001 - a bad message must
                # not kill the dispatcher (countable, rate-limited)
                self._dispatch_errors.increment()
                _RL_LOG.log("dispatch", e)
            finally:
                if span is not None:
                    span.finish()
                t1 = time.perf_counter()
                p_lat = lat.get(msg_type)
                if p_lat is None:
                    p_lat = lat[msg_type] = prof.percentile(
                        f"{msg_type}_exec_ms")
                    cnt[msg_type] = prof.counter(f"{msg_type}_count")
                p_lat.set((t1 - t0) * 1000.0)
                cnt[msg_type].increment(1 if batch is None
                                        else len(batch))
                if PROFILER.enabled:
                    # toollet join point: queue delay + exec latency
                    # per task code (profiler.cpp:90-198)
                    PROFILER.observe(msg_type, (t0 - t_enq) * 1000.0,
                                     (t1 - t0) * 1000.0)
