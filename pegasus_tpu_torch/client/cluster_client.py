"""ClusterClient: the client stack over a replicated cluster.

Parity: the reference client's resolution pipeline —
pegasus_client_impl (pegasus_client_impl.cpp:124 key hash) →
partition_resolver_simple (partition_resolver_simple.h:56: hash → cached
partition_configuration → primary address, re-query meta on error) →
gpid-addressed RPC served through the replica gates
(replica_stub.cpp:1100, replica.cpp:386).

Unlike `PegasusClient` (in-process Table), every op here crosses the
network abstraction: writes go through the primary's full 2PC, reads
through the primary's replica gate. The config cache refreshes on
ERR_INVALID_STATE-class errors and on reply timeouts.

The transport is pluggable: a `pump()` callable drives message delivery
while the client waits for a reply (the deterministic SimNetwork needs
its loop driven). A socket transport delivers on threads of its own, so
its client is built with `reply_wait_s` instead: a wait blocks on an
event that the reply's arrival sets, at most `reply_wait_s` at a time.
"""

from __future__ import annotations

import itertools
import re
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from pegasus_tpu_torch.base.key_schema import generate_key, key_hash_parts, restore_key
from pegasus_tpu_torch.client.client import ScanOptions
from pegasus_tpu_torch.ops.predicates import host_match_filter
from pegasus_tpu_torch.rpc.codec import (
    OP_CAM,
    OP_CAS,
    OP_INCR,
    OP_MULTI_PUT,
    OP_MULTI_REMOVE,
    OP_PUT,
    OP_REMOVE,
)
from pegasus_tpu_torch.server.types import (
    BatchGetRequest,
    CheckAndMutateRequest,
    CheckAndMutateResponse,
    CheckAndSetRequest,
    CheckAndSetResponse,
    FullKey,
    GetScannerRequest,
    IncrRequest,
    KeyValue,
    MultiGetRequest,
    MultiPutRequest,
    MultiRemoveRequest,
    Mutate,
    SCAN_CONTEXT_ID_COMPLETED,
    SCAN_CONTEXT_ID_NOT_EXIST,
)
from pegasus_tpu_torch.utils import tracing
from pegasus_tpu_torch.utils.errors import ErrorCode, PegasusError, StorageStatus
from pegasus_tpu_torch.utils.flags import FLAGS, define_flag

_RETRYABLE = {
    int(ErrorCode.ERR_INVALID_STATE),
    int(ErrorCode.ERR_INACTIVE_STATE),
    int(ErrorCode.ERR_PARENT_PARTITION_MISUSED),
    int(ErrorCode.ERR_OBJECT_NOT_FOUND),
    int(ErrorCode.ERR_TIMEOUT),
    int(ErrorCode.ERR_SPLITTING),
    # overload shedding (transport dispatcher): BUSY means "come back
    # after a backoff", exactly what the retry loop now does
    int(ErrorCode.ERR_BUSY),
    # storage-integrity failures: the replica quarantined itself and
    # the guardian is repairing via re-learn — the retry's config
    # refresh lands the op on the healed (or newly promoted) primary
    int(ErrorCode.ERR_CHECKSUM_FAILED),
    int(ErrorCode.ERR_DISK_IO_ERROR),
    # duplication failover drill: fenced-for-drain is transient — the
    # backoff (plus its config refresh) carries the op across the flip
    int(ErrorCode.ERR_DUP_FENCED),
    # follower-read bounce: the secondary's lease lapsed or its
    # watermark missed the op's staleness bound. The routing table is
    # still RIGHT — the retry skips the config refresh and re-sends
    # only the bounced ops to the primary (misrouted-subset discipline)
    int(ErrorCode.ERR_STALE_REPLICA),
    # multi-tenant QoS: this client's tenant is over its CU budget —
    # the jittered backoff rides out the bucket refill; like BUSY, no
    # config refresh (the routing table is right, the tenant is hot)
    int(ErrorCode.ERR_CU_OVERBUDGET),
}

_OK = int(ErrorCode.ERR_OK)
_MISROUTED = int(ErrorCode.ERR_PARENT_PARTITION_MISUSED)
_STALE = int(ErrorCode.ERR_STALE_REPLICA)
_OVERBUDGET = int(ErrorCode.ERR_CU_OVERBUDGET)

# codes whose retry must NOT burn a config refresh: the routing table
# is known-correct, the condition is server-side pressure. Re-resolving
# would only convert a read/write storm into a meta query storm.
_NO_REFRESH = {int(ErrorCode.ERR_BUSY), _STALE, _OVERBUDGET}

# the public retryability surface: client/aio.py re-exports these so
# the sync and async clients can never drift on which codes retry (the
# tier-1 retryability matrix test asserts the identity)
RETRYABLE_CODES = frozenset(_RETRYABLE)
NO_REFRESH_CODES = frozenset(_NO_REFRESH)

# tenant-tag sanitation mirrors server/tenancy.TENANT_RE — the tiny
# regex is duplicated here rather than imported so the client package
# never drags the server package (and its storage stack) in. Anything
# that fails the slug check folds to the shared "default" tenant, the
# same fold the server registry applies to unknown wire tags
_TENANT_RE = re.compile(r"^[a-z0-9][a-z0-9_\-]{0,31}$")
DEFAULT_TENANT = "default"


def sanitize_tenant(raw) -> str:
    """Fold an arbitrary tenant tag to a bounded-cardinality slug."""
    if isinstance(raw, str):
        name = raw.strip().lower()
        if _TENANT_RE.match(name):
            return name
    return DEFAULT_TENANT


def bounded_stale(max_lag_ms: float) -> dict:
    """Consistency level: serve at ANY replica whose committed state is
    at most `max_lag_ms` behind the primary's advertised commit point
    (measured on the replica's sync stamps, so the practical floor is
    the group-check cadence). Pass to any read's `consistency=`."""
    return {"level": "bounded_stale", "max_lag_ms": float(max_lag_ms)}


# Consistency level: reads never observe an older prefix than any read
# this client already observed for that partition (per-partition
# high-water committed-decree session tokens carried on every reply).
MONOTONIC = {"level": "monotonic"}

# Default consistency: primary-only reads, unchanged semantics.
LINEARIZABLE = None

define_flag("pegasus.client", "client_op_timeout_ms", 3_600_000,
            "end-to-end deadline for one client op, spanning every "
            "retry; requests carry the absolute deadline so servers "
            "can drop work its client stopped waiting for",
            mutable=True)


class ClusterClient:
    """Full data-plane client resolved through meta.

    `pump` is called repeatedly while waiting for a reply; each call
    should advance message delivery (and, in simulation, virtual time so
    failure detection can progress during retries).
    """

    def __init__(self, net, name: str, meta_addr, app_name: str,
                 pump: Optional[Callable[[], None]],
                 max_retries: int = 6, pump_rounds: int = 50,
                 auth=None, op_timeout_ms: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None,
                 sleep: Optional[Callable[[float], None]] = None,
                 backoff_seed: Optional[int] = None,
                 tenant: Optional[str] = None,
                 reply_wait_s: Optional[float] = None) -> None:
        """`reply_wait_s` (with `pump` None): the client of a transport
        that delivers on its own threads (TcpTransport). A wait for a
        reply then blocks on an event that `_on_message` sets when it
        stores a reply, at most `reply_wait_s` a round, and gives up
        after `pump_rounds` rounds' worth of time: the budget a pump of
        `time.sleep(reply_wait_s)` gives, without sleeping out the
        round in which the reply lands.

        `auth`: (user, token) credentials from
        security.make_credentials — required when the cluster enforces
        authentication.

        `op_timeout_ms` overrides the client_op_timeout_ms flag: every
        op gets ONE absolute deadline covering all its retries, stamped
        into each request so servers can fast-fail abandoned work.
        `clock` must be the same timebase the serving stubs read (wall
        time.time for the TCP path — the default; the sim cluster
        passes its epoch-anchored virtual clock). `sleep` is the retry
        backoff's wait (sim passes a virtual-time advance).

        `tenant`: the QoS identity every request from this handle is
        billed to (weighted-fair admission + per-tenant CU budgets,
        server/tenancy.py). When omitted, the table's
        `qos.default_tenant` env (adopted at config refresh) names the
        tenant; failing that, the shared "default" tenant."""
        from pegasus_tpu_torch.utils.backoff import Backoff

        self.net = net
        self.name = name
        self.op_timeout_ms = op_timeout_ms
        self._clock = clock or time.time
        self.backoff = Backoff(seed=backoff_seed,
                               sleep=sleep or time.sleep)
        # one address or the whole meta group (rotated on timeout —
        # parity: the client's meta group_address failover)
        self.meta_addrs = ([meta_addr] if isinstance(meta_addr, str)
                           else list(meta_addr))
        self._meta_i = 0
        self.app_name = app_name
        if (pump is None) == (reply_wait_s is None):
            raise ValueError("give a pump or reply_wait_s, not both")
        self._pump = pump
        self._reply_wait_s = reply_wait_s
        self._reply_landed = threading.Event()
        self._max_retries = max_retries
        self._pump_rounds = pump_rounds
        self._rids = itertools.count(1)
        self._replies: Dict[int, dict] = {}
        self._pending: set = set()
        self.app_id: Optional[int] = None
        self.partition_count = 0
        self._configs: List[dict] = []
        self.auth = tuple(auth) if auth else None
        # QoS identity: explicit ctor tag wins and sticks; otherwise
        # the table's qos.default_tenant env (seen at refresh_config)
        # may rebind the handle's tenant
        self._tenant_explicit = tenant is not None
        self.tenant = sanitize_tenant(tenant) if tenant is not None \
            else DEFAULT_TENANT
        # per-op consistency default for THIS client handle: None =
        # linearizable (primary-only). Set to MONOTONIC or
        # bounded_stale(ms) to opt every read in; any read's
        # `consistency=` kwarg overrides per op
        self.consistency: Optional[dict] = None
        # monotonic session tokens: pidx -> highest committed decree any
        # read reply has shown this client for that partition. Carried
        # as min_decree on monotonic reads so no replica may answer
        # below what this session already observed
        self._session_tokens: Dict[int, int] = {}
        # deterministic round-robin over a partition's secondaries
        self._replica_rr = 0
        # distributed tracing: the op-level root span (one per client
        # API call; nested helpers — batch_get's per-group _read legs —
        # ride the outer op's trace instead of minting their own)
        self._cur_span = None
        net.register(name, self._on_message)

    # ---- transport plumbing -------------------------------------------

    def _on_message(self, src: str, msg_type: str, payload) -> None:
        if isinstance(payload, dict):
            # tail-keep propagation: a reply stamped KEEP by a hop that
            # crossed the slow threshold pins this trace here too —
            # slow traces stay whole at every upstream hop
            tracing.on_inbound_ctx(self.name, payload.get("trace"))
        if msg_type in ("client_read_reply", "client_write_reply",
                        "query_config_reply", "negotiate_reply"):
            rid = payload.get("rid")
            # only requests still being awaited are stored: a reply that
            # straggles in after its _await gave up (e.g. delivered once a
            # partition heals) would otherwise accumulate forever
            if rid in self._pending:
                self._replies[rid] = payload
                self._reply_landed.set()

    def _traced(self, name: str, fn, *args):
        """Run one client op under a sampled root span (or plain when
        sampling says no / an outer op's span already governs)."""
        if self._cur_span is not None or not tracing.maybe_sample():
            return fn(*args)
        span = tracing.ring_for(self.name).start(name)
        self._cur_span = span
        try:
            return fn(*args)
        finally:
            self._cur_span = None
            span.finish()

    def _send_request(self, dst: str, msg_type: str, payload: dict,
                      deadline: Optional[float] = None) -> int:
        rid = next(self._rids)
        payload["rid"] = rid
        # every request carries its tenant tag: the transport's
        # weighted-fair admission and the server's CU budgets classify
        # by this field (untagged traffic folds to "default" serverside)
        payload["tenant"] = self.tenant
        if deadline is not None:
            # absolute, on the cluster's shared timebase: the transport
            # dispatcher and replica gates fast-fail work past it
            payload["deadline"] = deadline
        if self._cur_span is not None:
            # the op's trace context rides every request it issues
            # (explicit — the client never leaves a span ambient, so
            # unrelated timer traffic pumped while we wait stays clean)
            payload["trace"] = self._cur_span.ctx()
        self._pending.add(rid)
        self.net.send(self.name, dst, msg_type, payload)
        return rid

    def _deadline(self) -> float:
        ms = self.op_timeout_ms if self.op_timeout_ms is not None else \
            FLAGS.get("pegasus.client", "client_op_timeout_ms")
        return self._clock() + float(ms) / 1000.0

    def _await(self, rid: int,
               deadline: Optional[float] = None) -> Optional[dict]:
        if self._pump is None:
            return self._await_landed(rid, deadline)
        try:
            for _ in range(self._pump_rounds):
                if rid in self._replies:
                    return self._replies.pop(rid)
                if deadline is not None and self._clock() > deadline:
                    break  # the op's deadline lapsed; stop pumping
                self._pump()
            return self._replies.pop(rid, None)
        finally:
            self._pending.discard(rid)

    def _await_landed(self, rid: int,
                      deadline: Optional[float]) -> Optional[dict]:
        """`_await` on a transport that delivers by itself: wake when a
        reply is stored (this one or another pending request's), give up
        after pump_rounds x reply_wait_s of wall time. A set that lands
        between a wake and the clear is not lost: the loop looks at the
        stored replies before every wait."""
        wait_s = self._reply_wait_s
        end = time.monotonic() + self._pump_rounds * wait_s
        try:
            while rid not in self._replies:
                left = end - time.monotonic()
                if left <= 0 or (deadline is not None
                                 and self._clock() > deadline):
                    break
                self._reply_landed.wait(min(wait_s, left))
                self._reply_landed.clear()
            return self._replies.pop(rid, None)
        finally:
            self._pending.discard(rid)

    def negotiate(self, node: str, user: str, secret: str) -> bool:
        """Run the SASL-style connection handshake with `node`
        (security/negotiation.py; parity negotiation.h:37). On success
        the server binds `user` to this client's address and requests
        to that node may omit per-request credentials."""
        from pegasus_tpu_torch.security.negotiation import NegotiationClient

        nc = NegotiationClient(user, secret)

        def call(payload):
            rid = self._send_request(node, "negotiate", dict(payload))
            return self._await(rid) or {}

        return nc.negotiate(call)

    # ---- config cache (parity: partition_resolver_simple) -------------

    @property
    def meta_addr(self) -> str:
        return self.meta_addrs[self._meta_i % len(self.meta_addrs)]

    def refresh_config(self, deadline: Optional[float] = None) -> None:
        """`deadline`: the CALLING op's remaining end-to-end deadline —
        a refresh inside a retry loop must not mint itself a fresh full
        window (the op would overrun its declared bound by up to 2x)."""
        last = None
        if deadline is None:
            deadline = self._deadline()
        for rotation in range(len(self.meta_addrs)):
            if rotation:
                if self._clock() > deadline:
                    break  # out of time: surface the last rotation error
                # pace the meta-group rotation: hammering the next
                # member the instant the last timed out is how a
                # failover turns into a refresh_config storm
                self.backoff.sleep(rotation)
            rid = self._send_request(self.meta_addr, "query_config", {
                "app_name": self.app_name}, deadline=deadline)
            reply = self._await(rid, deadline)
            if reply is None:
                # this meta is down/partitioned: rotate to the next group
                # member (a follower forwards to the leader)
                self._meta_i += 1
                last = PegasusError(ErrorCode.ERR_TIMEOUT,
                                    f"meta {self.meta_addr} unreachable")
                continue
            if reply["err"] != _OK:
                raise PegasusError(ErrorCode(reply["err"]), self.app_name)
            self.app_id = reply["app_id"]
            self.partition_count = reply["partition_count"]
            self._configs = reply["configs"]
            if not self._tenant_explicit:
                # adopt the table's default tenant env; an explicit
                # ctor tag always wins over the table-wide default
                env = (reply.get("envs") or {}).get("qos.default_tenant")
                if env:
                    self.tenant = sanitize_tenant(env)
            return
        raise last

    def _ensure_config(self) -> None:
        if self.app_id is None:
            self.refresh_config()

    def _primary_of(self, pidx: int) -> str:
        return self._configs[pidx]["primary"]

    def _norm_consistency(self, consistency) -> Optional[dict]:
        """Resolve one read's effective consistency level: the per-op
        kwarg wins, else the client-handle default. Returns None for
        linearizable (primary-only), else the level dict the replica
        gate consumes."""
        c = consistency if consistency is not None else self.consistency
        if c is None or c == "linearizable":
            return None
        if c == "monotonic":
            return MONOTONIC
        if isinstance(c, dict) and c.get("level") in (
                "bounded_stale", "monotonic"):
            return c
        raise ValueError(f"unknown consistency level: {c!r}")

    def _route_read(self, pidx: int, cons: Optional[dict],
                    force_primary: bool = False) -> str:
        """Pick the serving node for one read leg: the primary for
        linearizable ops and for post-bounce retries, otherwise
        round-robin across ALL of the partition's replicas — primary
        included — (meta's routing table already ships the
        secondaries), so a replica group's aggregate read capacity
        scales with replica count instead of pinning every read to one
        node; primary fallback when no secondary exists."""
        cfg = self._configs[pidx]
        if cons is None or force_primary:
            return cfg["primary"]
        members = [n for n in (cfg["primary"],
                               *cfg.get("secondaries", ())) if n]
        if not members:
            return cfg["primary"]
        self._replica_rr += 1
        return members[self._replica_rr % len(members)]

    def _wire_consistency(self, cons: dict, pidx: int) -> dict:
        """Stamp the monotonic session token onto the wire level: the
        replica must not answer below the committed decree this client
        already observed for the partition."""
        if cons.get("level") == "monotonic":
            tok = self._session_tokens.get(pidx, 0)
            if tok:
                return dict(cons, min_decree=tok)
        return cons

    def _note_decree(self, pidx: int, decree) -> None:
        """Fold a reply's committed-decree stamp into the session
        token (monotonic high-water mark, never regresses)."""
        if decree is not None and \
                decree > self._session_tokens.get(pidx, 0):
            self._session_tokens[pidx] = decree

    # ---- request dispatch with refresh-on-error retry ------------------

    def _read(self, op: str, args: Any, pidx: int,
              partition_hash: Optional[int] = None,
              deadline: Optional[float] = None,
              consistency=None,
              prefer_node: Optional[str] = None) -> Any:
        return self._traced(f"client.{op}", self._read_impl, op, args,
                            pidx, partition_hash, deadline, consistency,
                            prefer_node)

    def _read_impl(self, op: str, args: Any, pidx: int,
                   partition_hash: Optional[int] = None,
                   deadline: Optional[float] = None,
                   consistency=None,
                   prefer_node: Optional[str] = None) -> Any:
        """`deadline`: inherited when this read is one leg of a larger
        op (batch_get) — the outer op's single end-to-end bound governs,
        never a freshly minted per-leg window. `prefer_node`: first-
        attempt routing override (scanner paging stickiness — a scan
        context lives on the node that opened it); retries fall back to
        normal routing."""
        self._ensure_config()
        cons = self._norm_consistency(consistency)
        force_primary = False
        last_err = int(ErrorCode.ERR_TIMEOUT)
        if deadline is None:
            deadline = self._deadline()
        for attempt in range(self._max_retries):
            if attempt:
                if self._clock() > deadline:
                    raise PegasusError(ErrorCode.ERR_TIMEOUT,
                                       f"{op} deadline exceeded")
                # backoff BEFORE the refresh: mid-failover zero-sleep
                # retries burn every attempt in microseconds and storm
                # the meta with refresh_config
                self.backoff.sleep(attempt)
                if last_err in _NO_REFRESH:
                    # shed by an overloaded replica, bounced by a stale
                    # secondary, or over CU budget — not misrouted: the
                    # config is still right, so no refresh (see
                    # _NO_REFRESH above)
                    pass
                else:
                    try:
                        self.refresh_config(deadline)
                    except PegasusError as e:
                        # an unreachable meta burns this retry, it
                        # doesn't abort the op: the cached config may
                        # still be right (and the meta may heal before
                        # the next attempt)
                        last_err = int(e.code)
            p = pidx if partition_hash is None else (
                partition_hash % self.partition_count)
            if prefer_node is not None and not attempt \
                    and not force_primary:
                dst = prefer_node
            else:
                dst = self._route_read(p, cons, force_primary)
            if not dst:
                continue  # partition momentarily unowned; refresh + retry
            wire = {"gpid": (self.app_id, p), "op": op,
                    "auth": self.auth, "args": args,
                    "partition_hash": partition_hash}
            if cons is not None:
                wire["consistency"] = self._wire_consistency(cons, p)
            rid = self._send_request(dst, "client_read", wire,
                                     deadline=deadline)
            reply = self._await(rid, deadline)
            if reply is None:
                last_err = int(ErrorCode.ERR_TIMEOUT)
                continue
            if reply["err"] in _RETRYABLE:
                last_err = reply["err"]
                if reply["err"] == _STALE:
                    # bounced by a lapsed-lease / too-stale secondary:
                    # ONLY this op re-flies, and it goes to the primary
                    force_primary = True
                continue
            if reply["err"] != _OK:
                raise PegasusError(ErrorCode(reply["err"]), op)
            self._note_decree(p, reply.get("decree"))
            return reply["result"]
        raise PegasusError(ErrorCode(last_err), f"{op} exhausted retries")

    def _write(self, ops: List[Tuple[int, Any]],
               partition_hash: int) -> List[Any]:
        return self._traced("client.write", self._write_impl, ops,
                            partition_hash)

    def _write_impl(self, ops: List[Tuple[int, Any]],
                    partition_hash: int) -> List[Any]:
        from pegasus_tpu_torch.replica.mutation import ATOMIC_OPS

        self._ensure_config()
        retry_safe = all(op not in ATOMIC_OPS for op, _ in ops)
        last_err = int(ErrorCode.ERR_TIMEOUT)
        deadline = self._deadline()
        for attempt in range(self._max_retries):
            if attempt:
                if self._clock() > deadline:
                    raise PegasusError(ErrorCode.ERR_TIMEOUT,
                                       "write deadline exceeded")
                self.backoff.sleep(attempt)
                if last_err not in _NO_REFRESH:
                    # (BUSY/over-budget = server pressure, config still
                    # right — see _read; back off without re-resolving)
                    try:
                        self.refresh_config(deadline)
                    except PegasusError as e:
                        last_err = int(e.code)
            pidx = partition_hash % self.partition_count
            primary = self._primary_of(pidx)
            if not primary:
                continue
            rid = self._send_request(primary, "client_write", {
                "gpid": (self.app_id, pidx), "ops": ops,
                "auth": self.auth,
                "partition_hash": partition_hash}, deadline=deadline)
            reply = self._await(rid, deadline)
            if reply is None:
                # a LOST REPLY is ambiguous: the write may have committed.
                # Retrying a put/remove is idempotent; retrying incr/cas/
                # cam would double-apply — surface the timeout instead
                # (the reference client does the same for atomic ops)
                if not retry_safe:
                    raise PegasusError(ErrorCode.ERR_TIMEOUT,
                                       "atomic write reply lost")
                last_err = int(ErrorCode.ERR_TIMEOUT)
                continue
            if reply["err"] in _RETRYABLE:
                last_err = reply["err"]
                continue
            if reply["err"] != _OK:
                raise PegasusError(ErrorCode(reply["err"]), "write")
            return reply["results"]
        raise PegasusError(ErrorCode(last_err), "write exhausted retries")

    # ---- single-record ops --------------------------------------------

    def set(self, hash_key: bytes, sort_key: bytes, value: bytes,
            ttl_seconds: int = 0) -> int:
        from pegasus_tpu_torch.base.value_schema import expire_ts_from_ttl

        ph = key_hash_parts(hash_key, sort_key)
        key = generate_key(hash_key, sort_key)
        results = self._write(
            [(OP_PUT, (key, value, expire_ts_from_ttl(ttl_seconds)))], ph)
        return results[0]

    def get(self, hash_key: bytes, sort_key: bytes,
            consistency=None) -> Tuple[int, bytes]:
        ph = key_hash_parts(hash_key, sort_key)
        return self._read("get", generate_key(hash_key, sort_key), -1,
                          ph, consistency=consistency)

    def delete(self, hash_key: bytes, sort_key: bytes) -> int:
        ph = key_hash_parts(hash_key, sort_key)
        results = self._write(
            [(OP_REMOVE, (generate_key(hash_key, sort_key),))], ph)
        return results[0]

    def exist(self, hash_key: bytes, sort_key: bytes) -> bool:
        return self.get(hash_key, sort_key)[0] == int(StorageStatus.OK)

    def ttl(self, hash_key: bytes, sort_key: bytes,
            consistency=None) -> Tuple[int, int]:
        ph = key_hash_parts(hash_key, sort_key)
        return self._read("ttl", generate_key(hash_key, sort_key), -1,
                          ph, consistency=consistency)

    def incr(self, hash_key: bytes, sort_key: bytes, increment: int,
             ttl_seconds: int = 0):
        ph = key_hash_parts(hash_key, sort_key)
        req = IncrRequest(generate_key(hash_key, sort_key), increment,
                          ttl_seconds)
        return self._write([(OP_INCR, req)], ph)[0]

    # ---- multi ops ----------------------------------------------------

    def multi_set(self, hash_key: bytes, kvs, ttl_seconds: int = 0) -> int:
        if not hash_key:
            return int(StorageStatus.INVALID_ARGUMENT)
        items = kvs.items() if isinstance(kvs, dict) else kvs
        req = MultiPutRequest(hash_key,
                              [KeyValue(k, v) for k, v in items],
                              ttl_seconds)
        return self._write([(OP_MULTI_PUT, req)],
                           key_hash_parts(hash_key))[0]

    def multi_get(self, hash_key: bytes,
                  sort_keys: Optional[Sequence[bytes]] = None,
                  consistency=None,
                  **kwargs) -> Tuple[int, Dict[bytes, bytes]]:
        if not hash_key:
            return int(StorageStatus.INVALID_ARGUMENT), {}
        req = MultiGetRequest(hash_key, sort_keys=list(sort_keys or []),
                              **kwargs)
        resp = self._read("multi_get", req, -1, key_hash_parts(hash_key),
                          consistency=consistency)
        return resp.error, {kv.key: kv.value for kv in resp.kvs}

    def multi_del(self, hash_key: bytes, sort_keys: Sequence[bytes]
                  ) -> Tuple[int, int]:
        if not hash_key:
            return int(StorageStatus.INVALID_ARGUMENT), 0
        req = MultiRemoveRequest(hash_key, list(sort_keys))
        return self._write([(OP_MULTI_REMOVE, req)],
                           key_hash_parts(hash_key))[0]

    def multi_get_sortkeys(self, hash_key: bytes
                           ) -> Tuple[int, List[bytes]]:
        """Paginates past the server's one-shot read budget (shared
        paginate_sortkeys driver)."""
        from pegasus_tpu_torch.client.client import paginate_sortkeys

        def fetch(cursor: bytes, inclusive: bool):
            req = MultiGetRequest(hash_key, no_value=True,
                                  start_sortkey=cursor,
                                  start_inclusive=inclusive)
            return self._read("multi_get", req, -1,
                              key_hash_parts(hash_key))

        return paginate_sortkeys(fetch)

    def sortkey_count(self, hash_key: bytes,
                      consistency=None) -> Tuple[int, int]:
        if not hash_key:
            return int(StorageStatus.INVALID_ARGUMENT), 0
        return self._read("sortkey_count", hash_key, -1,
                          key_hash_parts(hash_key),
                          consistency=consistency)

    def batch_get(self, keys: Sequence[Tuple[bytes, bytes]],
                  consistency=None
                  ) -> Tuple[int, List[Tuple[bytes, bytes, bytes]]]:
        return self._traced("client.batch_get", self._batch_get_impl,
                            keys, consistency)

    def _batch_get_impl(self, keys: Sequence[Tuple[bytes, bytes]],
                        consistency=None
                        ) -> Tuple[int, List[Tuple[bytes, bytes, bytes]]]:
        self._ensure_config()
        deadline = self._deadline()
        out: List[Tuple[bytes, bytes, bytes]] = []
        # keys not yet definitively answered; a split racing an attempt
        # bounces only the stale-routed GROUPS (per-key misroute gate on
        # the server), and only those re-resolve under the refreshed
        # count — answered groups keep their results instead of the
        # whole flush replaying
        pending: List[Tuple[bytes, bytes]] = list(keys)
        for attempt in range(self._max_retries):
            if not pending:
                break
            if attempt:
                if self._clock() > deadline:
                    raise PegasusError(ErrorCode.ERR_TIMEOUT,
                                       "batch_get deadline exceeded")
                self.backoff.sleep(attempt)
                try:
                    self.refresh_config(deadline)
                except PegasusError:
                    pass  # meta momentarily down: cached config may
                    # still be right, like _read/_write tolerate
            # regroup under the CURRENT partition count each attempt — a
            # split between attempts changes the stale keys' pidx
            by_pidx: Dict[int, List[Tuple[bytes, bytes]]] = {}
            for hk, sk in pending:
                pidx = key_hash_parts(hk, sk) % self.partition_count
                by_pidx.setdefault(pidx, []).append((hk, sk))
            still: List[Tuple[bytes, bytes]] = []
            for pidx, group in by_pidx.items():
                fks = [FullKey(hk, sk) for hk, sk in group]
                try:
                    resp = self._read("batch_get", BatchGetRequest(fks),
                                      pidx, deadline=deadline,
                                      consistency=consistency)
                except PegasusError as e:
                    if int(e.code) in _RETRYABLE:
                        still.extend(group)
                        continue
                    raise
                if resp.error == int(
                        ErrorCode.ERR_PARENT_PARTITION_MISUSED):
                    still.extend(group)
                    continue
                if resp.error != int(StorageStatus.OK):
                    return resp.error, []
                out.extend((d.hash_key, d.sort_key, d.value)
                           for d in resp.data)
            pending = still
        if pending:
            raise PegasusError(ErrorCode.ERR_TIMEOUT,
                               "batch_get exhausted retries")
        return int(StorageStatus.OK), out

    def check_and_set(self, hash_key: bytes, check_sort_key: bytes,
                      check_type: int, check_operand: bytes,
                      set_sort_key: bytes, set_value: bytes,
                      ttl_seconds: int = 0,
                      return_check_value: bool = False
                      ) -> CheckAndSetResponse:
        if not hash_key:
            resp = CheckAndSetResponse()
            resp.error = int(StorageStatus.INVALID_ARGUMENT)
            return resp
        req = CheckAndSetRequest(
            hash_key, check_sort_key, check_type, check_operand,
            set_diff_sort_key=(set_sort_key != check_sort_key),
            set_sort_key=set_sort_key, set_value=set_value,
            set_expire_ts_seconds=ttl_seconds,
            return_check_value=return_check_value)
        return self._write([(OP_CAS, req)], key_hash_parts(hash_key))[0]

    def check_and_mutate(self, hash_key: bytes, check_sort_key: bytes,
                         check_type: int, check_operand: bytes,
                         mutates: Sequence[Mutate],
                         return_check_value: bool = False
                         ) -> CheckAndMutateResponse:
        if not hash_key:
            resp = CheckAndMutateResponse()
            resp.error = int(StorageStatus.INVALID_ARGUMENT)
            return resp
        req = CheckAndMutateRequest(
            hash_key, check_sort_key, check_type, check_operand,
            mutate_list=list(mutates),
            return_check_value=return_check_value)
        return self._write([(OP_CAM, req)], key_hash_parts(hash_key))[0]

    def scan_multi(self, groups: Dict[int, list], consistency=None):
        """Batched scans for MANY partitions in as few node round-trips
        as possible: partitions group by their serving node, each node
        stacks its partitions' blocks into one device evaluation
        (SURVEY §2.6's partitions-as-batch-dimension model). Returns
        {pidx: [ScanResponse]}. With a non-linearizable `consistency`,
        partitions fan out across secondaries under their read leases;
        a stale-bounced slot re-flies alone to the primary."""
        return self._traced("client.scan_multi", self._scan_multi_impl,
                            groups, consistency)

    def _scan_multi_impl(self, groups: Dict[int, list],
                         consistency=None):
        self._ensure_config()
        cons = self._norm_consistency(consistency)
        out: Dict[int, list] = {}
        force_primary: set = set()  # pidxs bounced ERR_STALE_REPLICA
        need_refresh = False
        deadline = self._deadline()
        for attempt in range(self._max_retries):
            if attempt:
                if self._clock() > deadline:
                    break  # surfaced below as the partitions-missing error
                self.backoff.sleep(attempt)
                if need_refresh:
                    # (stale-replica bounces alone skip this: the
                    # routing table is right, only the replica choice
                    # was — the bounced subset re-flies to the primary)
                    try:
                        self.refresh_config(deadline)
                    except PegasusError:
                        pass  # meta momentarily down: cached config may
                        # still be right, like _read/_write tolerate
            need_refresh = False
            by_node: Dict[str, list] = {}
            for pidx, reqs in groups.items():
                if pidx in out:
                    continue
                node = self._route_read(pidx, cons,
                                        pidx in force_primary)
                if node:
                    by_node.setdefault(node, []).append(
                        ((self.app_id, pidx), reqs))
                else:
                    need_refresh = True  # momentarily unowned
            if not by_node:
                need_refresh = True
                continue  # mid-failover: refresh and retry, like _read
            # send EVERY node's request first, then await — per-attempt
            # latency is the max of node round-trips, not the sum
            rids = []
            for node, node_groups in by_node.items():
                payload = {"groups": node_groups, "auth": self.auth}
                if cons is not None:
                    payload["consistency"] = cons
                    payload["min_decrees"] = [
                        (gp[1], self._session_tokens.get(gp[1], 0))
                        for gp, _reqs in node_groups]
                rids.append(self._send_request(
                    node, "client_scan_multi", payload,
                    deadline=deadline))
            for rid in rids:
                reply = self._await(rid, deadline)
                if reply is None or reply["err"] != _OK:
                    need_refresh = True
                    continue  # retried next attempt for missing pidxs
                for pidx, decree, _role in reply.get("decrees") or []:
                    self._note_decree(pidx, decree)
                for pidx, resps in reply["result"]:
                    if resps and resps[0].error == int(
                            ErrorCode.ERR_ACL_DENY):
                        raise PegasusError(ErrorCode.ERR_ACL_DENY,
                                           "scan_multi")
                    if resps and resps[0].error == _STALE:
                        # only THIS slot re-flies, straight to the
                        # primary — the rest of the flush keeps serving
                        force_primary.add(pidx)
                        continue
                    if resps and resps[0].error == int(
                            ErrorCode.ERR_INVALID_STATE):
                        need_refresh = True
                        continue  # stale primary; re-resolve
                    out[pidx] = resps
            if len(out) == len(groups):
                break
        missing = set(groups) - set(out)
        if missing:
            raise PegasusError(ErrorCode.ERR_TIMEOUT,
                               f"scan_multi: partitions {sorted(missing)} "
                               f"unreachable")
        return out

    @staticmethod
    def _point_result_err(result) -> int:
        """The storage error inside a point-read result (tuple for
        get/ttl, .error for multi_get/batch_get responses)."""
        if isinstance(result, (tuple, list)):
            return result[0]
        return result.error

    def point_read_multi(self, groups: Dict[int, list],
                         consistency=None):
        """Batched point reads (get / ttl / multi_get with sort keys /
        batch_get) for MANY partitions in as few node round-trips as
        possible — the point-read twin of scan_multi: partitions group
        by their primary node, each node serves its whole flush through
        the cross-partition read coordinator. `groups`: {pidx: [(op,
        args, partition_hash)]}. Returns {pidx: [result]} (the caller's
        grouping, original op order) with results byte-identical to the
        solo read ops.

        Ops are re-routed PER ATTEMPT from their partition_hash (like
        _read recomputes `ph % partition_count`), and a
        misrouted-split result coming back in-band
        (ERR_PARENT_PARTITION_MISUSED from the per-op gate) re-resolves
        just that op — matching the solo path's transparent re-resolve
        instead of surfacing the routing error to the application.

        With a non-linearizable `consistency`, each partition's slot
        fans out to one of its secondaries under the read lease; a slot
        bounced ERR_STALE_REPLICA re-flies ONLY its own ops, straight
        to the primary, with no config refresh (the routing table was
        right — only the replica choice was stale)."""
        return self._traced("client.point_read_multi",
                            self._point_read_multi_impl, groups,
                            consistency)

    def _point_read_multi_impl(self, groups: Dict[int, list],
                               consistency=None):
        self._ensure_config()
        cons = self._norm_consistency(consistency)
        items = [(orig_pidx, i, op)
                 for orig_pidx, ops in groups.items()
                 for i, op in enumerate(ops)]
        out: Dict[int, list] = {pidx: [None] * len(ops)
                                for pidx, ops in groups.items()}
        unresolved = set(range(len(items)))
        force_primary: set = set()  # pidxs bounced ERR_STALE_REPLICA
        need_refresh = False
        deadline = self._deadline()
        for attempt in range(self._max_retries):
            if not unresolved:
                break
            if attempt:
                if self._clock() > deadline:
                    break  # surfaced below as partitions-unreachable
                self.backoff.sleep(attempt)
                if need_refresh:
                    # stale-replica bounces alone skip the refresh —
                    # the bounced subset just re-routes to the primary
                    try:
                        self.refresh_config(deadline)
                    except PegasusError:
                        continue  # meta momentarily down; cached config
                        # may still be right on the next pass
            need_refresh = False
            send: Dict[str, Dict[int, list]] = {}
            route: Dict[int, str] = {}  # ONE replica per partition per
            # attempt: splitting a partition's ops across replicas
            # would trade the coalesced batch for extra round-trips
            for idx in sorted(unresolved):
                orig_pidx, _i, op = items[idx]
                ph = op[2] if len(op) > 2 else None
                pidx = (ph % self.partition_count if ph is not None
                        else orig_pidx)
                if pidx not in route:
                    route[pidx] = self._route_read(
                        pidx, cons, pidx in force_primary)
                node = route[pidx]
                if node:
                    send.setdefault(node, {}).setdefault(
                        pidx, []).append((idx, op))
                else:
                    need_refresh = True  # momentarily unowned
            if not send:
                continue  # mid-failover: refresh and retry, like _read
            rids = []
            for node, pmap in send.items():
                payload = {"groups": [((self.app_id, pidx),
                                       [op for _i, op in lst])
                                      for pidx, lst in pmap.items()],
                           "auth": self.auth}
                if cons is not None:
                    payload["consistency"] = cons
                    payload["min_decrees"] = [
                        (pidx, self._session_tokens.get(pidx, 0))
                        for pidx in pmap]
                rids.append((self._send_request(
                    node, "client_read_batch", payload,
                    deadline=deadline), pmap))
            for rid, pmap in rids:
                reply = self._await(rid, deadline)
                if reply is None or reply["err"] != _OK:
                    need_refresh = True
                    continue  # retried next attempt
                for pidx, decree, _role in reply.get("decrees") or []:
                    self._note_decree(pidx, decree)
                for pidx, err, results in reply["result"]:
                    sent = pmap.get(pidx)
                    if sent is None:
                        continue
                    if err == int(ErrorCode.ERR_ACL_DENY):
                        raise PegasusError(ErrorCode.ERR_ACL_DENY,
                                           "point_read_multi")
                    if err == _STALE:
                        # bounced slot: ONLY its ops re-fly, to the
                        # primary, no refresh (subset discipline)
                        force_primary.add(pidx)
                        continue
                    if err in _RETRYABLE:
                        need_refresh = True
                        continue  # stale primary; re-resolve
                    if err != _OK:
                        raise PegasusError(ErrorCode(err),
                                           "point_read_multi")
                    for (idx, _op), result in zip(sent, results):
                        if self._point_result_err(result) == _MISROUTED:
                            # split raced: refresh the (grown) table map
                            # and re-route this op by its hash
                            need_refresh = True
                            continue
                        orig_pidx, i, _o = items[idx]
                        out[orig_pidx][i] = result
                        unresolved.discard(idx)
        if unresolved:
            stuck = sorted({items[i][0] for i in unresolved})
            raise PegasusError(
                ErrorCode.ERR_TIMEOUT,
                f"point_read_multi: partitions {stuck} unreachable")
        return out

    def write_multi(self, groups: Dict[int, list]):
        """Batched writes (set / del / multi_set / multi_del — plus
        atomic ops, which ride alone server-side) for MANY partitions
        in as few node round-trips as possible — the write-side twin of
        point_read_multi: partitions group by their primary node, each
        node replicates its whole flush through per-partition 2PC
        inside one group-commit window. `groups`: {pidx: [(op_code,
        request, partition_hash)]} (op_code/request exactly as the solo
        `_write` sends them). Returns {pidx: [result]} (the caller's
        grouping, original op order) with per-op results identical to
        the solo write handlers.

        Retry machinery mirrors point_read_multi: ops re-route per
        attempt from partition_hash, per-op retryable errors (ERR_BUSY
        overload, per-op deadline fast-fail, split misroute) retry just
        that op. A LOST reply is ambiguous for atomic ops in flight on
        that node (they may have committed) — surfaced as ERR_TIMEOUT
        instead of retried, like the solo path."""
        return self._traced("client.write_multi",
                            self._write_multi_impl, groups)

    def _write_multi_impl(self, groups: Dict[int, list]):
        from pegasus_tpu_torch.replica.mutation import ATOMIC_OPS

        self._ensure_config()
        items = [(orig_pidx, i, op)
                 for orig_pidx, ops in groups.items()
                 for i, op in enumerate(ops)]
        out: Dict[int, list] = {pidx: [None] * len(ops)
                                for pidx, ops in groups.items()}
        unresolved = set(range(len(items)))
        deadline = self._deadline()
        for attempt in range(self._max_retries):
            if not unresolved:
                break
            if attempt:
                if self._clock() > deadline:
                    break  # surfaced below as partitions-unreachable
                self.backoff.sleep(attempt)
                try:
                    self.refresh_config(deadline)
                except PegasusError:
                    continue  # meta momentarily down; cached config may
                    # still be right on the next pass
            send: Dict[str, Dict[int, list]] = {}
            for idx in sorted(unresolved):
                orig_pidx, _i, op = items[idx]
                ph = op[2] if len(op) > 2 else None
                pidx = (ph % self.partition_count if ph is not None
                        else orig_pidx)
                primary = self._primary_of(pidx)
                if primary:
                    send.setdefault(primary, {}).setdefault(
                        pidx, []).append((idx, op))
            if not send:
                continue  # mid-failover: refresh and retry, like _write
            rids = []
            for node, pmap in send.items():
                node_groups = [
                    ((self.app_id, pidx),
                     [([(op[0], op[1])],
                       op[2] if len(op) > 2 else None, deadline)
                      for _i, op in lst])
                    for pidx, lst in pmap.items()]
                rids.append((self._send_request(
                    node, "client_write_batch",
                    {"groups": node_groups, "auth": self.auth},
                    deadline=deadline), pmap))
            for rid, pmap in rids:
                reply = self._await(rid, deadline)
                if reply is None:
                    # ambiguous: the node may have committed some of
                    # the batch. Idempotent ops retry; an atomic op in
                    # flight here must surface the timeout instead
                    for lst in pmap.values():
                        for idx, op in lst:
                            if (idx in unresolved
                                    and op[0] in ATOMIC_OPS):
                                raise PegasusError(
                                    ErrorCode.ERR_TIMEOUT,
                                    "atomic write reply lost")
                    continue
                if reply["err"] != _OK:
                    continue  # retried next attempt
                for pidx, err, item_res in reply["result"]:
                    sent = pmap.get(pidx)
                    if sent is None:
                        continue
                    if err == int(ErrorCode.ERR_ACL_DENY):
                        raise PegasusError(ErrorCode.ERR_ACL_DENY,
                                           "write_multi")
                    if err in _RETRYABLE:
                        continue  # stale primary/splitting; re-resolve
                    if err != _OK:
                        raise PegasusError(ErrorCode(err), "write_multi")
                    for (idx, _op), (op_err, op_results) in zip(
                            sent, item_res):
                        if op_err in _RETRYABLE:
                            # per-op deadline fast-fail / ERR_BUSY shed
                            # / split misroute: nothing ran — safe to
                            # retry even atomic ops
                            continue
                        if op_err != _OK:
                            raise PegasusError(ErrorCode(op_err),
                                               "write_multi")
                        orig_pidx, i, _o = items[idx]
                        out[orig_pidx][i] = op_results[0]
                        unresolved.discard(idx)
        if unresolved:
            stuck = sorted({items[i][0] for i in unresolved})
            raise PegasusError(
                ErrorCode.ERR_TIMEOUT,
                f"write_multi: partitions {stuck} unreachable")
        return out

    def scan_page(self, pidx: int, context_id: int, consistency=None,
                  prefer_node: Optional[str] = None):
        """Continue a server-held scan context (batched-path paging).
        Scan contexts are node-local: a consistency-routed page must
        come back to the replica that opened the context, so callers
        pass `prefer_node` to pin it (a lost pin surfaces as
        SCAN_CONTEXT_ID_NOT_EXIST and the caller restarts)."""
        return self._read("scan", context_id, pidx,
                          consistency=consistency,
                          prefer_node=prefer_node)

    def scan_abort(self, pidx: int, context_id: int, consistency=None,
                   prefer_node: Optional[str] = None) -> None:
        try:
            self._read("clear_scanner", context_id, pidx,
                       consistency=consistency,
                       prefer_node=prefer_node)
        except PegasusError:
            pass

    # ---- scanners ------------------------------------------------------

    def get_scanner(self, hash_key: bytes, start_sortkey: bytes = b"",
                    stop_sortkey: bytes = b"",
                    options: Optional[ScanOptions] = None,
                    consistency=None) -> "ClusterScanner":
        from dataclasses import replace

        from pegasus_tpu_torch.base.key_schema import generate_next_bytes

        if not hash_key:
            raise ValueError("hash key cannot be empty when scan")
        self._ensure_config()
        opts = options or ScanOptions()
        start_key = generate_key(hash_key, start_sortkey)
        if stop_sortkey:
            stop_key = generate_key(hash_key, stop_sortkey)
        else:
            stop_key = generate_next_bytes(hash_key)
            opts = replace(opts, stop_inclusive=False)
        req = self._make_scan_request(start_key, stop_key, opts)
        pidx = key_hash_parts(hash_key) % self.partition_count
        return ClusterScanner(self, [pidx], req,
                              consistency=consistency)

    def get_unordered_scanners(self, max_split_count: int,
                               options: Optional[ScanOptions] = None,
                               consistency=None
                               ) -> List["ClusterScanner"]:
        if max_split_count < 1:
            raise ValueError("max_split_count must be >= 1")
        self._ensure_config()
        opts = options or ScanOptions()
        req = self._make_scan_request(b"", b"", opts, full_scan=True)
        split = min(max_split_count, self.partition_count)
        groups: List[List[int]] = [[] for _ in range(split)]
        for pidx in range(self.partition_count):
            groups[pidx % split].append(pidx)
        return [ClusterScanner(self, g, req, consistency=consistency)
                for g in groups if g]

    @staticmethod
    def _make_scan_request(start_key: bytes, stop_key: bytes,
                           opts: ScanOptions,
                           full_scan: bool = False) -> GetScannerRequest:
        from pegasus_tpu_torch.ops.predicates import FT_NO_FILTER
        from pegasus_tpu_torch.ops.pushdown import PushdownSpec

        pushdown = None
        if opts.value_filter_type != FT_NO_FILTER:
            pushdown = PushdownSpec(
                value_filter_type=opts.value_filter_type,
                value_filter_pattern=opts.value_filter_pattern)
            pushdown.check()
        return GetScannerRequest(
            start_key=start_key, stop_key=stop_key,
            start_inclusive=opts.start_inclusive,
            stop_inclusive=opts.stop_inclusive,
            batch_size=opts.batch_size,
            hash_key_filter_type=opts.hash_key_filter_type,
            hash_key_filter_pattern=opts.hash_key_filter_pattern,
            sort_key_filter_type=opts.sort_key_filter_type,
            sort_key_filter_pattern=opts.sort_key_filter_pattern,
            no_value=opts.no_value,
            return_expire_ts=opts.return_expire_ts,
            only_return_count=opts.only_return_count,
            full_scan=full_scan,
            validate_partition_hash=True,
            pushdown=pushdown)


class ClusterScanner:
    """Pages scan contexts over the cluster read path (parity:
    pegasus_scanner_impl paging via RPC_RRDB_RRDB_SCAN)."""

    def __init__(self, client: ClusterClient, pidxs: List[int],
                 request: GetScannerRequest,
                 consistency=None) -> None:
        self._client = client
        self._pidxs = list(pidxs)
        self._request = request
        self._consistency = client._norm_consistency(consistency)
        # scan contexts are node-local: a follower-read scanner pins
        # the replica that opened each partition's context and pages
        # against it; a lost pin (failover, lease lapse, context
        # expiry) surfaces as SCAN_CONTEXT_ID_NOT_EXIST and the
        # restart re-pins
        self._node: Optional[str] = None
        self._i = 0
        self._context_id: Optional[int] = None
        self._buffer: List[KeyValue] = []
        self._pos = 0
        self._last_key: Optional[bytes] = None
        self.kv_count = 0
        self.shipped_bytes = 0  # wire-size of every response consumed

    def _open(self, req, pidx: int):
        """Open (or reopen) a scan context: pick this partition's
        serving replica under the scanner's consistency level, pin it,
        and issue get_scanner against the pin."""
        self._node = self._client._route_read(pidx, self._consistency)
        return self._client._read("get_scanner", req, pidx,
                                  consistency=self._consistency,
                                  prefer_node=self._node)

    def __iter__(self) -> Iterator[Tuple[bytes, bytes, bytes]]:
        return self

    def __next__(self) -> Tuple[bytes, bytes, bytes]:
        kv = self._next_kv()
        hk, sk = restore_key(kv.key)
        return hk, sk, kv.value

    def next_record(self) -> Tuple[bytes, bytes, bytes, int]:
        """Like next(), plus the record's expire_ts (0 = no TTL);
        meaningful only with GetScannerRequest.return_expire_ts."""
        kv = self._next_kv()
        hk, sk = restore_key(kv.key)
        return hk, sk, kv.value, kv.expire_ts_seconds or 0

    def _next_kv(self):
        while True:
            if self._pos < len(self._buffer):
                kv = self._buffer[self._pos]
                self._pos += 1
                self._last_key = kv.key
                return kv
            if not self._fetch(self._request):
                raise StopIteration

    def _fetch(self, base_req: GetScannerRequest) -> bool:
        from dataclasses import replace

        while self._i < len(self._pidxs):
            pidx = self._pidxs[self._i]
            if self._context_id is None:
                resp = self._open(base_req, pidx)
            else:
                resp = self._client.scan_page(
                    pidx, self._context_id,
                    consistency=self._consistency,
                    prefer_node=self._node)
                if resp.context_id == SCAN_CONTEXT_ID_NOT_EXIST:
                    # context expired server-side (or moved with a
                    # failover / the pinned follower bounced): restart
                    # past the last served key on a fresh pin
                    self._context_id = None
                    restart = base_req
                    if self._last_key is not None:
                        restart = replace(base_req,
                                          start_key=self._last_key + b"\x00",
                                          start_inclusive=True)
                    resp = self._open(restart, pidx)
            if resp.error != int(StorageStatus.OK):
                raise RuntimeError(f"scan failed: error {resp.error}")
            self.shipped_bytes += resp.wire_bytes()
            if resp.kv_count >= 0:
                self.kv_count += resp.kv_count
            buf = resp.kvs
            spec = base_req.pushdown
            vf = spec.value_filter if spec is not None else None
            if vf is not None and not resp.pushdown_applied:
                # pre-pushdown server (or pushdown disabled): spec was
                # ignored, full pages streamed — evaluate locally
                buf = [kv for kv in buf
                       if host_match_filter(kv.value, vf[0], vf[1])]
            self._buffer = buf
            self._pos = 0
            if resp.context_id == SCAN_CONTEXT_ID_COMPLETED:
                self._i += 1
                self._context_id = None
            else:
                self._context_id = resp.context_id
            if self._buffer:
                return True
        return False

    # ---- aggregate pushdown -------------------------------------------

    def count(self) -> int:
        """Matching-row count over this scanner's partitions, evaluated
        server-side where possible — one tiny aggregate partial per
        partition on the wire instead of every row. Respects the
        scanner's value filter; pre-pushdown servers stream rows and the
        count happens here."""
        return self.aggregate("count")

    def aggregate(self, kind: str, k: int = 0, seed: int = 0):
        """Run this scanner's range as ONE aggregate — `count`, `sum`
        (values as u64), `top_k` (by sort key) or `sample` (reservoir) —
        merged across partitions. Independent of the iteration cursor."""
        from dataclasses import replace

        from pegasus_tpu_torch.ops import pushdown as pushdown_ops

        base = self._request.pushdown or pushdown_ops.PushdownSpec()
        spec = replace(base, aggregate=kind, k=int(k), seed=int(seed))
        spec.check()
        req = replace(self._request, pushdown=spec,
                      one_page=False, only_return_count=False)
        parts = [self._aggregate_partition(pidx, req, spec)
                 for pidx in self._pidxs]
        return pushdown_ops.finalize(
            spec, pushdown_ops.merge_partials(spec, parts))

    def _aggregate_partition(self, pidx: int, req, spec):
        from dataclasses import replace

        from pegasus_tpu_torch.ops import pushdown as pushdown_ops

        resp = self._open(req, pidx)
        rows: List[Tuple[bytes, bytes]] = []  # fallback accumulation
        last_key: Optional[bytes] = None
        while True:
            if resp.context_id == SCAN_CONTEXT_ID_NOT_EXIST:
                # context expired server-side (or moved with a failover
                # / split fence bounce). The aggregate partial lives
                # SERVER-side, so the lost context lost every page it
                # folded — restarting from the original start with
                # nothing accumulated client-side cannot double count.
                # The local-fallback path (rows collected here) resumes
                # past the last collected key like a plain scan.
                if rows and last_key is not None:
                    resp = self._open(replace(
                        req, start_key=last_key + b"\x00",
                        start_inclusive=True), pidx)
                else:
                    rows.clear()
                    resp = self._open(req, pidx)
                continue
            if resp.error != int(StorageStatus.OK):
                raise RuntimeError(f"scan failed: error {resp.error}")
            self.shipped_bytes += resp.wire_bytes()
            for kv in resp.kvs:
                rows.append((kv.key, kv.value))
                last_key = kv.key
            if resp.context_id == SCAN_CONTEXT_ID_COMPLETED:
                break
            resp = self._client.scan_page(
                pidx, resp.context_id, consistency=self._consistency,
                prefer_node=self._node)
        if resp.agg is not None:
            return resp.agg
        # pre-pushdown server streamed rows: evaluate the whole spec here
        vf = spec.value_filter
        st = pushdown_ops.AggState(spec)
        for key, value in rows:
            if vf is not None and not host_match_filter(value, vf[0], vf[1]):
                continue
            st.fold_row(key, value)
        return st.to_wire()

    def close(self) -> None:
        if self._context_id is not None and self._i < len(self._pidxs):
            self._client.scan_abort(self._pidxs[self._i],
                                    self._context_id,
                                    consistency=self._consistency,
                                    prefer_node=self._node)
            self._context_id = None
