"""Async client facade (parity: the async half of the reference C++
client API, include/pegasus/client.h async_get/async_set/async_multi_get
/... :42-1180, and the twisted-based python client).

A sync client instance is a SERIAL protocol endpoint (one
request/reply pump, one config cache), so the facade runs every call on
one dedicated worker thread guarded by a lock: the asyncio event loop
is never blocked, calls from many tasks interleave safely, and there is
ONE code path for the actual protocol. `gather_*` helpers express the
scatter/join shape of the reference's async API; for true wire-level
parallelism, shard work across several AsyncPegasusClient instances
(each wrapping its own sync client), exactly as the reference scales
with multiple sessions."""

from __future__ import annotations

import asyncio
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

# the async facade shares the sync client's retryability surface
# VERBATIM — one definition, two exports, so the sync and async stacks
# can never disagree on which typed errors retry or which retries are
# forbidden from burning a config refresh (the tier-1 retryability
# matrix test asserts this identity)
from pegasus_tpu_torch.client.cluster_client import (  # noqa: F401
    DEFAULT_TENANT,
    NO_REFRESH_CODES,
    RETRYABLE_CODES,
    sanitize_tenant,
)


class AsyncPegasusClient:
    """Wraps any sync client (PegasusClient or ClusterClient-backed).

    Robustness rides the wrapped client: end-to-end deadlines and the
    jittered retry backoff run on the worker thread, so awaiting tasks
    see the same typed ERR_TIMEOUT/ERR_BUSY surface as the sync API and
    the event loop never blocks on a backoff sleep."""

    # kwargs forward verbatim, so cluster-backed read ops accept
    # consistency=bounded_stale(...)/MONOTONIC exactly like the sync
    # API (await aio.get(hk, sk, consistency=MONOTONIC))
    _FORWARDED = (
        "set", "get", "delete", "exist", "ttl", "incr",
        "multi_set", "multi_get", "multi_get_sortkeys", "multi_del",
        "batch_get", "sortkey_count", "check_and_set",
        "check_and_mutate", "scan_multi", "scan_page", "scan_abort",
        "point_read_multi", "write_multi",
    )

    def __init__(self, client, max_workers: int = 1,
                 op_timeout_ms: Optional[float] = None,
                 tenant: Optional[str] = None) -> None:
        """`op_timeout_ms`: per-op end-to-end deadline override applied
        to the wrapped client (ClusterClient.op_timeout_ms); None keeps
        the client_op_timeout_ms flag default.

        `tenant`: QoS identity override applied to the wrapped cluster
        client (ClusterClient.tenant) — every op issued through this
        facade is billed to it; None keeps the wrapped client's tag."""
        import threading

        self._c = client
        if tenant is not None:
            if not hasattr(client, "tenant"):
                # mirror the op_timeout_ms guard: only the cluster
                # client carries tenant identity on the wire
                raise TypeError(
                    f"{type(client).__name__} does not support "
                    "tenant tags (a ClusterClient feature)")
            self._c.tenant = sanitize_tenant(tenant)
            self._c._tenant_explicit = True
        if op_timeout_ms is not None:
            if not hasattr(client, "op_timeout_ms"):
                # only the cluster client enforces deadlines; silently
                # setting a dead attribute would leave the caller
                # believing a bound is active when none is
                raise TypeError(
                    f"{type(client).__name__} does not support "
                    "op_timeout_ms (deadlines are a ClusterClient "
                    "feature)")
            self._c.op_timeout_ms = op_timeout_ms
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers,
            thread_name_prefix="pegasus-aio")

    def __getattr__(self, name: str):
        if name not in self._FORWARDED:
            raise AttributeError(name)
        fn = getattr(self._c, name)

        async def call(*args, **kwargs):
            loop = asyncio.get_running_loop()

            def locked():
                with self._lock:
                    return fn(*args, **kwargs)

            return await loop.run_in_executor(self._pool, locked)

        return call

    async def gather_get(self, keys: Sequence[Tuple[bytes, bytes]]):
        """Concurrent point gets; returns [(err, value)] in key order."""
        return await asyncio.gather(
            *(self.get(hk, sk) for hk, sk in keys))

    async def gather_set(self, items: Sequence[Tuple[bytes, bytes, bytes]],
                         ttl_seconds: int = 0):
        """Concurrent puts; returns [err] in item order."""
        return await asyncio.gather(
            *(self.set(hk, sk, v, ttl_seconds) for hk, sk, v in items))

    @staticmethod
    def _scan_options(batch_size: int, value_filter: Optional[bytes]):
        from pegasus_tpu_torch.client.client import ScanOptions
        from pegasus_tpu_torch.ops.predicates import FT_MATCH_ANYWHERE

        if value_filter:
            # server-side pushdown: only matching rows cross the wire
            # (old servers stream everything and the scanner filters
            # locally — same rows either way)
            return ScanOptions(batch_size=batch_size,
                               value_filter_type=FT_MATCH_ANYWHERE,
                               value_filter_pattern=value_filter)
        return ScanOptions(batch_size=batch_size)

    async def scan_all(self, hash_key: bytes, batch_size: int = 100,
                       value_filter: Optional[bytes] = None,
                       consistency=None):
        """Drain a hashkey scan without blocking the event loop between
        pages; returns [(hashkey, sortkey, value)]. `value_filter`
        keeps only rows whose value contains the pattern, evaluated
        server-side when the server supports pushdown. `consistency`
        (cluster-backed clients): bounded_stale(...)/MONOTONIC routes
        the pages to lease-holding secondaries — see
        ClusterClient.get_scanner."""
        loop = asyncio.get_running_loop()
        opts = self._scan_options(batch_size, value_filter)

        def scan():
            with self._lock:
                if consistency is not None:
                    scanner = self._c.get_scanner(
                        hash_key, options=opts, consistency=consistency)
                else:
                    scanner = self._c.get_scanner(hash_key, options=opts)
                return list(scanner)

        return await loop.run_in_executor(self._pool, scan)

    async def scan_count(self, hash_key: bytes,
                         value_filter: Optional[bytes] = None) -> int:
        """Count a hashkey's (optionally value-filtered) rows via
        aggregate pushdown: the server replies with one tiny partial
        instead of streaming rows (pre-pushdown servers stream and the
        scanner counts locally)."""
        loop = asyncio.get_running_loop()
        opts = self._scan_options(100, value_filter)

        def count():
            with self._lock:
                return self._c.get_scanner(hash_key, options=opts).count()

        return await loop.run_in_executor(self._pool, count)

    def close(self) -> None:
        self._pool.shutdown(wait=False)
