"""Capped exponential retry backoff with seeded jitter.

Parity: the reference client's retry pacing (pegasus_client_impl
resolves-and-retries with the rDSN task delay growing per attempt;
partition_resolver.cpp:42 get_retry_interval caps the backoff) plus the
"full jitter" scheme — sleep a uniform fraction of the exponential
ceiling so a thundering herd of clients retrying into a failover
de-synchronizes instead of re-storming the meta in lockstep.

One `Backoff` instance belongs to one retry context (a client); the RNG
is seeded so a chaos schedule replays identically from its seed.
"""

from __future__ import annotations

import random
import time
from typing import Callable, List, Optional

from pegasus_tpu_torch.utils.flags import FLAGS, define_flag

define_flag("pegasus.client", "retry_backoff_base_ms", 20,
            "first-retry backoff ceiling (doubles per attempt)",
            mutable=True)
define_flag("pegasus.client", "retry_backoff_max_ms", 1000,
            "cap on the per-attempt backoff ceiling", mutable=True)


class Backoff:
    """delay(attempt) in [ceiling/2, ceiling], ceiling = min(max, base·2^a).

    The lower bound keeps a measurable sleep on every retry (no
    zero-jitter busy spin) while the upper half of the window provides
    the de-synchronization. `sleep` is injectable: the sim cluster pumps
    virtual time instead of blocking the wall clock, and tests record
    the slept amounts to assert pacing without real waiting.
    """

    def __init__(self, base_ms: Optional[float] = None,
                 max_ms: Optional[float] = None,
                 seed: Optional[int] = None,
                 sleep: Callable[[float], None] = time.sleep) -> None:
        """`seed` None (the default) derives per-process entropy — N
        clients hitting the same failover must NOT draw identical
        jitter streams, or the herd stays in lockstep and the jitter
        buys nothing. Pass an explicit seed only for replayable
        schedules (the sim cluster, timing-bound tests)."""
        import os

        self._base_ms = base_ms
        self._max_ms = max_ms
        if seed is None:
            seed = (os.getpid() << 20) ^ time.time_ns()
        self._rng = random.Random(seed)
        self._sleep = sleep
        self.slept: List[float] = []  # measured backoff, for harnesses

    def delay(self, attempt: int) -> float:
        """Seconds to wait before retry number `attempt` (1-based)."""
        base = self._base_ms if self._base_ms is not None else \
            FLAGS.get("pegasus.client", "retry_backoff_base_ms")
        cap = self._max_ms if self._max_ms is not None else \
            FLAGS.get("pegasus.client", "retry_backoff_max_ms")
        # exponent clamped: long-lived retry contexts (the transport's
        # reconnect streak) pass unbounded attempt counts, and
        # 2.0**large raises OverflowError long after the cap would win
        ceiling = min(float(cap),
                      float(base) * (2.0 ** min(max(0, attempt - 1), 32)))
        return (ceiling * (0.5 + 0.5 * self._rng.random())) / 1000.0

    def sleep(self, attempt: int) -> float:
        d = self.delay(attempt)
        self._sleep(d)
        self.slept.append(d)
        return d

    def reset(self) -> None:
        self.slept.clear()
