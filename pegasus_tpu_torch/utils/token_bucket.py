"""Token-bucket throttling controller: the port's own copy of the JAX
package's pegasus_tpu/utils/token_bucket.py (pure stdlib; the port
imports nothing of that package).

Parity: src/utils/token_bucket_throttling_controller.h:32 and
src/utils/throttling_controller.* — per-table QPS/size throttles used by
replica read/write throttling (src/replica/replica_throttle.cpp),
configured from app-envs like "2000*delay*100" or "100K".
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Tuple


class TokenBucket:
    """Classic token bucket: `rate` units/sec with `burst` capacity."""

    def __init__(self, rate: float, burst: Optional[float] = None,
                 clock=None) -> None:
        """`clock`: monotonic-seconds source (default wall
        time.monotonic). Sim-hosted buckets pass the virtual clock so
        refill tracks virtual seconds — a compressed sim schedule burns
        thousands of virtual seconds in milliseconds of wall, and a
        wall-clocked bucket would never refill under it."""
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else rate)
        self._clock = clock if clock is not None else time.monotonic
        self._tokens = self.burst
        self._last = self._clock()
        self._lock = threading.Lock()

    def _refill(self, now: float) -> None:
        elapsed = max(0.0, now - self._last)
        self._last = now
        self._tokens = min(self.burst, self._tokens + elapsed * self.rate)

    def try_consume(self, tokens: float = 1.0) -> bool:
        with self._lock:
            now = self._clock()
            self._refill(now)
            if self._tokens >= tokens:
                self._tokens -= tokens
                return True
            return False

    def consume_or_delay(self, tokens: float = 1.0) -> float:
        """Consume unconditionally; return suggested delay (seconds) before
        serving, 0 if within budget. Mirrors the reference's delay-mode
        throttling (delay instead of reject)."""
        with self._lock:
            now = self._clock()
            self._refill(now)
            self._tokens -= tokens
            if self._tokens >= 0:
                return 0.0
            return -self._tokens / self.rate

    def debit(self, tokens: float) -> None:
        """Post-debit charge: subtract unconditionally, allowing the
        level to go negative. The CU-budget admission model charges the
        ACTUAL capacity units after serving (they are only known then)
        and gates the NEXT op on the sign of the level — an op that
        overshoots pushes the bucket into debt the refill must pay off
        before the tenant is admitted again."""
        with self._lock:
            self._refill(self._clock())
            self._tokens -= tokens

    def level(self) -> float:
        """Current token level after refill (may be negative under
        debit()); admission peeks this without consuming."""
        with self._lock:
            self._refill(self._clock())
            return self._tokens


def parse_throttle_env(value: str) -> Tuple[Optional[TokenBucket], Optional[TokenBucket]]:
    """Parse a throttle app-env of the reference's form
    "<qps>*delay*<ms>[,<qps>*reject*<ms>]" or a bare size like "100K"/"2M".

    Returns (delay_bucket, reject_bucket). Parity:
    src/utils/throttling_controller.cpp parse_from_env.
    """
    delay_b: Optional[TokenBucket] = None
    reject_b: Optional[TokenBucket] = None
    value = value.strip()
    if not value:
        return None, None
    for part in value.split(","):
        part = part.strip()
        if "*" in part:
            fields = part.split("*")
            qps = _parse_units(fields[0])
            kind = fields[1] if len(fields) > 1 else "delay"
            bucket = TokenBucket(qps)
            if kind == "reject":
                reject_b = bucket
            else:
                delay_b = bucket
        else:
            delay_b = TokenBucket(_parse_units(part))
    return delay_b, reject_b


def _parse_units(s: str) -> float:
    s = s.strip().upper()
    mult = 1.0
    if s.endswith("K"):
        mult, s = 1e3, s[:-1]
    elif s.endswith("M"):
        mult, s = 1e6, s[:-1]
    elif s.endswith("G"):
        mult, s = 1e9, s[:-1]
    return float(s) * mult
