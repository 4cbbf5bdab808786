"""Background-compaction governor: the node half of the cluster-level
background-I/O scheduler, as in the JAX package's
storage/compact_governor.py.

- every byte the compaction pipeline reads passes through one
  process-wide token bucket (`acquire`), so background disk bandwidth
  has a single knob;
- the knob is driven by a foreground-pressure source with AIMD feedback:
  any growth since the last look halves the allowance (engaging a cap at
  half the measured recent rate when previously uncapped), quiet
  intervals recover it multiplicatively until the cap disengages —
  compaction always keeps the configured floor, so it makes forward
  progress even on a shedding node;
- heavy (env-triggered manual) compactions ask a leased cluster grant;
  no grant ever received, or an expired one, means "may run".

The default pressure source is the node's RPC dispatch counters
(`deadline_expired_count` + `read_shed_count` on the ("rpc",
"dispatch") entity, which the transport counts); callers and tests may
inject their own. The replica stub's config sync runs a feedback step
(`poke`) on every report. The JAX package's node metrics are published
under its names on the ("storage", "node") entity (`compaction_bytes_per_s`,
`compact_throttle_mbps`, `compact_backoff_count`,
`compact_throttle_stall_ms`, `compact_defer_count`); each governor also
keeps its own readings as attributes: `throttle_mbps`, `rate_bps`,
`backoff_count`, `stall_ms`, `defer_count`.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from pegasus_tpu_torch.utils.flags import FLAGS, define_flag
from pegasus_tpu_torch.utils.metrics import METRICS

define_flag("pegasus.storage", "compact_max_mbps", 0,
            "hard background-compaction read-bandwidth cap in MB/s; "
            "0 = uncapped until foreground pressure engages the AIMD "
            "backoff", mutable=True)
define_flag("pegasus.storage", "compact_min_mbps", 32,
            "floor the pressure backoff never throttles below — "
            "background compaction must keep making forward progress "
            "(a stalled compaction eventually hurts reads more than "
            "the bandwidth it frees)", mutable=True)
define_flag("pegasus.storage", "compact_feedback_interval_s", 1.0,
            "seconds between foreground-pressure samples driving the "
            "AIMD rate adaptation", mutable=True)
define_flag("pegasus.storage", "compact_grant_lease_s", 30.0,
            "seconds a meta-issued heavy-compaction grant stays valid "
            "without renewal (a dead meta therefore releases the "
            "cluster stagger rather than wedging compaction)",
            mutable=True)


def _default_pressure() -> int:
    ent = METRICS.entity("rpc", "dispatch", {})
    return (ent.counter("deadline_expired_count").value()
            + ent.counter("read_shed_count").value())


class CompactionGovernor:
    """One per process (module singleton GOVERNOR); engines share it."""

    # multiplicative recovery per quiet feedback interval, and the
    # throttle level (relative to the engage point) at which an
    # AIMD-engaged cap disengages back to uncapped
    RECOVER_FACTOR = 1.5
    UNCAP_FACTOR = 2.0

    def __init__(self,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 pressure_source: Callable[[], int] = _default_pressure,
                 ) -> None:
        self._clock = clock
        self._sleep = sleep
        self._pressure = pressure_source
        self._lock = threading.Lock()
        # throttle: MB/s currently enforced; 0 = uncapped. AIMD state
        # distinguishes an operator cap (compact_max_mbps, permanent)
        # from a pressure-engaged cap (recovers to uncapped)
        self.throttle_mbps = 0.0
        self._engaged_at_mbps = 0.0  # rate when pressure first engaged
        self._tokens = 0.0
        self._tok_t = self._clock()
        self._pressure_last: Optional[int] = None
        self._feedback_t = self._clock()
        # measured recent read rate (1 s windows)
        self._win_t = self._clock()
        self._win_bytes = 0
        self.rate_bps = 0.0
        # heavy-compaction demand + cluster grant lease
        self.heavy_running = 0
        self._heavy_waiting = False
        self._grant: Optional[tuple] = None  # (granted, expires_at)
        self.backoff_count = 0
        self.stall_ms = 0
        self.defer_count = 0
        ent = METRICS.entity("storage", "node")
        self._g_rate = ent.gauge("compaction_bytes_per_s")
        self._g_throttle = ent.gauge("compact_throttle_mbps")
        self._c_backoff = ent.counter("compact_backoff_count")
        self._c_stall_ms = ent.counter("compact_throttle_stall_ms")
        self._c_defer = ent.counter("compact_defer_count")

    # ---- pacing (called by the pipeline's read stage) ------------------

    def acquire(self, nbytes: int) -> None:
        """Account `nbytes` of background compaction IO, sleeping as
        needed to hold the current throttle. Uncapped mode costs two
        clock reads."""
        now = self._clock()
        sleep_s = 0.0
        with self._lock:
            self._feedback_locked(now)
            self._win_bytes += nbytes
            dt = now - self._win_t
            if dt >= 1.0:
                self.rate_bps = self._win_bytes / dt
                self._g_rate.set(self.rate_bps)
                self._win_t = now
                self._win_bytes = 0
            rate = self.throttle_mbps
            if rate > 0:
                bps = rate * 1e6
                # token bucket with a 250 ms burst allowance; debt is
                # allowed (a block is atomic) and paid off by sleeping
                self._tokens = min(self._tokens + (now - self._tok_t)
                                   * bps, bps * 0.25)
                self._tok_t = now
                self._tokens -= nbytes
                if self._tokens < 0:
                    sleep_s = -self._tokens / bps
                    self._tokens = 0.0
            if sleep_s > 0:
                self.stall_ms += int(sleep_s * 1000)
                self._c_stall_ms.increment(int(sleep_s * 1000))
        if sleep_s > 0:
            self._sleep(sleep_s)

    def _feedback_locked(self, now: float) -> None:
        interval = float(FLAGS.get("pegasus.storage",
                                   "compact_feedback_interval_s"))
        if now - self._feedback_t < interval:
            return
        self._feedback_t = now
        try:
            p = self._pressure()
        except Exception:  # noqa: BLE001 - a broken source never throttles
            return
        prev, self._pressure_last = self._pressure_last, p
        max_mbps = float(FLAGS.get("pegasus.storage", "compact_max_mbps"))
        min_mbps = float(FLAGS.get("pegasus.storage", "compact_min_mbps"))
        if self.throttle_mbps == 0 and max_mbps > 0:
            self.throttle_mbps = max_mbps  # operator cap always on
        if prev is None:
            return
        if p > prev:
            # foreground is shedding / expiring deadlines: halve the
            # allowance (engage a cap at half the measured recent rate
            # when previously uncapped)
            cur = self.throttle_mbps
            if cur == 0:
                cur = max(self.rate_bps / 1e6, min_mbps * 2)
                self._engaged_at_mbps = cur
            self.throttle_mbps = max(cur / 2, min_mbps)
            self.backoff_count += 1
            self._c_backoff.increment()
            self._g_throttle.set(self.throttle_mbps)
            return
        # quiet interval: multiplicative recovery toward the operator
        # cap, or toward disengaging a pressure-engaged cap
        cur = self.throttle_mbps
        if cur == 0:
            return
        cur *= self.RECOVER_FACTOR
        if max_mbps > 0:
            self.throttle_mbps = min(cur, max_mbps)
        elif self._engaged_at_mbps > 0 and \
                cur >= self._engaged_at_mbps * self.UNCAP_FACTOR:
            self.throttle_mbps = 0.0  # fully recovered: uncap
            self._engaged_at_mbps = 0.0
        else:
            self.throttle_mbps = cur
        self._g_throttle.set(self.throttle_mbps)

    def poke(self) -> None:
        """Run a feedback step if the interval elapsed (the timer hook of
        a node where no compaction is currently paying `acquire`)."""
        with self._lock:
            self._feedback_locked(self._clock())

    # ---- cluster stagger ------------------------------------------------

    def heavy_allowed(self) -> bool:
        """May an env-triggered (heavy) compaction start NOW? True when
        no coordinator has ever answered or the lease is live and
        granted; an expired lease fails open."""
        g = self._grant
        if g is None:
            return True
        granted, expires = g
        if self._clock() > expires:
            return True
        return granted

    def set_cluster_grant(self, granted: bool) -> None:
        lease = float(FLAGS.get("pegasus.storage", "compact_grant_lease_s"))
        self._grant = (bool(granted), self._clock() + lease)

    def note_deferred(self) -> None:
        """An env trigger found heavy_allowed() False and deferred to the
        next delivery: record the demand so the node asks for a slot."""
        self._heavy_waiting = True
        self.defer_count += 1
        self._c_defer.increment()

    def begin_heavy(self) -> None:
        self._heavy_waiting = False
        with self._lock:
            self.heavy_running += 1

    def end_heavy(self) -> None:
        with self._lock:
            self.heavy_running = max(0, self.heavy_running - 1)

    # ---- observability --------------------------------------------------

    def report(self) -> dict:
        """The node's compaction block of a cluster report."""
        return {
            "running": self.heavy_running,
            "waiting": bool(self._heavy_waiting),
            "bytes_per_s": int(self.rate_bps),
        }


GOVERNOR = CompactionGovernor()
