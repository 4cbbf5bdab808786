"""Duplication-shipping governor: AIMD backpressure for geo-replication
catch-up.

Taurus (PAPERS.md) shows log-shipping replication must be batched AND
flow-controlled to survive real links; RESYSTANCE shows unmanaged
background transfer wrecking foreground latency. This is the dup twin of
the PR 8 CompactionGovernor, closed from the FOLLOWER side: every
`dup_apply_batch` ack carries the follower node's foreground-pressure
counters (the PR 2 `deadline_expired_count` + `read_shed_count` pair),
and the source node's governor turns growth into a multiplicative
backoff of the ship-window byte budget. Catch-up therefore slows BEFORE
the follower sheds its own foreground load, recovers multiplicatively
once acks come back quiet, and never throttles below a forward-progress
floor — the duplicator always loads at least one mutation per tick, so
catch-up cannot stall however hard the link is squeezed (a stalled dup
pins the log-GC floor forever, which eventually hurts more than the
bandwidth it frees).

One governor per NODE (all of a stub's dup sessions share the WAN
egress), clocked on the stub's sim clock so seeded schedules replay.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from pegasus_tpu_torch.utils.flags import FLAGS, define_flag
from pegasus_tpu_torch.utils.metrics import METRICS

define_flag("pegasus.dup", "ship_max_mbps", 0.0,
            "hard duplication-shipping bandwidth cap in MB/s; 0 = "
            "uncapped until follower pressure engages the AIMD backoff",
            mutable=True)
define_flag("pegasus.dup", "ship_min_mbps", 0.25,
            "floor the follower-pressure backoff never throttles below "
            "— catch-up must keep making forward progress (the window "
            "additionally always carries at least one mutation, so a "
            "zero byte budget cannot stall shipping)", mutable=True)
define_flag("pegasus.dup", "ship_governor", True,
            "enable AIMD backpressure on duplication shipping fed by "
            "the follower pressure counters riding each batch ack",
            mutable=True)
define_flag("pegasus.dup", "ship_feedback_interval_s", 1.0,
            "minimum seconds between multiplicative recovery steps on "
            "quiet acks (backoff reacts to every pressure growth "
            "immediately; recovery is paced)", mutable=True)


class DupGovernor:
    """Per-node ship-budget pacer. The duplicator asks `window_budget()`
    before loading a ship window and reports `note_shipped()` wire
    bytes; acks feed `on_follower_pressure()`."""

    RECOVER_FACTOR = 1.5
    UNCAP_FACTOR = 2.0

    def __init__(self, node: str,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self._clock = clock or time.monotonic
        # MB/s currently enforced; 0 = uncapped. Like the compaction
        # governor, an OPERATOR cap (ship_max_mbps) is permanent while a
        # PRESSURE-engaged cap recovers back to uncapped.
        self._throttle_mbps = 0.0
        self._engaged_at_mbps = 0.0
        self._tokens = 0.0
        self._tok_t = self._clock()
        self._recover_t = self._clock()
        # last observed cumulative pressure per follower node
        self._pressure: Dict[str, int] = {}
        # measured recent ship rate (1s windows -> gauge)
        self._win_t = self._clock()
        self._win_bytes = 0
        self._rate_bps = 0.0
        ent = METRICS.entity("duplication", node, {"node": node})
        self._g_throttle = ent.gauge("dup_throttle_mbps")
        self._g_rate = ent.gauge("dup_ship_bytes_per_s")
        self._c_backoff = ent.counter("dup_backoff_count")

    @staticmethod
    def enabled() -> bool:
        return bool(FLAGS.get("pegasus.dup", "ship_governor"))

    # ---- feedback (rides every dup_apply_batch ack) --------------------

    def on_follower_pressure(self, follower: str,
                             counters: Optional[dict]) -> None:
        if not counters or not self.enabled():
            return
        total = (int(counters.get("deadline_expired", 0))
                 + int(counters.get("read_shed", 0)))
        prev = self._pressure.get(follower)
        self._pressure[follower] = total
        if prev is None:
            return
        now = self._clock()
        min_mbps = float(FLAGS.get("pegasus.dup", "ship_min_mbps"))
        max_mbps = float(FLAGS.get("pegasus.dup", "ship_max_mbps"))
        if total > prev:
            # the follower is shedding/expiring foreground work: halve
            # the allowance (engaging a cap at half the measured recent
            # ship rate when previously uncapped)
            cur = self._throttle_mbps
            if cur == 0:
                cur = max(self._rate_bps / 1e6, min_mbps * 2)
                self._engaged_at_mbps = cur
            self._throttle_mbps = max(cur / 2, min_mbps)
            self._c_backoff.increment()
            self._g_throttle.set(self._throttle_mbps)
            self._recover_t = now
            return
        # quiet ack: multiplicative recovery, paced to the feedback
        # interval so a burst of acks does not undo a backoff at once
        cur = self._throttle_mbps
        if cur == 0:
            return
        if now - self._recover_t < float(
                FLAGS.get("pegasus.dup", "ship_feedback_interval_s")):
            return
        self._recover_t = now
        cur *= self.RECOVER_FACTOR
        if max_mbps > 0:
            self._throttle_mbps = min(cur, max_mbps)
        elif self._engaged_at_mbps > 0 and \
                cur >= self._engaged_at_mbps * self.UNCAP_FACTOR:
            self._throttle_mbps = 0.0  # fully recovered: uncap
            self._engaged_at_mbps = 0.0
        else:
            self._throttle_mbps = cur
        self._g_throttle.set(self._throttle_mbps)

    # ---- budget (asked once per dup tick per session) ------------------

    def window_budget(self) -> Optional[int]:
        """Bytes the next ship window may load; None = uncapped. The
        CALLER applies the forward-progress floor (a window always
        carries at least one mutation, whatever this returns)."""
        if not self.enabled():
            return None
        max_mbps = float(FLAGS.get("pegasus.dup", "ship_max_mbps"))
        if self._throttle_mbps == 0 and max_mbps > 0:
            self._throttle_mbps = max_mbps  # operator cap always on
        rate = self._throttle_mbps
        if rate <= 0:
            return None
        now = self._clock()
        bps = rate * 1e6
        # token bucket with a 1s burst allowance; the floor mutation may
        # drive tokens negative (an envelope is atomic) — debt is capped
        # so one oversized window cannot stall shipping for minutes
        self._tokens = min(self._tokens + (now - self._tok_t) * bps,
                           bps * 1.0)
        self._tok_t = now
        return max(0, int(self._tokens))

    def note_shipped(self, nbytes: int) -> None:
        now = self._clock()
        bps = max(self._throttle_mbps, 0.001) * 1e6
        self._tokens = max(self._tokens - nbytes, -bps * 2.0)
        self._win_bytes += nbytes
        dt = now - self._win_t
        if dt >= 1.0:
            self._rate_bps = self._win_bytes / dt
            self._g_rate.set(int(self._rate_bps))
            self._win_t = now
            self._win_bytes = 0

    # ---- observability --------------------------------------------------

    def status(self) -> dict:
        return {
            "throttle_mbps": round(self._throttle_mbps, 3),
            "ship_bytes_per_s": int(self._rate_bps),
            "backoff_count": self._c_backoff.value(),
            "followers_observed": sorted(self._pressure),
        }
