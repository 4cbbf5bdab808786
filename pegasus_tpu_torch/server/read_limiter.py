"""Range-read iteration budget.

Parity: src/server/range_read_limiter.h:37 — a range read (multi_get/
sortkey_count/scan) stops early when it has examined
FLAGS_rocksdb_max_iteration_count records or spent
FLAGS_rocksdb_iteration_threshold_time_ms; the handler then reports an
incomplete result the client resumes from.
"""

from __future__ import annotations

import time

from pegasus_tpu_torch.utils.flags import FLAGS, define_flag

define_flag("pegasus.server", "rocksdb_max_iteration_count", 1000,
            "max records examined by one ranged read", mutable=True)
define_flag("pegasus.server", "rocksdb_iteration_threshold_time_ms", 30_000,
            "max milliseconds for one ranged read (<=0: unlimited)",
            mutable=True)


class RangeReadLimiter:
    def __init__(self, clock_ns=None) -> None:
        """`clock_ns`: nanosecond time source (default wall
        perf_counter_ns). A partition hosted by a stub under a simulated
        loop passes its virtual clock, so a compressed schedule neither
        trips the budget spuriously nor never trips it."""
        self._max_count = FLAGS.get("pegasus.server",
                                    "rocksdb_max_iteration_count")
        self._threshold_ns = 1_000_000 * FLAGS.get(
            "pegasus.server", "rocksdb_iteration_threshold_time_ms")
        self._clock_ns = (clock_ns if clock_ns is not None
                          else time.perf_counter_ns)
        self._count = 0
        self._start_ns = self._clock_ns()

    def add_count(self, n: int = 1) -> None:
        self._count += n

    @property
    def iteration_count(self) -> int:
        """Records examined so far."""
        return self._count

    def remaining(self):
        """Records the count budget still allows (None: no count
        budget)."""
        if self._max_count <= 0:
            return None
        return max(0, self._max_count - self._count)

    def count_exceeded(self) -> bool:
        return self._max_count > 0 and self._count >= self._max_count

    def time_exceeded(self) -> bool:
        return (self._threshold_ns > 0 and
                self._clock_ns() - self._start_ns > self._threshold_ns)

    def valid(self) -> bool:
        return not self.count_exceeded() and not self.time_exceeded()
