"""Perfect failure detector: beacon protocol with lease / grace asymmetry.

Parity: src/failure_detector/failure_detector.h:79-121 and
src/meta/meta_server_failure_detector.h:64. The invariant that makes the
FD "perfect" (never splits authority): the worker's lease period is
SHORTER than the master's grace period, so a worker that cannot refresh
its lease stops serving BEFORE the master declares it dead and reassigns
its partitions. Clocks only need bounded drift, not synchrony.

Master side (here): record each worker's last beacon; `check(now)`
returns workers whose grace expired. Worker side: ReplicaStub sends
beacons; a worker whose lease expired must consider itself disconnected
(`worker_lease_valid`).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

# defaults mirror the reference's config shape (check_interval 2s,
# beacon every 3s, lease 9s, grace 10s in config.min.ini terms)
DEFAULT_BEACON_INTERVAL = 3.0
DEFAULT_LEASE = 9.0
DEFAULT_GRACE = 10.0


class FailureDetector:
    """Master-side FD state."""

    def __init__(self, grace_seconds: float = DEFAULT_GRACE,
                 on_worker_dead: Optional[Callable[[str], None]] = None,
                 on_worker_alive: Optional[Callable[[str], None]] = None
                 ) -> None:
        self.grace = grace_seconds
        self._last_beacon: Dict[str, float] = {}
        self._alive: Dict[str, bool] = {}
        self.on_worker_dead = on_worker_dead
        self.on_worker_alive = on_worker_alive

    def on_beacon(self, worker: str, now: float) -> None:
        self._last_beacon[worker] = now
        if not self._alive.get(worker, False):
            self._alive[worker] = True
            if self.on_worker_alive is not None:
                self.on_worker_alive(worker)

    def check(self, now: float) -> List[str]:
        """Declare workers dead whose grace expired; returns newly dead."""
        newly_dead = []
        for worker, last in self._last_beacon.items():
            if self._alive.get(worker, False) and now - last > self.grace:
                self._alive[worker] = False
                newly_dead.append(worker)
                if self.on_worker_dead is not None:
                    self.on_worker_dead(worker)
        return newly_dead

    def is_alive(self, worker: str) -> bool:
        return self._alive.get(worker, False)

    def alive_workers(self) -> List[str]:
        return sorted(w for w, a in self._alive.items() if a)


def worker_lease_valid(last_ack: float, now: float,
                       lease_seconds: float = DEFAULT_LEASE) -> bool:
    """Worker-side self-check: serving is only allowed under a valid lease
    (lease < grace makes the detector 'perfect')."""
    return now - last_ack <= lease_seconds
