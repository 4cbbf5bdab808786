"""Fail points: named code-site fault-injection hooks.

Parity: src/utils/fail_point.h:47,87 — FAIL_POINT_INJECT_F sites that tests
configure to return a value, raise, or delay; off by default with zero
overhead on the hot path. Used pervasively in the reference's replica and
server code (e.g. src/replica/replication_app_base.cpp:289).

The port's copy of the JAX package's utils/fail_point.py, its imports rewritten to
pegasus_tpu_torch (it imports nothing of that package).
"""

from __future__ import annotations

import random
import re
import threading
import time
from typing import Any, Callable, Dict, Optional

_SENTINEL = object()

# '<N>%action(arg)' — the reference's probabilistic frequency prefix
# (fail_point.h parses "25%return(ok)"; N may be fractional)
_FREQ_RE = re.compile(r"^(\d+(?:\.\d+)?)%(.+)$")


class _FailPointRegistry:
    def __init__(self) -> None:
        self._actions: Dict[str, Callable[[str], Any]] = {}
        self._enabled = False
        self._lock = threading.Lock()
        # seedable RNG for the probabilistic '<N>%...' actions: chaos
        # runs replay from their seed (parity: the reference threads one
        # seeded env through the simulator's fault decisions)
        self._rng = random.Random(0)

    def setup(self) -> None:
        self._enabled = True

    @property
    def enabled(self) -> bool:
        return self._enabled

    def teardown(self) -> None:
        with self._lock:
            self._actions.clear()
        self._enabled = False
        self._rng = random.Random(0)

    def seed(self, seed: int) -> None:
        """Re-seed the probabilistic-action RNG (reproducible chaos)."""
        with self._lock:
            self._rng = random.Random(seed)

    def rand(self) -> float:
        """One draw from the seeded chaos stream (under the registry
        lock — concurrent consumers must not tear or de-determinize
        it). Fault actions that need PARAMETERS beyond fire/don't-fire
        — which bit a vfs bit-flip corrupts, how much of a torn write
        survives — draw here so a whole chaos run replays from
        FAIL_POINTS.seed alone."""
        with self._lock:
            return self._rng.random()

    def cfg(self, name: str, action: str) -> None:
        """Configure an action string, mirroring the reference's mini-language:
        'off', 'return(<value>)', 'delay(<ms>)', 'raise(<msg>)', each
        optionally prefixed '<N>%' to fire with probability N/100 per
        inject (fail_point.h's frequency syntax), e.g. '25%raise(io)'.
        """
        with self._lock:
            if action == "off":
                self._actions.pop(name, None)
                return
            prob = 1.0
            m = _FREQ_RE.match(action)
            if m:
                prob = float(m.group(1)) / 100.0
                action = m.group(2)
            if action.startswith("return(") and action.endswith(")"):
                value = action[len("return("):-1]
                base = lambda _n, v=value: v  # noqa: E731
            elif action.startswith("delay(") and action.endswith(")"):
                ms = float(action[len("delay("):-1])
                def base(_n, ms=ms):
                    time.sleep(ms / 1000.0)
                    return _SENTINEL
            elif action.startswith("raise(") and action.endswith(")"):
                msg = action[len("raise("):-1]
                def base(_n, msg=msg):
                    raise RuntimeError(f"fail_point({_n}): {msg}")
            else:
                raise ValueError(f"unknown fail_point action: {action!r}")
            if prob >= 1.0:
                self._actions[name] = base
            else:
                def probabilistic(n, base=base, prob=prob):
                    # RNG draw under the registry lock: concurrent
                    # injects from many dispatcher threads must not
                    # corrupt (or de-determinize) the shared stream
                    with self._lock:
                        hit = self._rng.random() < prob
                    return base(n) if hit else _SENTINEL
                self._actions[name] = probabilistic

    def cfg_callable(self, name: str, fn: Callable[[str], Any]) -> None:
        with self._lock:
            self._actions[name] = fn

    def configured(self, name: str) -> bool:
        """Whether an action is configured for `name` — lets layers
        that wrap whole objects per fault domain (storage/vfs.py) skip
        the wrap when THEIR sites are idle even while the registry is
        enabled for someone else's (the network FaultPlan's)."""
        return name in self._actions

    def inject(self, name: str) -> Optional[Any]:
        """Returns None when the point is inactive; otherwise the configured
        return value (which callers interpret), or raises/delays."""
        if not self._enabled:
            return None
        fn = self._actions.get(name)
        if fn is None:
            return None
        result = fn(name)
        return None if result is _SENTINEL else result


FAIL_POINTS = _FailPointRegistry()


def fail_point(name: str) -> Optional[Any]:
    return FAIL_POINTS.inject(name)
