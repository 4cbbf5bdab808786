"""Arithmetic the metric readers share."""

from __future__ import annotations

import numpy as np


def request_percentile(walls: list, q: float) -> float:
    """The q-th percentile over requests of the wall of the call that
    carried each: `walls` holds (wall_s, requests) a call. Milliseconds."""
    w = np.repeat([x for x, _n in walls], [n for _x, n in walls])
    return float(np.percentile(w, q)) * 1e3


def calls_wall_s(walls: list) -> float:
    return float(sum(x for x, _n in walls))


def idle_pct(run):
    """100 less the device's busy share of the traced window."""
    if not run.trace or run.trace_window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace_window_s)


def frontend_ms_per_call(run, kind: str, message: str):
    """The wall of a kind's calls less the exec wall of the node's
    handler of their message, per call."""
    walls = run.walls.get(kind)
    if not walls or message not in run.exec_ms:
        return None
    return (calls_wall_s(walls) * 1e3 - run.exec_ms[message]) / len(walls)


def exec_ms_per(run, message: str, per: int):
    if message not in run.exec_ms or not per:
        return None
    return run.exec_ms[message] / per
