"""95th percentile over the window's scans of the wall of the
scan_multi call that carried each (the harness's clock)."""

from benchmark.core.stats import request_percentile


def read(run):
    walls = run.walls.get("scan")
    return request_percentile(walls, 95) if walls else None
