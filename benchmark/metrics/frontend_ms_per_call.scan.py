"""The front end's share of a scan_multi call: its wall less the exec
wall of the node's client_scan_multi handler (utils/profiler), a call."""

from benchmark.core.stats import frontend_ms_per_call


def read(run):
    return frontend_ms_per_call(run, "scan", "client_scan_multi")
