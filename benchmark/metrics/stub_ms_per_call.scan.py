"""Exec wall of the node's client_scan_multi handler (the stub, the
scan coordinator and the partition servers) a message."""

from benchmark.core.stats import exec_ms_per


def read(run):
    return exec_ms_per(run, "client_scan_multi",
                       run.exec_count.get("client_scan_multi", 0))
