"""The share of the client_scan_multi handler's exec wall that none of
its leaf stages (pegasus.stub.*, pegasus.scan.*, pegasus.merge.*)
covers."""

from benchmark.core.stages import untraced_pct


def read(run):
    return untraced_pct(run)
