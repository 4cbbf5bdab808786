"""Wall of the merge path's stage pegasus.merge.rows (survivors' user
data and the page's KeyValue assembly) a client_scan_multi message."""

from benchmark.core.stages import stage_ms_per_call


def read(run):
    return stage_ms_per_call(run, ["pegasus.merge.rows"])
