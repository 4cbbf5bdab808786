"""Wall of the stage pegasus.scan.overlay (finish_scan_batch's merge of
memtable and L0 rows into the windows they fall in) a client_scan_multi
message."""

from benchmark.core.stages import stage_ms_per_call


def read(run):
    return stage_ms_per_call(run, ["pegasus.scan.overlay"])
