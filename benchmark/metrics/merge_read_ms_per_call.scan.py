"""Wall of the merge path's stage pegasus.merge.read (pulling predicate
batches from engine.iterate) a client_scan_multi message."""

from benchmark.core.stages import stage_ms_per_call


def read(run):
    return stage_ms_per_call(run, ["pegasus.merge.read"])
