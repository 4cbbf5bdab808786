"""Wall of the merge path's stage pegasus.merge.validate (a candidate
block built and copied to the device, the scan kernel's `now` launch,
the status copied back) a client_scan_multi message."""

from benchmark.core.stages import stage_ms_per_call


def read(run):
    return stage_ms_per_call(run, ["pegasus.merge.validate"])
