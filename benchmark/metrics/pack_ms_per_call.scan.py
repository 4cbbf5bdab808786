"""Wall of the page-packing stages a client_scan_multi message:
pegasus.scan.prepare (live masks and windows), .pack (the native
serve_batch call) and .assemble (responses, numpy re-serves of arena
overflows, accounting)."""

from benchmark.core.stages import stage_ms_per_call


def read(run):
    return stage_ms_per_call(run, ["pegasus.scan.prepare",
                                   "pegasus.scan.pack",
                                   "pegasus.scan.assemble"])
