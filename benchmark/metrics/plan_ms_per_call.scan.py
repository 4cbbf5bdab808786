"""Wall of the task profiler's stage pegasus.scan.plan (the batched
path's plan_scan_batch calls) a client_scan_multi message."""

from benchmark.core.stages import stage_ms_per_call


def read(run):
    return stage_ms_per_call(run, ["pegasus.scan.plan"])
