"""Wall of the stub's own stages a client_scan_multi message:
pegasus.stub.gate (the per-partition gates before scan_multi) and
pegasus.stub.reply (the reply built and sent)."""

from benchmark.core.stages import stage_ms_per_call


def read(run):
    return stage_ms_per_call(run, ["pegasus.stub.gate", "pegasus.stub.reply"])
