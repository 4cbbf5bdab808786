"""Wall of the stage pegasus.scan.mask_eval (the batched path's missing
static masks: blocks uploaded, the scan kernel launched, the masks
copied back, unpacked and stored) a client_scan_multi message."""

from benchmark.core.stages import stage_ms_per_call


def read(run):
    return stage_ms_per_call(run, ["pegasus.scan.mask_eval"])
