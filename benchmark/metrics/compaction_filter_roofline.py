"""The compaction filter kernel's share of its roofline over the traced
passes: the bytes each launch needs (roofline/compaction.filter_bytes
of the launch's shape) at the card's HBM rate, over the device time of
the kernels named compaction_filter_kernel or slot_gate_kernel in the
torch.profiler trace. The bound is the bytes one: the filter's integer
operations a row are fewer than its bytes allow at the card's scalar
rate, so the bytes bound it."""

from benchmark.roofline.arith import HBM_BYTES_PER_S
from benchmark.roofline.compaction import filter_bytes

KERNELS = ("compaction_filter_kernel", "slot_gate_kernel")


def read(run):
    if not run.launch_shapes or not run.trace:
        return None
    device_s = sum(s for name, s in run.trace["device_s_by_name"].items()
                   if any(k in name for k in KERNELS))
    if device_s <= 0:
        return None
    nbytes = sum(filter_bytes(**shape) for shape in run.launch_shapes)
    return 100.0 * nbytes / HBM_BYTES_PER_S / device_s
