"""The scan kernel's share of its roofline over the traced window: the
bytes each table launch needs (roofline/arith.table_bytes of the
launch's shape) at the card's HBM rate, over the device time of the
kernels named scan_table_kernel in the torch.profiler trace. The bound
is the bytes one: the kernel's operations per record are data-dependent
and are not counted, so the share is a floor of the true one."""

from benchmark.roofline.arith import HBM_BYTES_PER_S, table_bytes

KERNEL = "scan_table_kernel"


def read(run):
    if not run.launch_shapes or not run.trace:
        return None
    device_s = sum(s for name, s in run.trace["device_s_by_name"].items()
                   if KERNEL in name)
    if device_s <= 0:
        return None
    nbytes = sum(table_bytes(**shape) for shape in run.launch_shapes)
    return 100.0 * nbytes / HBM_BYTES_PER_S / device_s
