"""Scan-kernel launches (ops/fused_scan.LAUNCHES: static, now and multi;
the keyhash count is an attribute of those launches) a thousand scans
answered in the window."""


def read(run):
    scans = run.done.get("scan", 0)
    if not scans:
        return None
    n = run.counters["scan_launches"]
    return 1000.0 * (n["static"] + n["now"] + n["multi"]) / scans
