"""Start of the process to the first timed request: imports, the kernel
build, the layout, the load, the compaction and the warm-up."""


def read(run):
    return run.setup_s
