"""The staged SST bytes of the window's compaction passes over the
passes' summed seconds (only the manual_compact calls are timed), in
units of 1e9 B/s."""


def read(run):
    if not run.window_s:
        return None
    return run.bytes_in / run.window_s / 1e9
