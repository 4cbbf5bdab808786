"""Milliseconds the bulk compaction pipeline's filter stage spent blocked
on its neighbour's queue (StorageEngine.last_pipeline.filter_stall_ms,
summed over the partitions of every timed pass), a GB of input."""


def read(run):
    if not run.bytes_in:
        return None
    return run.counters["compact_stall_ms"]["filter"] / (run.bytes_in / 1e9)
