"""Launches of the compaction filter kernel in the timed passes
(ops/fused_compaction.LAUNCHES: compaction_filter_kernel, and
slot_gate_kernel under "slot_gate_columns"), a GB of input."""


def read(run):
    if not run.bytes_in:
        return None
    n = run.counters["compaction_launches"]
    return (n.get("compaction", 0) + n.get("slot_gate_columns", 0)) \
        / (run.bytes_in / 1e9)
