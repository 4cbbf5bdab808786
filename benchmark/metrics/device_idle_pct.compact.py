"""100 less the union of device activity over the traced compaction
passes (torch.profiler, each timed pass traced on its own)."""

from benchmark.core.stats import idle_pct


def read(run):
    return idle_pct(run)
