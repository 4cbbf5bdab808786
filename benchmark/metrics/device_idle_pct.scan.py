"""100 less the union of device activity over the traced window
(torch.profiler), in a scan cell."""

from benchmark.core.stats import idle_pct


def read(run):
    return idle_pct(run)
