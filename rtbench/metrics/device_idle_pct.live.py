"""Device idle share over the traced sub-window (torch.profiler): 1 - the
union of device activity over the sub-window, in percent."""

from rtbench.metrics._common import idle_pct


def read(run):
    return idle_pct(run)
