"""The host's own time in ``value_and_grad_scene`` per traced step: the
program's span ``grad.value_and_grad`` less the sync waits made while it
was open, in ms."""

from rtbench.metrics._spans import busy_ms, counters

SPANS = ("grad.value_and_grad",)
COUNTERS = counters(*SPANS)


def read(run):
    return busy_ms(run, COUNTERS, SPANS)
