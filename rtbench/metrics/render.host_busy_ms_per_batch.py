"""The host's own time in ``Renderer.update`` per traced batch: the
program's span ``render.update`` less the sync waits made inside it, in ms."""

from rtbench.metrics._spans import busy_ms, counters

SPANS = ("render.update",)
COUNTERS = counters(*SPANS)


def read(run):
    return busy_ms(run, COUNTERS, SPANS)
