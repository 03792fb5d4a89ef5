"""The host's own time in a frame per traced frame: the program's spans
``render.update`` and ``render.display`` less the sync waits made inside
them, in ms. The benchmark's ``render.host_ms_per_frame`` (its host clock
around ``Renderer.update``) is this update's busy time plus its waits."""

from rtbench.metrics._spans import busy_ms, counters

SPANS = ("render.update", "render.display")
COUNTERS = counters(*SPANS)


def read(run):
    return busy_ms(run, COUNTERS, SPANS)
