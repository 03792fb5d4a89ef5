"""The host's wait for the card in the wavefront driver's read of the
runnable count (the sync waits inside ``wavefront.runnable``) per launch of
``wavefront_step``, in ms."""

from rtbench.metrics._spans import counters, wait_ms_per_launch

SPAN = "wavefront.runnable"
COUNTERS = counters(SPAN, launches=True)


def read(run):
    return wait_ms_per_launch(run, COUNTERS, SPAN)
