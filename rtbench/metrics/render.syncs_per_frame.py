"""Host syncs of the program (``tracing.HOST_SYNCS``: every read of a
device tensor and copy from pageable memory made through ``tracing.sync``)
per traced frame: the frame's update and its display read back."""

from rtbench.metrics._spans import counters, syncs_per

COUNTERS = counters(syncs=True)


def read(run):
    return syncs_per(run, COUNTERS, "units")
