"""Host syncs of the program (``tracing.HOST_SYNCS``) per sample of every
pixel over the traced sub-window: on the wavefront route the camera's, and
one read of the runnable count before each launch."""

from rtbench.metrics._spans import counters, syncs_per

COUNTERS = counters(syncs=True)


def read(run):
    return syncs_per(run, COUNTERS, "spp")
