"""Host syncs of the program (``tracing.HOST_SYNCS``) per traced gradient
step: the forward's camera reads and ``camv`` copy, and their gradients'
copies back in autograd's backward."""

from rtbench.metrics._spans import counters, syncs_per

COUNTERS = counters(syncs=True)


def read(run):
    return syncs_per(run, COUNTERS, "units")
