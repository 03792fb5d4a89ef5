"""The wavefront driver's own host time per launch of ``wavefront_step``:
its spans (``wavefront.setup``, ``.runnable``, ``.sort``, ``.launch``,
``.unpermute``) less the sync waits made inside them, over
``wavefront.LAUNCHES``' change, in ms."""

from rtbench.metrics._spans import busy_ms, counters

SPANS = ("wavefront.setup", "wavefront.runnable", "wavefront.sort", "wavefront.launch",
         "wavefront.unpermute")
COUNTERS = counters(*SPANS, launches=True)


def read(run):
    return busy_ms(run, COUNTERS, SPANS, per="launches")
