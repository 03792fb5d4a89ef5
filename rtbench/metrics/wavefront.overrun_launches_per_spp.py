"""Steps the wavefront driver queued on a pass whose own runnable count,
read after them, ended the pass's phase (``wavefront.OVERRUN_LAUNCHES``),
per sample of every pixel over the traced sub-window. A program without
that counter (one that read each count before queueing the step) gives the
reader no counters to list, and the reader reads nothing."""

import importlib

from rtbench.metrics._common import per_spp

MODULE, ATTR = "raytrace2_tpu_torch.ops.kernels.wavefront", "OVERRUN_LAUNCHES"
COUNTERS = (f"{MODULE}.{ATTR}",) if hasattr(importlib.import_module(MODULE), ATTR) else ()


def read(run):
    return per_spp(run, COUNTERS[0]) if COUNTERS else None
