"""Launches of the wavefront driver's keys kernel
(``wavefront.KEY_LAUNCHES``) per sample of every pixel over the traced
sub-window. A program without that counter (before the keys kernel) gives
the reader no counters to list, and the reader reads nothing."""

import importlib

from rtbench.metrics._common import per_spp

MODULE, ATTR = "raytrace2_tpu_torch.ops.kernels.wavefront", "KEY_LAUNCHES"
COUNTERS = (f"{MODULE}.{ATTR}",) if hasattr(importlib.import_module(MODULE), ATTR) else ()


def read(run):
    return per_spp(run, COUNTERS[0]) if COUNTERS else None
