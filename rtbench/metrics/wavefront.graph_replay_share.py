"""The wavefront driver's passes replayed from a CUDA graph
(``wavefront.GRAPH_REPLAYS``) over its launches of ``wavefront_step``
(``wavefront.LAUNCHES``), both changes over the traced sub-window. A
program without that counter (one that launched every pass's sort and
step eagerly) gives the reader no counters to list, and the reader reads
nothing."""

import importlib

MODULE = "raytrace2_tpu_torch.ops.kernels.wavefront"
COUNTERS = ((f"{MODULE}.GRAPH_REPLAYS", f"{MODULE}.LAUNCHES")
            if hasattr(importlib.import_module(MODULE), "GRAPH_REPLAYS") else ())


def read(run):
    s = run.trace_summary
    if not COUNTERS or not s:
        return None
    replays, launches = (s["counters"].get(c, 0) for c in COUNTERS)
    return replays / launches if launches else None
