"""Path segments that v4 traced (``megakernel.SEGMENTS``: its closest-hit
queries, one a bounce of a lane, counted on the device while a profiler
records) per traced path, a path being one sample of one pixel. A program
without that counter (before it had one) gives the reader no counters to
list, and the reader reads nothing."""

import importlib

MODULE, ATTR = "raytrace2_tpu_torch.ops.kernels.megakernel", "SEGMENTS"
COUNTERS = (f"{MODULE}.{ATTR}",) if hasattr(importlib.import_module(MODULE), ATTR) else ()


def read(run):
    s, work = run.trace_summary, run.traced_work
    if not COUNTERS or not s or not work or not work["spp"]:
        return None
    delta = s["counters"].get(COUNTERS[0], 0)
    return delta / (work["spp"] * run.n_pix) if delta else None
