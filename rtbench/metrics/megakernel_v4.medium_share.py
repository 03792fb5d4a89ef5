"""The share of v4's path segments that ended in a medium scatter
(``megakernel.MEDIUM_SCATTERS`` over ``megakernel.SEGMENTS``, both counted
on the device while a profiler records) over the traced sub-window. A
program without those counters gives the reader no counters to list, and
the reader reads nothing."""

import importlib

MODULE, ATTRS = "raytrace2_tpu_torch.ops.kernels.megakernel", ("MEDIUM_SCATTERS", "SEGMENTS")
_mk = importlib.import_module(MODULE)
COUNTERS = tuple(f"{MODULE}.{a}" for a in ATTRS) if all(hasattr(_mk, a) for a in ATTRS) \
    else ()


def read(run):
    s = run.trace_summary
    if not COUNTERS or not s:
        return None
    scatters, segments = (s.get("counters", {}).get(c, 0) for c in COUNTERS)
    return scatters / segments if segments else None
