"""The share of the camera frames that the program's host frame cache
served without reading the card (``camera.FRAME_HITS`` over
``FRAME_HITS + FRAME_MISSES``) over the traced sub-window. A program without
those counters (one that read the camera from the card every batch) gives
the reader no counters to list, and the reader reads nothing."""

import importlib

MODULE, ATTRS = "raytrace2_tpu_torch.ops.camera", ("FRAME_HITS", "FRAME_MISSES")
_camera = importlib.import_module(MODULE)
COUNTERS = tuple(f"{MODULE}.{a}" for a in ATTRS) if all(hasattr(_camera, a) for a in ATTRS) \
    else ()


def read(run):
    s = run.trace_summary
    if not COUNTERS or not s:
        return None
    hits, misses = (s.get("counters", {}).get(c, 0) for c in COUNTERS)
    return hits / (hits + misses) if hits + misses else None
