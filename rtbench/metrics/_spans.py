"""Shared arithmetic of the readers of the program's spans and host syncs
(``raytrace2_tpu_torch.tracing``): changes of its totals over the traced
sub-window, per traced unit (batch, frame, step), per sample of every pixel
or per wavefront launch. A program without that module (before it had
spans) gives a reader no counters to list, and the reader reads nothing."""

from __future__ import annotations

import importlib.util

MODULE = "raytrace2_tpu_torch.tracing"
LAUNCHES = "raytrace2_tpu_torch.ops.kernels.wavefront.LAUNCHES"


def _has_spans() -> bool:
    try:
        return importlib.util.find_spec(MODULE) is not None
    except ModuleNotFoundError:
        return False


def counters(*spans: str, syncs: bool = False, launches: bool = False) -> tuple:
    """The dotted paths a reader reads: ``HOST_SYNCS`` where ``syncs``, each
    span's nanoseconds and nested sync nanoseconds, and the wavefront's
    launches where ``launches``; none where the program has no spans."""
    if not _has_spans():
        return ()
    names = [f"{MODULE}.HOST_SYNCS"] if syncs else []
    for span in spans:
        key = span.replace(".", "_")
        names += [f"{MODULE}.NS_{key}", f"{MODULE}.SYNC_NS_{key}"]
    return tuple(names) + ((LAUNCHES,) if launches else ())


def _deltas(run, counters: tuple) -> dict | None:
    s = run.trace_summary
    if not counters or not s or not run.traced_work:
        return None
    got = s.get("counters", {})
    return got if all(c in got for c in counters) else None


def syncs_per(run, counters: tuple, per: str) -> float | None:
    """``HOST_SYNCS``' change over the traced sub-window per traced unit
    (``per="units"``) or per sample of every pixel (``per="spp"``)."""
    d = _deltas(run, counters)
    n = run.traced_work.get(per) if d is not None else None
    return d[f"{MODULE}.HOST_SYNCS"] / n if n else None


def busy_ms(run, counters: tuple, spans, per: str = "units") -> float | None:
    """The host's own time in ``spans`` (their nanoseconds less the sync
    waits made while they were open), in ms per traced unit or, with
    ``per="launches"``, per wavefront launch."""
    d = _deltas(run, counters)
    if d is None:
        return None
    n = d[LAUNCHES] if per == "launches" else run.traced_work.get(per)
    if not n:
        return None
    ns = sum(d[f"{MODULE}.NS_{k}"] - d[f"{MODULE}.SYNC_NS_{k}"]
             for k in (s.replace(".", "_") for s in spans))
    return ns / 1e6 / n


def wait_ms_per_launch(run, counters: tuple, span: str) -> float | None:
    """The sync waits made inside ``span``, in ms per wavefront launch."""
    d = _deltas(run, counters)
    if d is None or not d[LAUNCHES]:
        return None
    return d[f"{MODULE}.SYNC_NS_{span.replace('.', '_')}"] / 1e6 / d[LAUNCHES]
