"""The host's own time in the cluster tables' rebuild from the current
geometry (the program's span ``integrator.cluster``, inside the gradient
step's ``integrator.pack``) per traced step, in ms. A program without that
span (before it had one) gives the reader no counters to list, and the
reader reads nothing."""

import importlib

from rtbench.metrics._spans import MODULE, busy_ms, counters

SPANS = ("integrator.cluster",)


def _has_span() -> bool:
    try:
        return SPANS[0] in importlib.import_module(MODULE).SPANS
    except ModuleNotFoundError:
        return False


COUNTERS = counters(*SPANS) if _has_span() else ()


def read(run):
    return busy_ms(run, COUNTERS, SPANS)
