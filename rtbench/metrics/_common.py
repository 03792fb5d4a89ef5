"""Shared arithmetic of the per-layer metric readers."""

from __future__ import annotations


def idle_pct(run) -> float | None:
    """The traced sub-window's share in which no operation ran on the card."""
    s = run.trace_summary
    if not s or s["window_s"] <= 0 or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def per_spp(run, counter: str) -> float | None:
    """A program counter's change over the traced sub-window per sample of
    every pixel rendered in it; None where it did not move."""
    s, work = run.trace_summary, run.traced_work
    if not s or not work or not work["spp"]:
        return None
    delta = s["counters"].get(counter, 0)
    return delta / work["spp"] if delta else None
