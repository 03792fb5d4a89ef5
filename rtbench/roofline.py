"""The yardstick of the roofline shares: the card's peaks and the
operations and bytes that a render's inputs need.

Operations are counted per path segment (one bounce: a closest hit and a
shading) from the family of the record the segment ended on, which the
reference's trace of the sampled pixels gives (``pathtrace.FAMILIES``):
one shading, and one test of the record that was hit; a gradient replay
adds the adjoint of the segment. The counts are the least the estimator
needs, whatever sweep a kernel runs, so a kernel that tests fewer records
is not credited with less work. Bytes are the scene's tables read once and
the launch's output written once. The share is a lower bound.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores (an FMA
# counts two operations), and HBM3 bandwidth; both at the 700 W limit.
PEAK_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# f32 operations: the shading of one bounce, one test of each record
# family, and the gradient replay's adjoint of one segment.
OPS_SHADE = 120
OPS_TEST = {"sphere": 35, "quad": 46, "box": 28, "medium": 85, "miss": 0}
OPS_ADJOINT = 60


def segment_ops(segments: dict, adjoint: bool = False) -> float:
    """Operations of ``segments`` ({family: count})."""
    per = OPS_SHADE + (OPS_ADJOINT if adjoint else 0)
    return float(sum(n * (per + OPS_TEST[fam]) for fam, n in segments.items()))


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the peak bandwidth."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)


def share_pct(ops: float, nbytes: float, device_seconds: float) -> float | None:
    """Least time over the device time, in percent (None without time)."""
    if device_seconds <= 0 or ops <= 0:
        return None
    return 100.0 * least_seconds(ops, nbytes) / device_seconds


def kernel_share(run, kernel: str, adjoint: bool = False) -> float | None:
    """``kernel``'s share of its roofline over the traced sub-window of
    ``run``: the work of the traced units (``run.traced_work``: segments by
    family, and per unit the tables read and the output written once) over
    the kernel's device time in the trace. None where the kernel did not
    run."""
    summary, work = run.trace_summary, run.traced_work
    if not summary or not work:
        return None
    seconds = summary["kernels"].get(kernel, 0.0)
    ops = segment_ops(work["segments"], adjoint)
    nbytes = work["units"] * (work["table_bytes"] + work["output_bytes"])
    return share_pct(ops, nbytes, seconds)

