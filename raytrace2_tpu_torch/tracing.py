"""Spans at the renderer's layer boundaries and a counter of host syncs.

``span(name, unit=None)`` marks a layer's work. While no ``torch.profiler``
records, it is a shared no-op behind one check. While one records (a
benchmark's traced window, ``app.py --profile``), it enters
``torch.profiler.record_function(name)``, so the span lands in the trace
beside the CUDA kernels, on their clock, and it adds its nanoseconds and
the nanoseconds of the ``sync`` calls made while it was open to per-name
totals. ``unit`` (a dict) identifies the unit of work a top span opens: the
batch's seed and first sample, the gradient step's seed. The exported trace
drops a ``record_function``'s args, so the unit rides the span's own name in
the trace, ``<name>#<key>=<value>,...``; its totals stay under ``name``.

``sync(t, site, ...)`` is the one way the renderer reads a tensor on its
device from the host or copies one there from pageable memory: each call is
a stream synchronisation on the card. It always adds 1 to ``HOST_SYNCS``,
as the kernels' wrappers count their launches, on the CPU too, so that the
same call sites count on either device. Under a recording profiler it opens
the span ``sync.<site>``, whose time is the host's wait.

Totals are read by dotted path as plain ints, ``tracing.HOST_SYNCS`` and, per
span, ``tracing.NS_<key>`` and ``tracing.SYNC_NS_<key>``, where the key is
the span's name with ``.`` written ``_`` (``NS_render_update``). A documented
span that has not run reads 0.

Spans (``SPANS``), each at one layer's boundary:

* renderer (``render.py``): ``render.update`` (a batch: seed and first
  sample), ``render.accumulate``, ``render.display`` (the u8 image and its
  readback);
* integrator, kernel path (``ops/integrator.py``): ``integrator.camv`` (the
  camera frame and ``camv``, with their reads), ``integrator.pack`` (the
  tables packed for a batch or a gradient step, the noise tables),
  ``integrator.launch`` (the route's launch: v4's wrapper, or the wavefront
  driver);
* wavefront driver (``ops/kernels/wavefront.py``): ``wavefront.setup``
  (``camv``'s values, the scene bounds, the slot state), ``wavefront.runnable``
  (the runnable count read before each launch), ``wavefront.sort``,
  ``wavefront.launch``, ``wavefront.unpermute``;
* gradient (``grad.py``, ``ops/kernels/megakernel_grad.py``):
  ``grad.value_and_grad`` (a step: its seed), ``grad.params``,
  ``grad.forward``, ``grad.backward`` (``torch.autograd.grad``),
  ``grad.replay`` (the replay kernel's wrapper, inside the backward),
  ``grad.tree``.

Sites of ``sync`` (``SITES``): ``camera`` (a camera leaf read for the
frame), ``frame`` (the frame copied to the device for the non-kernel
path's rays), ``camv`` (``camv`` copied to the device), ``camv_values`` (the
wavefront driver's read of ``camv``), ``runnable``, ``display``, ``linear``
(the linear image read back), ``mat_types`` (the material types, once per
scene tensor), ``slots`` (the block-tiled layout's slot map copied to the
device), ``bvh`` (the threaded BVH built on the host), ``alive`` (the
non-kernel path's live-ray count), and ``camera_grad``, ``frame_grad``,
``camv_grad``: the copies back of their gradients in autograd's backward.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

SPANS = ("render.update", "render.accumulate", "render.display",
         "integrator.camv", "integrator.pack", "integrator.launch",
         "wavefront.setup", "wavefront.runnable", "wavefront.sort", "wavefront.launch",
         "wavefront.unpermute",
         "grad.value_and_grad", "grad.params", "grad.forward", "grad.backward", "grad.replay",
         "grad.tree")
SITES = ("camera", "frame", "camv", "camv_values", "runnable", "display", "linear",
         "mat_types", "slots", "bvh", "alive", "camera_grad", "frame_grad", "camv_grad")

# Host syncs made through ``sync``, on any device, profiler or not.
HOST_SYNCS = 0

_recording = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()
# Read-modify-writes of the totals: autograd's backward runs on a thread of
# its own per device.
_LOCK = threading.Lock()
# The spans open on any thread: a sync's wait counts in each of them.
_OPEN: list = []
# Span key -> [ns, sync_ns].
_TOTALS: dict = {}
_DOCUMENTED = frozenset(n.replace(".", "_") for n in
                        SPANS + tuple("sync." + s for s in SITES))


def key(name: str) -> str:
    """The attribute key of span ``name``: ``render.update`` -> ``render_update``."""
    return name.replace(".", "_")


class _Span:
    __slots__ = ("key", "is_sync", "waited", "t0", "rf")

    def __init__(self, name: str, unit, is_sync: bool = False):
        self.key, self.is_sync, self.waited = key(name), is_sync, 0
        if unit is not None:
            name += "#" + ",".join(f"{k}={v}" for k, v in unit.items())
        self.rf = torch.profiler.record_function(name)

    def __enter__(self):
        self.rf.__enter__()
        _OPEN.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        _OPEN.remove(self)
        with _LOCK:
            if self.is_sync:
                self.waited = ns
                for other in _OPEN:
                    other.waited += ns
            tot = _TOTALS.setdefault(self.key, [0, 0])
            tot[0] += ns
            tot[1] += self.waited
        self.rf.__exit__(*exc)
        return False


def span(name: str, unit: dict | None = None):
    """A context manager marking ``name``'s work (see the module doc);
    ``unit`` identifies the unit of work a top span opens."""
    if not _recording():
        return _NULL
    return _Span(name, unit)


class _Copy(torch.autograd.Function):
    """A counted copy whose backward copies the gradient back through
    ``sync`` (autograd's own backward of a copy makes the same copy)."""

    @staticmethod
    def forward(ctx, t, device, site):
        ctx.src, ctx.site = t.device, site
        out = t.to(device)
        return out.view_as(out) if out is t else out

    @staticmethod
    def backward(ctx, g):
        return sync(g, ctx.site + "_grad", device=ctx.src), None, None


def _do(t, read, device, site):
    if read is not None:
        return read(t)
    if t.requires_grad and torch.is_grad_enabled():
        return _Copy.apply(t, device, site)
    return t.to(device)


def sync(t: torch.Tensor, site: str, read=None, *, device="cpu"):
    """One host round trip of ``t``, counted in ``HOST_SYNCS`` (and under a
    recording profiler timed as the span ``sync.<site>``): ``read(t)``
    (``int``, ``torch.Tensor.tolist``, ...) where ``read`` is given, else
    ``t`` copied to ``device`` (the host by default). A copy of a tensor
    that requires grad stays in autograd's graph, and its backward's copy
    back counts as one more sync (site ``<site>_grad``)."""
    global HOST_SYNCS
    with _LOCK:
        HOST_SYNCS += 1
    if not _recording():
        return _do(t, read, device, site)
    with _Span("sync." + site, None, is_sync=True):
        return _do(t, read, device, site)


def __getattr__(attr: str) -> int:
    for prefix, i in (("SYNC_NS_", 1), ("NS_", 0)):
        if attr.startswith(prefix):
            name = attr[len(prefix):]
            if name in _TOTALS:
                return _TOTALS[name][i]
            if name in _DOCUMENTED:
                return 0
            break
    raise AttributeError(f"module {__name__!r} has no attribute {attr!r}")
