"""Kernel-path integrator (port of the v4 branch of
``raytrace2_tpu/ops/integrator.py``: ``mega_schedule`` :314-343,
``_render_batch_megakernel`` :346-465, ``render_progressive`` :481-489).

Scenes with at most 256 sweep records render through the v4 kernel on the
linear slot layout with instant regeneration; larger ones (books 1 and 2)
through the sorted wavefront (``ops/kernels/wavefront.py``), whose K-bounce
kernel advances the slot state between Morton sorts. Scenes without kernel
sizes (ellipsoids, which need the non-kernel path) are not ported yet and
raise.

Feature knobs read here, named as in the JAX package: ``mega_wavefront``
forces the route either way; ``mega_k_bounces``, ``mega_sort_every``,
``mega_sort_key``, ``mega_tail_k``, ``mega_tail_frac``, ``mega_tail_compact``
and ``mega_sort_impl`` set the wavefront's schedule (none changes the
image). ``mega_sublanes`` and ``mega_state_packed`` are TPU tile and layout
knobs that choose nothing here.
"""

from __future__ import annotations

import torch

from raytrace2_tpu_torch.ops import camera
from raytrace2_tpu_torch.ops.kernels import megakernel as mk
from raytrace2_tpu_torch.ops.kernels import wavefront as wf

# JAX mega_schedule's threshold: above it, scenes go to the sorted
# wavefront kernel (wavefront_sorted.py::_bounce_step_kernel).
WAVEFRONT_MIN_RECORDS = 256


def n_records(features) -> int:
    """Sweep records of a scene: spheres + plain quads + media + AA boxes."""
    ms = features.get("mega_sizes") or (0,) * 6
    return ms[0] + ms[1] + ms[4] + ms[5]


def mega_schedule(features) -> tuple:
    """(sublanes, wave_frac, linear, wavefront) as the JAX package picks them
    on its two ported branches: the sorted wavefront (24×128 tiles, linear
    slots) above 256 records or when ``mega_wavefront`` is set, else v4 with
    32×128 tiles, instant regeneration and linear slots. Only ``wavefront``
    chooses anything in the port: its kernels have no tiles."""
    if bool(features.get("mega_wavefront", n_records(features) > WAVEFRONT_MIN_RECORDS)):
        return 24, 1.0, True, True
    return 32, 1.0, True, False


def _check_kernel_features(features) -> None:
    if features.get("mega_sizes") is None:
        raise NotImplementedError(
            "scene has no kernel sizes (ellipsoids): the non-kernel path is not "
            "ported yet (ROADMAP queue A item 12)")
    if features.get("noise_impl", "hash") != "hash":
        raise NotImplementedError(
            "table Perlin noise (noise_impl='table') is not ported yet "
            "(ROADMAP queue B item 2)")


def _render_batch_megakernel(scene, packed, features, width, height, sample0,
                             n_samples, seed, max_depth, sqrt_spp):
    """Radiance SUM over samples [sample0, sample0 + n_samples), [H, W, 3],
    from one launch of the v4 kernel or one wavefront pass (a launch per K
    bounces). ``scene`` and ``packed`` live on the render device."""
    wavefront = mega_schedule(features)[3]
    n_pix = width * height
    camv = camera.make_camv(scene.camera, width, height, sample0, n_samples,
                            sqrt_spp, seed).to(packed.device)
    kw = dict(max_depth=max_depth, sizes=tuple(features["mega_sizes"]),
              has_checker=int(features.get("has_checker", 1)),
              has_noise=bool(features.get("has_noise", False)))
    background = scene.background.to(torch.float32).contiguous()
    if wavefront:
        radiance = wf.trace_wavefront_batch(
            camv, int(seed), packed, background,
            n_rays=-(-n_pix // wf.SLOT_TILE) * wf.SLOT_TILE,
            sort_every=int(features.get("mega_sort_every", wf.SORT_EVERY)),
            k_bounces=int(features.get("mega_k_bounces", wf.K_BOUNCES)),
            key_mode=str(features.get("mega_sort_key", "pos")),
            tail_k=int(features.get("mega_tail_k", wf.TAIL_K)),
            tail_frac=float(features.get("mega_tail_frac", wf.TAIL_FRAC)),
            tail_compact=bool(features.get("mega_tail_compact", False)),
            sort_impl=str(features.get("mega_sort_impl", wf.SORT_IMPL)),
            **kw)[:n_pix]
    else:
        radiance = mk.trace_megakernel_batch(camv, int(seed), packed, background,
                                             n_pix=n_pix, **kw)
    return radiance.reshape(height, width, 3)


def pack_scene(scene, features) -> torch.Tensor:
    """The packed f32 table buffer of a device scene."""
    _check_kernel_features(features)
    sizes = tuple(features["mega_sizes"])
    return mk.pack_buffer(scene, sizes)


def render_progressive(scene, features, width: int, height: int, sample0: int,
                       n_samples: int, seed: int, max_depth: int, sqrt_spp: int,
                       packed=None):
    """Accumulate ``n_samples`` consecutive progressive samples in one kernel
    launch; returns the radiance sum [H, W, 3] on the scene's device.
    ``packed`` (``pack_scene``) may be passed to reuse the table buffer."""
    _check_kernel_features(features)
    if packed is None:
        packed = pack_scene(scene, features)
    return _render_batch_megakernel(scene, packed, features, width, height,
                                    sample0, n_samples, seed, max_depth, sqrt_spp)
