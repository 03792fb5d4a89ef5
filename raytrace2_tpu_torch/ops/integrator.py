"""Kernel-path integrator (port of the v4 branch of
``raytrace2_tpu/ops/integrator.py``: ``mega_schedule`` :314-343,
``_render_batch_megakernel`` :346-465, ``render_progressive`` :481-489).

Scenes with at most 256 sweep records render through the v4 kernel on the
linear slot layout with instant regeneration. Larger scenes (the sorted
wavefront kernel) and scenes without kernel sizes (ellipsoids, which need
the non-kernel path) are not ported yet and raise.
"""

from __future__ import annotations

import torch

from raytrace2_tpu_torch.ops import camera
from raytrace2_tpu_torch.ops.kernels import megakernel as mk

# JAX mega_schedule's threshold: above it, scenes go to the sorted
# wavefront kernel (wavefront_sorted.py::_bounce_step_kernel).
WAVEFRONT_MIN_RECORDS = 256


def mega_schedule(features) -> tuple:
    """(sublanes, wave_frac, linear, wavefront) as the JAX package picks them.
    Only the ≤256-record branch is ported: 32×128 tiles, instant
    regeneration, linear slots, no wavefront."""
    ms = features.get("mega_sizes") or (0,) * 6
    n_records = ms[0] + ms[1] + ms[4] + ms[5]
    if bool(features.get("mega_wavefront", n_records > WAVEFRONT_MIN_RECORDS)):
        raise NotImplementedError(
            f"scene has {n_records} sweep records (> {WAVEFRONT_MIN_RECORDS}): the "
            "sorted-wavefront kernel is not ported yet (ROADMAP queue A item 10, "
            "queue B item 2)")
    return 32, 1.0, True, False


def _check_kernel_features(features) -> None:
    if features.get("mega_sizes") is None:
        raise NotImplementedError(
            "scene has no kernel sizes (ellipsoids): the non-kernel path is not "
            "ported yet (ROADMAP queue A item 12)")
    if features.get("noise_impl", "hash") != "hash":
        raise NotImplementedError(
            "table Perlin noise (noise_impl='table') is not ported yet "
            "(ROADMAP queue B item 1 options)")


def _render_batch_megakernel(scene, packed, features, width, height, sample0,
                             n_samples, seed, max_depth, sqrt_spp):
    """Radiance SUM over samples [sample0, sample0 + n_samples), [H, W, 3],
    from one launch of the v4 kernel. ``scene`` and ``packed`` live on the
    render device."""
    mega_schedule(features)
    n_pix = width * height
    camv = camera.make_camv(scene.camera, width, height, sample0, n_samples,
                            sqrt_spp, seed).to(packed.device)
    radiance = mk.trace_megakernel_batch(
        camv, int(seed), packed, scene.background.to(torch.float32).contiguous(),
        n_pix=n_pix, max_depth=max_depth, sizes=tuple(features["mega_sizes"]),
        has_checker=int(features.get("has_checker", 1)),
        has_noise=bool(features.get("has_noise", False)))
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
