"""Progressive renderer (port of ``raytrace2_tpu/render.py``).

The accumulator and frame count are the whole render state, as in the
reference's RayTracer (src/cpu_raytrace/RayTracer.cpp:55-70). The device is
always explicit: a CPU device runs the kernels' plain PyTorch versions, a
CUDA device the Hopper kernels; nothing falls back from one to the other.

Routing follows the JAX ``Renderer`` (render.py:100-134): ``auto`` takes the
kernel path (v4, or the sorted wavefront above 256 records) when the scene
has kernel sizes and at most ``max_records`` records, and the non-kernel
path otherwise (ellipsoids, bigger scenes); ``mega`` and ``wavefront`` take
the kernel path, except for an ellipsoid scene, which only the non-kernel
path renders; ``xla`` takes the non-kernel path with the dense closest hit
and ``pallas`` with the fused intersect kernel B5.

On ``xla`` (and ``auto`` off the kernel path) a scene of 256 or more
active spheres takes its spheres through the BVH walk
(``ops/bvh_traverse.py``, the kernel ``csrc/bvh_traverse.cu`` on the card),
as the JAX ``Renderer`` does (render.py:138-155); ``bvh`` forces it at any
sphere count. The tree is built from the host scene.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from raytrace2_tpu_torch import defs, tracing
from raytrace2_tpu_torch.ops import integrator
from raytrace2_tpu_torch.ops.kernels import intersect_kernel as pk
from raytrace2_tpu_torch.scene import bvh, schema

BACKENDS = ("auto", "mega", "wavefront", "xla", "pallas", "bvh")
# Records whose tables the kernel path takes (JAX megakernel.MAX_SMEM_RECORDS);
# larger scenes take the non-kernel path.
MAX_SMEM_RECORDS = 4096
# Rays per chunk of the non-kernel path (JAX Renderer.chunk_size), and the
# smaller chunk it takes above 1,024 records.
CHUNK_SIZE = 65536
CHUNK_SIZE_LARGE = 16384
# Active spheres from which ``auto`` and ``xla`` walk the sphere BVH.
BVH_MIN_SPHERES = 256


@dataclasses.dataclass
class RenderState:
    """Progressive accumulation state."""

    accum: torch.Tensor  # [H, W, 3] linear radiance sum (defs.TORCH_REAL)
    frame_idx: int       # samples accumulated so far


def init_state(width: int, height: int, device) -> RenderState:
    return RenderState(torch.zeros((height, width, 3), dtype=defs.TORCH_REAL,
                                   device=device), 0)


def render_step(scene, features, state: RenderState, seed: int, n_samples: int = 1,
                *, width, height, max_depth, sqrt_spp, packed=None,
                chunk_size=None) -> RenderState:
    """``n_samples`` progressive samples for all pixels: one launch on the
    kernel path, a loop of samples on the non-kernel path. The accumulator
    is updated in place: this stands in for the JAX package's buffer
    donation."""
    radiance = integrator.render_progressive(
        scene, features, width, height, state.frame_idx, n_samples, seed,
        max_depth, sqrt_spp, packed=packed, chunk_size=chunk_size)
    with tracing.span("render.accumulate"):
        state.accum += radiance
    state.frame_idx += int(n_samples)
    return state


def linear_image(state: RenderState) -> torch.Tensor:
    """acc / frame_idx (RayTracer::NonConvertedPixels)."""
    return state.accum / float(max(state.frame_idx, 1))


def display_image(state: RenderState) -> torch.Tensor:
    """u8 display pixels: clamp(acc/frames) → sqrt gamma → ×255.999."""
    lin = torch.clamp(linear_image(state), 0.0, 1.0)
    return torch.clamp(torch.sqrt(lin) * 255.999, 0.0, 255.0).to(torch.uint8)


def resolve_device(device) -> torch.device:
    """The render device, checked: CUDA must be present when asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run the kernel's plain PyTorch version")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


@dataclasses.dataclass
class Renderer:
    """Host-side progressive loop (Update / Reset / Pixels)."""

    scene: schema.FlatScene
    width: int
    height: int
    num_samples: int = 1
    max_depth: int = 50
    seed: int = 0
    # 'auto' | 'mega' | 'wavefront' | 'xla' | 'pallas' | 'bvh' (see the module doc).
    backend: str = "auto"
    device: str | torch.device = "cuda"
    # Most sweep records the kernel path takes (default MAX_SMEM_RECORDS).
    max_records: int | None = None
    # Rays per chunk on the non-kernel path (CHUNK_SIZE; CHUNK_SIZE_LARGE
    # above 1,024 records when left at the default).
    chunk_size: int | None = CHUNK_SIZE
    _features: dict = dataclasses.field(default_factory=dict)
    _state: RenderState | None = None
    _packed: torch.Tensor | None = None

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        self.device = resolve_device(self.device)
        features = self.scene.features()
        ceiling = MAX_SMEM_RECORDS if self.max_records is None else self.max_records
        n_records = integrator.n_records(features)
        has_sizes = features["mega_sizes"] is not None
        eligible = has_sizes and n_records <= ceiling
        if self.backend in ("mega", "wavefront") and has_sizes and n_records > ceiling:
            raise NotImplementedError(
                f"scene has {n_records} sweep records, above the kernel path's {ceiling} "
                f"(its tables live in shared memory): use backend 'auto', 'xla' or 'pallas'")
        features["use_megakernel"] = (self.backend in ("mega", "wavefront") and has_sizes) \
            or (self.backend == "auto" and eligible)
        features["use_pallas"] = self.backend == "pallas"
        if self.backend == "wavefront":
            features["mega_wavefront"] = True
        if self.chunk_size == CHUNK_SIZE and n_records > 1024:
            self.chunk_size = CHUNK_SIZE_LARGE
        # The material types pick the kernels' instances: read here, from the
        # host scene, so that no batch reads the device for them.
        features["mat_types"] = frozenset(
            float(t) for t in np.unique(np.asarray(self.scene.materials.mtype)))
        # B5's live extents, for the same reason.
        features["pallas_extents"] = pk.live_extents(self.scene)
        # The sphere BVH, from the host scene's active spheres (not
        # mega_sizes, which an ellipsoid scene leaves out).
        n_sph_active = int(np.asarray(self.scene.spheres.active).sum())
        use_bvh = self.backend == "bvh" or (
            not features["use_megakernel"] and self.backend in ("auto", "xla")
            and n_sph_active >= BVH_MIN_SPHERES)
        if use_bvh and n_sph_active:
            tree, depth = bvh.build_sphere_bvh(self.scene.spheres)
            self.scene = dataclasses.replace(self.scene, sphere_bvh=tree)
            features["use_bvh_spheres"] = True
            features["bvh_depth"] = depth
        self._features = features
        self.scene = schema.to_device(self.scene, self.device)
        if features["use_megakernel"]:
            self._packed = integrator.pack_scene(self.scene, features)
        self.reset()

    @property
    def route(self) -> str:
        """"kernel" (v4 or the wavefront), "pallas" (the non-kernel path with
        B5), "bvh" (the non-kernel path, spheres through the BVH walk) or
        "xla" (the non-kernel path, dense closest hit)."""
        if self._features["use_megakernel"]:
            return "kernel"
        if self._features["use_pallas"]:
            return "pallas"
        return "bvh" if self._features.get("use_bvh_spheres") else "xla"

    @property
    def kernel(self) -> str | None:
        """The kernel this renderer's launches run: "megakernel_v4",
        "wavefront_step", "intersect_kernel", "bvh_traverse", or None on the
        dense route."""
        if self.route == "kernel":
            return "wavefront_step" if integrator.mega_schedule(self._features)[3] \
                else "megakernel_v4"
        return {"pallas": "intersect_kernel", "bvh": "bvh_traverse"}.get(self.route)

    @property
    def sqrt_spp(self) -> int:
        # int sqrt truncation as in Camera::Update (Camera.hpp:45).
        return max(int(math.sqrt(self.num_samples)), 1)

    def reset(self) -> None:
        """RayTracer::Reset (RayTracer.cpp:49-53): a zero accumulator."""
        self._state = init_state(self.width, self.height, self.device)

    def resize(self, width: int, height: int) -> None:
        """RayTracer::OnResize: reallocate and restart the accumulation
        (RayTracer.cpp:87-104)."""
        self.width, self.height = width, height
        self.reset()

    def update(self, n_samples: int = 1) -> None:
        with tracing.span("render.update", {"seed": self.seed, "s0": self._state.frame_idx}):
            chunk = self.chunk_size
            if chunk is not None and chunk >= self.width * self.height:
                chunk = None
            self._state = render_step(
                self.scene, self._features, self._state, self.seed, n_samples,
                width=self.width, height=self.height, max_depth=self.max_depth,
                sqrt_spp=self.sqrt_spp, packed=self._packed, chunk_size=chunk)

    def render(self, num_samples: int | None = None, batch: int = 1) -> np.ndarray:
        remaining = num_samples or self.num_samples
        while remaining > 0:
            step = min(batch, remaining)
            self.update(step)
            remaining -= step
        return self.linear_pixels()

    @property
    def frame_idx(self) -> int:
        return self._state.frame_idx

    @property
    def state(self) -> RenderState:
        return self._state

    def set_state(self, state: RenderState) -> None:
        """Restore a checkpointed accumulator (resume; ``io.checkpoint``),
        moved to the render device. Its image must have this renderer's
        size."""
        shape = (self.height, self.width, 3)
        if tuple(state.accum.shape) != shape:
            raise ValueError(f"checkpoint accumulator {tuple(state.accum.shape)} does not "
                             f"match the render's {shape}")
        self._state = RenderState(state.accum.to(self.device, defs.TORCH_REAL).contiguous(),
                                  int(state.frame_idx))

    def linear_pixels(self) -> np.ndarray:
        return tracing.sync(linear_image(self._state), "linear").numpy()

    def display_pixels(self) -> np.ndarray:
        """u8 display pixels [H, W, 3] (``display_image``)."""
        with tracing.span("render.display"):
            return tracing.sync(display_image(self._state), "display").numpy()
