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

One documented difference: on ``xla`` (and ``auto`` off the kernel path) the
JAX package switches its sphere sweep to a BVH at 256 or more active
spheres; the port sweeps densely there, which is JAX's own ``xla`` route
below 256 spheres and finds the same closest hits. The BVH (``bvh``) is not
ported yet.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from raytrace2_tpu_torch.ops import integrator
from raytrace2_tpu_torch.ops.kernels import intersect_kernel as pk
from raytrace2_tpu_torch.scene import schema

# Backends of the JAX package that the port does not have yet, and the
# ROADMAP item that brings each.
_NOT_PORTED = {
    "bvh": "ROADMAP queue A item 12, the sphere BVH",
}
BACKENDS = ("auto", "mega", "wavefront", "xla", "pallas")
# Records whose tables the kernel path takes (JAX megakernel.MAX_SMEM_RECORDS);
# larger scenes take the non-kernel path.
MAX_SMEM_RECORDS = 4096
# Rays per chunk of the non-kernel path (JAX Renderer.chunk_size), and the
# smaller chunk it takes above 1,024 records.
CHUNK_SIZE = 65536
CHUNK_SIZE_LARGE = 16384


@dataclasses.dataclass
class RenderState:
    """Progressive accumulation state."""

    accum: torch.Tensor  # [H, W, 3] f32 linear radiance sum
    frame_idx: int       # samples accumulated so far


def init_state(width: int, height: int, device) -> RenderState:
    return RenderState(torch.zeros((height, width, 3), dtype=torch.float32,
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
    # 'auto' | 'mega' | 'wavefront' | 'xla' | 'pallas' (see the module doc).
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
        if self.backend in _NOT_PORTED:
            raise NotImplementedError(
                f"backend {self.backend!r} is not ported yet: {_NOT_PORTED[self.backend]}")
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
        self._features = features
        self.scene = schema.to_device(self.scene, self.device)
        if features["use_megakernel"]:
            self._packed = integrator.pack_scene(self.scene, features)
        self.reset()

    @property
    def route(self) -> str:
        """"kernel" (v4 or the wavefront), "pallas" (the non-kernel path with
        B5) or "xla" (the non-kernel path, dense closest hit)."""
        if self._features["use_megakernel"]:
            return "kernel"
        return "pallas" if self._features["use_pallas"] else "xla"

    @property
    def kernel(self) -> str | None:
        """The kernel this renderer's launches run: "megakernel_v4",
        "wavefront_step", "intersect_kernel", or None on the dense route."""
        if self.route == "kernel":
            return "wavefront_step" if integrator.mega_schedule(self._features)[3] \
                else "megakernel_v4"
        return "intersect_kernel" if self.route == "pallas" else None

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
        self._state = RenderState(state.accum.to(self.device, torch.float32).contiguous(),
                                  int(state.frame_idx))

    def linear_pixels(self) -> np.ndarray:
        return linear_image(self._state).cpu().numpy()

    def display_pixels(self) -> np.ndarray:
        """u8 display pixels [H, W, 3] (``display_image``)."""
        return display_image(self._state).cpu().numpy()
