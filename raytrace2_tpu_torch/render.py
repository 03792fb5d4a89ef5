"""Progressive renderer (port of ``raytrace2_tpu/render.py``).

The accumulator and frame count are the whole render state, as in the
reference's RayTracer (src/cpu_raytrace/RayTracer.cpp:55-70). The device is
always explicit: a CPU device runs the kernel's plain PyTorch version, a
CUDA device the Hopper kernel; nothing falls back from one to the other.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from raytrace2_tpu_torch.ops import integrator
from raytrace2_tpu_torch.scene import schema

# Backends of the JAX package that the port does not have yet, and the
# ROADMAP item that brings each.
_NOT_PORTED = {
    "xla": "ROADMAP queue A item 12 (non-kernel path)",
    "bvh": "ROADMAP queue A item 12 (non-kernel path, sphere BVH)",
    "pallas": "ROADMAP queue B item 2 (kernel B5, the fused intersect kernel)",
}
# Records whose tables the kernel path takes (JAX megakernel.MAX_SMEM_RECORDS);
# the JAX package sends larger scenes to its XLA path.
MAX_SMEM_RECORDS = 4096


@dataclasses.dataclass
class RenderState:
    """Progressive accumulation state."""

    accum: torch.Tensor  # [H, W, 3] f32 linear radiance sum
    frame_idx: int       # samples accumulated so far


def init_state(width: int, height: int, device) -> RenderState:
    return RenderState(torch.zeros((height, width, 3), dtype=torch.float32,
                                   device=device), 0)


def render_step(scene, features, state: RenderState, seed: int, n_samples: int = 1,
                *, width, height, max_depth, sqrt_spp, packed=None) -> RenderState:
    """``n_samples`` progressive samples for all pixels in one launch. The
    accumulator is updated in place: this stands in for the JAX package's
    buffer donation."""
    radiance = integrator.render_progressive(
        scene, features, width, height, state.frame_idx, n_samples, seed,
        max_depth, sqrt_spp, packed=packed)
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
    # 'auto' | 'mega' take the kernel path (v4, or the sorted wavefront above
    # 256 records); 'wavefront' forces the wavefront for any scene.
    backend: str = "auto"
    device: str | torch.device = "cuda"
    # Most sweep records the kernel path takes (default MAX_SMEM_RECORDS).
    max_records: int | None = None
    _features: dict = dataclasses.field(default_factory=dict)
    _state: RenderState | None = None
    _packed: torch.Tensor | None = None

    def __post_init__(self):
        if self.backend in _NOT_PORTED:
            raise NotImplementedError(
                f"backend {self.backend!r} is not ported yet: {_NOT_PORTED[self.backend]}")
        if self.backend not in ("auto", "mega", "wavefront"):
            raise ValueError(f"unknown backend {self.backend!r}")
        self.device = resolve_device(self.device)
        self._features = self.scene.features()
        ceiling = MAX_SMEM_RECORDS if self.max_records is None else self.max_records
        n_records = integrator.n_records(self._features)
        if n_records > ceiling:
            raise NotImplementedError(
                f"scene has {n_records} sweep records, above the kernel path's "
                f"{ceiling}: the non-kernel path is not ported yet (ROADMAP queue A "
                "item 12)")
        if self.backend == "wavefront":
            self._features["mega_wavefront"] = True
        self.scene = schema.to_device(self.scene, self.device)
        self._packed = integrator.pack_scene(self.scene, self._features)
        self.reset()

    @property
    def kernel(self) -> str:
        """The kernel this renderer's launches run: "wavefront_step" or
        "megakernel_v4"."""
        return "wavefront_step" if integrator.mega_schedule(self._features)[3] \
            else "megakernel_v4"

    @property
    def sqrt_spp(self) -> int:
        # int sqrt truncation as in Camera::Update (Camera.hpp:45).
        return max(int(math.sqrt(self.num_samples)), 1)

    def reset(self) -> None:
        self._state = init_state(self.width, self.height, self.device)

    def update(self, n_samples: int = 1) -> None:
        self._state = render_step(
            self.scene, self._features, self._state, self.seed, n_samples,
            width=self.width, height=self.height, max_depth=self.max_depth,
            sqrt_spp=self.sqrt_spp, packed=self._packed)

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

    def linear_pixels(self) -> np.ndarray:
        return linear_image(self._state).cpu().numpy()
