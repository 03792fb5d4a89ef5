"""Camera frame, the kernel's camera control vector and in-kernel ray
generation (port of ``raytrace2_tpu/ops/camera.py::camera_frame`` and of
``ops/pallas/megakernel.py:1665-1736``).

``camv`` layout (28 f32): 0:3 pixel00, 3:6 pixel_delta_u, 6:9 pixel_delta_v,
9:12 center, 12:15 defocus_disk_u, 15:18 defocus_disk_v, 18 defocus_angle,
19 width, 20 n_pix, 21 s0, 22 n_samples, 23 sqrt_spp, 24 seed (information
only: the exact seed travels as a separate int, since f32 loses
seed·1000003 above 2^24), 25 slot0, 26 nbx, 27 height.
"""

from __future__ import annotations

import math

import torch

from raytrace2_tpu_torch import defs, tracing
from raytrace2_tpu_torch.ops import rng

CAMV_LEN = 28
# camv[26] is the pixel-block grid width, ceil(width / block). On the linear
# layout nothing reads it, and it is the JAX v4 kernel's, whose 32x128-lane
# tile gives block 64; the port's block-tiled v4 tile is one CUDA block of
# 256 lanes, a 16x16 pixel block (csrc/megakernel_v4.cu).
_TILE_BLOCK = 64
PIXEL_BLOCK = 16




def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True)).clamp(min=1e-12)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


# The host frame cache of ``camera_frame``: hits and misses (plain ints, as
# the kernels' LAUNCHES), and the last frame computed with what it was
# computed from.
FRAME_HITS = 0
FRAME_MISSES = 0
_LAST = None  # (leaves, (their versions, width, height, dtype), frame)


def clear_frame_cache() -> None:
    """Forget the last frame, so the next ``camera_frame`` computes anew."""
    global _LAST
    _LAST = None


def _compute_frame(cam, width: int, height: int, dtype) -> dict:
    def real(x):
        if torch.is_tensor(x):
            return tracing.sync(x.to(dtype), "camera")
        return torch.as_tensor(x, dtype=dtype)

    center, look_at, vup = real(cam.center), real(cam.look_at), real(cam.vup)
    vfov, focus = real(cam.vfov), real(cam.focus_dist)
    defocus_angle = real(cam.defocus_angle)
    h = torch.tan(vfov * (math.pi / 180.0) / 2.0)
    w = _normalize(center - look_at)
    u = _normalize(_cross(vup, w))
    v = _cross(w, u)
    viewport_height = 2.0 * h * focus
    viewport_width = viewport_height * (width / height)
    viewport_u = viewport_width * u
    viewport_v = viewport_height * v
    pixel_delta_u = viewport_u / width
    pixel_delta_v = viewport_v / height
    upper_left = center - w * focus - viewport_u / 2.0 - viewport_v / 2.0
    pixel00 = upper_left + 0.5 * (pixel_delta_u + pixel_delta_v)
    defocus_radius = focus * torch.tan(defocus_angle / 2.0 * (math.pi / 180.0))
    return {
        "center": center,
        "pixel00": pixel00,
        "pixel_delta_u": pixel_delta_u,
        "pixel_delta_v": pixel_delta_v,
        "defocus_disk_u": u * defocus_radius,
        "defocus_disk_v": v * defocus_radius,
        "defocus_angle": defocus_angle,
    }


def camera_frame(cam, width: int, height: int, dtype=None) -> dict:
    """Derived camera quantities (Camera::Update, Camera.hpp:16-48) on the
    CPU, in ``dtype`` (``defs.TORCH_REAL`` by default; the kernels' camv is
    float32): pixel00, pixel_delta_u/v, center, defocus_disk_u/v,
    defocus_angle. Each camera leaf that is a tensor is read through
    ``tracing.sync`` (six host syncs where the camera lives on the card).

    A camera of tensors, none of which requires grad, hits the host frame
    cache when its leaves are the very tensors of the last frame computed,
    each at the same ``_version`` (an in-place edit through torch bumps
    it), at the same ``width``, ``height`` and ``dtype``: the call then
    reads nothing from the card and returns that frame's CPU tensors
    (``FRAME_HITS``); otherwise it computes the frame and keeps it
    (``FRAME_MISSES``). The cache holds the leaves, so a freed tensor's
    address cannot pass for a new one. A camera with a leaf that requires
    grad computes the frame in autograd's graph, and one with a leaf that
    is not a tensor or is an inference tensor (no version) computes it
    too; neither counts."""
    global _LAST, FRAME_HITS, FRAME_MISSES
    dtype = dtype or defs.TORCH_REAL
    leaves = (cam.center, cam.look_at, cam.vup, cam.vfov, cam.focus_dist, cam.defocus_angle)
    if not all(torch.is_tensor(x) for x in leaves) or any(
            x.requires_grad or x.is_inference() for x in leaves):
        return _compute_frame(cam, width, height, dtype)
    key = (tuple(x._version for x in leaves), width, height, dtype)
    last = _LAST
    if last is not None and last[1] == key and all(a is b for a, b in zip(last[0], leaves)):
        FRAME_HITS += 1
        return dict(last[2])
    frame = _compute_frame(cam, width, height, dtype)
    _LAST = (leaves, key, frame)
    FRAME_MISSES += 1
    return dict(frame)


def make_camv(cam, width: int, height: int, sample0: int, n_samples: int,
              sqrt_spp: int, seed: int, block: int = _TILE_BLOCK,
              slot0: int = 0) -> torch.Tensor:
    """The 28-entry control vector (JAX integrator.py:365-378), f32 CPU.
    ``slot0`` is the first slot of a shard's run of the lane layout (0: one
    device renders every pixel). ``block`` is the side of the pixel block of
    the lane layout (``PIXEL_BLOCK`` for the block-tiled one)."""
    frame = camera_frame(cam, width, height, torch.float32)
    tail = torch.tensor([
        float(frame["defocus_angle"].detach()), float(width), float(width * height),
        float(sample0), float(n_samples), float(sqrt_spp), float(seed),
        float(slot0), float(-(-width // block)), float(height),
    ], dtype=torch.float32)
    return torch.cat([
        frame["pixel00"], frame["pixel_delta_u"], frame["pixel_delta_v"],
        frame["center"], frame["defocus_disk_u"], frame["defocus_disk_v"], tail,
    ])


def stratum(sample_idx: int, sqrt_spp: int) -> tuple[int, int]:
    """Stratum cell of progressive sample ``sample_idx``
    (src/cpu_raytrace/RayTracer.cpp:57-60)."""
    return sample_idx % sqrt_spp, (sample_idx // sqrt_spp) % sqrt_spp


def generate_rays(cam, width: int, height: int, sample_idx: int, sqrt_spp: int, keys,
                  pixel_ids=None, uniforms=None):
    """Rays of the non-kernel path for a set of pixels at one stratified
    sample (JAX ``camera.generate_rays``, :72-125): (origins [N,3], dirs
    [N,3], times [N]) on the device of ``keys`` or ``uniforms``.

    ``keys`` are threefry keys [N, 2] (``rng.pixel_sample_key``), whose
    camera draw is ``uniform(fold_in(k, 0x7FFFFFFF), 5)``; or ``uniforms``
    [N, 5] from the caller's generator (the murmur camera draws)."""
    u = rng.uniform(rng.fold_in(keys, 0x7FFFFFFF), 5) if uniforms is None else uniforms
    device = u.device
    frame = {k: tracing.sync(v, "frame", device=device)
             for k, v in camera_frame(cam, width, height).items()}
    if pixel_ids is None:
        pixel_ids = torch.arange(width * height, dtype=torch.int32, device=device)
    xs = (pixel_ids % width).to(defs.TORCH_REAL)
    ys = torch.div(pixel_ids, width, rounding_mode="floor").to(defs.TORCH_REAL)
    s_i, s_j = stratum(int(sample_idx), int(sqrt_spp))
    recip = 1.0 / sqrt_spp
    px = (s_i + u[:, 0]) * recip - 0.5
    py = (s_j + u[:, 1]) * recip - 0.5
    pixel_center = (frame["pixel00"][None, :]
                    + (xs + px)[:, None] * frame["pixel_delta_u"][None, :]
                    + (ys + py)[:, None] * frame["pixel_delta_v"][None, :])
    disk = rng.disk_from_uniforms(u[:, 2], u[:, 3])
    if float(frame["defocus_angle"].detach()) > 0.0:
        origins = (frame["center"][None, :]
                   + disk[:, 0:1] * frame["defocus_disk_u"][None, :]
                   + disk[:, 1:2] * frame["defocus_disk_v"][None, :])
    else:
        origins = frame["center"][None, :].expand_as(pixel_center)
    dirs = _normalize(pixel_center - origins)
    return origins.contiguous(), dirs, u[:, 4].contiguous()


def _div(a: torch.Tensor, b) -> torch.Tensor:
    """``a / b`` as a true elementwise division: on CUDA, torch divides by a
    host scalar as a multiply by its reciprocal, which can move floor() of
    an exact quotient (a pixel row) down by one."""
    return a / torch.full_like(a, float(b))


def camera_ray(cv, xx, yy, sqrt_spp, s_global_f, key):
    """Camera::GetRay (Camera.hpp:50-67) as the v4 kernel computes it
    (``mk.camera_ray``): stratified jitter, defocus disk, shutter time.
    ``cv`` is indexable by camv entry (a list of floats or a tensor).
    Returns (ox, oy, oz, dx, dy, dz, time)."""
    u0 = rng.cam_draw(key, 0)
    u1 = rng.cam_draw(key, 1)
    u2 = rng.cam_draw(key, 2)
    u3 = rng.cam_draw(key, 3)
    u4 = rng.cam_draw(key, 4)
    k1 = torch.floor(_div(s_global_f, sqrt_spp))
    s_i = s_global_f - k1 * sqrt_spp
    s_j = k1 - torch.floor(_div(k1, sqrt_spp)) * sqrt_spp
    recip = 1.0 / sqrt_spp
    pxj = (s_i + u0) * recip - 0.5
    pyj = (s_j + u1) * recip - 0.5
    pcx = cv[0] + (xx + pxj) * cv[3] + (yy + pyj) * cv[6]
    pcy = cv[1] + (xx + pxj) * cv[4] + (yy + pyj) * cv[7]
    pcz = cv[2] + (xx + pxj) * cv[5] + (yy + pyj) * cv[8]
    r = torch.sqrt(u2)
    th = (2.0 * 3.14159265358979) * u3
    dkx = r * torch.cos(th)
    dky = r * torch.sin(th)
    if (cv[18].item() if torch.is_tensor(cv) else cv[18]) > 0.0:
        ox = cv[9] + dkx * cv[12] + dky * cv[15]
        oy = cv[10] + dkx * cv[13] + dky * cv[16]
        oz = cv[11] + dkx * cv[14] + dky * cv[17]
    elif torch.is_tensor(cv):
        # A camv tensor (the gradient replay) keeps the center in the graph.
        ox, oy, oz = cv[9].expand_as(pcx), cv[10].expand_as(pcx), cv[11].expand_as(pcx)
    else:
        ox = torch.full_like(pcx, float(cv[9]))
        oy = torch.full_like(pcx, float(cv[10]))
        oz = torch.full_like(pcx, float(cv[11]))
    ddx = pcx - ox
    ddy = pcy - oy
    ddz = pcz - oz
    inv_len = 1.0 / torch.sqrt(torch.clamp(ddx * ddx + ddy * ddy + ddz * ddz, min=1e-24))
    return ox, oy, oz, ddx * inv_len, ddy * inv_len, ddz * inv_len, u4


def slot_to_pixel(slot_f: torch.Tensor, cv, tile_r: int = 0):
    """Slot → (xx, yy, in_grid) (JAX ``slot_to_pixel``, :1729-1747). With
    ``tile_r`` = 0 the linear layout (slot == pixel id); else the
    block-tiled one: tile ``slot // tile_r`` owns the square pixel block of
    side sqrt(tile_r) at block row ``tile // nbx`` (nbx = camv[26]), pixels
    row-major inside it, and lanes past the image's edge are idle. All
    values stay below 2^24, so the f32 arithmetic is exact."""
    width = cv[19]
    if not tile_r:
        yy = torch.floor(_div(slot_f, width))
        xx = slot_f - yy * width
        return xx, yy, slot_f < cv[20]
    block = int(round(tile_r ** 0.5))
    tile_f = torch.floor(slot_f * (1.0 / tile_r))
    within = slot_f - tile_f * tile_r
    by = torch.floor(_div(tile_f, cv[26]))
    bx = tile_f - by * cv[26]
    ly = torch.floor(within * (1.0 / block))
    lx = within - ly * block
    xx = bx * block + lx
    yy = by * block + ly
    return xx, yy, (xx < width) & (yy < cv[27])
