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

from raytrace2_tpu_torch.ops import rng

CAMV_LEN = 28
# Lane tile of the JAX v4 kernel on the linear layout (32×128 lanes); only
# camv[26] (the pixel-block grid width, unused on the linear layout) uses it.
_TILE_BLOCK = 64


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).cpu()


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True)).clamp(min=1e-12)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def camera_frame(cam, width: int, height: int) -> dict:
    """Derived camera quantities (Camera::Update, Camera.hpp:16-48), f32 on
    the CPU: pixel00, pixel_delta_u/v, center, defocus_disk_u/v,
    defocus_angle."""
    center, look_at, vup = _f32(cam.center), _f32(cam.look_at), _f32(cam.vup)
    vfov, focus = _f32(cam.vfov), _f32(cam.focus_dist)
    defocus_angle = _f32(cam.defocus_angle)
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


def make_camv(cam, width: int, height: int, sample0: int, n_samples: int,
              sqrt_spp: int, seed: int) -> torch.Tensor:
    """The 28-entry control vector (JAX integrator.py:365-378), f32 CPU.
    slot0 (a shard's first pixel) is 0: one device renders every pixel."""
    frame = camera_frame(cam, width, height)
    tail = torch.tensor([
        float(frame["defocus_angle"].detach()), float(width), float(width * height),
        float(sample0), float(n_samples), float(sqrt_spp), float(seed),
        0.0, float(-(-width // _TILE_BLOCK)), float(height),
    ], dtype=torch.float32)
    return torch.cat([
        frame["pixel00"], frame["pixel_delta_u"], frame["pixel_delta_v"],
        frame["center"], frame["defocus_disk_u"], frame["defocus_disk_v"], tail,
    ])


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


def slot_to_pixel(slot_f: torch.Tensor, cv):
    """Linear slot layout (slot == pixel id): (xx, yy, in_grid). All values
    stay below 2^24, so the f32 arithmetic is exact."""
    width = cv[19]
    yy = torch.floor(_div(slot_f, width))
    xx = slot_f - yy * width
    return xx, yy, slot_f < cv[20]
