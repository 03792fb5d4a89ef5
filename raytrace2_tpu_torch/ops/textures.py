"""Texture evaluation over the SoA texture tables (port of
``raytrace2_tpu/ops/textures.py``): the non-kernel path's table Perlin noise
(the per-texture permutation and gradient tables the loader bakes,
PerlinNoiseGen.cpp:66-103), turbulence, and checker nesting resolved to the
scene's depth. The kernels evaluate hash-gradient noise, or with
``noise_impl="table"`` the same tables (``ops/kernels/megakernel.py``).
"""

from __future__ import annotations

import torch

from raytrace2_tpu_torch import defs


def perlin_noise(perm, grad, tex_idx, p):
    """Perlin evaluation (PerlinNoiseGen.cpp:66-88, PerlinInterp :10-26).

    perm: [L,3,256] int permutation tables; grad: [L,256,3] f32 gradients;
    tex_idx: [N] texture row per point; p: [N,3]. Returns [N] in [-1, 1]."""
    pf = torch.floor(p)
    uvw = p - pf
    ijk = pf.to(torch.int32).to(torch.int64)
    tex = tex_idx.to(torch.int64)
    u, v, w = uvw[:, 0], uvw[:, 1], uvw[:, 2]
    uu = u * u * (3.0 - 2.0 * u)
    vv = v * v * (3.0 - 2.0 * v)
    ww = w * w * (3.0 - 2.0 * w)
    accum = torch.zeros(p.shape[0], dtype=p.dtype, device=p.device)
    for di in range(2):
        for dj in range(2):
            for dk in range(2):
                px = perm[tex, 0, (ijk[:, 0] + di) & 255]
                py = perm[tex, 1, (ijk[:, 1] + dj) & 255]
                pz = perm[tex, 2, (ijk[:, 2] + dk) & 255]
                g = grad[tex, (px ^ py ^ pz).to(torch.int64)]
                weight = uvw - torch.tensor([di, dj, dk], dtype=p.dtype, device=p.device)
                wt = ((di * uu + (1 - di) * (1.0 - uu))
                      * (dj * vv + (1 - dj) * (1.0 - vv))
                      * (dk * ww + (1 - dk) * (1.0 - ww)))
                accum = accum + wt * torch.sum(g * weight, -1)
    return accum


def turbulence(perm, grad, tex_idx, p, depth: int = 7):
    """|Σ_k 0.5^k noise(2^k p)| (PerlinNoiseGen.cpp:52-64)."""
    accum = torch.zeros(p.shape[0], dtype=p.dtype, device=p.device)
    temp, weight = p, 1.0
    for _ in range(depth):
        accum = accum + weight * perlin_noise(perm, grad, tex_idx, temp)
        weight *= 0.5
        temp = temp * 2.0
    return torch.abs(accum)


def _noise_value(textures, idx, p):
    """Noise texture value (Texture.cpp:13-22)."""
    albedo = textures.albedo[idx]
    scale = textures.scale[idx][:, None]
    marble = 0.5 * (1.0 + torch.sin(
        scale[:, 0] * p[:, 2] + 10.0 * turbulence(textures.perm, textures.grad, idx, p)))
    perl = 0.5 * (1.0 + perlin_noise(textures.perm, textures.grad, idx, scale * p))
    val = torch.where((textures.noise_type[idx] == defs.NOISE_MARBLE)[:, None],
                      marble[:, None], perl[:, None])
    return albedo * val


def _leaf_value(textures, idx, p, features):
    """Texture value of rows that are solid or noise."""
    solid = textures.albedo[idx]
    if not features.get("has_noise", True):
        return solid
    noise = _noise_value(textures, idx, p)
    return torch.where((textures.ttype[idx] == defs.TEX_NOISE)[:, None], noise, solid)


def texture_value(textures, tex_idx, uv, p, features):
    """Texture of every shading point: checkers resolved to the scene's
    nesting depth (``features["has_checker"]``), parity taken on the
    absolute value of the cell sum as the reference's C++ ``%`` needs
    (Texture.cpp:7-11). ``uv`` is accepted for interface parity."""
    del uv
    depth = int(features.get("has_checker", 1))
    idx = tex_idx.to(torch.int64)
    for _ in range(depth):
        ttype = textures.ttype[idx]
        i3 = torch.floor(textures.inv_scale[idx][:, None] * p).to(torch.int32)
        even = (torch.abs(i3[:, 0] + i3[:, 1] + i3[:, 2]) % 2) == 0
        child = torch.where(even, textures.even[idx], textures.odd[idx]).to(torch.int64)
        idx = torch.where(ttype == defs.TEX_CHECKER, child, idx)
    return _leaf_value(textures, idx, p, features)
