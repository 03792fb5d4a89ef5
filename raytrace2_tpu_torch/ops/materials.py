"""Material shading of the non-kernel path (port of
``raytrace2_tpu/ops/materials.py``): emission and scatter of every hit, the
six materials computed side by side and chosen by masked selects
(Material.hpp:12-29, Material.cpp)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytrace2_tpu_torch import defs
from raytrace2_tpu_torch.ops import textures as tex_ops


class Scatter(NamedTuple):
    emitted: torch.Tensor      # [N,3] emission at the hit (DiffuseLight::Emit)
    did_scatter: torch.Tensor  # [N] bool
    direction: torch.Tensor    # [N,3] next direction, not normalised
    attenuation: torch.Tensor  # [N,3]


def _dot(a, b):
    return torch.sum(a * b, -1, keepdim=True)


def reflect(v, n):
    """math::Reflect (src/cpu_raytrace/Math.hpp:66)."""
    return v - 2.0 * _dot(v, n) * n


def refract(uv, n, etai_over_etat):
    """math::Refract (src/cpu_raytrace/Math.hpp:68-73); ``uv`` unit."""
    cos_theta = torch.clamp(_dot(-uv, n), max=1.0)
    r_out_perp = etai_over_etat * (uv + cos_theta * n)
    k = 1.0 - _dot(r_out_perp, r_out_perp)
    return r_out_perp - torch.sqrt(torch.abs(k)) * n


def schlick(cosine, refraction_index):
    """Schlick reflectance (src/cpu_raytrace/Material.cpp:21-25)."""
    r0 = (1.0 - refraction_index) / (1.0 + refraction_index)
    r0 = r0 * r0
    om = 1.0 - cosine
    om2 = om * om
    return r0 + (1.0 - r0) * (om * (om2 * om2))  # x**5 as JAX's integer_pow


def _normalize(v):
    return v / torch.sqrt(_dot(v, v)).clamp(min=1e-12)


def shade(scene, features, hit, d_in, u_vec, u_frsn) -> Scatter:
    """Emission and scatter for every ray's hit record (JAX ``shade``).

    ``hit``: ``intersect.Hit``; ``d_in`` [N,3] incoming directions;
    ``u_vec`` [N,3] unit-sphere directions (Lambertian, metal fuzz and
    isotropic share them); ``u_frsn`` [N] the dielectric's reflect/refract
    draw."""
    mats = scene.materials
    m = hit.material.to(torch.int64)
    mtype = mats.mtype[m]
    albedo = mats.albedo[m]
    param = mats.param[m]
    texval = tex_ops.texture_value(scene.textures, mats.tex[m], hit.uv, hit.point, features)

    lamb_dir = hit.normal + u_vec
    degenerate = torch.all(torch.abs(lamb_dir) < float(defs.NEAR_ZERO_EPS), -1, keepdim=True)
    lamb_dir = torch.where(degenerate, hit.normal, lamb_dir)

    metal_dir = _normalize(reflect(d_in, hit.normal)) + param[:, None] * u_vec

    param_safe = torch.where(param > 0.0, param, 1.0)
    ri = torch.where(hit.front_face, 1.0 / param_safe, param_safe)
    unit_d = _normalize(d_in)
    cos_t = torch.clamp(torch.sum(-unit_d * hit.normal, -1), max=1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    cannot_refract = ri * sin_t > 1.0
    reflect_choice = cannot_refract | (schlick(cos_t, ri) > u_frsn)
    diel_dir = torch.where(reflect_choice[:, None], reflect(unit_d, hit.normal),
                           refract(unit_d, hit.normal, ri[:, None]))

    is_lamb = (mtype == defs.MAT_LAMBERTIAN) | (mtype == defs.MAT_TEXTURE)
    is_metal = mtype == defs.MAT_METAL
    is_diel = mtype == defs.MAT_DIELECTRIC
    is_iso = mtype == defs.MAT_ISOTROPIC
    is_light = mtype == defs.MAT_DIFFUSE_LIGHT

    direction = torch.where(
        is_lamb[:, None], lamb_dir,
        torch.where(is_metal[:, None], metal_dir,
                    torch.where(is_diel[:, None], diel_dir, u_vec)))
    uses_tex = (mtype == defs.MAT_TEXTURE) | is_iso
    attenuation = torch.where(is_diel[:, None], torch.ones_like(albedo),
                              torch.where(uses_tex[:, None], texval, albedo))
    emitted = torch.where(is_light[:, None], texval, torch.zeros_like(texval))
    return Scatter(emitted=emitted, did_scatter=~is_light, direction=direction,
                   attenuation=attenuation)
