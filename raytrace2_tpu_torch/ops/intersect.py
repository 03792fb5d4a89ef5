"""Closest hit of the non-kernel path over the flattened SoA scene (port of
``raytrace2_tpu/ops/intersect.py``).

Every family is tested densely, ray × record ([N, P] intermediates), and the
winner of each family and across families is an argmin, first index on a
tie. Spheres: the quadratic against the moving centre, nearest root strictly
inside (t_min, t_max) (Sphere.cpp:7-37). Quads: plane solve and the closed
interior test (Quad.cpp:19-43). Media: analytic boundary entry/exit in model
space, then an exponential free path (ConstantMedium.cpp:14-58). Ellipsoids:
the sphere quadratic in model space. The winner's record (point, normal,
uv, material, front face) is rebuilt once per ray from its index.

``features["use_pallas"]`` takes the sphere and quad families through the
fused kernel B5 (``ops/kernels/intersect_kernel.py``), as the JAX package's
``backend="pallas"`` does. The sphere BVH (``use_bvh_spheres``) is not
ported.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from raytrace2_tpu_torch import defs
from raytrace2_tpu_torch.ops.kernels import intersect_kernel as pk
from raytrace2_tpu_torch.ops.kernels.megakernel import _cross

BIG = 3.0e38  # "no hit" distance (below f32 max, so it stays finite)


def _mm(a, bt):
    """[N,3]·[3,P] ray × record contraction as three broadcast
    multiply-adds (the JAX package's ``_mm``; not a matmul)."""
    return a[:, 0:1] * bt[0][None, :] + a[:, 1:2] * bt[1][None, :] + a[:, 2:3] * bt[2][None, :]


def _dot(a, b):
    return torch.sum(a * b, -1)


def _norm(v):
    return torch.sqrt(_dot(v, v))


class Hit(NamedTuple):
    """SoA hit record (cpu::HitRecord, HitRecord.hpp:9-21)."""

    valid: torch.Tensor       # [N] bool
    t: torch.Tensor           # [N]
    point: torch.Tensor       # [N,3]
    normal: torch.Tensor      # [N,3] face-forwarded
    front_face: torch.Tensor  # [N] bool
    uv: torch.Tensor          # [N,2]
    material: torch.Tensor    # [N] int


def _root_sqrt(disc):
    """sqrt(disc) of a quadratic's discriminant where it is positive, else
    0, with no cotangent at or below 0: sqrt'(0) is inf, and the backward of
    a root that loses (or of a padded record) multiplies it by a zero
    cotangent (NaN). The value is sqrt's wherever disc >= 0, so hits do not
    move (JAX's safe sqrt, which keeps sqrt(0), agrees in the forward)."""
    pos = disc > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0)


def _first_min(ts):
    """(min, argmin) along the last axis, first index on a tie."""
    idx = torch.argmin(ts, -1)
    return torch.gather(ts, -1, idx[..., None])[..., 0], idx


def _uv_sphere(outward):
    """GetUV (Sphere.cpp:39-43) of the outward unit normal."""
    theta = torch.arccos(torch.clamp(-outward[:, 1], -1.0, 1.0))
    phi = torch.atan2(-outward[:, 2], outward[:, 0]) + math.pi
    return torch.stack([phi / (2.0 * math.pi), theta / math.pi], -1)


# ---- spheres ---------------------------------------------------------------


def _sphere_ts(spheres, o, d, time, t_min, t_max):
    """Per-(ray, sphere) accepted hit t, BIG where no hit: [N, S]."""
    c0, disp, rad = spheres.center0, spheres.displacement, spheres.radius
    c0c0 = _dot(c0, c0)
    c0disp = _dot(c0, disp)
    dispdisp = _dot(disp, disp)
    r2 = rad * rad
    d_c0 = _mm(d, c0.T)
    d_disp = _mm(d, disp.T)
    o_c0 = _mm(o, c0.T)
    o_disp = _mm(o, disp.T)
    oo = _dot(o, o)[:, None]
    a = _dot(d, d)[:, None]
    tt = time[:, None]
    # oc = c(time) - o;  h = d·oc;  c_coef = oc·oc - r².
    h = d_c0 + tt * d_disp - _dot(d, o)[:, None]
    cc = c0c0[None, :] + 2.0 * tt * c0disp[None, :] + tt * tt * dispdisp[None, :]
    c_coef = cc - 2.0 * (o_c0 + tt * o_disp) + oo - r2[None, :]
    disc = h * h - a * c_coef
    has_root = disc >= 0.0
    sq = _root_sqrt(disc)
    root0 = (h - sq) / a
    root1 = (h + sq) / a
    tmin, tmax = t_min[:, None], t_max[:, None]
    ok0 = (root0 > tmin) & (root0 < tmax)
    ok1 = (root1 > tmin) & (root1 < tmax)
    root = torch.where(ok0, root0, root1)
    hit = has_root & (ok0 | ok1) & spheres.active[None, :]
    return torch.where(hit, root, BIG)


def _sphere_record(spheres, o, d, time, t, idx):
    """Point, normal, front face, uv and material of the winning sphere."""
    center = spheres.center0[idx] + time[:, None] * spheres.displacement[idx]
    rad = spheres.radius[idx]
    point = o + t[:, None] * d
    outward = (point - center) / torch.where(rad != 0.0, rad, 1.0)[:, None]
    front = _dot(d, outward) < 0.0
    normal = torch.where(front[:, None], outward, -outward)
    return point, normal, front, _uv_sphere(outward), spheres.material[idx]


# ---- ellipsoids (spheres under non-similarity affines) ---------------------


def _affine(m, x, bias=True):
    """``m[..., :3] @ x (+ m[..., 3])`` per (ray, record) written out:
    x [N,3], m [E,3,4] → [N,E,3]."""
    out = (x[:, None, None, 0] * m[None, :, :, 0] + x[:, None, None, 1] * m[None, :, :, 1]
           + x[:, None, None, 2] * m[None, :, :, 2])
    return out + m[None, :, :, 3] if bias else out


def _ellipsoid_ts(ell, o, d, time, t_min, t_max):
    """Per-(ray, ellipsoid) accepted hit t, BIG where no hit: [N, E]. The
    model-space direction is not renormalised, so the root is world t."""
    om, dm = _affine(ell.inv_model, o), _affine(ell.inv_model, d, bias=False)
    c = ell.center0[None] + time[:, None, None] * ell.displacement[None]
    oc = c - om
    a = _dot(dm, dm)
    h = _dot(dm, oc)
    cc = _dot(oc, oc) - (ell.radius * ell.radius)[None]
    disc = h * h - a * cc
    has_root = disc >= 0.0
    sq = _root_sqrt(disc)
    a_safe = torch.where(a > 0.0, a, 1.0)
    root0 = (h - sq) / a_safe
    root1 = (h + sq) / a_safe
    tmin, tmax = t_min[:, None], t_max[:, None]
    ok0 = (root0 > tmin) & (root0 < tmax)
    ok1 = (root1 > tmin) & (root1 < tmax)
    root = torch.where(ok0, root0, root1)
    hit = has_root & (ok0 | ok1) & ell.active[None, :] & (a > 0.0)
    return torch.where(hit, root, BIG)


def _ellipsoid_record(ell, o, d, time, t, idx):
    """The model-space sphere record mapped back: normal through the
    inverse-transpose (Transform.cpp:38,87), uv from the model normal."""
    inv = ell.inv_model[idx]
    lin = inv[:, :, :3]
    om = torch.sum(o[:, None, :] * lin, -1) + inv[:, :, 3]
    dm = torch.sum(d[:, None, :] * lin, -1)
    c = ell.center0[idx] + time[:, None] * ell.displacement[idx]
    rad = ell.radius[idx]
    pm = om + t[:, None] * dm
    outward_m = (pm - c) / torch.where(rad != 0.0, rad, 1.0)[:, None]
    n_raw = torch.sum(outward_m[:, None, :] * ell.inv_t[idx], -1)
    outward = n_raw / torch.sqrt(torch.clamp(_dot(n_raw, n_raw), min=1e-24))[:, None]
    point = o + t[:, None] * d
    front = _dot(d, outward) < 0.0
    normal = torch.where(front[:, None], outward, -outward)
    return point, normal, front, _uv_sphere(outward_m), ell.material[idx]


# ---- quads -----------------------------------------------------------------


def _quad_ts(quads, o, d, t_min, t_max):
    """Per-(ray, quad) accepted hit t, BIG where no hit: [N, Q]; alpha and
    beta by the triple-product identity (Quad.cpp:30-34)."""
    n, q, w = quads.normal, quads.q, quads.w
    a_alpha = _cross(quads.v, w)
    a_beta = _cross(w, quads.u)
    nd = _mm(d, n.T)
    no = _mm(o, n.T)
    not_parallel = torch.abs(nd) >= float(defs.QUAD_EPS)
    t = (quads.d[None, :] - no) / torch.where(not_parallel, nd, 1.0)
    alpha = _mm(o, a_alpha.T) + t * _mm(d, a_alpha.T) - _dot(q, a_alpha)[None, :]
    beta = _mm(o, a_beta.T) + t * _mm(d, a_beta.T) - _dot(q, a_beta)[None, :]
    tmin, tmax = t_min[:, None], t_max[:, None]
    hit = (not_parallel & (t >= tmin) & (t <= tmax) & (alpha >= 0.0) & (alpha <= 1.0)
           & (beta >= 0.0) & (beta <= 1.0) & quads.active[None, :])
    return torch.where(hit, t, BIG)


def _quad_record(quads, o, d, t, idx):
    """Point, normal, uv = (alpha, beta) of the winning quad (Quad.cpp:36-42)."""
    n = quads.normal[idx]
    point = o + t[:, None] * d
    pq = point - quads.q[idx]
    w = quads.w[idx]
    alpha = _dot(w, _cross(pq, quads.v[idx]))
    beta = _dot(w, _cross(quads.u[idx], pq))
    front = _dot(d, n) < 0.0
    normal = torch.where(front[:, None], n, -n)
    return point, normal, front, torch.stack([alpha, beta], -1), quads.material[idx]


# ---- constant media --------------------------------------------------------


def _boundary_interval(media, om, dm, time):
    """Entry/exit ts of the model-space ray against each boundary over the
    universe interval, and whether a second hit follows t0 + 1e-4
    (ConstantMedium.cpp:17-26): [N, M] each."""
    center = media.p0[None] + time[:, None, None] * media.displacement[None]
    oc = center - om
    a = _dot(dm, dm)
    h = _dot(dm, oc)
    c = _dot(oc, oc) - media.p1[None, :, 0] ** 2
    disc = h * h - a * c
    s_valid = disc > 0.0
    sq = torch.sqrt(torch.where(s_valid, disc, 1.0))
    s_t0 = (h - sq) / a
    s_t1 = (h + sq) / a
    # Box boundary: slabs (AABB.hpp:34-47) with a safe reciprocal.
    dm_safe = torch.where(torch.abs(dm) < 1e-12, torch.where(dm < 0, -1e-12, 1e-12), dm)
    inv = 1.0 / dm_safe
    lo = (media.p0[None] - om) * inv
    hi = (media.p1[None] - om) * inv
    b_t0 = torch.amax(torch.minimum(lo, hi), -1)
    b_t1 = torch.amin(torch.maximum(lo, hi), -1)
    is_sphere = (media.btype == defs.MEDIUM_SPHERE)[None, :]
    t0 = torch.where(is_sphere, s_t0, b_t0)
    t1 = torch.where(is_sphere, s_t1, b_t1)
    valid = torch.where(is_sphere, s_valid, b_t0 < b_t1)
    return t0, t1, valid & (t1 > t0 + float(defs.MEDIUM_EPS))


def _media_ts(media, o, d, time, t_min, t_max, u):
    """Per-(ray, medium) scatter t, BIG where the path leaves the medium
    first: [N, M]. ``u`` [N, M] are the free-path uniforms."""
    om = _affine(media.inv_model, o)
    dm_raw = _affine(media.inv_model, d, bias=False)
    dm_len = torch.clamp(_norm(dm_raw), min=1e-12)
    dm = dm_raw / dm_len[..., None]
    t0, t1, valid = _boundary_interval(media, om, dm, time)
    scale = dm_len / torch.clamp(_norm(d), min=1e-12)[:, None]
    tmin, tmax = t_min[:, None], t_max[:, None]
    e0 = torch.clamp(torch.maximum(t0, tmin * scale), min=0.0)
    e1 = torch.minimum(t1, tmax * scale)
    valid = valid & (e0 < e1)
    hit_dist = media.neg_inv_density[None, :] * torch.log(torch.clamp(u, min=1e-12))
    valid = valid & (hit_dist <= e1 - e0) & media.active[None, :]
    return torch.where(valid, (e0 + hit_dist) / scale, BIG)


def _media_record(media, o, d, t, idx):
    """Medium scatter record: fixed normal, front face (ConstantMedium.cpp:50-55)."""
    point = o + t[:, None] * d
    normal = torch.zeros_like(point)
    normal[:, 0] = 1.0
    front = torch.ones(t.shape, dtype=torch.bool, device=t.device)
    return point, normal, front, torch.zeros_like(point[:, :2]), media.material[idx]


# ---- combined closest hit --------------------------------------------------


def pallas_tables(scene, features):
    """B5's tables of a scene: ``pack_scene``'s rows and the live extents,
    (sph, qd, n_sph, n_quad). The extents are ``features["pallas_extents"]``,
    read from the host scene (the ``Renderer`` reads them), never from the
    device; a route without them is refused."""
    extents = features.get("pallas_extents")
    if extents is None:
        raise ValueError('the pallas route needs features["pallas_extents"], the live extents '
                         'of the host scene (intersect_kernel.live_extents)')
    return (*pk.pack_scene(scene.spheres, scene.quads), *extents)


def _sphere_quad_best_pallas(o, d, time, t_min, t_max, tables):
    """Per-family best (t, index) of spheres and quads from B5 over
    ``tables`` = (sph, qd, n_sph, n_quad) (``pallas_tables``)."""
    sph, qd, n_sph, n_quad = tables
    t, code = pk.closest_hit(o, d, time, t_min, t_max, sph, qd, n_sph=n_sph, n_quad=n_quad)
    fam = code >> pk.FAM_SHIFT           # -1 (miss) stays -1
    idx = (code & ((1 << pk.FAM_SHIFT) - 1)).to(torch.int64)
    is_s, is_q = fam == 0, fam == 1
    return (torch.where(is_s, t, BIG), torch.where(is_s, idx, 0),
            torch.where(is_q, t, BIG), torch.where(is_q, idx, 0))


def closest_hit(scene, o, d, time, u_media=None, t_min=None, t_max=None, features=None,
                tables=None) -> Hit:
    """Closest hit of N rays against the whole scene (JAX ``closest_hit``).

    ``u_media`` [N, M]: free-path uniforms; None treats media as absent.
    ``t_min``/``t_max`` default to [1e-3, BIG]. ``tables``: B5's
    ``pallas_tables`` of the scene (rows and live extents), made here when
    None and ``features["use_pallas"]`` is set."""
    n = o.shape[0]
    features = features or {}
    if t_min is None:
        t_min = torch.full((n,), float(defs.T_MIN), device=o.device)
    if t_max is None:
        t_max = torch.full((n,), BIG, device=o.device)
    if features.get("use_bvh_spheres", False):
        raise NotImplementedError(
            "the sphere BVH (use_bvh_spheres, --backend bvh) is not ported yet "
            "(ROADMAP queue A item 12, the sphere BVH)")

    if features.get("use_pallas", False):
        bt_s, bi_s, bt_q, bi_q = _sphere_quad_best_pallas(
            o, d, time, t_min, t_max, tables or pallas_tables(scene, features))
    else:
        bt_s, bi_s = _first_min(_sphere_ts(scene.spheres, o, d, time, t_min, t_max))
        bt_q, bi_q = _first_min(_quad_ts(scene.quads, o, d, t_min, t_max))

    if features.get("has_media", True) and u_media is not None:
        bt_m, bi_m = _first_min(_media_ts(scene.media, o, d, time, t_min, t_max, u_media))
    else:
        bt_m = torch.full((n,), BIG, device=o.device)
        bi_m = torch.zeros((n,), dtype=torch.int64, device=o.device)

    has_ell = features.get("has_ellipsoids", False) and scene.ellipsoids is not None
    if has_ell:
        bt_e, bi_e = _first_min(_ellipsoid_ts(scene.ellipsoids, o, d, time, t_min, t_max))
    else:
        bt_e = torch.full((n,), BIG, device=o.device)
        bi_e = torch.zeros((n,), dtype=torch.int64, device=o.device)

    t, fam = _first_min(torch.stack([bt_s, bt_q, bt_m, bt_e], -1))
    valid = t < BIG

    # Each family's record at its own best t, or at t = 0 where it has no
    # hit: only the winner's record is kept, and a point at t = BIG along an
    # unnormalised direction overflows to inf, which the backward of the
    # discarded record multiplies by its zero cotangent (NaN).
    def rec_t(bt):
        return torch.where(bt < BIG, bt, 0.0)

    rec_s = _sphere_record(scene.spheres, o, d, time, rec_t(bt_s), bi_s)
    rec_q = _quad_record(scene.quads, o, d, rec_t(bt_q), bi_q)
    rec_m = _media_record(scene.media, o, d, rec_t(bt_m), bi_m)
    rec_e = (_ellipsoid_record(scene.ellipsoids, o, d, time, rec_t(bt_e), bi_e)
             if has_ell else rec_s)

    def pick(s, q, m, e):
        def sel(f, a, b):
            return torch.where(f.view(-1, *([1] * (a.dim() - 1))), a, b)
        return sel(fam == 0, s, sel(fam == 1, q, sel(fam == 2, m, e)))

    point, normal, front, uv, mat = (pick(*r) for r in zip(rec_s, rec_q, rec_m, rec_e))
    # Missed rays: their record is never used, but shading computes it; t =
    # BIG points would overflow the texture math into inf/NaN.
    v3 = valid[:, None]
    point = torch.where(v3, point, 0.0)
    up = torch.zeros_like(normal)
    up[:, 2] = 1.0
    normal = torch.where(v3, normal, up)
    uv = torch.where(v3, uv, 0.0)
    mat = torch.where(valid, mat, 0)
    return Hit(valid=valid, t=t, point=point, normal=normal, front_face=front, uv=uv,
               material=mat)
