"""Fused sphere + quad closest hit (B5): host packing, the plain PyTorch
version, and the wrapper that launches the Hopper kernel
(``csrc/intersect_kernel.cu``).

Port of ``raytrace2_tpu/ops/pallas/intersect_kernel.py`` (``_kernel``,
launched by ``closest_hit_pallas``), which serves ``Renderer(backend=
"pallas")``: the non-kernel path's bounce loop calls it once per bounce for
the sphere and quad families, and resolves media and ellipsoids densely.
For each ray it returns the nearest sphere or quad hit inside
(t_min, t_max): ``best_t`` [N] f32 (3e38 on a miss) and ``code`` [N] int32,
``family << 24 | index`` (family 0 spheres, 1 quads; -1 on a miss).

The arithmetic is the Pallas kernel's: ``inv_a = 1/a`` and ``(h ∓ sq) *
inv_a``, ``sq = sqrt(has ? disc : 0)``, the quad's ``t = (d - n·o) /
(not_par ? n·d : 1)``, closed intervals for quads and strict ones for
spheres, ``act > 0``. Records are tested in index order, spheres before
quads, and a hit replaces the best only when strictly closer, which is the
Pallas kernel's tile-wise argmin plus its strict ``<`` across tiles: the
first index wins a tie.
"""

from __future__ import annotations

import torch

from raytrace2_tpu_torch import defs
from raytrace2_tpu_torch.ops.kernels.megakernel import _cross

BIG = 3.0e38
TILE_P = 128      # records per tile (the Pallas kernel's primitive tile)
FAM_SHIFT = 24
CODE_SPHERE = 0 << FAM_SHIFT
CODE_QUAD = 1 << FAM_SHIFT

SPH_KEYS = ("c0x", "c0y", "c0z", "dpx", "dpy", "dpz", "r2", "act")
QUAD_KEYS = ("nx", "ny", "nz", "d", "aax", "aay", "aaz", "abx", "aby", "abz",
             "qaa", "qab", "act")

# Launches of the CUDA kernel (the plain version does not count).
LAUNCHES = 0


def _dot3_fused(a, b):
    """``a·b`` of [P, 3] rows as XLA contracts the JAX ``jnp.sum(a * b, -1)``
    here: fma(a2, b2, fma(a1, b1, a0*b0)), each fma taken in float64 (where
    the product of two f32 is exact) and rounded once to f32."""
    a, b = a.double(), b.double()
    s = (a[:, 0] * b[:, 0]).float()
    s = (a[:, 1] * b[:, 1] + s.double()).float()
    return (a[:, 2] * b[:, 2] + s.double()).float()


def pack_scene(spheres, quads):
    """Record rows of every sphere and quad (active or not), each padded with
    zeros to a multiple of ``TILE_P``, as the JAX ``pack_scene`` (:189-223)
    emits them: ``sph`` [8, Ps] (``SPH_KEYS``) and ``qd`` [13, Pq]
    (``QUAD_KEYS``), contiguous f32 on the scene's device. The cross
    products and ``q·(v×w)`` are fused as XLA contracts them, so the rows
    equal the JAX package's bit for bit."""
    def rows(cols):
        x = torch.stack([c.to(torch.float32) for c in cols])
        return torch.nn.functional.pad(x, (0, -x.shape[1] % TILE_P)).contiguous()

    sph = rows([spheres.center0[:, 0], spheres.center0[:, 1], spheres.center0[:, 2],
                spheres.displacement[:, 0], spheres.displacement[:, 1],
                spheres.displacement[:, 2], spheres.radius * spheres.radius,
                spheres.active])
    a_alpha = _cross(quads.v, quads.w)
    a_beta = _cross(quads.w, quads.u)
    qd = rows([quads.normal[:, 0], quads.normal[:, 1], quads.normal[:, 2], quads.d,
               a_alpha[:, 0], a_alpha[:, 1], a_alpha[:, 2],
               a_beta[:, 0], a_beta[:, 1], a_beta[:, 2],
               _dot3_fused(quads.q, a_alpha), _dot3_fused(quads.q, a_beta), quads.active])
    return sph, qd


# ---------------------------------------------------------------------------
# Plain version (PyTorch, [N, TILE_P] record tiles)
# ---------------------------------------------------------------------------


def _sphere_tile(ray, s):
    """[N, TILE_P] accepted roots of one sphere tile (``_sphere_pass``)."""
    ox, oy, oz, dx, dy, dz, tm, t0, t1, a, inv_a = ray
    cx = s[0] + tm * s[3]
    cy = s[1] + tm * s[4]
    cz = s[2] + tm * s[5]
    ocx, ocy, ocz = cx - ox, cy - oy, cz - oz
    h = dx * ocx + dy * ocy + dz * ocz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - s[6]
    disc = h * h - a * cc
    has = disc >= 0.0
    sq = torch.sqrt(torch.where(has, disc, 0.0))
    r0 = (h - sq) * inv_a
    r1 = (h + sq) * inv_a
    ok0 = (r0 > t0) & (r0 < t1)
    ok1 = (r1 > t0) & (r1 < t1)
    root = torch.where(ok0, r0, r1)
    hit = has & (ok0 | ok1) & (s[7] > 0)
    return torch.where(hit, root, BIG)


def _quad_tile(ray, q):
    """[N, TILE_P] accepted plane ts of one quad tile (``_quad_pass``)."""
    ox, oy, oz, dx, dy, dz, _, t0, t1, _, _ = ray
    nd = dx * q[0] + dy * q[1] + dz * q[2]
    no = ox * q[0] + oy * q[1] + oz * q[2]
    not_par = torch.abs(nd) >= float(defs.QUAD_EPS)
    t = (q[3] - no) / torch.where(not_par, nd, 1.0)
    o_aa = ox * q[4] + oy * q[5] + oz * q[6]
    d_aa = dx * q[4] + dy * q[5] + dz * q[6]
    o_ab = ox * q[7] + oy * q[8] + oz * q[9]
    d_ab = dx * q[7] + dy * q[8] + dz * q[9]
    alpha = o_aa + t * d_aa - q[10]
    beta = o_ab + t * d_ab - q[11]
    hit = (not_par & (t >= t0) & (t <= t1) & (alpha >= 0.0) & (alpha <= 1.0)
           & (beta >= 0.0) & (beta <= 1.0) & (q[12] > 0))
    return torch.where(hit, t, BIG)


def closest_hit_plain(o, d, time, t_min, t_max, sph, qd):
    """Plain PyTorch version of the kernel, over [N, TILE_P] record tiles in
    the Pallas kernel's order of operations. Returns (best_t, code)."""
    n = o.shape[0]
    cols = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], time, t_min, t_max]
    ox, oy, oz, dx, dy, dz, tm, t0, t1 = (c[:, None] for c in cols)
    a = dx * dx + dy * dy + dz * dz
    ray = (ox, oy, oz, dx, dy, dz, tm, t0, t1, a, 1.0 / a)
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=o.device)
    code = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    for rows, tile_fn, fam in ((sph, _sphere_tile, CODE_SPHERE), (qd, _quad_tile, CODE_QUAD)):
        for off in range(0, rows.shape[1], TILE_P):
            ts = tile_fn(ray, rows[:, None, off:off + TILE_P])
            tile_best, tile_arg = ts.min(dim=1)
            closer = tile_best < best_t
            best_t = torch.where(closer, tile_best, best_t)
            code = torch.where(closer, (tile_arg + (fam + off)).to(torch.int32), code)
    return best_t, code


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------


def closest_hit(o, d, time, t_min, t_max, sph, qd):
    """Nearest sphere/quad hit of each ray: (best_t [N] f32, code [N] int32).

    ``o``, ``d`` [N, 3]; ``time``, ``t_min``, ``t_max`` [N]; ``sph``, ``qd``
    from ``pack_scene``. On a CPU tensor this runs the plain version; on a
    CUDA tensor it launches the Hopper kernel (built at first use) or
    raises. Any N: the kernel masks the tail."""
    global LAUNCHES
    n = o.shape[0]
    for name, t, shape in (("o", o, (n, 3)), ("d", d, (n, 3)), ("time", time, (n,)),
                           ("t_min", t_min, (n,)), ("t_max", t_max, (n,)),
                           ("sph", sph, (len(SPH_KEYS), sph.shape[-1])),
                           ("qd", qd, (len(QUAD_KEYS), qd.shape[-1]))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != o.device:
            raise ValueError(f"{name} is on {t.device}, o on {o.device}")
    if o.device.type == "cpu":
        return closest_hit_plain(o, d, time, t_min, t_max, sph, qd)
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    from raytrace2_tpu_torch.ops.kernels import build

    best_t = torch.empty((n,), dtype=torch.float32, device=o.device)
    code = torch.empty((n,), dtype=torch.int32, device=o.device)
    build.launch_intersect_kernel(*(x.contiguous() for x in (o, d, time, t_min, t_max,
                                                             sph, qd)), best_t, code)
    LAUNCHES += 1
    return best_t, code
