"""Gradient of the kernel render: the indexed-replay backward (its plain
PyTorch version and the wrapper that launches the Hopper kernel
``csrc/megakernel_grad.cu``) and the ``torch.autograd.Function`` that puts
it behind the forward kernels.

Port of ``raytrace2_tpu/ops/pallas/megakernel_grad.py`` (``_grad_kernel``,
launched by ``_grad_call``, and ``_make_diff_render``). The counter-hash
RNG makes each (pixel, sample) path a pure function of (seed, pixel,
sample), so the backward stores nothing from the forward: per sample it

* runs a pre-pass without gradient: the forward's camera ray and bounces,
  recording each bounce's winner (material, record index, family id
  ``mk.FAMID``);
* replays the path differentiably: each bounce resolves only its pinned
  winner (that family's body on the winner's columns, gathered by index),
  then shades and advances as the forward does. The winner's root choice
  and a medium's free path do not depend on the running best, so the
  replay's primal is the forward's.

Estimator (JAX ``grad.py``): discrete events carry no gradient — which
record wins, front or back face, reflect or refract, the checker cell, the
noise lattice cell, medium acceptance, and the alive masks. Reported
cotangents: ``camv[0:19]`` (zero beyond), the background, and the packed
table entries of the ``GRAD_*_KEYS`` columns (zero elsewhere); autograd
carries them on to the scene leaves through ``camera.make_camv`` and
``megakernel.pack_buffer``.

JAX's replay runs big scenes in 8-bounce segments to fit the TPU's VMEM;
the plain version here replays whole paths in lane chunks, and the kernel
keeps one thread's per-bounce carries in local memory.

The JAX kernel is traced per scene (family sizes, ``has_checker`` and
``has_noise`` static), so it holds only the code the scene needs; the
kernel here is built per scene feature mask (``megakernel.scene_features``,
shared with the forward kernels): which families and material types the
scene holds, a checker, and hash or table noise.
"""

from __future__ import annotations

import torch

from raytrace2_tpu_torch import tracing
from raytrace2_tpu_torch.ops import camera, rng
from raytrace2_tpu_torch.ops.kernels import megakernel as mk

# Differentiable columns per table, as the JAX kernel reports them (the
# other columns are ids, flags or medium boundary geometry).
GRAD_SPH_KEYS = ("c0x", "c0y", "c0z", "dpx", "dpy", "dpz", "rad")
GRAD_QUAD_KEYS = ("nx", "ny", "nz", "d", "aax", "aay", "aaz",
                  "abx", "aby", "abz", "qaa", "qab")
GRAD_BOX_KEYS = ("x0", "y0", "z0", "x1", "y1", "z1")
GRAD_MED_KEYS = ("nid",)
GRAD_MAT_KEYS = ("alr", "alg", "alb", "param")
GRAD_TEX_KEYS = ("alr", "alg", "alb", "scale")
GRAD_KEYS = {"sph": GRAD_SPH_KEYS, "quad": GRAD_QUAD_KEYS, "box": GRAD_BOX_KEYS,
             "med": GRAD_MED_KEYS, "mat": GRAD_MAT_KEYS, "tex": GRAD_TEX_KEYS}
N_CAMV_DIFF = 19  # camv entries 0..18 are camera geometry; the rest batch params
GRAD_MAX_DEPTH = 64
# Sweep records the kernel path takes (JAX megakernel.MAX_SMEM_RECORDS).
MAX_RECORDS = 4096
# Lanes per replay pass of the plain version: bounds autograd's memory.
LANE_CHUNK = 1 << 17

# Launches of the CUDA kernel (the plain version does not count).
LAUNCHES = 0

# The scene feature mask that picks the kernel's instance (shared with v4
# and B4: megakernel.scene_features); re-exported under the names the
# gradient path has used.
(F_SPH, F_QUAD, F_BOX, F_MED, F_CHECKER, F_HASH_NOISE, F_TABLE_NOISE, F_METAL,
 F_DIEL, F_ALL) = (mk.F_SPH, mk.F_QUAD, mk.F_BOX, mk.F_MED, mk.F_CHECKER, mk.F_HASH_NOISE,
                   mk.F_TABLE_NOISE, mk.F_METAL, mk.F_DIEL, mk.F_ALL)
feature_mask, material_types = mk.feature_mask, mk.material_types
scene_material_types, grad_features = mk.scene_material_types, mk.scene_features


def grad_supported(sizes, max_depth) -> bool:
    """Scenes within the kernel path's record bound, at depth ≤ 64 (JAX
    ``grad_supported``; it allows hash and table noise, which is what gives
    geometry and camera leaves a gradient under the detached estimator)."""
    n_sph, n_quad, _, _, n_med, n_box = sizes
    return n_sph + n_quad + n_box + n_med <= MAX_RECORDS and max_depth <= GRAD_MAX_DEPTH


def grad_mask(sizes, device="cpu") -> torch.Tensor:
    """Bool mask over the packed buffer: True on the ``GRAD_*_KEYS`` rows."""
    layout = mk.table_layout(sizes)
    mask = torch.zeros(layout["total"][0], dtype=torch.bool, device=device)
    for fam, keys in mk.FAMILIES:
        base, rows = layout[fam]
        for i, k in enumerate(keys):
            if k in GRAD_KEYS[fam]:
                mask[base + i * rows: base + (i + 1) * rows] = True
    return mask


# ---------------------------------------------------------------------------
# The replay (differentiable under torch.autograd)
# ---------------------------------------------------------------------------


def camera_rays(cv, xx, yy, in_grid, s_f, key, sqrt_spp):
    """Carry of a fresh camera ray per lane, and its time (JAX
    ``_grad_kernel.camera_rays``). Lanes outside the image get a dummy unit
    ray and alive = 0, so no NaN reaches a cotangent. ``cv`` is the camv
    list of floats (pre-pass) or tensor (replay, entries 0-17 in the
    graph)."""
    ox, oy, oz, dx, dy, dz, tm = camera.camera_ray(cv, xx, yy, sqrt_spp, s_f, key)
    ox, oy, oz = (torch.where(in_grid, c, 0.0) for c in (ox, oy, oz))
    dx, dy = torch.where(in_grid, dx, 0.0), torch.where(in_grid, dy, 0.0)
    dz = torch.where(in_grid, dz, 1.0)
    zero, one = torch.zeros_like(xx), torch.ones_like(xx)
    alive0 = torch.where(in_grid, 1.0, 0.0)
    return (zero, alive0, ox, oy, oz, dx, dy, dz, one, one, one, zero, zero, zero), tm


_BODIES = (("sph", mk.SPH_KEYS, mk.sph_body), ("quad", mk.QUAD_KEYS, mk.quad_body),
           ("box", mk.BOX_KEYS, mk.box_body), ("med", mk.MED_KEYS, mk.med_body))


def resolve_shade(key, tm, carry, winner, cols, bg, *, sizes, has_checker, has_noise,
                  max_depth, ntab=None):
    """One replayed bounce with a pinned winner (JAX ``_make_resolve_shade``):
    gather the winner's columns from ``cols`` (``unpack_buffer`` of the
    packed tables) by index, run its family's body once, then the forward's
    ``_shade_advance``. ``winner`` = (material, record index, family id),
    as ``make_bounce(track=True)`` returns it; ``bg`` is a [3] tensor.
    Differentiable in ``carry``, ``cols`` and ``bg``; with ``ntab`` the
    noise is table Perlin, whose tables are constants (JAX
    ``_noise_factor_impl_table``: gathers at detached lattice cells, the
    gradient through the Hermite weights and the (u - di) terms)."""
    n_sph, n_quad, _, _, n_med, n_box = sizes
    count = {"sph": n_sph, "quad": n_quad, "box": n_box, "med": n_med}
    matf, idx, famid = winner
    bn, _, ox, oy, oz, dx, dy, dz = carry[:8]
    a = dx * dx + dy * dy + dz * dz
    ray = dict(tm=tm, ox=ox, oy=oy, oz=oz, dx=dx, dy=dy, dz=dz, a=a, inv_a=1.0 / a,
               best_t=mk.BIG, aux=1.0)
    rec = [torch.full_like(ox, mk.BIG), torch.full_like(ox, -1.0), torch.zeros_like(ox),
           torch.zeros_like(ox), torch.zeros_like(ox), torch.zeros_like(ox),
           torch.ones_like(ox)]
    for fam, keys, body in _BODIES:
        if not count[fam]:
            continue
        sel = famid == float(mk.FAMID[fam])
        gi = torch.where(sel, idx, 0.0).to(torch.int64)
        g = {k: cols[fam][k][gi] for k in keys}
        extra = {}
        if fam == "box":
            extra = dict(inv_d=(mk._safe_inv(dx), mk._safe_inv(dy), mk._safe_inv(dz)),
                         sgn_d=(torch.sign(dx), torch.sign(dy), torch.sign(dz)))
        elif fam == "med":
            # The draw counter of the winner's own index, as the sweep drew it.
            bctr = bn.to(torch.int32).to(torch.int64) * (3 + n_med)
            extra = dict(key=key, ctr=bctr + 3 + gi,
                         d_len=torch.sqrt(torch.clamp(a, min=1e-24)))
        closer, vals = body(g, **ray, **extra)
        sel = sel & closer
        rec = [torch.where(sel, v, r) for v, r in zip(vals, rec)]
    midx = matf.to(torch.int64)
    mat6 = tuple(cols["mat"][k][midx] for k in mk.MAT_KEYS)

    def tex_resolve(idx_f):
        ti = idx_f.to(torch.int64)
        return tuple(cols["tex"][k][ti] for k in mk.TEX_KEYS)

    return mk._shade_advance(carry, rec, mat6, tex_resolve, bg, key,
                             has_checker=has_checker, has_noise=has_noise,
                             max_depth=max_depth, n_med=n_med, ntab=ntab)


def grad_plain(camv, seed, packed, background, g, *, n_pix, max_depth, sizes,
               has_checker, has_noise, ntab=None, bounces=None, mat_types=None):
    """Plain PyTorch version of the backward kernel: the vector-Jacobian
    product of the v4 render (radiance summed over ``camv[22]`` samples,
    [n_pix, 3]) with the cotangent ``g`` [n_pix, 3]. Per sample: the pre-pass
    without gradient records every bounce's winner, then the path is
    replayed under ``torch.autograd``. Returns (d_camv [28], d_background
    [3], d_packed): zero beyond camv entry 18 and outside the GRAD keys.
    The (pixel slot, sample) lanes replay ``LANE_CHUNK`` at a time. ``bounces`` (an int64 [1]
    tensor, optional) gets the number of live bounces of the pre-pass added,
    as the kernel counts them. ``ntab`` (table noise) takes no cotangent.
    ``mat_types``, which picks the kernel's instance, changes nothing here."""
    device = packed.device
    cv = [float(x) for x in camv.tolist()]
    bounce = mk.make_bounce(packed, background, max_depth=max_depth, sizes=sizes,
                            has_checker=has_checker, has_noise=has_noise, ntab=ntab)
    camv_l = camv.detach().clone().requires_grad_(True)
    bg_l = background.detach().clone().requires_grad_(True)
    packed_l = packed.detach().clone().requires_grad_(True)
    leaves = (camv_l, bg_l, packed_l)
    acc = [torch.zeros_like(x) for x in leaves]
    shade_kw = dict(sizes=sizes, has_checker=has_checker, has_noise=has_noise,
                    max_depth=max_depth, ntab=ntab)
    n_lanes = n_pix * int(cv[22])
    for l0 in range(0, n_lanes, LANE_CHUNK):
        q = torch.arange(l0, min(l0 + LANE_CHUNK, n_lanes), dtype=torch.int32, device=device)
        slot = q % n_pix
        xx, yy, in_grid = camera.slot_to_pixel((slot + int(cv[25])).to(torch.float32), cv)
        pid_u = rng.as_u32(yy * cv[19] + xx)
        gl = g[slot].to(torch.float32)
        s_f = (q // n_pix).to(torch.float32) + cv[21]
        key = rng.v4_sample_key(seed, pid_u, s_f)
        with torch.no_grad():
            carry, tm = camera_rays(cv, xx, yy, in_grid, s_f, key, cv[23])
            winners = []
            while len(winners) < max_depth and bool((carry[1] > 0.0).any()):
                if bounces is not None:
                    bounces += (carry[1] > 0.0).sum()
                carry, w = bounce(key, tm, carry, track=True)
                winners.append(w)
        with torch.enable_grad():  # also inside an autograd backward
            cols = mk.unpack_buffer(packed_l, sizes)
            carry, tm = camera_rays(camv_l, xx, yy, in_grid, s_f, key, cv[23])
            for w in winners:
                # Only the lanes alive at this bounce replay it, as in
                # the kernel: a dead lane's bounce changes nothing, but
                # its masked branches can hold 0 * inf in the backward.
                live = torch.nonzero(carry[1].detach() > 0.0).squeeze(1)
                sub = resolve_shade(key[live], tm[live], tuple(c[live] for c in carry),
                                    tuple(x[live] for x in w), cols, bg_l, **shade_kw)
                carry = tuple(c.index_copy(0, live, v) for c, v in zip(carry, sub))
            out = (carry[11] * gl[:, 0] + carry[12] * gl[:, 1]
                   + carry[13] * gl[:, 2]).sum()
            if not out.requires_grad:
                continue  # no lane of the chunk is in the image (a shard past its edge)
            grads = torch.autograd.grad(out, leaves, allow_unused=True)
        for a, d in zip(acc, grads):
            if d is not None:
                a += d
    d_camv, d_bg, d_packed = acc
    d_camv[N_CAMV_DIFF:] = 0.0
    return d_camv, d_bg, torch.where(grad_mask(sizes, device), d_packed, 0.0)


# ---------------------------------------------------------------------------
# Wrapper and autograd Function
# ---------------------------------------------------------------------------


def grad_call(camv, seed, packed, background, g, *, n_pix, max_depth, sizes,
              has_checker, has_noise, ntab=None, bounces=None, mat_types=None):
    """(d_camv [28], d_background [3], d_packed) of the render's
    vector-Jacobian product with ``g`` [n_pix, 3]. On a CPU tensor this runs
    the plain version; on a CUDA tensor it launches the Hopper kernel's
    instance for the scene's ``feature_mask`` (built at first use) or
    raises. ``bounces`` (an int64 [1] tensor on the same
    device, optional) gets the number of replayed bounces added. ``ntab``
    (``megakernel.pack_noise_tables``) selects table noise. ``mat_types``
    (``scene_material_types``; None: read from ``packed``) are the material
    type ids the scene holds."""
    global LAUNCHES
    mk.check_inputs(camv, packed, background, n_pix, sizes)
    mk.check_ntab(ntab, packed)
    if g.dtype != torch.float32 or not g.is_contiguous() or tuple(g.shape) != (n_pix, 3) \
            or g.device != packed.device:
        raise ValueError("g must be a contiguous [n_pix, 3] float32 tensor on the "
                         "tables' device")
    if not grad_supported(sizes, max_depth):
        raise ValueError(f"sizes {sizes} at depth {max_depth} are outside the "
                         "gradient kernel's bounds")
    if packed.device.type == "cpu":
        return grad_plain(camv, seed, packed, background, g, n_pix=n_pix,
                          max_depth=max_depth, sizes=sizes, has_checker=has_checker,
                          has_noise=has_noise, ntab=ntab, bounces=bounces)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    from raytrace2_tpu_torch.ops.kernels import build

    d_camv = torch.zeros_like(camv)
    d_bg = torch.zeros_like(background)
    d_packed = torch.zeros_like(packed)
    build.launch_megakernel_grad(
        camv, int(seed), background, packed, ntab, g, d_camv, d_bg, d_packed, n_pix=n_pix,
        max_depth=max_depth, counts=mk.counts(sizes, mk.n_noise_of(ntab)),
        checker_depth=int(has_checker), has_noise=bool(has_noise),
        features=grad_features(packed, sizes, has_checker, has_noise, ntab, mat_types),
        bounces=bounces)
    LAUNCHES += 1
    return d_camv, d_bg, d_packed


class DiffRender(torch.autograd.Function):
    """The kernel render as an autograd node (JAX ``_make_diff_render``).

    ``apply(camv, packed, background, seed, forward, grad_kw)``: the forward
    is ``forward(camv, seed, packed, background)`` — the integrator's own
    route (v4, or the sorted wavefront above 256 records), so the result is
    bitwise the non-differentiable render's, [n_pix, 3] in pixel order. It
    saves only its inputs; the backward is ``grad_call(..., **grad_kw)``.
    ``packed`` is packed from the current geometry at every forward, so the
    cluster tables that steer both sweeps are never stale under
    optimisation (JAX rebuilds them inside the same jit)."""

    @staticmethod
    def forward(ctx, camv, packed, background, seed, forward, grad_kw):
        ctx.save_for_backward(camv, packed, background)
        ctx.seed, ctx.grad_kw = seed, grad_kw
        return forward(camv, seed, packed, background)

    @staticmethod
    def backward(ctx, g):
        camv, packed, background = ctx.saved_tensors
        with tracing.span("grad.replay"):
            d_camv, d_bg, d_packed = grad_call(camv, ctx.seed, packed, background,
                                               g.contiguous(), **ctx.grad_kw)
        return d_camv, d_packed, d_bg, None, None, None
