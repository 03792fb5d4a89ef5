"""v4 path-regeneration megakernel: host packing, the plain PyTorch version,
and the wrapper that launches the Hopper kernel (``csrc/megakernel_v4.cu``).

Port of ``raytrace2_tpu/ops/pallas/megakernel.py`` (``_render_kernel_v4``,
launched by ``trace_megakernel_batch``) in its linear-slot, instant-
regeneration form: every lane owns one pixel and loops over that pixel's
samples; when its path ends it regenerates the camera ray of its next
sample, and it returns the radiance summed over the batch's samples.

The plain version below follows the JAX kernel's math operation by
operation, vectorised over all lanes at once. It is what the CPU tests and
the on-card comparison run; on a CUDA tensor the wrapper launches the kernel
and nothing else.

Sweep order and comparisons are the JAX kernel's: spheres → quads → AA
boxes → media, flat in record order; sphere ``root < best_t``, quad
``t <= best_t``, box ``t < best_t``, medium ``hit_dist <= e1 - e0``. The
material/texture resolve is a direct index (the JAX sweep and gather both
copy exact table values, so the result is the same).
"""

from __future__ import annotations

import torch

from raytrace2_tpu_torch import defs
from raytrace2_tpu_torch.ops import camera, rng

BIG = 3.0e38

SPH_KEYS = ("c0x", "c0y", "c0z", "dpx", "dpy", "dpz", "rad", "mat", "act")
QUAD_KEYS = ("nx", "ny", "nz", "d", "aax", "aay", "aaz", "abx", "aby",
             "abz", "qaa", "qab", "mat")
BOX_KEYS = ("x0", "y0", "z0", "x1", "y1", "z1", "mat", "act")
MED_KEYS = ("btype", "p0x", "p0y", "p0z", "p1x", "p1y", "p1z",
            "dspx", "dspy", "dspz",
            "i00", "i01", "i02", "i03", "i10", "i11", "i12", "i13",
            "i20", "i21", "i22", "i23", "nid", "mat")
MAT_KEYS = ("mtype", "alr", "alg", "alb", "param", "tex")
TEX_KEYS = ("ttype", "alr", "alg", "alb", "inv_scale", "even", "odd",
            "scale", "ntype", "nslot")
FAMILIES = (("sph", SPH_KEYS), ("quad", QUAD_KEYS), ("box", BOX_KEYS),
            ("med", MED_KEYS), ("mat", MAT_KEYS), ("tex", TEX_KEYS))

# Launches of the CUDA kernel (the plain version does not count).
LAUNCHES = 0


# ---------------------------------------------------------------------------
# Host side: table packing
# ---------------------------------------------------------------------------


def _fms(a, b, c, d):
    """``a*b - c*d`` with the first product fused, as XLA contracts the JAX
    package's ``jnp.cross`` (fma(a, b, -(c*d))): computed in float64, where
    a*b of two f32 is exact, then rounded once to f32."""
    return (a.double() * b.double() - (c * d).double()).float()


def _cross(a, b):
    return torch.stack([
        _fms(a[:, 1], b[:, 2], a[:, 2], b[:, 1]),
        _fms(a[:, 2], b[:, 0], a[:, 0], b[:, 2]),
        _fms(a[:, 0], b[:, 1], a[:, 1], b[:, 0]),
    ], dim=-1)


def _dot3(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def pack_tables(scene, sizes):
    """Record columns of the active rows, as the JAX ``pack_tables``
    (megakernel.py:273-380) emits them, without its cluster tables.

    ``scene`` is a FlatScene of torch tensors (``schema.to_device``).
    Returns six dicts (sph, quad, box, med, mat, tex) of f32 columns of
    ``family_rows(sizes)`` rows each: the JAX package's columns without the
    ``act = 0`` rows it pads spheres and boxes with."""
    rows = family_rows(sizes)
    s, q_, m_, b_ = rows["sph"], rows["quad"], rows["med"], rows["box"]

    def f32(x):
        return x.to(torch.float32)

    sp = scene.spheres
    act = torch.full((s,), float(sizes[0] > 0), device=sp.radius.device)
    sph = dict(
        c0x=sp.center0[:s, 0], c0y=sp.center0[:s, 1], c0z=sp.center0[:s, 2],
        dpx=sp.displacement[:s, 0], dpy=sp.displacement[:s, 1],
        dpz=sp.displacement[:s, 2], rad=sp.radius[:s], mat=sp.material[:s],
        act=act,
    )
    sph = {k: f32(v) for k, v in sph.items()}

    q = scene.quads
    a_alpha = _cross(q.v, q.w)
    a_beta = _cross(q.w, q.u)
    quad = dict(
        nx=q.normal[:q_, 0], ny=q.normal[:q_, 1], nz=q.normal[:q_, 2], d=q.d[:q_],
        aax=a_alpha[:q_, 0], aay=a_alpha[:q_, 1], aaz=a_alpha[:q_, 2],
        abx=a_beta[:q_, 0], aby=a_beta[:q_, 1], abz=a_beta[:q_, 2],
        qaa=_dot3(q.q, a_alpha)[:q_], qab=_dot3(q.q, a_beta)[:q_],
        mat=q.material[:q_],
    )
    quad = {k: f32(v) for k, v in quad.items()}

    bx = scene.boxes
    box = dict(
        x0=bx.bmin[:b_, 0], y0=bx.bmin[:b_, 1], z0=bx.bmin[:b_, 2],
        x1=bx.bmax[:b_, 0], y1=bx.bmax[:b_, 1], z1=bx.bmax[:b_, 2],
        mat=bx.material[:b_],
        act=torch.full((b_,), float(sizes[5] > 0), device=bx.bmin.device),
    )
    box = {k: f32(v) for k, v in box.items()}

    md = scene.media
    med = dict(btype=md.btype[:m_])
    for i, axis in enumerate("xyz"):
        med["p0" + axis] = md.p0[:m_, i]
    for i, axis in enumerate("xyz"):
        med["p1" + axis] = md.p1[:m_, i]
    for i, axis in enumerate("xyz"):
        med["dsp" + axis] = md.displacement[:m_, i]
    for r in range(3):
        for c in range(4):
            med[f"i{r}{c}"] = md.inv_model[:m_, r, c]
    med["nid"] = md.neg_inv_density[:m_]
    med["mat"] = md.material[:m_]
    med = {k: f32(med[k]) for k in MED_KEYS}

    m = scene.materials
    mat = dict(mtype=m.mtype, alr=m.albedo[:, 0], alg=m.albedo[:, 1],
               alb=m.albedo[:, 2], param=m.param, tex=m.tex)
    mat = {k: f32(v) for k, v in mat.items()}

    t = scene.textures
    is_noise = (t.ttype == defs.TEX_NOISE).to(torch.int32)
    nslot = torch.cumsum(is_noise, 0) - is_noise
    tex = dict(ttype=t.ttype, alr=t.albedo[:, 0], alg=t.albedo[:, 1],
               alb=t.albedo[:, 2], inv_scale=t.inv_scale, even=t.even,
               odd=t.odd, scale=t.scale, ntype=t.noise_type, nslot=nslot)
    tex = {k: f32(v) for k, v in tex.items()}
    return sph, quad, box, med, mat, tex


def family_rows(sizes) -> dict:
    """Rows per column of each family in the packed buffer: the active
    records (at least one row, as in the JAX tables)."""
    n_sph, n_quad, n_mat, n_tex, n_med, n_box = sizes
    return {"sph": max(n_sph, 1), "quad": max(n_quad, 1), "box": max(n_box, 1),
            "med": max(n_med, 1), "mat": n_mat, "tex": n_tex}


def table_layout(sizes) -> dict:
    """Static offsets of the packed buffer: family → (base, rows). Column
    ``k`` of a family starts at ``base + k * rows``. The CUDA kernel
    computes the same offsets from the same counts."""
    rows = family_rows(sizes)
    layout, base = {}, 0
    for fam, keys in FAMILIES:
        layout[fam] = (base, rows[fam])
        base += len(keys) * rows[fam]
    layout["total"] = (base, 0)
    return layout


def pack_buffer(scene, sizes) -> torch.Tensor:
    """The scene's table columns (``pack_tables``) as one contiguous f32
    buffer laid out by ``table_layout``, on the scene's device."""
    tables = pack_tables(scene, sizes)
    return torch.cat([tbl[k] for (_, keys), tbl in zip(FAMILIES, tables)
                      for k in keys]).contiguous()


def unpack_buffer(packed: torch.Tensor, sizes) -> dict:
    """Inverse of ``pack_buffer``: family → {key: column view}."""
    layout = table_layout(sizes)
    out = {}
    for fam, keys in FAMILIES:
        base, n = layout[fam]
        out[fam] = {k: packed[base + i * n: base + (i + 1) * n]
                    for i, k in enumerate(keys)}
    return out


# ---------------------------------------------------------------------------
# Plain version of the kernel (PyTorch, vectorised over lanes)
# ---------------------------------------------------------------------------


def _safe_inv(c):
    """1/c with the sign-preserving epsilon clamp of the slab tests."""
    return 1.0 / torch.where(torch.abs(c) < 1e-12,
                             torch.where(c < 0, -1e-12, 1e-12), c)


def sph_body(g, *, tm, ox, oy, oz, dx, dy, dz, a, inv_a, best_t, aux, **_):
    """Sphere test (JAX ``make_family_bodies.sph_body``). ``g`` maps each
    ``SPH_KEYS`` column to the record's value: a float in the sweep, a
    per-lane tensor in the gradient replay. Returns (closer, record)."""
    t_min = float(defs.T_MIN)
    cx = g["c0x"] + tm * g["dpx"]
    cy = g["c0y"] + tm * g["dpy"]
    cz = g["c0z"] + tm * g["dpz"]
    ocx, ocy, ocz = cx - ox, cy - oy, cz - oz
    h = dx * ocx + dy * ocy + dz * ocz
    rad = g["rad"]
    cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
    disc = h * h - a * cc
    has = disc >= 0.0
    # Double where: the replay's backward meets no sqrt'(0) on masked lanes.
    sq = torch.where(has, torch.sqrt(torch.where(has, disc, 1.0)), 0.0)
    root0 = (h - sq) * inv_a
    root1 = (h + sq) * inv_a
    ok0 = (root0 > t_min) & (root0 < best_t)
    ok1 = (root1 > t_min) & (root1 < best_t)
    root = torch.where(ok0, root0, root1)
    closer = has & (ok0 | ok1) & (g["act"] > 0)
    return closer, (root, 0.0, g["mat"], cx, cy, cz, rad)


def quad_body(g, *, ox, oy, oz, dx, dy, dz, best_t, aux, **_):
    """Quad test (``quad_body``): plane t, then alpha/beta inside [0, 1]."""
    t_min = float(defs.T_MIN)
    nx, ny, nz = g["nx"], g["ny"], g["nz"]
    nd = dx * nx + dy * ny + dz * nz
    no = ox * nx + oy * ny + oz * nz
    not_par = torch.abs(nd) >= float(defs.QUAD_EPS)
    t = (g["d"] - no) / torch.where(not_par, nd, 1.0)
    o_aa = ox * g["aax"] + oy * g["aay"] + oz * g["aaz"]
    d_aa = dx * g["aax"] + dy * g["aay"] + dz * g["aaz"]
    o_ab = ox * g["abx"] + oy * g["aby"] + oz * g["abz"]
    d_ab = dx * g["abx"] + dy * g["aby"] + dz * g["abz"]
    alpha = o_aa + t * d_aa - g["qaa"]
    beta = o_ab + t * d_ab - g["qab"]
    closer = (not_par & (t >= t_min) & (t <= best_t)
              & (alpha >= 0.0) & (alpha <= 1.0)
              & (beta >= 0.0) & (beta <= 1.0))
    return closer, (t, 1.0, g["mat"], nx, ny, nz, aux)


def box_body(g, *, ox, oy, oz, inv_d, sgn_d, best_t, aux, **_):
    """AA box slab test (``box_body``): entry at t0 with the entering face's
    normal, exit at t1 for a ray that starts inside. ``inv_d`` and
    ``sgn_d`` are the ray's safe reciprocal and sign per axis."""
    t_min = float(defs.T_MIN)
    inv_dx, inv_dy, inv_dz = inv_d
    tax = (g["x0"] - ox) * inv_dx
    tbx = (g["x1"] - ox) * inv_dx
    tay = (g["y0"] - oy) * inv_dy
    tby = (g["y1"] - oy) * inv_dy
    taz = (g["z0"] - oz) * inv_dz
    tbz = (g["z1"] - oz) * inv_dz
    lox, hix = torch.minimum(tax, tbx), torch.maximum(tax, tbx)
    loy, hiy = torch.minimum(tay, tby), torch.maximum(tay, tby)
    loz, hiz = torch.minimum(taz, tbz), torch.maximum(taz, tbz)
    t0 = torch.maximum(lox, torch.maximum(loy, loz))
    t1 = torch.minimum(hix, torch.minimum(hiy, hiz))
    enter = t0 >= t_min
    t = torch.where(enter, t0, t1)
    closer = (t1 > t0) & (t > t_min) & (t < best_t) & (t1 > t_min)
    ax_x = (enter & (t0 == lox)) | (~enter & (t1 == hix))
    ax_y = ((enter & (t0 == loy)) | (~enter & (t1 == hiy))) & ~ax_x
    ax_z = ~ax_x & ~ax_y
    sgn = torch.where(enter, -1.0, 1.0)
    nxb = torch.where(ax_x, sgn * sgn_d[0], 0.0)
    nyb = torch.where(ax_y, sgn * sgn_d[1], 0.0)
    nzb = torch.where(ax_z, sgn * sgn_d[2], 0.0)
    closer = closer & (g["act"] > 0)
    return closer, (t, 1.0, g["mat"], nxb, nyb, nzb, aux)


def med_body(g, *, key, ctr, tm, ox, oy, oz, dx, dy, dz, d_len, best_t, aux, **_):
    """Constant medium (``med_body``): boundary entry/exit in model space,
    then an exponential free path drawn at counter ``ctr``. A float
    ``btype`` (the sweep) takes its boundary's branch only; a per-lane one
    (the replay) computes both and selects, as the JAX body does."""
    t_min = float(defs.T_MIN)
    omx = g["i00"] * ox + g["i01"] * oy + g["i02"] * oz + g["i03"]
    omy = g["i10"] * ox + g["i11"] * oy + g["i12"] * oz + g["i13"]
    omz = g["i20"] * ox + g["i21"] * oy + g["i22"] * oz + g["i23"]
    dmx_r = g["i00"] * dx + g["i01"] * dy + g["i02"] * dz
    dmy_r = g["i10"] * dx + g["i11"] * dy + g["i12"] * dz
    dmz_r = g["i20"] * dx + g["i21"] * dy + g["i22"] * dz
    dm_len = torch.sqrt(torch.clamp(dmx_r * dmx_r + dmy_r * dmy_r + dmz_r * dmz_r,
                                    min=1e-24))
    dmx, dmy, dmz = dmx_r / dm_len, dmy_r / dm_len, dmz_r / dm_len

    def box():
        # Box boundary (slabs, safe reciprocal).
        ix, iy, iz = _safe_inv(dmx), _safe_inv(dmy), _safe_inv(dmz)
        ax, bx = (g["p0x"] - omx) * ix, (g["p1x"] - omx) * ix
        ay, by = (g["p0y"] - omy) * iy, (g["p1y"] - omy) * iy
        az, bz = (g["p0z"] - omz) * iz, (g["p1z"] - omz) * iz
        t0_ = torch.maximum(torch.minimum(ax, bx),
                            torch.maximum(torch.minimum(ay, by), torch.minimum(az, bz)))
        t1_ = torch.minimum(torch.maximum(ax, bx),
                            torch.minimum(torch.maximum(ay, by), torch.maximum(az, bz)))
        return t0_, t1_, t0_ < t1_

    def sphere():
        # Sphere boundary (moving center).
        ocx = (g["p0x"] + tm * g["dspx"]) - omx
        ocy = (g["p0y"] + tm * g["dspy"]) - omy
        ocz = (g["p0z"] + tm * g["dspz"]) - omz
        h = dmx * ocx + dmy * ocy + dmz * ocz
        r = g["p1x"]
        cc = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        disc = h * h - cc
        v = disc > 0.0
        sq = torch.where(v, torch.sqrt(torch.where(v, disc, 1.0)), 0.0)
        return h - sq, h + sq, v

    if isinstance(g["btype"], float):
        t0_, t1_, v = box() if g["btype"] == float(defs.MEDIUM_BOX) else sphere()
    else:
        is_box = g["btype"] == float(defs.MEDIUM_BOX)
        (b0, b1, bv), (s0, s1, sv) = box(), sphere()
        t0_, t1_ = torch.where(is_box, b0, s0), torch.where(is_box, b1, s1)
        v = torch.where(is_box, bv, sv)
    v = v & (t1_ > t0_ + float(defs.MEDIUM_EPS))
    scale = dm_len / d_len
    e0 = torch.clamp(torch.maximum(t0_, t_min * scale), min=0.0)
    e1 = torch.minimum(t1_, best_t * scale)
    v = v & (e0 < e1)
    u_m = rng.draw(key, ctr)
    hit_dist = g["nid"] * torch.log(torch.clamp(u_m, min=1e-12))
    v = v & (hit_dist <= (e1 - e0))
    return v, ((e0 + hit_dist) / scale, 2.0, g["mat"], 1.0, 0.0, 0.0, aux)


# Family id of each sweep family as the gradient replay pins a winner
# (JAX ``track_index``): the forward record's ``fam`` cannot tell a quad
# from an AA box.
FAMID = {"sph": 0, "quad": 1, "box": 2, "med": 3}


def _closest_hit(tl, sizes, *, key, tm, ox, oy, oz, dx, dy, dz, a, inv_a, bn,
                 track=False):
    """Flat closest-hit sweep in record order (JAX ``make_family_bodies`` +
    ``_closest_hit``, :635-882). ``tl`` maps family → {key: list of
    floats}. Returns [best_t, fam, mat, p0, p1, p2, aux], and with
    ``track`` also the winner's record index and family id (``FAMID``; -1
    on a miss) — the same values, the extra columns only follow them."""
    n_sph, n_quad, _, _, n_med, n_box = sizes
    rec = [torch.full_like(ox, BIG), torch.full_like(ox, -1.0), torch.zeros_like(ox),
           torch.zeros_like(ox), torch.zeros_like(ox), torch.zeros_like(ox),
           torch.ones_like(ox)]
    if track:
        rec += [torch.full_like(ox, -1.0), torch.full_like(ox, -1.0)]
    ray = dict(tm=tm, ox=ox, oy=oy, oz=oz, dx=dx, dy=dy, dz=dz, a=a, inv_a=inv_a)

    def sweep(fam, keys, n, body, extra=lambda p: {}):
        tbl = tl[fam]
        for p in range(n):
            closer, vals = body({k: tbl[k][p] for k in keys}, best_t=rec[0],
                                aux=rec[6], **ray, **extra(p))
            for i, v in enumerate(vals):
                rec[i] = torch.where(closer, v, rec[i])
            if track:
                rec[7] = torch.where(closer, float(p), rec[7])
                rec[8] = torch.where(closer, float(FAMID[fam]), rec[8])

    sweep("sph", SPH_KEYS, n_sph, sph_body)
    sweep("quad", QUAD_KEYS, n_quad, quad_body)
    if n_box:
        box_kw = dict(inv_d=(_safe_inv(dx), _safe_inv(dy), _safe_inv(dz)),
                      sgn_d=(torch.sign(dx), torch.sign(dy), torch.sign(dz)))
        sweep("box", BOX_KEYS, n_box, box_body, lambda p: box_kw)
    if n_med:
        d_len = torch.sqrt(torch.clamp(a, min=1e-24))
        bctr = bn.to(torch.int32).to(torch.int64) * (3 + n_med)
        sweep("med", MED_KEYS, n_med, med_body,
              lambda p: dict(key=key, ctr=bctr + (3 + p), d_len=d_len))
    return rec


def perlin_noise(px, py, pz, seed_u):
    """One octave of hash-gradient noise in [-1, 1] (``mk._perlin_noise``)."""
    fx, fy, fz = torch.floor(px), torch.floor(py), torch.floor(pz)
    ix, iy, iz = fx.to(torch.int32), fy.to(torch.int32), fz.to(torch.int32)
    u, v, w = px - fx, py - fy, pz - fz
    uu = u * u * (3.0 - 2.0 * u)
    vv = v * v * (3.0 - 2.0 * v)
    ww = w * w * (3.0 - 2.0 * w)
    accum = torch.zeros_like(px)
    for di in (0, 1):
        wi = uu if di else (1.0 - uu)
        for dj in (0, 1):
            wj = vv if dj else (1.0 - vv)
            for dk in (0, 1):
                wk = ww if dk else (1.0 - ww)
                gx, gy, gz = rng.hash_gradient(ix + di, iy + dj, iz + dk, seed_u)
                dot = gx * (u - di) + gy * (v - dj) + gz * (w - dk)
                accum = accum + wi * wj * wk * dot
    return accum


def turbulence(px, py, pz, seed_u, depth=7):
    """|Σ 0.5^k noise(2^k p)| (``mk._turbulence``)."""
    accum = torch.zeros_like(px)
    weight = 1.0
    sx, sy, sz = px, py, pz
    for _ in range(depth):
        accum = accum + weight * perlin_noise(sx, sy, sz, seed_u)
        weight *= 0.5
        sx, sy, sz = sx * 2.0, sy * 2.0, sz * 2.0
    return torch.abs(accum)


def noise_factor(npx, npy, npz, t_scale, t_ntype, nseed):
    """Marble or Perlin factor of a noise texture (Texture.cpp:13-22)."""
    marble = 0.5 * (1.0 + torch.sin(t_scale * npz + 10.0 * turbulence(npx, npy, npz, nseed)))
    perl = 0.5 * (1.0 + perlin_noise(t_scale * npx, t_scale * npy, t_scale * npz, nseed))
    return torch.where(t_ntype == float(defs.NOISE_MARBLE), marble, perl)


def _shade_advance(carry, rec, mat6, tex_resolve, bg, key, *, has_checker,
                   has_noise, max_depth, n_med):
    """Shade + state advance (JAX ``_shade_advance``, :1047-1265)."""
    (bn, alive_f, ox, oy, oz, dx, dy, dz, tpr, tpg, tpb, rr, rg, rb) = carry
    alive = alive_f > 0.0
    a = dx * dx + dy * dy + dz * dz
    best_t, fam, matf, p0, p1, p2, aux = rec
    mtype, alr, alg, alb, mparam, mtex = mat6
    valid = fam >= 0.0
    is_sph = fam == 0.0
    is_med = fam == 2.0

    px = ox + best_t * dx
    py = oy + best_t * dy
    pz = oz + best_t * dz
    rad_safe = torch.where(aux != 0.0, aux, 1.0)
    onx = torch.where(is_sph, (px - p0) / rad_safe, p0)
    ony = torch.where(is_sph, (py - p1) / rad_safe, p1)
    onz = torch.where(is_sph, (pz - p2) / rad_safe, p2)
    front_geom = (dx * onx + dy * ony + dz * onz) < 0.0
    front = front_geom | is_med
    sgn = torch.where(is_med, 1.0, torch.where(front_geom, 1.0, -1.0))
    nx_, ny_, nz_ = sgn * onx, sgn * ony, sgn * onz

    leaf = mtex
    (ttype, t_alr, t_alg, t_alb, t_inv, t_even, t_odd,
     t_scale, t_ntype, _) = tex_resolve(leaf)
    for _ in range(int(has_checker)):
        fx = torch.floor(t_inv * px)
        fy = torch.floor(t_inv * py)
        fz = torch.floor(t_inv * pz)
        parity = fx + fy + fz - 2.0 * torch.floor((fx + fy + fz) * 0.5)
        child = torch.where(parity == 0.0, t_even, t_odd)
        leaf = torch.where(ttype == float(defs.TEX_CHECKER), child, leaf)
        (ttype, t_alr, t_alg, t_alb, t_inv, t_even, t_odd,
         t_scale, t_ntype, _) = tex_resolve(leaf)
    if has_noise:
        # Noise is evaluated only on the lanes that shade a noise texture
        # (a per-lane function, so the subset gives the same values as the
        # JAX kernel's whole-tile branch); points are clamped to 0 on miss
        # lanes, where best_t = BIG would overflow.
        sel_n = (ttype == float(defs.TEX_NOISE)) & valid
        idx = torch.nonzero(sel_n).squeeze(1)
        if idx.numel():
            npx = torch.where(valid, px, 0.0)[idx]
            npy = torch.where(valid, py, 0.0)[idx]
            npz = torch.where(valid, pz, 0.0)[idx]
            nfac = noise_factor(npx, npy, npz, t_scale[idx], t_ntype[idx],
                                rng.noise_seed(leaf[idx]))
            t_alr, t_alg, t_alb = t_alr.clone(), t_alg.clone(), t_alb.clone()
            t_alr[idx] = t_alr[idx] * nfac
            t_alg[idx] = t_alg[idx] * nfac
            t_alb[idx] = t_alb[idx] * nfac

    bctr = bn.to(torch.int32).to(torch.int64) * (3 + n_med)
    u1 = rng.draw(key, bctr)
    u2 = rng.draw(key, bctr + 1)
    u3 = rng.draw(key, bctr + 2)
    z = 1.0 - 2.0 * u1
    phi = (2.0 * 3.14159265358979) * u2
    rxy = torch.sqrt(torch.clamp(1.0 - z * z, min=1e-12))
    uvx = rxy * torch.cos(phi)
    uvy = rxy * torch.sin(phi)
    uvz = z

    is_lamb = (mtype == float(defs.MAT_LAMBERTIAN)) | (mtype == float(defs.MAT_TEXTURE))
    is_metal = mtype == float(defs.MAT_METAL)
    is_diel = mtype == float(defs.MAT_DIELECTRIC)
    is_iso = mtype == float(defs.MAT_ISOTROPIC)
    is_light = mtype == float(defs.MAT_DIFFUSE_LIGHT)
    uses_tex = (mtype == float(defs.MAT_TEXTURE)) | is_iso

    ldx, ldy, ldz = nx_ + uvx, ny_ + uvy, nz_ + uvz
    eps = float(defs.NEAR_ZERO_EPS)
    degen = (torch.abs(ldx) < eps) & (torch.abs(ldy) < eps) & (torch.abs(ldz) < eps)
    ldx = torch.where(degen, nx_, ldx)
    ldy = torch.where(degen, ny_, ldy)
    ldz = torch.where(degen, nz_, ldz)

    dn = dx * nx_ + dy * ny_ + dz * nz_
    rfx = dx - 2.0 * dn * nx_
    rfy = dy - 2.0 * dn * ny_
    rfz = dz - 2.0 * dn * nz_
    rlen = torch.sqrt(torch.clamp(rfx * rfx + rfy * rfy + rfz * rfz, min=1e-24))
    mdx = rfx / rlen + mparam * uvx
    mdy = rfy / rlen + mparam * uvy
    mdz = rfz / rlen + mparam * uvz

    param_safe = torch.where(mparam > 0.0, mparam, 1.0)
    ri = torch.where(front, 1.0 / param_safe, param_safe)
    dlen = torch.sqrt(torch.clamp(a, min=1e-24))
    udx, udy, udz = dx / dlen, dy / dlen, dz / dlen
    cos_t = torch.clamp(-(udx * nx_ + udy * ny_ + udz * nz_), max=1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=1e-12))
    cannot = ri * sin_t > 1.0
    r0s = (1.0 - ri) / (1.0 + ri)
    r0s = r0s * r0s
    om = 1.0 - cos_t
    om2 = om * om
    schl = r0s + (1.0 - r0s) * (om * (om2 * om2))  # x**5 as JAX's integer_pow
    refl_choice = cannot | (schl > u3)
    udn = udx * nx_ + udy * ny_ + udz * nz_
    rfux = udx - 2.0 * udn * nx_
    rfuy = udy - 2.0 * udn * ny_
    rfuz = udz - 2.0 * udn * nz_
    rpx = ri * (udx + cos_t * nx_)
    rpy = ri * (udy + cos_t * ny_)
    rpz = ri * (udz + cos_t * nz_)
    k = 1.0 - (rpx * rpx + rpy * rpy + rpz * rpz)
    spar = -torch.sqrt(torch.clamp(torch.abs(k), min=1e-20))
    ddx = torch.where(refl_choice, rfux, rpx + spar * nx_)
    ddy = torch.where(refl_choice, rfuy, rpy + spar * ny_)
    ddz = torch.where(refl_choice, rfuz, rpz + spar * nz_)

    ndx = torch.where(is_lamb, ldx, torch.where(is_metal, mdx, torch.where(is_diel, ddx, uvx)))
    ndy = torch.where(is_lamb, ldy, torch.where(is_metal, mdy, torch.where(is_diel, ddy, uvy)))
    ndz = torch.where(is_lamb, ldz, torch.where(is_metal, mdz, torch.where(is_diel, ddz, uvz)))

    atr = torch.where(is_diel, 1.0, torch.where(uses_tex, t_alr, alr))
    atg = torch.where(is_diel, 1.0, torch.where(uses_tex, t_alg, alg))
    atb = torch.where(is_diel, 1.0, torch.where(uses_tex, t_alb, alb))
    emr = torch.where(is_light, t_alr, 0.0)
    emg = torch.where(is_light, t_alg, 0.0)
    emb = torch.where(is_light, t_alb, 0.0)

    miss = alive & ~valid
    hit_live = alive & valid
    scatter_live = hit_live & ~is_light

    rr = rr + torch.where(miss, tpr * bg[0], 0.0) + torch.where(hit_live, tpr * emr, 0.0)
    rg = rg + torch.where(miss, tpg * bg[1], 0.0) + torch.where(hit_live, tpg * emg, 0.0)
    rb = rb + torch.where(miss, tpb * bg[2], 0.0) + torch.where(hit_live, tpb * emb, 0.0)
    tpr = torch.where(scatter_live, tpr * atr, tpr)
    tpg = torch.where(scatter_live, tpg * atg, tpg)
    tpb = torch.where(scatter_live, tpb * atb, tpb)
    ox = torch.where(scatter_live, px, ox)
    oy = torch.where(scatter_live, py, oy)
    oz = torch.where(scatter_live, pz, oz)
    dx = torch.where(scatter_live, ndx, dx)
    dy = torch.where(scatter_live, ndy, dy)
    dz = torch.where(scatter_live, ndz, dz)
    bn = bn + torch.where(alive, 1.0, 0.0)
    next_alive = scatter_live & (bn < float(max_depth))
    return (bn, next_alive.to(torch.float32), ox, oy, oz, dx, dy, dz,
            tpr, tpg, tpb, rr, rg, rb)


def make_bounce(packed, background, *, max_depth, sizes, has_checker, has_noise):
    """The per-bounce transition of the v4 kernel (JAX ``_make_bounce``):
    ``bounce(key, tm, carry) -> carry`` with carry = (bn, alive, ox, oy, oz,
    dx, dy, dz, tpr, tpg, tpb, rr, rg, rb), all [N] f32, and ``key`` the
    lane's uint32 sample key (int64 holder). ``track=True`` also returns
    the winner (material, record index, ``FAMID``) of each lane's sweep."""
    cols = unpack_buffer(packed, sizes)
    tl = {fam: {k: v.tolist() for k, v in cols[fam].items()}
          for fam in ("sph", "quad", "box", "med")}
    mat_cols = [cols["mat"][k] for k in MAT_KEYS]
    tex_cols = [cols["tex"][k] for k in TEX_KEYS]
    bg = [float(x) for x in background.tolist()]
    n_med = sizes[4]

    def tex_resolve(idx_f):
        idx = idx_f.to(torch.int64)
        return tuple(c[idx] for c in tex_cols)

    def bounce(key, tm, carry, track=False):
        (bn, alive_f, ox, oy, oz, dx, dy, dz) = carry[:8]
        a = dx * dx + dy * dy + dz * dz
        inv_a = 1.0 / a
        rec = _closest_hit(tl, sizes, key=key, tm=tm, ox=ox, oy=oy, oz=oz,
                           dx=dx, dy=dy, dz=dz, a=a, inv_a=inv_a, bn=bn, track=track)
        midx = rec[2].to(torch.int64)
        mat6 = tuple(c[midx] for c in mat_cols)
        out = _shade_advance(carry, rec[:7], mat6, tex_resolve, bg, key,
                             has_checker=has_checker, has_noise=has_noise,
                             max_depth=max_depth, n_med=n_med)
        return (out, (rec[2], rec[7], rec[8])) if track else out

    return bounce


def regenerate(cv, seed, pix, s_lane, tm, carry, in_grid):
    """Regeneration step of the kernel's loop: every dead lane with samples
    left takes the camera ray of its next sample. ``pix`` is (xx, yy,
    pid_u) of each lane; ``carry`` the 14 bounce columns. Returns (s_lane,
    key, tm, carry), with ``key`` the lane's sample key for the bounce."""
    xx, yy, pid_u = pix
    s0, n_samples, sqrt_spp = cv[21], cv[22], cv[23]
    (bn, al, ox, oy, oz, dx, dy, dz, tpr, tpg, tpb, rr, rg, rb) = carry
    need = (al <= 0.0) & (s_lane < n_samples - 1.0) & in_grid
    s_lane = s_lane + torch.where(need, 1.0, 0.0)
    key = rng.v4_sample_key(seed, pid_u, s0 + s_lane)
    cox, coy, coz, cdx, cdy, cdz, ctm = camera.camera_ray(
        cv, xx, yy, sqrt_spp, s0 + s_lane, key)
    ox, oy, oz = torch.where(need, cox, ox), torch.where(need, coy, oy), torch.where(need, coz, oz)
    dx, dy, dz = torch.where(need, cdx, dx), torch.where(need, cdy, dy), torch.where(need, cdz, dz)
    tm = torch.where(need, ctm, tm)
    bn = torch.where(need, 0.0, bn)
    al = torch.where(need, 1.0, al)
    tpr, tpg, tpb = torch.where(need, 1.0, tpr), torch.where(need, 1.0, tpg), torch.where(need, 1.0, tpb)
    return s_lane, key, tm, (bn, al, ox, oy, oz, dx, dy, dz, tpr, tpg, tpb, rr, rg, rb)


def trace_plain(camv, seed, packed, background, *, n_pix, max_depth, sizes,
                has_checker, has_noise):
    """Plain PyTorch version of the v4 kernel: radiance summed over
    ``camv[22]`` samples for each of ``n_pix`` linear slots, [n_pix, 3].

    Like the JAX kernel's tile loop, every iteration regenerates each dead
    lane that has samples left, then bounces all lanes (a bounce is a no-op
    on a dead lane); the loop ends when no lane can run."""
    device = packed.device
    cv = [float(x) for x in camv.tolist()]
    bounce = make_bounce(packed, background, max_depth=max_depth, sizes=sizes,
                         has_checker=has_checker, has_noise=has_noise)
    slot_i = torch.arange(n_pix, dtype=torch.int32, device=device) + int(cv[25])
    slot_f = slot_i.to(torch.float32)
    xx, yy, in_grid = camera.slot_to_pixel(slot_f, cv)
    pix = (xx, yy, rng.as_u32(yy * cv[19] + xx))
    zero = torch.zeros(n_pix, dtype=torch.float32, device=device)
    s_lane = torch.full_like(zero, -1.0)
    tm = zero
    carry = (zero,) * 14
    while True:
        al = carry[1]
        runnable = (al > 0.0) | ((s_lane < cv[22] - 1.0) & in_grid)
        if not bool(runnable.any()):
            break
        s_lane, key, tm, carry = regenerate(cv, seed, pix, s_lane, tm, carry, in_grid)
        carry = bounce(key, tm, carry)
    return torch.stack(carry[11:14], dim=-1)


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------


def check_inputs(camv, packed, background, n_pix, sizes):
    for name, t in (("camv", camv), ("packed", packed), ("background", background)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.dim() != 1:
            raise ValueError(f"{name} must be a contiguous 1-D float32 tensor")
        if t.device != packed.device:
            raise ValueError(f"{name} is on {t.device}, packed on {packed.device}")
    if camv.numel() != camera.CAMV_LEN or background.numel() != 3:
        raise ValueError("camv must hold 28 entries and background 3")
    if packed.numel() != table_layout(sizes)["total"][0]:
        raise ValueError("packed buffer does not match the table layout of sizes")
    if not 0 <= n_pix < (1 << 24):
        # Pixel ids ride f32 in the kernel's slot arithmetic (JAX :1729-1731).
        raise ValueError(f"n_pix={n_pix} must be below 2^24")


def trace_megakernel_batch(camv, seed, packed, background, *, n_pix, max_depth,
                           sizes, has_checker, has_noise):
    """Radiance summed over the batch's samples, [n_pix, 3] f32.

    ``camv``: the 28-entry control vector (``camera.make_camv``); ``seed``:
    the exact int seed; ``packed``: ``pack_buffer`` of the scene tables;
    ``background``: [3]. On a CPU tensor this runs the plain version; on a
    CUDA tensor it launches the Hopper kernel (built at first use) or
    raises."""
    global LAUNCHES
    check_inputs(camv, packed, background, n_pix, sizes)
    if packed.device.type == "cpu":
        return trace_plain(camv, seed, packed, background, n_pix=n_pix,
                           max_depth=max_depth, sizes=sizes,
                           has_checker=has_checker, has_noise=has_noise)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    from raytrace2_tpu_torch.ops.kernels import build

    out = torch.empty((n_pix, 3), dtype=torch.float32, device=packed.device)
    build.launch_megakernel_v4(
        camv, int(seed), background, packed, out, n_pix=n_pix,
        max_depth=max_depth, sizes=sizes, checker_depth=int(has_checker),
        has_noise=bool(has_noise))
    LAUNCHES += 1
    return out
