"""Plain PyTorch path tracer: the benchmark's reference.

It traces the path of each (pixel, sample) pair that it is given with the
renderer's published estimator (the counter-hash streams keyed by seed,
pixel and sample; the stratified camera jitter; the closest hit of spheres,
quads, axis-aligned boxes and constant media; lambertian, metal, dielectric,
isotropic and emissive materials; solid, checker and hash-noise marble
textures; depth cut at ``depth`` bounces), one lane per path, vectorised
over lanes and records. It imports nothing of the program and reads only
the tables that ``scene.py`` worked out from the scene JSON.

Each record family is tested against all lanes at once, [lanes, records],
with the sweep's rules for equal distances: the first sphere or box of the
least distance wins and a later one only when strictly nearer, a quad also
at an equal distance, a medium is tested last against the distance found so
far. Arithmetic follows the estimator operation by operation in ``dtype``
(float32; the benchmark's control runs it in bfloat16).
"""

from __future__ import annotations

import dataclasses

import torch

from rtbench.reference import scene as sc

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
SAMPLE_MUL = 1000003
CAMERA_CTR = 0x40000000
NOISE_SEED = 0x5EEDBA5E
BIG = 3.0e38
T_MIN = 1e-3
QUAD_EPS = 1e-8
NEAR_ZERO = 1e-8
MEDIUM_EPS = 1e-4
TWO_PI = 2.0 * 3.14159265358979
# Families a segment can end on (the roofline's operation count reads them).
FAMILIES = ("sphere", "quad", "box", "medium", "miss")


# ---- counter hashes (uint32 words held in int64) ---------------------------

def u32(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    if x.is_floating_point():
        x = x.to(torch.int32)
    return x.to(torch.int64) & MASK32


def mul32(x, c: int):
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def mix(x):
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def unit(bits, dtype):
    return ((bits >> 8).to(torch.int32).to(torch.float32) * (1.0 / (1 << 24))).to(dtype)


def sample_key(seed: int, pid, sample):
    mega = (mul32(u32(seed), SAMPLE_MUL) + u32(sample)) & MASK32
    return mix(mul32(pid, GOLDEN) ^ mix(mega))


def draw(key, ctr, dtype):
    c = (mul32(u32(ctr), GOLDEN) + 1) & MASK32
    return unit(mix(key ^ mix(c)), dtype)


def hash_gradient(ix, iy, iz, seed_u, dtype):
    h = mul32(u32(ix), 0x8DA6B343) ^ mul32(u32(iy), 0xD8163841) ^ mul32(u32(iz), 0xCB1AB31F)
    h1 = mix(h ^ seed_u)
    u1, u2 = unit(h1, dtype), unit(mix(h1 ^ 0x68E31DA4), dtype)
    z = 1.0 - 2.0 * u1
    phi = TWO_PI * u2
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=1e-12))
    return r * torch.cos(phi), r * torch.sin(phi), z


def perlin(px, py, pz, seed_u):
    fx, fy, fz = torch.floor(px), torch.floor(py), torch.floor(pz)
    ix, iy, iz = fx.to(torch.int32), fy.to(torch.int32), fz.to(torch.int32)
    u, v, w = px - fx, py - fy, pz - fz
    uu, vv, ww = u * u * (3.0 - 2.0 * u), v * v * (3.0 - 2.0 * v), w * w * (3.0 - 2.0 * w)
    acc = torch.zeros_like(px)
    for di in (0, 1):
        wi = uu if di else (1.0 - uu)
        for dj in (0, 1):
            wj = vv if dj else (1.0 - vv)
            for dk in (0, 1):
                wk = ww if dk else (1.0 - ww)
                gx, gy, gz = hash_gradient(ix + di, iy + dj, iz + dk, seed_u, px.dtype)
                acc = acc + wi * wj * wk * (gx * (u - di) + gy * (v - dj) + gz * (w - dk))
    return acc


def turbulence(px, py, pz, seed_u, depth=7):
    acc = torch.zeros_like(px)
    weight = 1.0
    for _ in range(depth):
        acc = acc + weight * perlin(px, py, pz, seed_u)
        weight *= 0.5
        px, py, pz = px * 2.0, py * 2.0, pz * 2.0
    return torch.abs(acc)


def safe_inv(c):
    tiny = torch.where(c < 0, -1e-12, 1e-12).to(c.dtype)
    return 1.0 / torch.where(torch.abs(c) < 1e-12, tiny, c)


# ---- tables ---------------------------------------------------------------

@dataclasses.dataclass
class Tables:
    """The scene's columns as [1, n] rows (broadcast against [lanes, 1])."""

    sph: dict
    quad: dict
    box: dict
    med: list        # one dict of floats per medium (tested one after another)
    mat: dict        # columns [K]
    tex: dict        # columns [L]
    background: list
    dtype: torch.dtype
    checker_depth: int = 0

    @classmethod
    def of(cls, scene: sc.Scene, device, dtype=torch.float32) -> "Tables":
        def row(x):
            return torch.as_tensor(x, device=device).to(dtype).reshape(1, -1)

        s, q, b = scene.sph, scene.quad, scene.box
        sph = dict(c0x=row(s["c0"][:, 0]), c0y=row(s["c0"][:, 1]), c0z=row(s["c0"][:, 2]),
                   dpx=row(s["dp"][:, 0]), dpy=row(s["dp"][:, 1]), dpz=row(s["dp"][:, 2]),
                   rad=row(s["rad"]), mat=row(s["mat"]))
        quad = dict(nx=row(q["n"][:, 0]), ny=row(q["n"][:, 1]), nz=row(q["n"][:, 2]), d=row(q["d"]),
                    aax=row(q["aa"][:, 0]), aay=row(q["aa"][:, 1]), aaz=row(q["aa"][:, 2]),
                    abx=row(q["ab"][:, 0]), aby=row(q["ab"][:, 1]), abz=row(q["ab"][:, 2]),
                    qaa=row(q["qaa"]), qab=row(q["qab"]), mat=row(q["mat"]))
        box = dict(x0=row(b["lo"][:, 0]), y0=row(b["lo"][:, 1]), z0=row(b["lo"][:, 2]),
                   x1=row(b["hi"][:, 0]), y1=row(b["hi"][:, 1]), z1=row(b["hi"][:, 2]),
                   mat=row(b["mat"]))
        m = scene.med
        med = []
        for i in range(len(m["mat"])):
            rec = dict(btype=int(m["btype"][i]), nid=float(m["nid"][i]), mat=float(m["mat"][i]))
            for j, ax in enumerate("xyz"):
                rec["p0" + ax], rec["p1" + ax] = float(m["p0"][i, j]), float(m["p1"][i, j])
                rec["dsp" + ax] = float(m["dsp"][i, j])
            for r in range(3):
                for c in range(4):
                    rec[f"i{r}{c}"] = float(m["inv"][i, r, c])
            med.append(rec)

        def col(x):
            return torch.as_tensor(x, device=device).to(dtype)

        mat = dict(mtype=col(scene.mat["mtype"]), alr=col(scene.mat["albedo"][:, 0]),
                   alg=col(scene.mat["albedo"][:, 1]), alb=col(scene.mat["albedo"][:, 2]),
                   param=col(scene.mat["param"]), tex=col(scene.mat["tex"]))
        t = scene.tex
        tex = dict(ttype=col(t["ttype"]), alr=col(t["albedo"][:, 0]), alg=col(t["albedo"][:, 1]),
                   alb=col(t["albedo"][:, 2]), inv_scale=col(t["inv_scale"]), even=col(t["even"]),
                   odd=col(t["odd"]), scale=col(t["scale"]), ntype=col(t["ntype"]))
        ttype, even, odd = t["ttype"], t["even"], t["odd"]

        def depth(i: int) -> int:
            if ttype[i] != sc.TEX_CHECKER:
                return 0
            return 1 + max(depth(int(even[i])), depth(int(odd[i])))

        return cls(sph, quad, box, med, mat, tex, [float(x) for x in scene.background], dtype,
                   max((depth(i) for i in range(len(ttype))), default=0))


# ---- closest hit ------------------------------------------------------------

def _min_first(t):
    """(least value, index of its first occurrence) over dim 1."""
    return torch.min(t, dim=1)


def _min_last(t):
    v, i = torch.min(torch.flip(t, (1,)), dim=1)
    return v, t.shape[1] - 1 - i


def closest_hit(tb: Tables, key, bn, tm, o, d, n_med_active: int):
    """Per lane: (t, fam, mat, p0, p1, p2, aux, famid) of the nearest record.
    ``fam`` is 0 sphere, 1 quad or box, 2 medium, -1 miss (the shading's
    record classes); ``famid`` indexes ``FAMILIES``. Lanes [N], columns
    [N, 1] against rows [1, R]."""
    ox, oy, oz = (x[:, None] for x in o)
    dx, dy, dz = (x[:, None] for x in d)
    tm_ = tm[:, None]
    n = ox.shape[0]
    dt = ox.dtype
    dev = ox.device
    best = torch.full((n,), BIG, dtype=dt, device=dev)
    fam = torch.full((n,), -1.0, dtype=dt, device=dev)
    famid = torch.full((n,), 4, dtype=torch.int64, device=dev)
    mat = torch.zeros((n,), dtype=dt, device=dev)
    p0, p1, p2 = (torch.zeros((n,), dtype=dt, device=dev) for _ in range(3))
    aux = torch.ones((n,), dtype=dt, device=dev)
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a

    s = tb.sph
    if s["rad"].shape[1]:
        cx = s["c0x"] + tm_ * s["dpx"]
        cy = s["c0y"] + tm_ * s["dpy"]
        cz = s["c0z"] + tm_ * s["dpz"]
        ocx, ocy, ocz = cx - ox, cy - oy, cz - oz
        h = dx * ocx + dy * ocy + dz * ocz
        cc = ocx * ocx + ocy * ocy + ocz * ocz - s["rad"] * s["rad"]
        disc = h * h - a * cc
        pos = disc > 0.0
        sq = torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0)
        r0 = (h - sq) * inv_a
        r1 = (h + sq) * inv_a
        root = torch.where(r0 > T_MIN, r0, r1)
        ok = (disc >= 0.0) & (root > T_MIN)
        t_s, i_s = _min_first(torch.where(ok, root, float("inf")))
        win = t_s < best
        i_s = i_s[:, None]
        best = torch.where(win, t_s, best)
        fam = torch.where(win, 0.0, fam)
        famid = torch.where(win, 0, famid)
        mat = torch.where(win, s["mat"][0][i_s[:, 0]], mat)
        p0 = torch.where(win, cx.gather(1, i_s)[:, 0], p0)
        p1 = torch.where(win, cy.gather(1, i_s)[:, 0], p1)
        p2 = torch.where(win, cz.gather(1, i_s)[:, 0], p2)
        aux = torch.where(win, s["rad"][0][i_s[:, 0]], aux)

    q = tb.quad
    if q["d"].shape[1]:
        nd = dx * q["nx"] + dy * q["ny"] + dz * q["nz"]
        no = ox * q["nx"] + oy * q["ny"] + oz * q["nz"]
        not_par = torch.abs(nd) >= QUAD_EPS
        t = (q["d"] - no) / torch.where(not_par, nd, 1.0)
        alpha = (ox * q["aax"] + oy * q["aay"] + oz * q["aaz"]) + t * (
            dx * q["aax"] + dy * q["aay"] + dz * q["aaz"]) - q["qaa"]
        beta = (ox * q["abx"] + oy * q["aby"] + oz * q["abz"]) + t * (
            dx * q["abx"] + dy * q["aby"] + dz * q["abz"]) - q["qab"]
        ok = (not_par & (t >= T_MIN) & (alpha >= 0.0) & (alpha <= 1.0)
              & (beta >= 0.0) & (beta <= 1.0))
        t_q, i_q = _min_last(torch.where(ok, t, float("inf")))
        win = t_q <= best
        best = torch.where(win, t_q, best)
        fam = torch.where(win, 1.0, fam)
        famid = torch.where(win, 1, famid)
        mat = torch.where(win, q["mat"][0][i_q], mat)
        p0 = torch.where(win, q["nx"][0][i_q], p0)
        p1 = torch.where(win, q["ny"][0][i_q], p1)
        p2 = torch.where(win, q["nz"][0][i_q], p2)

    b = tb.box
    if b["x0"].shape[1]:
        ix, iy, iz = safe_inv(dx), safe_inv(dy), safe_inv(dz)
        tax, tbx = (b["x0"] - ox) * ix, (b["x1"] - ox) * ix
        tay, tby = (b["y0"] - oy) * iy, (b["y1"] - oy) * iy
        taz, tbz = (b["z0"] - oz) * iz, (b["z1"] - oz) * iz
        lox, hix = torch.minimum(tax, tbx), torch.maximum(tax, tbx)
        loy, hiy = torch.minimum(tay, tby), torch.maximum(tay, tby)
        loz, hiz = torch.minimum(taz, tbz), torch.maximum(taz, tbz)
        t0 = torch.maximum(lox, torch.maximum(loy, loz))
        t1 = torch.minimum(hix, torch.minimum(hiy, hiz))
        enter = t0 >= T_MIN
        t = torch.where(enter, t0, t1)
        ok = (t1 > t0) & (t > T_MIN) & (t1 > T_MIN)
        t_b, i_b = _min_first(torch.where(ok, t, float("inf")))
        win = t_b < best
        g = i_b[:, None]

        def pick(x):
            return x.gather(1, g)[:, 0]

        en, lo_x, lo_y, hi_x, hi_y = pick(enter), pick(lox), pick(loy), pick(hix), pick(hiy)
        w0, w1 = pick(t0), pick(t1)
        ax_x = (en & (w0 == lo_x)) | (~en & (w1 == hi_x))
        ax_y = ((en & (w0 == lo_y)) | (~en & (w1 == hi_y))) & ~ax_x
        ax_z = ~ax_x & ~ax_y
        sgn = torch.where(en, -1.0, 1.0).to(dt)
        best = torch.where(win, t_b, best)
        fam = torch.where(win, 1.0, fam)
        famid = torch.where(win, 2, famid)
        mat = torch.where(win, b["mat"][0][i_b], mat)
        p0 = torch.where(win, torch.where(ax_x, sgn * torch.sign(dx[:, 0]), 0.0), p0)
        p1 = torch.where(win, torch.where(ax_y, sgn * torch.sign(dy[:, 0]), 0.0), p1)
        p2 = torch.where(win, torch.where(ax_z, sgn * torch.sign(dz[:, 0]), 0.0), p2)

    if tb.med:
        oxl, oyl, ozl = o
        dxl, dyl, dzl = d
        al = a[:, 0]
        d_len = torch.sqrt(torch.clamp(al, min=1e-24))
        bctr = bn.to(torch.int32).to(torch.int64) * (3 + n_med_active)
        for p, g in enumerate(tb.med):
            omx = g["i00"] * oxl + g["i01"] * oyl + g["i02"] * ozl + g["i03"]
            omy = g["i10"] * oxl + g["i11"] * oyl + g["i12"] * ozl + g["i13"]
            omz = g["i20"] * oxl + g["i21"] * oyl + g["i22"] * ozl + g["i23"]
            rx = g["i00"] * dxl + g["i01"] * dyl + g["i02"] * dzl
            ry = g["i10"] * dxl + g["i11"] * dyl + g["i12"] * dzl
            rz = g["i20"] * dxl + g["i21"] * dyl + g["i22"] * dzl
            dm_len = torch.sqrt(torch.clamp(rx * rx + ry * ry + rz * rz, min=1e-24))
            dmx, dmy, dmz = rx / dm_len, ry / dm_len, rz / dm_len
            if g["btype"] == sc.MEDIUM_BOX:
                ix, iy, iz = safe_inv(dmx), safe_inv(dmy), safe_inv(dmz)
                bx0, bx1 = (g["p0x"] - omx) * ix, (g["p1x"] - omx) * ix
                by0, by1 = (g["p0y"] - omy) * iy, (g["p1y"] - omy) * iy
                bz0, bz1 = (g["p0z"] - omz) * iz, (g["p1z"] - omz) * iz
                t0 = torch.maximum(torch.minimum(bx0, bx1),
                                   torch.maximum(torch.minimum(by0, by1), torch.minimum(bz0, bz1)))
                t1 = torch.minimum(torch.maximum(bx0, bx1),
                                   torch.minimum(torch.maximum(by0, by1), torch.maximum(bz0, bz1)))
                v = t0 < t1
            else:
                ocx = (g["p0x"] + tm * g["dspx"]) - omx
                ocy = (g["p0y"] + tm * g["dspy"]) - omy
                ocz = (g["p0z"] + tm * g["dspz"]) - omz
                h = dmx * ocx + dmy * ocy + dmz * ocz
                r = g["p1x"]
                cc = ocx * ocx + ocy * ocy + ocz * ocz - r * r
                disc = h * h - cc
                v = disc > 0.0
                sq = torch.where(v, torch.sqrt(torch.where(v, disc, 1.0)), 0.0)
                t0, t1 = h - sq, h + sq
            v = v & (t1 > t0 + MEDIUM_EPS)
            scale = dm_len / d_len
            e0 = torch.clamp(torch.maximum(t0, T_MIN * scale), min=0.0)
            e1 = torch.minimum(t1, best * scale)
            v = v & (e0 < e1)
            u_m = draw(key, bctr + (3 + p), dt)
            hit_dist = g["nid"] * torch.log(torch.clamp(u_m, min=1e-12))
            v = v & (hit_dist <= (e1 - e0))
            best = torch.where(v, (e0 + hit_dist) / scale, best)
            fam = torch.where(v, 2.0, fam)
            famid = torch.where(v, 3, famid)
            mat = torch.where(v, g["mat"], mat)
            p0 = torch.where(v, 1.0, p0)
            p1 = torch.where(v, 0.0, p1)
            p2 = torch.where(v, 0.0, p2)
    return best, fam, mat, p0, p1, p2, aux, famid


# ---- shading --------------------------------------------------------------

def shade(tb: Tables, key, bn, o, d, hit, n_med_active: int):
    """One bounce's shading: (emitted [3], attenuation [3], scatters, the
    hit point, the new direction)."""
    best_t, fam, matf, p0, p1, p2, aux, _ = hit
    ox, oy, oz = o
    dx, dy, dz = d
    a = dx * dx + dy * dy + dz * dz
    valid = fam >= 0.0
    is_sph = fam == 0.0
    is_med = fam == 2.0
    px, py, pz = ox + best_t * dx, oy + best_t * dy, oz + best_t * dz
    rad_safe = torch.where(aux != 0.0, aux, 1.0)
    onx = torch.where(is_sph, (px - p0) / rad_safe, p0)
    ony = torch.where(is_sph, (py - p1) / rad_safe, p1)
    onz = torch.where(is_sph, (pz - p2) / rad_safe, p2)
    front_geom = (dx * onx + dy * ony + dz * onz) < 0.0
    front = front_geom | is_med
    sgn = torch.where(is_med, 1.0, torch.where(front_geom, 1.0, -1.0)).to(ox.dtype)
    nx_, ny_, nz_ = sgn * onx, sgn * ony, sgn * onz

    midx = matf.to(torch.int64)
    m = {k: v[midx] for k, v in tb.mat.items()}
    leaf = m["tex"]

    def resolve(idx):
        i = idx.to(torch.int64)
        return {k: v[i] for k, v in tb.tex.items()}

    t = resolve(leaf)
    for _ in range(tb.checker_depth):
        fx, fy, fz = (torch.floor(t["inv_scale"] * c) for c in (px, py, pz))
        parity = fx + fy + fz - 2.0 * torch.floor((fx + fy + fz) * 0.5)
        child = torch.where(parity == 0.0, t["even"], t["odd"])
        leaf = torch.where(t["ttype"] == float(sc.TEX_CHECKER), child, leaf)
        t = resolve(leaf)
    t_al = [t["alr"], t["alg"], t["alb"]]
    sel = (t["ttype"] == float(sc.TEX_NOISE)) & valid
    idx = torch.nonzero(sel).squeeze(1)
    if idx.numel():
        npx, npy, npz = px[idx], py[idx], pz[idx]
        seed_u = mix(u32(leaf[idx]) ^ NOISE_SEED)
        ts = t["scale"][idx]
        turb = turbulence(npx, npy, npz, seed_u)
        marble = 0.5 * (1.0 + torch.sin(ts * npz + 10.0 * turb))
        perl = 0.5 * (1.0 + perlin(ts * npx, ts * npy, ts * npz, seed_u))
        nfac = torch.where(t["ntype"][idx] == float(sc.NOISE_MARBLE), marble, perl)
        t_al = [c.clone() for c in t_al]
        for c in t_al:
            c[idx] = c[idx] * nfac

    bctr = bn.to(torch.int32).to(torch.int64) * (3 + n_med_active)
    dt = ox.dtype
    u1, u2, u3 = draw(key, bctr, dt), draw(key, bctr + 1, dt), draw(key, bctr + 2, dt)
    z = 1.0 - 2.0 * u1
    phi = TWO_PI * u2
    rxy = torch.sqrt(torch.clamp(1.0 - z * z, min=1e-12))
    uvx, uvy, uvz = rxy * torch.cos(phi), rxy * torch.sin(phi), z

    mtype, mparam = m["mtype"], m["param"]
    is_lamb = (mtype == float(sc.MAT_LAMBERTIAN)) | (mtype == float(sc.MAT_TEXTURE))
    is_metal = mtype == float(sc.MAT_METAL)
    is_diel = mtype == float(sc.MAT_DIELECTRIC)
    is_light = mtype == float(sc.MAT_LIGHT)
    uses_tex = (mtype == float(sc.MAT_TEXTURE)) | (mtype == float(sc.MAT_ISOTROPIC))

    ldx, ldy, ldz = nx_ + uvx, ny_ + uvy, nz_ + uvz
    degen = (torch.abs(ldx) < NEAR_ZERO) & (torch.abs(ldy) < NEAR_ZERO) & (torch.abs(ldz) < NEAR_ZERO)
    ldx, ldy, ldz = (torch.where(degen, n_, l_) for n_, l_ in ((nx_, ldx), (ny_, ldy), (nz_, ldz)))

    dn = dx * nx_ + dy * ny_ + dz * nz_
    rfx, rfy, rfz = dx - 2.0 * dn * nx_, dy - 2.0 * dn * ny_, dz - 2.0 * dn * nz_
    rlen = torch.sqrt(torch.clamp(rfx * rfx + rfy * rfy + rfz * rfz, min=1e-24))
    mdx, mdy, mdz = rfx / rlen + mparam * uvx, rfy / rlen + mparam * uvy, rfz / rlen + mparam * uvz

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
    schl = r0s + (1.0 - r0s) * (om * (om2 * om2))
    refl = cannot | (schl > u3)
    udn = udx * nx_ + udy * ny_ + udz * nz_
    rfux, rfuy, rfuz = udx - 2.0 * udn * nx_, udy - 2.0 * udn * ny_, udz - 2.0 * udn * nz_
    rpx, rpy, rpz = ri * (udx + cos_t * nx_), ri * (udy + cos_t * ny_), ri * (udz + cos_t * nz_)
    k = 1.0 - (rpx * rpx + rpy * rpy + rpz * rpz)
    spar = -torch.sqrt(torch.clamp(torch.abs(k), min=1e-20))
    ddx = torch.where(refl, rfux, rpx + spar * nx_)
    ddy = torch.where(refl, rfuy, rpy + spar * ny_)
    ddz = torch.where(refl, rfuz, rpz + spar * nz_)

    def choose(l_, m_, d_, u_):
        return torch.where(is_lamb, l_, torch.where(is_metal, m_, torch.where(is_diel, d_, u_)))

    new_d = (choose(ldx, mdx, ddx, uvx), choose(ldy, mdy, ddy, uvy), choose(ldz, mdz, ddz, uvz))
    m_al = [m["alr"], m["alg"], m["alb"]]
    att = [torch.where(is_diel, 1.0, torch.where(uses_tex, ta, ma)).to(dt)
           for ta, ma in zip(t_al, m_al)]
    emit = [torch.where(is_light, ta, 0.0).to(dt) for ta in t_al]
    return emit, att, valid & ~is_light, (px, py, pz), new_d


# ---- camera and paths -------------------------------------------------------

def _div(a, b: float):
    return a / torch.full_like(a, float(b))


def camera_rays(cv: list, pid, sample, seed: int, width: int, sqrt_spp: int, dtype):
    """Camera::GetRay for lanes of pixel ``pid`` and sample ``sample``
    (int64): stratified jitter from the camera's five draws, defocus disk,
    shutter time. Returns (origin, direction, time, key)."""
    key = sample_key(seed, u32(pid), sample)
    u = [draw(key, CAMERA_CTR + k, dtype) for k in range(5)]
    pf = pid.to(torch.float32)
    yy = torch.floor(_div(pf, width))
    xx = (pf - yy * width).to(dtype)
    yy = yy.to(dtype)
    s = sample.to(torch.float32).to(dtype)
    k1 = torch.floor(_div(s, sqrt_spp))
    s_i = s - k1 * sqrt_spp
    s_j = k1 - torch.floor(_div(k1, sqrt_spp)) * sqrt_spp
    recip = 1.0 / sqrt_spp
    pxj = (s_i + u[0]) * recip - 0.5
    pyj = (s_j + u[1]) * recip - 0.5
    pc = [cv[i] + (xx + pxj) * cv[3 + i] + (yy + pyj) * cv[6 + i] for i in range(3)]
    r = torch.sqrt(u[2])
    th = TWO_PI * u[3]
    dkx, dky = r * torch.cos(th), r * torch.sin(th)
    if cv[18] > 0.0:
        o = [cv[9 + i] + dkx * cv[12 + i] + dky * cv[15 + i] for i in range(3)]
    else:
        o = [torch.full_like(pc[0], cv[9 + i]) for i in range(3)]
    dd = [pc[i] - o[i] for i in range(3)]
    inv_len = 1.0 / torch.sqrt(torch.clamp(dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2],
                                           min=1e-24))
    return o, [x * inv_len for x in dd], u[4], key


def trace(tb: Tables, cv: list, pid, sample, *, seed: int, width: int, depth: int,
          sqrt_spp: int, count_mats: bool = False):
    """Trace one path per lane (pixel ``pid``, sample ``sample``: int64
    tensors [N]). Returns a dict: ``radiance`` [N, 3], ``segments`` (int64
    [len(FAMILIES)]: the live lanes' bounces by the family they ended on),
    and with ``count_mats`` ``scatters`` [N, n_materials] int16 (each path's
    scatter events per material) and ``emitted`` [N, 3] (the emission its
    path ended on)."""
    dt = tb.dtype
    n = pid.shape[0]
    dev = pid.device
    n_med = len(tb.med)
    o, d, tm, key = camera_rays(cv, pid, sample, seed, width, sqrt_spp, dt)
    tp = [torch.ones(n, dtype=dt, device=dev) for _ in range(3)]
    rad = [torch.zeros(n, dtype=dt, device=dev) for _ in range(3)]
    segments = torch.zeros(len(FAMILIES), dtype=torch.int64, device=dev)
    n_mat = tb.mat["mtype"].shape[0]
    scatters = torch.zeros((n, n_mat), dtype=torch.int16, device=dev) if count_mats else None
    emitted = torch.zeros((n, 3), dtype=dt, device=dev) if count_mats else None
    lanes = torch.arange(n, device=dev)
    bn = torch.zeros(n, dtype=dt, device=dev)
    bg = tb.background
    for _ in range(depth):
        if lanes.numel() == 0:
            break
        hit = closest_hit(tb, key, bn, tm, o, d, n_med)
        segments += torch.bincount(hit[7], minlength=len(FAMILIES))
        emit, att, scat, p, nd = shade(tb, key, bn, o, d, hit, n_med)
        miss = ~(hit[1] >= 0.0)
        for c in range(3):
            contrib = torch.where(miss, tp[c] * bg[c], 0.0) + torch.where(miss, 0.0, tp[c] * emit[c])
            rad[c].index_add_(0, lanes, contrib.to(dt))
        if count_mats:
            ends = torch.stack([torch.where(miss, bg[c], emit[c]) for c in range(3)], -1)
            emitted.index_add_(0, lanes, torch.where(scat[:, None], 0.0, ends).to(dt))
            mi = hit[2].to(torch.int64)
            scatters.index_put_((lanes, mi), scatters[lanes, mi] + scat.to(torch.int16))
        bn = bn + 1.0
        keep = torch.nonzero(scat & (bn < float(depth))).squeeze(1)
        lanes, key, tm, bn = lanes[keep], key[keep], tm[keep], bn[keep]
        o = [x[keep] for x in p]
        d = [x[keep] for x in nd]
        tp = [(tp[c] * att[c])[keep] for c in range(3)]
    out = dict(radiance=torch.stack(rad, -1), segments=segments)
    if count_mats:
        out.update(scatters=scatters, emitted=emitted)
    return out


def pixel_sums(tb: Tables, cv: list, pixels, s0: int, n_samples: int, **kw):
    """Radiance summed over samples [s0, s0 + n_samples) for each of
    ``pixels`` (int64 [K]): float64 [K, 3], and the segments by family."""
    k = pixels.shape[0]
    dev = pixels.device
    sums = torch.zeros((k, 3), dtype=torch.float64, device=dev)
    segments = torch.zeros(len(FAMILIES), dtype=torch.int64, device=dev)
    total = k * n_samples
    step = chunk_lanes(tb)
    for i in range(0, total, step):
        flat = torch.arange(i, min(i + step, total), device=dev)
        rows = flat // n_samples
        out = trace(tb, cv, pixels[rows], s0 + flat % n_samples, **kw)
        sums.index_add_(0, rows, out["radiance"].to(torch.float64))
        segments += out["segments"]
    return sums, segments


def chunk_lanes(tb: Tables) -> int:
    """Lanes per call of ``trace``: about 2e7 lane-record pairs."""
    records = tb.sph["rad"].shape[1] + tb.quad["d"].shape[1] + tb.box["x0"].shape[1] + 1
    budget = 8e7 if tb.sph["rad"].is_cuda else 2e6
    return max(4096, int(budget // records))
