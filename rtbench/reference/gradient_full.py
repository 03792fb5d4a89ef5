"""The reference of an inverse-rendering step on material albedos, for a
scene of any material: the L2 image loss and its gradient with respect to
``materials.albedo``.

At fixed random draws a path's radiance is the emission (or background) it
ends on times the attenuation of each of its scatters, and no direction
depends on an albedo. Of those factors only a lambertian or metal scatter
takes a ``materials.albedo`` row. Every other factor is a constant of the
path: a textured lambertian's texture value (the marble noise at the hit
point), an isotropic medium's texture albedo, a dielectric's 1. So one
trace of every path of the image gives, per path, its constant (the end
emission times every factor that is not an albedo row) and its lambertian
and metal scatter counts per material, and the image at any albedos θ is
pixel p's mean over its S samples of C · Π_m θ_m^n_m. ``image`` and
``loss_and_grad`` (``gradient.py``'s, on these paths) apply the product
rule to it in float64 (no matrix product runs, so TF32 never arises). On a
scene of lambertian and metal materials only the paths are
``gradient.trace_image``'s, bit for bit.

Departures from the program's estimator, which differentiates every float
leaf of the scene: only ``materials.albedo`` is computed here, so the
gradients of geometry, camera, fuzz, refraction index, textures and media
are not compared. A material that takes no albedo row (a diffuse light,
whose emission is its texture's value, a dielectric, a textured
lambertian, an isotropic medium) gets no gradient here, as the program
gives it exactly 0.
"""

from __future__ import annotations

import torch

from rtbench.reference import gradient, pathtrace

# Material types whose scatter takes the material's albedo row.
ALBEDO_MATERIALS = gradient.ALBEDO_MATERIALS
image = gradient.image
loss_and_grad = gradient.loss_and_grad


# Lane-record pairs per call of ``closest_hit`` on a card: its [lanes, records]
# intermediates take ~20 x 4 B a pair (~17 GB).
CARD_LANE_RECORDS = 3e8


def lanes_per_hit_call(tb: pathtrace.Tables) -> int:
    """Lanes per call of ``closest_hit``: ``pathtrace.chunk_lanes`` on the
    CPU, ``CARD_LANE_RECORDS`` pairs on a card."""
    if not tb.sph["rad"].is_cuda:
        return pathtrace.chunk_lanes(tb)
    records = tb.sph["rad"].shape[1] + tb.quad["d"].shape[1] + tb.box["x0"].shape[1] + 1
    return max(4096, int(CARD_LANE_RECORDS // records))


def trace(tb: pathtrace.Tables, cv: list, pid, sample, seed, *, width: int, depth: int,
          sqrt_spp: int) -> dict:
    """Trace one path per lane (pixel ``pid``, sample ``sample`` and render
    seed ``seed``: int64 tensors [N]) as ``pathtrace.trace`` does, every
    live lane a bounce at a time: the closest hit in calls of
    ``lanes_per_hit_call`` lanes, the shading of all of them in one call
    (the marble noise's hashes launch thousands of small kernels a call,
    whatever its lanes). Returns ``emitted`` [N, 3], the emission the path
    ends on times every factor that is not an albedo row, and ``scatters``
    [N, n_materials] int16, its lambertian and metal scatters per
    material."""
    dt = tb.dtype
    n = pid.shape[0]
    dev = pid.device
    n_med = len(tb.med)
    o, d, tm, key = pathtrace.camera_rays(cv, pid, sample, seed, width, sqrt_spp, dt)
    n_mat = tb.mat["mtype"].shape[0]
    scatters = torch.zeros((n, n_mat), dtype=torch.int16, device=dev)
    emitted = torch.zeros((n, 3), dtype=dt, device=dev)
    const = torch.ones((n, 3), dtype=dt, device=dev)
    takes_albedo = torch.zeros_like(tb.mat["mtype"], dtype=torch.bool)
    for kind in ALBEDO_MATERIALS:
        takes_albedo |= tb.mat["mtype"] == float(kind)
    lanes = torch.arange(n, device=dev)
    bn = torch.zeros(n, dtype=dt, device=dev)
    step = lanes_per_hit_call(tb)
    for _ in range(depth):
        if lanes.numel() == 0:
            break
        parts = [pathtrace.closest_hit(tb, key[i:i + step], bn[i:i + step], tm[i:i + step],
                                       [x[i:i + step] for x in o], [x[i:i + step] for x in d],
                                       n_med)
                 for i in range(0, lanes.numel(), step)]
        hit = tuple(torch.cat(cols) for cols in zip(*parts))
        del parts
        emit, att, scat, p, nd = pathtrace.shade(tb, key, bn, o, d, hit, n_med)
        miss = ~(hit[1] >= 0.0)
        ends = torch.stack([torch.where(miss, tb.background[c], emit[c]) for c in range(3)], -1)
        emitted.index_add_(0, lanes, torch.where(scat[:, None], 0.0, const * ends).to(dt))
        mi = hit[2].to(torch.int64)
        counted = scat & takes_albedo[mi]
        scatters.index_put_((lanes, mi), scatters[lanes, mi] + counted.to(torch.int16))
        const = torch.where(counted[:, None], const, const * torch.stack(att, -1))
        bn = bn + 1.0
        keep = torch.nonzero(scat & (bn < float(depth))).squeeze(1)
        lanes, key, tm, bn, const = lanes[keep], key[keep], tm[keep], bn[keep], const[keep]
        o = [x[keep] for x in p]
        d = [x[keep] for x in nd]
    return {"emitted": emitted, "scatters": scatters}


def trace_images(tb: pathtrace.Tables, cv: list, images: list, *, width: int, height: int,
                 depth: int, sqrt_spp: int) -> list:
    """Every path of each image of ``images``, a list of (render seed,
    samples), traced together (so that each bounce shades once for them
    all): for each image, in ``gradient.trace_image``'s form, ``emitted``
    [P, 3] and ``scatters`` [P, n_materials] pixel-major (P = pixels ×
    samples) and ``n_samples``. A path is its image's path traced alone."""
    dev = tb.sph["rad"].device
    pid, sample, seed = [], [], []
    for s, n_samples in images:
        flat = torch.arange(width * height * n_samples, device=dev)
        pid.append(flat // n_samples)
        sample.append(flat % n_samples)
        seed.append(torch.full_like(flat, s))
    out = trace(tb, cv, torch.cat(pid), torch.cat(sample), torch.cat(seed), width=width,
                depth=depth, sqrt_spp=sqrt_spp)
    sizes = [x.shape[0] for x in pid]
    return [{"emitted": em, "scatters": sc, "n_samples": n_samples}
            for em, sc, (_, n_samples) in zip(out["emitted"].split(sizes),
                                               out["scatters"].split(sizes), images)]


def trace_image(tb: pathtrace.Tables, cv: list, *, seed: int, width: int, height: int,
                n_samples: int, depth: int, sqrt_spp: int) -> dict:
    """Every path of one image, in ``gradient.trace_image``'s form."""
    return trace_images(tb, cv, [(seed, n_samples)], width=width, height=height, depth=depth,
                        sqrt_spp=sqrt_spp)[0]
