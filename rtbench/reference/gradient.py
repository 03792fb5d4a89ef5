"""The reference of an inverse-rendering step on material albedos: the L2
image loss and its gradient with respect to ``materials.albedo``.

At fixed random draws a path's radiance is the emission it ends on times
the albedo of each lambertian or metal bounce, and no direction depends on
an albedo. So one trace of every path of the image (``pathtrace.trace``
with ``count_mats``: the emission and each path's scatter count per
material) gives the image at any albedos θ, pixel p's mean over its S
samples of E · Π_m θ_m^n_m, and its derivative by the product rule. A
scene whose paths scatter off any other material is refused.
"""

from __future__ import annotations

import torch

from rtbench.reference import pathtrace, scene as sc

ALBEDO_MATERIALS = (sc.MAT_LAMBERTIAN, sc.MAT_METAL)


def trace_image(tb: pathtrace.Tables, cv: list, *, seed: int, width: int, height: int,
                n_samples: int, depth: int, sqrt_spp: int) -> dict:
    """Every path of the image, pixel-major: ``emitted`` [P, 3] and
    ``scatters`` [P, n_materials] (P = pixels × n_samples)."""
    n_pix = width * height
    total = n_pix * n_samples
    dev = tb.sph["rad"].device
    n_mat = tb.mat["mtype"].shape[0]
    emitted = torch.empty((total, 3), dtype=tb.dtype, device=dev)
    scatters = torch.empty((total, n_mat), dtype=torch.int16, device=dev)
    step = pathtrace.chunk_lanes(tb)
    for i in range(0, total, step):
        flat = torch.arange(i, min(i + step, total), device=dev)
        out = pathtrace.trace(tb, cv, flat // n_samples, flat % n_samples, seed=seed,
                              width=width, depth=depth, sqrt_spp=sqrt_spp, count_mats=True)
        emitted[i:i + flat.shape[0]] = out["emitted"]
        scatters[i:i + flat.shape[0]] = out["scatters"]
    kinds = tb.mat["mtype"][scatters.amax(0) > 0]
    if not all(float(k) in ALBEDO_MATERIALS for k in kinds.tolist()):
        raise ValueError("paths scatter off a material whose factor is not its albedo")
    return {"emitted": emitted, "scatters": scatters, "n_samples": n_samples}


def _chunks(paths: dict, pixels_per_chunk: int = 65536):
    s = paths["n_samples"]
    total = paths["emitted"].shape[0]
    for i in range(0, total, pixels_per_chunk * s):
        j = min(i + pixels_per_chunk * s, total)
        yield i // s, paths["emitted"][i:j], paths["scatters"][i:j].to(torch.int64)


def image(paths: dict, theta: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """Mean radiance per pixel [n_pix, 3] at albedos ``theta`` [M, 3]."""
    s = paths["n_samples"]
    theta = theta.to(dtype)
    out = []
    for _, em, n in _chunks(paths):
        val = em.to(dtype)
        for m in torch.nonzero(n.amax(0) > 0).flatten().tolist():
            val = val * torch.pow(theta[m][None, :], n[:, m:m + 1].to(dtype))
        out.append(val.reshape(-1, s, 3).sum(1) / s)
    return torch.cat(out)


def loss_and_grad(paths: dict, theta: torch.Tensor, target: torch.Tensor,
                  dtype=torch.float64) -> tuple[torch.Tensor, torch.Tensor]:
    """mean((image - target)²) and its gradient with respect to ``theta``."""
    s = paths["n_samples"]
    theta = theta.to(dtype)
    img = image(paths, theta, dtype)
    diff = img - target.reshape(-1, 3).to(dtype)
    loss = torch.mean(diff * diff)
    weight = 2.0 * diff / diff.numel() / s
    grad = torch.zeros_like(theta)
    for p0, em, n in _chunks(paths):
        used = torch.nonzero(n.amax(0) > 0).flatten().tolist()
        w = weight[p0:p0 + em.shape[0] // s].repeat_interleave(s, 0) * em.to(dtype)
        powers = {m: torch.pow(theta[m][None, :], n[:, m:m + 1].to(dtype)) for m in used}
        for m in used:
            d = n[:, m:m + 1].to(dtype) * torch.pow(theta[m][None, :],
                                                    torch.clamp(n[:, m:m + 1] - 1, min=0).to(dtype))
            for k in used:
                if k != m:
                    d = d * powers[k]
            grad[m] += (w * d).sum(0)
    return loss, grad
