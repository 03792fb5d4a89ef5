"""AD against central differences for table-noise gradients through the
gradient kernel B3 (port of ``tools/check_table_grad.py``).

    python -m raytrace2_tpu_torch.tools.check_table_grad [--res 64] [--depth 3]
        [--eps 5e-3] [--device cuda|cpu]

A small scene (a noise-textured ground under a mirror sphere) renders on
the kernel route with ``noise_impl="table"`` (the reference's 256-entry
Perlin tables, forward and backward). ``grad.value_and_grad_scene`` of the
mean image gives the gradient of three leaves: the texture's scale, the
sphere's z and the texture's red albedo; each is held against the central
difference of the same render (the same streams) at ±``--eps``: both below
5e-5 in magnitude, or the same sign and a ratio within (0.5, 2), the JAX
tool's rule. One JSON line a leaf, then ``{"all_ok": ...}``; exit 1 when a
leaf fails. On ``--device cpu`` the plain forward and the plain replay run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np
import torch

NOISE_SCENE = {
    "background_color": [0.7, 0.75, 0.8],
    "camera": {"fov": 42, "center": [0, 2, 5], "look_at": [0, 0.5, 0]},
    "textures": [{"type": "noise", "albedo": [0.85, 0.8, 0.75], "scale": 0.6,
                  "noise_type": 0}],
    "materials": [{"type": "texture", "tex_idx": 0},
                  {"type": "metal", "albedo": [0.9, 0.9, 0.9], "fuzz": 0.0}],
    "primitives": [
        {"type": "quad", "q": [-30, 0, -30], "u": [60, 0, 0], "v": [0, 0, 60], "material": 0},
        {"type": "sphere", "center": [0, 1.0, 0], "radius": 0.9, "material": 1},
    ],
}


def agrees(ad: float, fd: float) -> bool:
    """The JAX tool's rule: both below 5e-5, or the same sign and a ratio
    within (0.5, 2)."""
    if not np.isfinite(ad):
        return False
    if abs(fd) < 5e-5 and abs(ad) < 5e-5:
        return True
    return bool(np.sign(ad) == np.sign(fd) and 0.5 < abs(ad / fd) < 2.0)


def ad_vs_fd(scene, features, leaves, eps, render_kw, log=print) -> list:
    """For each (name, path, index) of ``leaves``: the AD gradient of the
    mean image (``value_and_grad_scene``) at the scene's leaf entry against
    the central difference at ±eps. Returns the records."""
    from raytrace2_tpu_torch import grad as grad_mod

    def loss_fn(img):
        return img.mean()

    _, g = grad_mod.value_and_grad_scene(loss_fn, scene, features, 0, **render_kw)
    records = []
    for name, path, idx in leaves:
        family, leaf = path.split(".")

        def moved(delta, family=family, leaf=leaf, idx=idx):
            fam = getattr(scene, family)
            x = getattr(fam, leaf).clone()
            x[idx] += delta
            return dataclasses.replace(scene, **{family: dataclasses.replace(fam, **{leaf: x})})

        with torch.no_grad():
            f = [float(grad_mod.render_image(moved(s * eps), features, 0, **render_kw).mean())
                 for s in (1.0, -1.0)]
        fd = (f[0] - f[1]) / (2 * eps)
        ad = float(getattr(getattr(g, family), leaf)[idx])
        rec = {"leaf": name, "ad": ad, "fd": fd,
               "rel_err": abs(ad - fd) / max(abs(fd), 1e-12), "ok": agrees(ad, fd)}
        log(json.dumps(rec))
        records.append(rec)
    return records


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="check_table_grad")
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--depth", type=int, default=3)
    p.add_argument("--eps", type=float, default=5e-3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from raytrace2_tpu_torch.render import resolve_device
    from raytrace2_tpu_torch.scene import loader, schema

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as work:
        path = os.path.join(work, "noise.json")
        with open(path, "w") as f:
            json.dump(NOISE_SCENE, f)
        host, _ = loader.load_scene(path)
    features = dict(host.features(), use_megakernel=True, noise_impl="table")
    if not features.get("has_noise"):
        raise AssertionError("the scene lost its noise texture")
    scene = schema.to_device(host, device)
    kw = dict(width=args.res, height=args.res, n_samples=1, max_depth=args.depth, sqrt_spp=1)
    records = ad_vs_fd(scene, features, (("tex_scale", "textures.scale", (0,)),
                                         ("sphere_z", "spheres.center0", (0, 2)),
                                         ("tex_albedo_r", "textures.albedo", (0, 0))),
                       args.eps, kw)
    ok = all(r["ok"] for r in records)
    print(json.dumps({"all_ok": ok, "device": str(device)}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
