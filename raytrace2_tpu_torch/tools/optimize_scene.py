"""Inverse rendering: recover scene parameters by gradient descent on the
differentiable renderer (port of ``tools/optimize_scene.py``).

The tool renders a target image from a scene file, perturbs the chosen
parameters, then optimizes them back with Adam on an L2 image loss through
``grad.value_and_grad_scene`` — the forward kernel and the indexed-replay
backward kernel on a CUDA device, their plain versions on the CPU.

Usage:
    python -m raytrace2_tpu_torch.tools.optimize_scene SCENE.json \\
        --leaves materials.albedo camera.vfov \\
        --steps 60 --width 64 --height 64 --samples 4 --depth 6 [--device cpu]

Prints one JSON line per step (loss, relative parameter error) and a final
``{"event": "done", ...}`` summary.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from raytrace2_tpu_torch import grad as grad_mod
from raytrace2_tpu_torch.render import resolve_device
from raytrace2_tpu_torch.scene import loader, schema


def _leaf(path):
    """(getter, setter) of a dotted FlatScene leaf such as 'materials.albedo'."""
    parts = path.split(".")

    def get(s):
        for p in parts:
            s = getattr(s, p)
        return s

    def put(s, v):
        if len(parts) == 1:
            return dataclasses.replace(s, **{parts[0]: v})
        return dataclasses.replace(s, **{parts[0]: dataclasses.replace(
            getattr(s, parts[0]), **{parts[1]: v})})

    return get, put


# Leaves the tool optimizes (the JAX tool's set).
_LEAVES = {k: _leaf(k) for k in ("materials.albedo", "materials.param", "background",
                                 "camera.vfov", "camera.center", "spheres.center0")}


def optimize(scene, features, leaves, *, steps, lr, render_kw, seed=0, perturb_rel=0.15,
             log=print, rng=None):
    """Perturb ``leaves`` of ``scene`` (a FlatScene on the render device),
    then recover them against the clean render. Returns (recovered scene,
    per-step records)."""
    rng = rng or np.random.RandomState(0)
    with torch.no_grad():
        target = grad_mod.render_image(scene, features, seed, **render_kw)

    truth = {k: _LEAVES[k][0](scene).detach().clone() for k in leaves}
    cur = scene
    for k in leaves:
        t = truth[k]
        bump = torch.as_tensor(rng.uniform(-perturb_rel, perturb_rel, tuple(t.shape)),
                               dtype=torch.float32, device=t.device) * (torch.abs(t) + 0.3)
        cur = _LEAVES[k][1](cur, t + bump)

    # Adam on the selected leaves (explicit state, as the JAX tool keeps it).
    m = {k: torch.zeros_like(truth[k]) for k in leaves}
    v = {k: torch.zeros_like(truth[k]) for k in leaves}
    b1, b2, eps = 0.9, 0.999, 1e-8

    def loss_fn(img):
        return torch.mean((img - target) ** 2)

    records = []
    for step in range(1, steps + 1):
        loss, g = grad_mod.value_and_grad_scene(loss_fn, cur, features, seed, **render_kw)
        rec = {"step": step, "loss": float(loss)}
        for k in leaves:
            gk = _LEAVES[k][0](g).to(torch.float32)
            m[k] = b1 * m[k] + (1 - b1) * gk
            v[k] = b2 * v[k] + (1 - b2) * gk * gk
            mh = m[k] / (1 - b1 ** step)
            vh = v[k] / (1 - b2 ** step)
            new = _LEAVES[k][0](cur) - lr * mh / (torch.sqrt(vh) + eps)
            cur = _LEAVES[k][1](cur, new)
            err = float(torch.linalg.norm(new - truth[k])
                        / (torch.linalg.norm(truth[k]) + 1e-8))
            rec[f"rel_err[{k}]"] = round(err, 5)
        rec["loss"] = round(rec["loss"], 8)
        records.append(rec)
        log(json.dumps(rec))
    return cur, records


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("scene")
    p.add_argument("--leaves", nargs="+", default=["materials.albedo"],
                   choices=sorted(_LEAVES))
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--lr", type=float, default=2e-2)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--samples", type=int, default=4)
    p.add_argument("--depth", type=int, default=6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels; the default) or cpu (their plain versions)")
    args = p.parse_args(argv)

    try:
        device = resolve_device(args.device)
        scene_host, _ = loader.load_scene(args.scene, seed=args.seed)
    except (RuntimeError, ValueError, OSError, loader.SceneError) as e:
        print(f"optimize_scene: {e}", file=sys.stderr)
        return 1
    features = scene_host.features()
    scene = schema.to_device(scene_host, device)
    render_kw = dict(width=args.width, height=args.height, n_samples=args.samples,
                     max_depth=args.depth, sqrt_spp=max(int(args.samples ** 0.5), 1))
    _, records = optimize(scene, features, args.leaves, steps=args.steps, lr=args.lr,
                          render_kw=render_kw, seed=args.seed)
    first, last = records[0], records[-1]
    print(json.dumps({
        "event": "done", "steps": args.steps,
        "loss_first": first["loss"], "loss_last": last["loss"],
        "improvement": round(first["loss"] / max(last["loss"], 1e-12), 2),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
