"""Deep gradients of a big scene, timed, with an AD-against-FD gate (port
of ``tools/bench_big_grad.py``).

    python -m raytrace2_tpu_torch.tools.bench_big_grad [SCENE] [--res 600] [--spp 4]
        [--depth 50] [--steps 3] [--fd-res 64] [--fd-depth N] [--skip-fd]
        [--device cuda|cpu]

``SCENE`` is a scene JSON or a canned scene of the port's ``make_scene``
(default ``book2_final``, the corpus's depth 50). One training step is
``grad.value_and_grad_scene`` of an L2 loss (``mean((img - 0.25)²)``) over
the whole scene on the kernel route (the forward kernel and B3 where the
scene fits them, else the differentiable scan): the first step (builds
included) and the mean of ``--steps`` more are timed. Then the gate: the AD
gradient of the mean image in the first material's red albedo at
``--fd-res``², 1 spp, against the central difference at ±2e-3 (the rule of
``check_table_grad``); exit 1 when it fails. JSON lines on stdout.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from raytrace2_tpu_torch.tools import make_scene
from raytrace2_tpu_torch.tools.check_table_grad import ad_vs_fd


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bench_big_grad")
    p.add_argument("scene", nargs="?", default="book2_final")
    p.add_argument("--res", type=int, default=600)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--depth", type=int, default=50)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--fd-res", type=int, default=64)
    p.add_argument("--fd-depth", type=int, default=None)
    p.add_argument("--skip-fd", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from raytrace2_tpu_torch import grad as grad_mod
    from raytrace2_tpu_torch.render import resolve_device
    from raytrace2_tpu_torch.scene import schema

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    host, _, label = make_scene.load(args.scene)
    features = dict(host.features(), use_megakernel=True)
    scene = schema.to_device(host, device)
    print(json.dumps({"scene": label, "sizes": features["mega_sizes"], "depth": args.depth,
                      "kernel_route": grad_mod.takes_kernel(features, args.depth),
                      "device": str(device)}), flush=True)
    kw = dict(width=args.res, height=args.res, n_samples=args.spp, max_depth=args.depth,
              sqrt_spp=max(int(np.sqrt(args.spp)), 1))

    def loss_fn(img):
        return torch.mean(torch.square(img - 0.25))

    def step():
        loss, g = grad_mod.value_and_grad_scene(loss_fn, scene, features, 0, **kw)
        alb = g.materials.albedo
        return float(loss), alb

    t0 = time.perf_counter()
    loss, alb = step()
    first = time.perf_counter() - t0
    finite = bool(torch.isfinite(alb).all())
    print(json.dumps({"first_step_s": first, "loss": loss,
                      "grad_albedo_norm": float(torch.linalg.vector_norm(alb)),
                      "grad_finite": finite}), flush=True)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step()
    dt = (time.perf_counter() - t0) / max(args.steps, 1)
    print(json.dumps({"train_step_s": dt, "res": args.res, "spp": args.spp,
                      "fwdbwd_mpaths_s": args.res * args.res * args.spp / dt / 1e6}),
          flush=True)
    ok = finite
    if not args.skip_fd:
        fd_kw = dict(width=args.fd_res, height=args.fd_res, n_samples=1,
                     max_depth=args.fd_depth or args.depth, sqrt_spp=1)
        ok &= all(r["ok"] for r in ad_vs_fd(scene, features,
                                             (("albedo_r", "materials.albedo", (0, 0)),),
                                             2e-3, fd_kw, log=lambda s: print(s, flush=True)))
    print(json.dumps({"all_ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
