"""On-card validation ladder (port of ``tools/tpu_validate.py``).

    python -m raytrace2_tpu_torch.tools.validate [--golden-spp 1024] [--bench-spp 64]
        [--res 600] [--bench-res W] [--out DIR] [--device cuda|cpu]
        [--steps golden,ladder | golden,cornell_mega,...]

1. The golden render: the corpus Cornell box (``make_scene.
   cornell_box_corpus``) at ``--res``², depth 50, ``--golden-spp`` samples
   on the kernel route (v4), written as a PNG and held against
   ``renders/cornell32k_mega.npy`` (600², 32,768 spp): the mean linear
   radiance within 1 % of that render's 0.15941, and the PSNR of the two,
   clipped to [0, 1], over the means of 10 × 10-pixel blocks of the 600²
   image at least 40 dB. ``--res`` divides 600 by a whole number of blocks
   (600 takes 10-pixel blocks, 60 one pixel a block). The JAX tool compares
   against the reference's screenshot instead, which this repository does
   not hold.
2. The throughput ladder of the JAX tool's sweep, on scenes built in the
   process: Cornell on the kernel route and on the non-kernel (``xla``)
   route, the Cornell volume, book 1 (600 × 337) and book 2 on the kernel
   route (v4 below 257 records, the sorted wavefront above), depth 50, one
   warm-up sample, then ``--bench-spp`` samples in batches of at most the
   JAX tool's per-scene cap; paths/s and the mean, with a PNG of each.

Each step prints one JSON line; ``DIR/results.json`` holds them all. A
step that fails (a gate missed, an exception) makes the tool exit 1 after
the rest has run; the JAX tool's sweep records an exception and goes on
with exit 0, which this tool does not. On ``--device cpu`` it runs the
kernels' plain versions, far too slow at 600² (the tests run it at 60² and
8²).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np

from raytrace2_tpu_torch.tools import make_scene

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GOLDEN = os.path.join(REPO, "renders", "cornell32k_mega.npy")
GOLDEN_MEAN = 0.15941
MEAN_TOL = 0.01
PSNR_MIN_DB = 40.0
GOLDEN_BLOCK = 10   # pixels of the 600² golden image a block
DEPTH = 50
# (name, canned scene, width, height, backend, samples a batch): the JAX
# tool's sweep (tpu_validate.py:99-105).
LADDER = (("cornell_mega", "cornell_corpus", 600, 600, "mega", 128),
          ("cornell_xla", "cornell_corpus", 600, 600, "xla", 32),
          ("volume_mega", "cornell_volume", 600, 600, "mega", 64),
          ("book1_mega", "book1_final", 600, 337, "mega", 32),
          ("book2_mega", "book2_final", 600, 600, "mega", 16))


def block_psnr(img: np.ndarray, golden: np.ndarray, block: int = GOLDEN_BLOCK) -> float:
    """PSNR (dB) of ``img`` [r, r, 3] against ``golden`` [600, 600, 3] over
    the means of ``block``² blocks of the golden image (each r / (600 /
    block) pixels of ``img`` a block), both clipped to [0, 1]."""
    from raytrace2_tpu_torch.io import compare

    n = golden.shape[0] // block
    if img.shape[0] % n or img.shape[0] != img.shape[1]:
        raise ValueError(f"a {img.shape[0]}x{img.shape[1]} image has no whole blocks of the "
                         f"{n}x{n} grid")
    ours = compare.downsample(np.asarray(img, np.float64), img.shape[0] // n)
    ref = compare.downsample(np.asarray(golden, np.float64), block)
    return compare.psnr(np.clip(ours, 0.0, 1.0), np.clip(ref, 0.0, 1.0))


def render(name, width, height, spp, batch, device, backend="auto"):
    """(linear image, seconds, renderer) of ``spp`` samples of the canned
    scene ``name`` after one warm-up sample, the samples in batches of at
    most ``batch``, each batch read back."""
    import torch

    from raytrace2_tpu_torch.render import Renderer

    scene, _, _ = make_scene.load(name)
    r = Renderer(scene, width, height, num_samples=spp, max_depth=DEPTH, backend=backend,
                 device=device)
    r.update(1)
    r.reset()

    def sync():
        if r.device.type == "cuda":
            torch.cuda.synchronize(r.device)

    sync()
    t0 = time.perf_counter()
    done = 0
    while done < spp:
        step = min(batch, spp - done)
        r.update(step)
        float(r.state.accum[0, 0, 0])
        done += step
    sync()
    return r.linear_pixels(), time.perf_counter() - t0, r


def golden_step(args, device) -> dict:
    from raytrace2_tpu_torch.io import image

    img, dt, r = render("cornell_corpus", args.res, args.res, args.golden_spp, 128, device)
    image.write_image(img, os.path.join(args.out, "cornell_golden.png"))
    golden = np.load(GOLDEN)
    mean = float(img.mean())
    psnr = block_psnr(img, golden)
    ok = abs(mean - GOLDEN_MEAN) <= MEAN_TOL * GOLDEN_MEAN and psnr >= PSNR_MIN_DB
    return {"spp": args.golden_spp, "res": args.res, "route": r.route, "kernel": r.kernel,
            "seconds": dt, "paths_per_sec": args.golden_spp * args.res * args.res / dt,
            "mean": mean, "golden_mean": GOLDEN_MEAN, "block_psnr_db": psnr,
            "gate": f"|mean - {GOLDEN_MEAN}| <= {MEAN_TOL:.0%} and block PSNR >= "
                    f"{PSNR_MIN_DB} dB", "ok": bool(ok)}


def ladder_step(args, device, name, scene, width, height, backend, cap) -> dict:
    from raytrace2_tpu_torch.io import image

    scale = args.bench_res / 600.0 if args.bench_res else 1.0
    w, h = max(int(round(width * scale)), 1), max(int(round(height * scale)), 1)
    img, dt, r = render(scene, w, h, args.bench_spp, cap, device, backend)
    image.write_image(img, os.path.join(args.out, f"{name}.png"))
    mean = float(img.mean())
    return {"scene": scene, "width": w, "height": h, "route": r.route, "kernel": r.kernel,
            "spp": args.bench_spp, "seconds": dt, "paths_per_sec": args.bench_spp * w * h / dt,
            "mean": mean, "ok": bool(np.isfinite(img).all() and mean > 0.0)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="validate")
    p.add_argument("--golden-spp", type=int, default=1024)
    p.add_argument("--res", type=int, default=600, help="the golden render's side")
    p.add_argument("--bench-spp", type=int, default=64)
    p.add_argument("--bench-res", type=int, default=0,
                   help="the ladder's width in place of 600 (0: the JAX tool's sizes)")
    p.add_argument("--steps", default="golden,ladder",
                   help="golden, ladder, or ladder steps by name (comma list)")
    p.add_argument("--out", default="chiprun_out/validate")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from raytrace2_tpu_torch.render import resolve_device

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    steps = args.steps.split(",")
    unknown = set(steps) - {"golden", "ladder", *(rec[0] for rec in LADDER)}
    if unknown:
        print(f"error: unknown steps {sorted(unknown)}", file=sys.stderr)
        return 2
    jobs = ([("golden", lambda: golden_step(args, device))] if "golden" in steps else []) + [
        (rec[0], lambda rec=rec: ladder_step(args, device, *rec)) for rec in LADDER
        if "ladder" in steps or rec[0] in steps]
    results, failed = {}, []
    for name, job in jobs:
        try:
            results[name] = job()
        except Exception as e:  # noqa: BLE001 - recorded, and the exit code says so
            traceback.print_exc()
            results[name] = {"error": f"{type(e).__name__}: {e}", "ok": False}
        if not results[name]["ok"]:
            failed.append(name)
        print(json.dumps({name: results[name]}), flush=True)
    results["device"] = str(device)
    results["failed"] = failed
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
