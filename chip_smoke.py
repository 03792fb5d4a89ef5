#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (raytrace2_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. the device, with nvidia-smi's name and power limit;
  2. build every CUDA kernel from csrc/ with nvcc (timed, with ptxas usage);
  3. closed-form scenes through the kernel, exact (rtol 1e-5);
  4. kernel vs its plain PyTorch version on the card, same inputs: Cornell
     600x600 4 spp depth 8, the feature scene 256x256 4 spp depth 8, and
     Cornell at the main path's launch shape (600x600, depth 50, the CLI's
     6-sample batch) with both timed; gate |Δmean| < 1e-3 and PSNR ≥ 45 dB;
  5. the main path through the CLI entry (app.main): Cornell 600x600,
     depth 50, 64 spp, PNG written, launch counts reset before and read
     after, mean linear radiance checked, Mpaths/s reported;
  6. one JSON line describing each kernel.
The last line is {"ok": true, "device": {...}}. Any failure exits non-zero
before printing it, as does a machine without CUDA or a directory without
the package.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# Cornell mean linear radiance at 64 spp (sqrt_spp 8), depth 50. The scene
# of tools/make_scene.py cornell_box_original has a larger light (330x305 of
# radiance 7) than the reference corpus file whose telltale is 0.159-0.160;
# the JAX package renders this scene to 0.5373 (64x64) and 0.5358 (120x120)
# on its XLA path with the kernel's RNG streams. See PERF.md.
CORNELL_MEAN_BAND = (0.52, 0.55)
MATCH_MEAN, MATCH_PSNR = 1e-3, 45.0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def main() -> None:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"needs numpy and torch: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    try:
        import make_scene
        from test_torch_scenes import feature_scene_json

        from raytrace2_tpu_torch import app
        from raytrace2_tpu_torch.io import compare, image
        from raytrace2_tpu_torch.ops import camera
        from raytrace2_tpu_torch.ops.kernels import build
        from raytrace2_tpu_torch.ops.kernels import megakernel as mk
        from raytrace2_tpu_torch.render import Renderer
        from raytrace2_tpu_torch.scene import loader, schema
    except ImportError as e:
        fail(f"run from the root of a checkout of the repository: {e}")
    for name in ("jax", "raytrace2_tpu"):
        check(name not in sys.modules, f"{name} was imported")

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    # ---- phase 1: device ---------------------------------------------------
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi: {e}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say(f"phase 1 device: {kind} x{count}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- phase 2: build ----------------------------------------------------
    t0 = time.perf_counter()
    build.build_all()
    say(f"phase 2 build: {', '.join(build.KERNELS)} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    for name, log in build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  {name} ptxas: {line.strip()}")

    work = tempfile.mkdtemp(prefix="chip_smoke_")

    def scene_file(name: str, obj: dict) -> str:
        path = os.path.join(work, f"{name}.json")
        with open(path, "w") as f:
            json.dump(obj, f)
        return path

    # ---- phase 3: closed forms through the kernel ---------------------------
    closed = [
        ("enclosure", {"background_color": [0, 0, 0],
                       "camera": {"fov": 90, "center": [0, 0, 0], "look_at": [0, 0, -1]},
                       "materials": [{"type": "diffuse_light", "albedo": [2.0, 3.0, 4.0]}],
                       "primitives": [{"type": "sphere", "center": [0, 0, 0],
                                       "radius": 10.0, "material": 0}]},
         [2.0, 3.0, 4.0]),
        ("lambertian_plane", {"background_color": [1.0, 0.8, 0.6],
                              "camera": {"fov": 40, "center": [0, 5, 0],
                                         "look_at": [0, 0, -10]},
                              "materials": [{"type": "lambertian", "albedo": [0.3, 0.5, 0.7]}],
                              "primitives": [{"type": "quad", "q": [-1000, 0, -1000],
                                              "u": [2000, 0, 0], "v": [0, 0, 2000],
                                              "material": 0}]},
         [0.3 * 1.0, 0.5 * 0.8, 0.7 * 0.6]),
        ("aa_box", {"background_color": [0, 0, 0],
                    "camera": {"fov": 90, "center": [0, 0, 0], "look_at": [0, 0, -1]},
                    "materials": [{"type": "diffuse_light", "albedo": [1.5, 2.5, 3.5]}],
                    "primitives": [{"type": "box", "a": [-5, -5, -5], "b": [5, 5, 5],
                                    "material": 0}]},
         [1.5, 2.5, 3.5]),
    ]
    for name, obj, want in closed:
        scene, _ = loader.load_scene(scene_file(name, obj))
        before = mk.LAUNCHES
        img = Renderer(scene, 32, 32, num_samples=3, max_depth=4, device=dev).render(batch=3)
        check(mk.LAUNCHES == before + 1, f"{name}: the kernel was not launched")
        err = float(np.max(np.abs(img / np.asarray(want) - 1.0)))
        check(err <= 1e-5, f"{name}: relative error {err:.3g} > 1e-5")
        say(f"phase 3 closed form {name}: max relative error {err:.3g} (rtol 1e-5) ok")

    # ---- phase 4: kernel vs plain on the card --------------------------------
    def prepare(path, w, h, spp, depth):
        scene, _ = loader.load_scene(path)
        feats = scene.features()
        sizes = tuple(feats["mega_sizes"])
        ds = schema.to_device(scene, dev)
        packed = mk.pack_buffer(ds, sizes)
        camv = camera.make_camv(scene.camera, w, h, 0, spp, max(int(spp ** 0.5), 1), 0).to(dev)
        kw = dict(n_pix=w * h, max_depth=depth, sizes=sizes,
                  has_checker=feats["has_checker"], has_noise=feats["has_noise"])
        return (camv, 0, packed, ds.background), kw

    def timed(fn, reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end) / reps

    cornell = scene_file("cornell", make_scene.cornell_box_original().to_json())
    feature = scene_file("feature", feature_scene_json())
    results = {}
    cases = [("cornell 600x600 4spp depth 8", cornell, 600, 4, 8, 1),
             ("feature 256x256 4spp depth 8", feature, 256, 4, 8, 1),
             ("cornell 600x600 6spp depth 50 (main-path launch)", cornell, 600, 6, 50, 5)]
    for label, path, size, spp, depth, reps in cases:
        args, kw = prepare(path, size, size, spp, depth)
        mk.trace_megakernel_batch(*args, **kw)  # warm-up (and first launch)
        torch.cuda.synchronize()
        kern, ms = timed(lambda: mk.trace_megakernel_batch(*args, **kw), reps)
        plain, plain_ms = timed(lambda: mk.trace_plain(*args, **kw), 1)
        k = kern.cpu().numpy() / spp
        p = plain.cpu().numpy() / spp
        check(np.isfinite(k).all(), f"{label}: kernel output not finite")
        d_mean = abs(float(k.mean() - p.mean()))
        psnr = compare.psnr(k, p)
        max_err = float(np.max(np.abs(k - p)))
        n_diff = int((np.abs(k - p).max(-1) > 1e-4).sum())
        say(f"phase 4 kernel vs plain, {label}: |dmean| {d_mean:.3g}, PSNR {psnr:.2f} dB, "
            f"max abs err {max_err:.3g}, pixels differing >1e-4: {n_diff} of {size * size}; "
            f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms ({card})")
        check(d_mean < MATCH_MEAN and psnr >= MATCH_PSNR,
              f"{label}: kernel disagrees with its plain version")
        results[label] = dict(max_abs_err=max_err, psnr=psnr, ms=ms, plain_ms=plain_ms)

    # ---- phase 5: main path through the CLI ----------------------------------
    out_png = os.path.join(work, "cornell.png")
    metrics = os.path.join(work, "metrics.jsonl")
    mk.LAUNCHES = 0
    rc = app.main([cornell, out_png, "--samples", "64", "--depth", "50",
                   "--device", "cuda", "--metrics", metrics, "--quiet"])
    launches = mk.LAUNCHES
    check(rc == 0, f"app.main exited {rc}")
    check(launches > 0, "the main path launched no kernel")
    with open(metrics) as f:
        done = [json.loads(line) for line in f][-1]
    with open(out_png, "rb") as f:
        png = image.decode_png(f.read())
    check(png.shape == (600, 600, 3), f"PNG shape {png.shape}")
    mean = done["mean_linear"]
    lo, hi = CORNELL_MEAN_BAND
    check(lo <= mean <= hi, f"Cornell mean linear radiance {mean:.4f} outside [{lo}, {hi}]")
    say(f"phase 5 main path: app.main Cornell 600x600 64 spp depth 50, {launches} kernel "
        f"launches, mean linear radiance {mean:.4f} in [{lo}, {hi}], "
        f"{done['mpaths_per_s']:.2f} Mpaths/s over {done['elapsed_s']:.3f} s on {card}")
    shutil.rmtree(work)

    # ---- phase 6: the kernels ------------------------------------------------
    main_shape = results[cases[2][0]]
    say(json.dumps({"kernels": [{
        "name": "megakernel_v4", "route": "cuda",
        "source": "raytrace2_tpu_torch/csrc/megakernel_v4.cu",
        "replaces": "raytrace2_tpu/ops/pallas/megakernel.py:1786 (_render_kernel_v4)",
        "launches": launches,
        "max_abs_err": main_shape["max_abs_err"],
        # None when the two agree exactly (PSNR is infinite; not JSON).
        "psnr_db": main_shape["psnr"] if np.isfinite(main_shape["psnr"]) else None,
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "vs_plain": "pass",
    }]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
