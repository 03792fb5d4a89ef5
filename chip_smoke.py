#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (raytrace2_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. the device, with nvidia-smi's name and power limit;
  2. build every CUDA kernel from csrc/ with nvcc, one process per source,
     all started together (timed, with ptxas usage);
  3. closed-form scenes through both kernels (v4, and the wavefront forced),
     exact (rtol 1e-5);
  4. each kernel vs its plain PyTorch version on the card, same inputs, gate
     |Δmean| < 1e-3 and PSNR ≥ 45 dB: v4 on Cornell 600x600 4 spp depth 8,
     the feature scene 256x256 4 spp depth 8, and Cornell at its main path's
     launch shape (600x600, depth 50, the CLI's 6-sample batch), both timed;
     the wavefront on Cornell 600x600 4 spp depth 8 (forced) and book 2
     64x64 2 spp depth 4, driven by the kernel and by its plain step; the
     wavefront's step at its main path's launch shapes (book 2 600x600,
     depth 50, 6-sample batch: a K=2 launch and a K=16 tail launch),
     kernel vs plain step on the same captured state, timed; the wavefront
     bitwise equal to v4 on book 2 600x600 16 spp depth 50, both timed; and
     where a book-2 batch's time goes (kernel, sort, runnable counts, host);
  5. the v4 main path through the CLI entry (app.main): Cornell 600x600,
     depth 50, 64 spp, PNG written, launch counts reset before and read
     after, mean linear radiance checked, Mpaths/s reported;
  6. the wavefront main path through app.main with the default backend:
     book 2 600x600, depth 50, 64 spp; wavefront launches and sorts > 0 and
     no v4 launch, PNG written, mean linear radiance checked against the
     16-spp render of phase 4;
  7. one JSON line describing each kernel, with its bound (f32 operations
     counted from csrc/path_common.cuh for the bounces this run's data took,
     or bytes moved, over the card's peak rates).
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
# Book 2 at 64 spp against the same scene's 16-spp render: the same
# estimator, so the means agree to Monte-Carlo noise (well under 10 %).
BOOK2_MEAN_RTOL = 0.10
# H100 SXM peaks (NVIDIA data sheet, 700 W): f32 outside the tensor cores,
# and device memory.
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# f32 arithmetic operations (add, sub, mul, div, sqrt, compare, min/max) of
# one closest-hit test per record family and of one bounce's shading,
# counted from csrc/path_common.cuh (closest_hit, bounce). Integer hashing,
# selects and the camera ray are not counted, so the bound is a low one.
OPS_PER_RECORD = {"sph": 35, "quad": 46, "box": 28, "med": 85}
OPS_SHADE = 120


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
        from raytrace2_tpu_torch.ops.kernels import wavefront as wf
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
        for backend, module in (("auto", mk), ("wavefront", wf)):
            before = module.LAUNCHES
            img = Renderer(scene, 32, 32, num_samples=3, max_depth=4, backend=backend,
                           device=dev).render(batch=3)
            check(module.LAUNCHES > before, f"{name} ({backend}): the kernel was not launched")
            err = float(np.max(np.abs(img / np.asarray(want) - 1.0)))
            check(err <= 1e-5, f"{name} ({backend}): relative error {err:.3g} > 1e-5")
            say(f"phase 3 closed form {name} through {module.__name__.rsplit('.', 1)[1]}: "
                f"max relative error {err:.3g} (rtol 1e-5) ok")

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

    def n_rays_of(n_pix):
        return -(-n_pix // wf.SLOT_TILE) * wf.SLOT_TILE

    def gate(label, k, p):
        check(np.isfinite(k).all(), f"{label}: kernel output not finite")
        d_mean = abs(float(k.mean() - p.mean()))
        psnr = compare.psnr(k, p)
        max_err = float(np.max(np.abs(k - p)))
        check(d_mean < MATCH_MEAN and psnr >= MATCH_PSNR,
              f"{label}: kernel disagrees with its plain version "
              f"(|dmean| {d_mean:.3g}, PSNR {psnr:.2f} dB)")
        return d_mean, psnr, max_err

    book2 = scene_file("book2", make_scene.book2_final(rng_seed=0).to_json())
    wf_cases = [("cornell 600x600 4spp depth 8 (wavefront forced)", cornell, 600, 4, 8),
                ("book2 64x64 2spp depth 4", book2, 64, 2, 4)]
    for label, path, size, spp, depth in wf_cases:
        args, kw = prepare(path, size, size, spp, depth)
        kw.pop("n_pix")
        n_pix = size * size
        t0 = time.perf_counter()
        kern = wf.trace_wavefront_batch(*args, n_rays=n_rays_of(n_pix), **kw)[:n_pix]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        plain = wf.trace_wavefront_batch(*args, n_rays=n_rays_of(n_pix), step=wf.step_plain,
                                         **kw)[:n_pix]
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        k, p = kern.cpu().numpy() / spp, plain.cpu().numpy() / spp
        d_mean, psnr, max_err = gate(label, k, p)
        say(f"phase 4 wavefront kernel vs plain step, {label}: |dmean| {d_mean:.3g}, "
            f"PSNR {psnr:.2f} dB, max abs err {max_err:.3g}; whole batch with the kernel "
            f"{ms:.1f} ms, with the plain step {plain_ms:.1f} ms ({card})")

    def count_bounces(state, camv, seed, packed, bg, k, kw):
        """Bounces the next k steps of ``state`` take, counted by single
        plain steps: the slots that can run before each step."""
        state, total = state.clone(), 0
        n_samples = float(camv[22])
        for _ in range(k):
            total += wf.runnable_count(state, n_samples)
            state = wf.step_plain(state, camv, seed, packed, bg, k_bounces=1, **kw)
        return total

    def ops_per_bounce(sizes):
        n_sph, n_quad, _, _, n_med, n_box = sizes
        return (n_sph * OPS_PER_RECORD["sph"] + n_quad * OPS_PER_RECORD["quad"]
                + n_box * OPS_PER_RECORD["box"] + n_med * OPS_PER_RECORD["med"] + OPS_SHADE)

    # B1's bound at its main-path launch shape: bounces counted by the plain
    # version (single steps of the same per-slot semantics).
    args, kw = prepare(cornell, 600, 600, 6, 50)
    n_pix = kw.pop("n_pix")
    state = wf.init_wavefront_state(n_rays_of(n_pix), args[0].tolist(), dev)
    v4_bounces = 0
    while (c := wf.runnable_count(state, 6.0)) > 0:
        v4_bounces += c
        state = wf.step_plain(state, *args, k_bounces=1, **kw)
    v4_ops = v4_bounces * ops_per_bounce(kw["sizes"])
    v4_bytes = 12 * n_pix + args[2].numel() * 4
    results[cases[2][0]]["bound_ms"] = max(v4_ops / PEAK_F32_OPS, v4_bytes / PEAK_BYTES) * 1e3
    say(f"phase 4 v4 bound at the main-path launch: {v4_bounces} bounces "
        f"({v4_bounces / (n_pix * 6):.3f} per path) x {ops_per_bounce(kw['sizes'])} f32 ops "
        f"= {v4_ops:.4g} ops, {v4_bytes} B -> {results[cases[2][0]]['bound_ms']:.4f} ms "
        f"(by operations, 67 TFLOP/s f32)")

    # The wavefront at its main path's launch shape (book 2 600x600, depth
    # 50, the CLI's 6-sample batch): one batch with every launch, sort and
    # runnable count timed by CUDA events, and the state captured before a
    # K=2 launch and before the first K=16 tail launch.
    args, kw = prepare(book2, 600, 600, 6, 50)
    n_pix = kw.pop("n_pix")
    n_rays = n_rays_of(n_pix)
    ev = {"step2": [], "step16": [], "sort": [], "count": []}
    captured = {}

    def timed(fn, bucket):
        def run(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            ev[bucket(k) if callable(bucket) else bucket].append((start, end))
            return out
        return run

    def capture_step(state, *a, k_bounces, **k):
        tag = f"k{k_bounces}"
        if tag not in captured and (k_bounces != wf.K_BOUNCES or len(ev["step2"]) == 4):
            captured[tag] = state.clone()
        return wf.wavefront_step(state, *a, k_bounces=k_bounces, **k)

    orig_sort, orig_count = wf.sort_state, wf.runnable_count
    wf.sort_state = timed(orig_sort, "sort")
    wf.runnable_count = timed(orig_count, "count")
    try:
        wf.trace_wavefront_batch(*args, n_rays=n_rays, **kw)  # warm-up
        for v in ev.values():
            v.clear()
        captured.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wf.trace_wavefront_batch(
            *args, n_rays=n_rays,
            step=timed(capture_step, lambda k: f"step{min(k['k_bounces'], 16)}"), **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        wf.sort_state, wf.runnable_count = orig_sort, orig_count
    dev_ms = {b: sum(s_.elapsed_time(e_) for s_, e_ in v) for b, v in ev.items()}
    n2, n16 = len(ev["step2"]), len(ev["step16"])
    busy = sum(dev_ms.values())
    say(f"phase 4 where a book-2 batch goes (600x600, 6 spp, depth 50, {n2} K=2 + {n16} "
        f"K=16 launches, {len(ev['sort'])} sorts, {len(ev['count'])} runnable counts "
        f"read on the host): wall {wall_ms:.2f} ms; kernel {dev_ms['step2']:.2f} ms "
        f"(K=2) + {dev_ms['step16']:.2f} ms (K=16); keys+argsort+gather "
        f"{dev_ms['sort']:.2f} ms; runnable counts {dev_ms['count']:.2f} ms (device time "
        f"to each read); host gaps {wall_ms - busy:.2f} ms; per launch K=2 "
        f"{dev_ms['step2'] / max(n2, 1):.4f} ms, K=16 {dev_ms['step16'] / max(n16, 1):.4f} ms "
        f"({card})")
    check("k2" in captured and "k16" in captured, "no K=2 or K=16 launch to capture")

    wf_launch = {}
    for tag, k in (("k2", wf.K_BOUNCES), ("k16", wf.TAIL_K)):
        st0 = captured[tag]
        reps, ms = 5, 0.0
        for _ in range(reps):
            st = st0.clone()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            wf.wavefront_step(st, *args, k_bounces=k, **kw)
            end.record()
            torch.cuda.synchronize()
            ms += start.elapsed_time(end) / reps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sp = wf.step_plain(st0.clone(), *args, k_bounces=k, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        rad_k = st[wf.COL["rr"]:wf.COL["rb"] + 1].t().cpu().numpy()
        rad_p = sp[wf.COL["rr"]:wf.COL["rb"] + 1].t().cpu().numpy()
        scale = max(float(np.abs(rad_p).max()), 1.0)
        d_mean, psnr, _ = gate(f"wavefront {tag} launch", rad_k / scale, rad_p / scale)
        max_err = float((st - sp).abs().max())
        n_diff = int(((st != sp).any(0)).sum())
        bounces = count_bounces(st0, args[0], args[1], args[2], args[3], k, kw)
        ops = bounces * ops_per_bounce(kw["sizes"])
        nbytes = 2 * 17 * 4 * n_rays + args[2].numel() * 4
        bound_ms = max(ops / PEAK_F32_OPS, nbytes / PEAK_BYTES) * 1e3
        bound_by = "operations" if ops / PEAK_F32_OPS >= nbytes / PEAK_BYTES else "bytes"
        wf_launch[tag] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=max_err,
                              bound_ms=bound_ms, bound_by=bound_by)
        say(f"phase 4 wavefront {tag} launch at the main-path shape (book2 600x600, "
            f"{n_rays} slots): kernel {ms:.4f} ms (mean of {reps}), plain step "
            f"{plain_ms:.1f} ms; state max abs err {max_err:.3g}, slots differing "
            f"{n_diff}; radiance |dmean| {d_mean:.3g}, PSNR {psnr:.2f} dB; {bounces} "
            f"bounces x {ops_per_bounce(kw['sizes'])} f32 ops, {nbytes} B -> bound "
            f"{bound_ms:.4f} ms by {bound_by} ({card})")

    # Wavefront vs v4 on book 2, bitwise, timed in turns (v4, wf, wf, v4).
    args, kw = prepare(book2, 600, 600, 16, 50)
    n_pix = kw.pop("n_pix")
    t_v4, t_wf, imgs = [], [], {}
    for which in ("v4", "wf", "wf", "v4"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if which == "v4":
            out = mk.trace_megakernel_batch(*args, n_pix=n_pix, **kw)
        else:
            out = wf.trace_wavefront_batch(*args, n_rays=n_rays_of(n_pix), **kw)[:n_pix]
        torch.cuda.synchronize()
        (t_v4 if which == "v4" else t_wf).append((time.perf_counter() - t0) * 1e3)
        imgs[which] = out.cpu().numpy()
    n_diff = int((imgs["v4"] != imgs["wf"]).any(-1).sum())
    check(n_diff == 0, f"book2 600x600 16spp depth 50: wavefront differs from v4 in "
                       f"{n_diff} pixels")
    book2_mean16 = float(imgs["v4"].mean() / 16)
    say(f"phase 4 wavefront == v4 bitwise, book2 600x600 16spp depth 50 (mean linear "
        f"radiance {book2_mean16:.4f}): v4 {t_v4[0]:.1f}/{t_v4[1]:.1f} ms, wavefront "
        f"{t_wf[0]:.1f}/{t_wf[1]:.1f} ms ({16 * n_pix / min(t_v4) / 1e3:.2f} vs "
        f"{16 * n_pix / min(t_wf) / 1e3:.2f} Mpaths/s) ({card})")

    # ---- phase 5: main path through the CLI ----------------------------------
    out_png = os.path.join(work, "cornell.png")
    metrics = os.path.join(work, "metrics.jsonl")
    mk.LAUNCHES = wf.LAUNCHES = 0
    rc = app.main([cornell, out_png, "--samples", "64", "--depth", "50",
                   "--device", "cuda", "--metrics", metrics, "--quiet"])
    launches = mk.LAUNCHES
    check(rc == 0, f"app.main exited {rc}")
    check(launches > 0, "the main path launched no kernel")
    check(wf.LAUNCHES == 0, "the Cornell main path launched the wavefront kernel")
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

    # ---- phase 6: the wavefront main path through the CLI ------------------
    out_png = os.path.join(work, "book2.png")
    metrics = os.path.join(work, "metrics_book2.jsonl")
    mk.LAUNCHES = wf.LAUNCHES = wf.SORTS = 0
    rc = app.main([book2, out_png, "--samples", "64", "--depth", "50",
                   "--device", "cuda", "--metrics", metrics, "--quiet"])
    wf_launches, wf_sorts, v4_launches = wf.LAUNCHES, wf.SORTS, mk.LAUNCHES
    check(rc == 0, f"app.main exited {rc}")
    check(wf_launches > 0 and wf_sorts > 0, "the book-2 main path did not run the wavefront")
    check(v4_launches == 0, "the book-2 main path launched the v4 kernel")
    with open(metrics) as f:
        done = [json.loads(line) for line in f][-1]
    check(done["kernel"] == "wavefront_step" and done["launches"] == wf_launches
          and done["sorts"] == wf_sorts, f"done record {done}")
    with open(out_png, "rb") as f:
        png = image.decode_png(f.read())
    check(png.shape == (600, 600, 3), f"PNG shape {png.shape}")
    mean = done["mean_linear"]
    check(np.isfinite(mean) and abs(mean / book2_mean16 - 1.0) < BOOK2_MEAN_RTOL,
          f"book2 mean linear radiance {mean:.4f} vs {book2_mean16:.4f} at 16 spp")
    say(f"phase 6 wavefront main path: app.main book2 600x600 64 spp depth 50, "
        f"{wf_launches} wavefront launches, {wf_sorts} sorts, {v4_launches} v4 launches, "
        f"mean linear radiance {mean:.4f} (16 spp: {book2_mean16:.4f}), "
        f"{done['mpaths_per_s']:.2f} Mpaths/s over {done['elapsed_s']:.3f} s on {card}")
    shutil.rmtree(work)

    # ---- phase 7: the kernels ------------------------------------------------
    main_shape = results[cases[2][0]]
    k2 = wf_launch["k2"]
    say(json.dumps({"kernels": [{
        "name": "megakernel_v4", "route": "cuda",
        "source": "raytrace2_tpu_torch/csrc/megakernel_v4.cu",
        "replaces": "raytrace2_tpu/ops/pallas/megakernel.py:1786 (_render_kernel_v4)",
        "launches": launches,
        "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"], "bound_by": "operations",
        "library_ms": None,
    }, {
        "name": "wavefront_step", "route": "cuda",
        "source": "raytrace2_tpu_torch/csrc/wavefront_step.cu",
        "replaces": "raytrace2_tpu/ops/pallas/wavefront_sorted.py:117 (_bounce_step_kernel)",
        "launches": wf_launches,
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "library_ms": None,
    }]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
