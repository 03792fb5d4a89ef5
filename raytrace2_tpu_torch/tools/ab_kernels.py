"""Time the port's kernels from two package trees in turns, on one card.

    python -m raytrace2_tpu_torch.tools.ab_kernels ROOT_A ROOT_B
        [--what grad fwd v4 wf v3 b5 pallas]
        [--cli-spp 64] [--sweeps MODE_A MODE_B]

Each ROOT is a directory that holds a ``raytrace2_tpu_torch`` package: a
checkout, a ``git archive`` of another commit, or a copy with one change.
The trees run in turns A, B, B, A, each in a process of its own that builds
its kernels into its own ``_build/``, so two versions are compared inside
one call on one card. ``--sweeps`` runs A's processes with
``RT2_SWEEP_MODE=MODE_A`` and B's with ``MODE_B`` (default hier for both):
``. . --sweeps hier bvh`` times the cluster skip against the threaded-BVH
sweep in one tree. One JSON line per run:

* ``grad``: the gradient kernel (B3) at Cornell 600², depth 50, 64 spp,
  sqrt_spp 2, and book 2 64², depth 50, 4 spp, CUDA events over 3
  launches after a warm-up, with the sums of its outputs and the ptxas
  lines of each instance built;
* ``fwd``: the v4 kernel at Cornell 600², depth 50, 6 spp (20 launches),
  the Cornell gradient main path (``grad.value_and_grad_scene``, 600²,
  depth 50, 64 spp, sqrt_spp 2, loss = the mean; 3 gradients after a
  warm-up, host clock), and the CLI main paths' Mpaths/s (``app.main
  --metrics``, ``--cli-spp`` samples, 64 by default, depth 50; Cornell 5
  runs, book 2 2 runs, in one
  process; above 64 spp Cornell only, as book 2 takes a second per 64);
* ``v4``: the v4 kernel alone, built alone, with its ptxas register line:
  Cornell 600², depth 50, 6 spp (20 launches), and where the tree has the
  block-tiled layout, book 2 600², depth 50, 16 spp on it with wave_frac
  0.5 (5 launches);
* ``wf``: the wavefront step and B4 alone, built alone, with their ptxas
  register lines: one book-2 600² batch of 6 spp, depth 50, through the
  wavefront (3 batches); the step's fifth launch (K=2) and its first K=16
  launch of that batch, each on the state the batch gave it (5 launches
  each); and one B4 pass of Cornell 600² camera rays, depth 50,
  ``min_alive`` 8 (5 passes);
* ``v3``: B4 alone, with its ptxas register lines: one pass of Cornell
  600² camera rays, depth 50, ``min_alive`` 8 (20 passes), the whole
  two-pass trace of those rays with compaction (``trace_megakernel``,
  10 runs), and one pass of book-2 600² camera rays (5 passes);
* ``b5``: the fused closest hit B5 alone, at the launches of the
  ``pallas`` route that ``chip_smoke.py`` holds against the plain version
  (``b5_launches``): the first and fourth launches of the first
  16,384-ray chunk of book 2 600², and the first of a 65,536-ray Cornell
  chunk, and on each the first launch after each of the route's two
  compactions (2,048 and 256 rays; 8,192 and 1,024) (20 launches each),
  with sums of its outputs (equal in both trees:
  the kernel is bitwise its plain version) and its ptxas lines;
* ``pallas``: the non-kernel main paths through B5, ``app.main --backend
  pallas`` at 600², depth 50: Cornell at 4 spp (2 runs) and book 2 at
  1 spp (1 run), Mpaths/s, wall seconds, B5 launches and mean radiance,
  after a 64² Cornell warm-up.

Where a tree's wrappers take the scene's material types (``mat_types``),
they are read once before the timed launches, as the renderer does. Kernel
times are CUDA events around back-to-back launches queued behind a short
device-side spin, so that the host's pace does not enter them.

Needs a CUDA device; the scenes come from the port's ``make_scene``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PIX = 600 * 600


def _scenes(work):
    from raytrace2_tpu_torch.tools import make_scene

    paths = {}
    for name, build in (("cornell", make_scene.cornell_box_original),
                        ("book2", lambda: make_scene.book2_final(rng_seed=0))):
        paths[name] = os.path.join(work, f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(build().to_json(), f)
    return paths


def _prepare(path, spp, sqrt_spp, dev, size=600):
    from raytrace2_tpu_torch.ops import camera
    from raytrace2_tpu_torch.ops.kernels import megakernel as mk
    from raytrace2_tpu_torch.scene import loader, schema

    host, _ = loader.load_scene(path)
    feats = host.features()
    sizes = tuple(feats["mega_sizes"])
    scene = schema.to_device(host, dev)
    camv = camera.make_camv(host.camera, size, size, 0, spp, sqrt_spp, 0).to(dev)
    kw = dict(n_pix=size * size, max_depth=50, sizes=sizes, has_checker=feats["has_checker"],
              has_noise=feats["has_noise"])
    _with_mat_types(kw, mk.trace_megakernel_batch, scene)
    return (camv, 0, mk.pack_buffer(scene, sizes), scene.background), kw


def _with_mat_types(kw, fn, scene):
    """Add the scene's material types to ``kw`` where ``fn`` takes them."""
    import inspect

    from raytrace2_tpu_torch.ops.kernels import megakernel as mk

    if "mat_types" in inspect.signature(fn).parameters:
        kw["mat_types"] = mk.scene_material_types(scene.materials.mtype)


# GPU cycles the stream spins before a timed window (about 25 ms): the host
# queues the window's launches meanwhile, so the events bracket back-to-back
# kernels and not the host's pace (which set a 0.3-ms B4 pass's time before).
QUEUE_AHEAD_CYCLES = 50_000_000


def _events(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def _run_grad(paths, dev):
    import numpy as np
    import torch

    from raytrace2_tpu_torch.ops.kernels import build
    from raytrace2_tpu_torch.ops.kernels import megakernel_grad as mkg

    out = {}
    for name, spp, size in (("cornell", 64, 600), ("book2", 4, 64)):
        g = torch.from_numpy(np.random.RandomState(5).uniform(0, 1, (size * size, 3))
                             .astype(np.float32)).to(dev)
        args, kw = _prepare(paths[name], spp, 2, dev, size)
        kw.pop("mat_types", None)  # as the parent's B3 is timed: the mask read per launch
        res, out[f"b3_{name}_ms"] = _events(lambda: mkg.grad_call(*args, g, **kw), 3)
        out[f"b3_{name}_sums"] = [float(res[1].sum()), float(res[2].abs().sum())]
    out["ptxas"] = [f"{key}: {line.strip()}" for key, log in build.BUILD_LOGS.items()
                    if "grad" in key for line in log.splitlines()
                    if "registers" in line or "stack frame" in line]
    return out


def _run_fwd(paths, dev, cli_spp):
    import time

    import torch

    from raytrace2_tpu_torch import app, grad
    from raytrace2_tpu_torch.ops.kernels import megakernel as mk
    from raytrace2_tpu_torch.scene import loader, schema

    args, kw = _prepare(paths["cornell"], 6, 2, dev)
    _, v4_ms = _events(lambda: mk.trace_megakernel_batch(*args, **kw), 20)
    out = {"v4_cornell_ms": v4_ms}
    host, _ = loader.load_scene(paths["cornell"])
    feats, scene = host.features(), schema.to_device(host, dev)
    gkw = dict(width=600, height=600, n_samples=64, max_depth=50, sqrt_spp=2)
    grad.value_and_grad_scene(torch.mean, scene, feats, 0, **gkw)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        grad.value_and_grad_scene(torch.mean, scene, feats, 0, **gkw)
    torch.cuda.synchronize()
    out["grad_cornell_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    for name, reps in (("cornell", 5), ("book2", 2))[:1 if cli_spp > 64 else 2]:
        metrics = os.path.join(os.path.dirname(paths[name]), f"{name}.jsonl")
        runs = []
        for _ in range(reps):
            with contextlib.redirect_stdout(io.StringIO()):
                app.main([paths[name], os.path.join(os.path.dirname(metrics), f"{name}.png"),
                          "--samples", str(cli_spp), "--depth", "50", "--device", "cuda",
                          "--metrics", metrics, "--quiet"])
            with open(metrics) as f:
                runs.append(json.loads(f.read().splitlines()[-1])["mpaths_per_s"])
        out[f"cli_{name}_mpaths"] = runs
    out["ptxas"] = _ptxas("intersect_kernel")
    return out


def _run_v4(paths, dev):
    import inspect

    from raytrace2_tpu_torch.ops import camera
    from raytrace2_tpu_torch.ops.kernels import megakernel as mk
    from raytrace2_tpu_torch.scene import loader

    args, kw = _prepare(paths["cornell"], 6, 2, dev)
    _, ms = _events(lambda: mk.trace_megakernel_batch(*args, **kw), 20)
    out = {"v4_cornell_ms": ms}
    if "block" in inspect.signature(mk.trace_megakernel_batch).parameters:
        args, kw = _prepare(paths["book2"], 16, 4, dev)
        host, _ = loader.load_scene(paths["book2"])
        camv = camera.make_camv(host.camera, 600, 600, 0, 16, 4, 0, block=mk.BLOCK).to(dev)
        kw["n_pix"] = mk.pixel_slots(600, 600, block=True)[0]
        _, out["v4_book2_block_ms"] = _events(lambda: mk.trace_megakernel_batch(
            camv, *args[1:], block=True, wave_frac=0.5, **kw), 5)
    out["ptxas"] = _ptxas("megakernel_v4")
    return out


def _ptxas(prefix):
    """ptxas's register and spill lines of every library built whose key
    starts with ``prefix``."""
    from raytrace2_tpu_torch.ops.kernels import build

    return [f"{key}: {line.strip()}" for key, log in build.BUILD_LOGS.items()
            if key.startswith(prefix) for line in log.splitlines()
            if "registers" in line or "spill" in line]


def _b4_inputs(path, dev, size=600):
    """((o, d, time) padded to the tile, seed_lane, packed, background,
    keywords) of B4 over the camera rays of a size² image at sample 0."""
    import torch

    from raytrace2_tpu_torch.ops import camera, integrator, rng
    from raytrace2_tpu_torch.ops.kernels import megakernel as mk
    from raytrace2_tpu_torch.ops.kernels import megakernel_v3 as mk3
    from raytrace2_tpu_torch.scene import loader, schema

    host, _ = loader.load_scene(path)
    feats = host.features()
    sizes = tuple(feats["mega_sizes"])
    ds = schema.to_device(host, dev)
    seed_lane = integrator.mega_seed_of(0, 0)
    pix = torch.arange(size * size, dtype=torch.int32, device=dev)
    u = rng.murmur_uniforms(seed_lane, pix, tuple(rng.CAMERA_CTR_BASE + k for k in range(5)))
    o, d, tm = camera.generate_rays(ds.camera, size, size, 0, 4, None, uniforms=u)
    pad = -size * size % mk3.TILE_R
    rays = (torch.nn.functional.pad(o, (0, 0, 0, pad)),
            torch.nn.functional.pad(d, (0, 0, 0, pad), value=1.0),
            torch.nn.functional.pad(tm, (0, pad)))
    kw = dict(max_depth=50, sizes=sizes, has_checker=feats["has_checker"],
              has_noise=feats["has_noise"])
    _with_mat_types(kw, mk3.megakernel_pass, ds)
    return rays, seed_lane, mk.pack_buffer(ds, sizes), ds.background.to(torch.float32), kw


def b5_launches(path, dev, size, chunk, picks):
    """(device scene, [(pick, args, kwargs)], {rays: launches}): the
    arguments of B5's launches ``picks`` while the ``pallas`` route
    (``Renderer(backend="pallas")``'s scene and features) traces the first
    ``chunk`` camera rays of a size² image at sample 0 through its own
    bounce loop, B5's wrapper wrapped to keep what it is given, and how many
    launches the chunk made at each ray count. A pick is a launch number,
    or ``"c<k>"``: the first launch after the k-th compaction (the k-th
    change of the ray count). It calls only what every tree of the port
    has, so that both trees of a run capture their own."""
    import torch

    from raytrace2_tpu_torch.ops import camera, integrator, rng
    from raytrace2_tpu_torch.ops.kernels import intersect_kernel as pk
    from raytrace2_tpu_torch.render import Renderer
    from raytrace2_tpu_torch.scene import loader

    host, _ = loader.load_scene(path)
    r = Renderer(host, size, size, backend="pallas", device=dev)
    pix = torch.arange(chunk, dtype=torch.int32, device=dev)
    keys = rng.pixel_sample_key(0, pix, 0)
    o, d, tm = camera.generate_rays(r.scene.camera, size, size, 0, 1, keys, pixel_ids=pix)
    seen, widths, orig = {}, {}, pk.closest_hit

    def keep(*a, **k):
        i, n = sum(widths.values()), a[0].shape[0]
        if widths and n not in widths:
            i = f"c{len(widths)}"
        widths[n] = widths.get(n, 0) + 1
        if i in picks:
            seen[i] = (tuple(x.clone() for x in a), dict(k))
        return orig(*a, **k)

    pk.closest_hit = keep
    try:
        integrator.trace_rays(r.scene, r._features, o, d, tm, keys, 50)
    finally:
        pk.closest_hit = orig
    if r.device.type == "cuda":
        torch.cuda.synchronize()
    return r.scene, [(i, *seen[i]) for i in picks], widths


# B5's launches at the pallas route's chunk sizes (render.py CHUNK_SIZE,
# CHUNK_SIZE_LARGE above 1,024 records) and after each of its two
# compactions (integrator.trace_rays, ratio 8): (scene, chunk, picks).
B5_CASES = (("book2", 16384, (0, 3, "c1", "c2")), ("cornell", 65536, (0, "c1", "c2")))


def _run_b5(paths, dev):
    from raytrace2_tpu_torch.ops.kernels import intersect_kernel as pk

    out = {}
    for name, chunk, picks in B5_CASES:
        _, launches, _ = b5_launches(paths[name], dev, 600, chunk, picks)
        for i, a, k in launches:
            (t, c), out[f"b5_{name}_{i}_ms"] = _events(lambda: pk.closest_hit(*a, **k), 20)
            out[f"b5_{name}_{i}_sums"] = [float(t[c >= 0].double().sum()),
                                          int(c.long().sum())]
    out["ptxas"] = _ptxas("intersect_kernel")
    return out


def _run_pallas(paths, dev):
    from raytrace2_tpu_torch import app
    from raytrace2_tpu_torch.ops.kernels import intersect_kernel as pk

    work = os.path.dirname(paths["cornell"])
    out = {}
    for name, spp, reps, size in (("cornell", 1, 1, 64), ("cornell", 4, 2, 600),
                                  ("book2", 1, 1, 600)):
        metrics = os.path.join(work, f"{name}_pallas.jsonl")
        runs = []
        for _ in range(reps):
            pk.LAUNCHES = 0
            with contextlib.redirect_stdout(io.StringIO()):
                rc = app.main([paths[name], os.path.join(work, f"{name}_pallas.png"),
                               "--samples", str(spp), "--depth", "50", "--width", str(size),
                               "--height", str(size), "--device", "cuda", "--backend",
                               "pallas", "--metrics", metrics, "--quiet"])
            if rc:
                raise RuntimeError(f"app.main {name} --backend pallas exited {rc}")
            with open(metrics) as f:
                done = json.loads(f.read().splitlines()[-1])
            runs.append({k: done[k] for k in ("mpaths_per_s", "elapsed_s", "mean_linear")}
                        | {"b5_launches": pk.LAUNCHES})
        if size == 600:
            out[f"pallas_{name}_{spp}spp"] = runs
    return out


def _run_v3(paths, dev):
    from raytrace2_tpu_torch.ops.kernels import megakernel_v3 as mk3

    out = {}
    for name, reps in (("cornell", 20), ("book2", 5)):
        rays, seed_lane, packed, bg, kw = _b4_inputs(paths[name], dev)
        state, rid = mk3.init_state(*rays)
        _, out[f"b4_{name}_pass_ms"] = _events(lambda: mk3.megakernel_pass(
            state, rid, seed_lane, mk3.TILE_R // 16, packed, bg, **kw), reps)
        if name == "cornell":
            res, out["b4_cornell_trace_ms"] = _events(lambda: mk3.trace_megakernel(
                *rays, seed_lane, packed, bg, phases=2, compaction_ratio=16, **kw), 10)
            out["b4_cornell_trace_mean"] = float(res.mean())
    out["ptxas"] = _ptxas("megakernel_v3")
    return out


def _run_wf(paths, dev):
    from raytrace2_tpu_torch.ops.kernels import megakernel_v3 as mk3
    from raytrace2_tpu_torch.ops.kernels import wavefront as wf

    args, kw = _prepare(paths["book2"], 6, 2, dev)
    kw.pop("n_pix")
    kw.pop("mat_types", None)
    n_rays = -(-PIX // 128) * 128
    _, ms = _events(lambda: wf.trace_wavefront_batch(*args, n_rays=n_rays, **kw), 3)
    captured = {}

    def capture(state, *a, k_bounces, **k):
        captured["n"] = captured.get("n", 0) + 1
        tag = f"k{k_bounces}"
        if tag not in captured and (k_bounces != wf.K_BOUNCES or captured["n"] == 5):
            captured[tag] = state.clone()
        return wf.wavefront_step(state, *a, k_bounces=k_bounces, **k)

    wf.trace_wavefront_batch(*args, n_rays=n_rays, step=capture, **kw)
    launch_ms = {}
    for tag, k in (("k2", wf.K_BOUNCES), ("k16", wf.TAIL_K)):
        states = [captured[tag].clone() for _ in range(6)]
        it = iter(states)
        _, launch_ms[tag] = _events(lambda: wf.wavefront_step(next(it), *args, k_bounces=k,
                                                              **kw), 5)
    rays, seed_lane, packed, bg, b4_kw = _b4_inputs(paths["cornell"], dev)
    state, rid = mk3.init_state(*rays)
    _, b4_ms = _events(lambda: mk3.megakernel_pass(
        state, rid, seed_lane, mk3.TILE_R // 16, packed, bg, **b4_kw), 5)
    return {"wf_book2_batch_ms": ms, "wf_k2_launch_ms": launch_ms["k2"],
            "wf_k16_launch_ms": launch_ms["k16"], "b4_cornell_pass_ms": b4_ms,
            "ptxas": _ptxas("wavefront_step") + _ptxas("megakernel_v3")}


def _child(root, what, cli_spp):
    sys.path.insert(0, root)
    import torch

    import raytrace2_tpu_torch
    from raytrace2_tpu_torch.ops.kernels import build

    if not raytrace2_tpu_torch.__file__.startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {raytrace2_tpu_torch.__file__}, not the tree at {root}")
    if what == "fwd":
        # Kept out of the timed CLI runs: the wavefront's first build (v4's
        # and B3's instances are built by the first timed calls' warm-ups).
        build.build_all((getattr(build, "step_target", lambda: "wavefront_step")(),
                         "intersect_kernel"))
    dev = torch.device("cuda")
    run = {"grad": _run_grad, "fwd": lambda p, d: _run_fwd(p, d, cli_spp), "v4": _run_v4,
           "wf": _run_wf, "v3": _run_v3, "b5": _run_b5, "pallas": _run_pallas}[what]
    with tempfile.TemporaryDirectory() as work:
        paths = _scenes(work)
        out = {"root": root, "what": what}
        out.update(run(paths, dev))
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("roots", nargs=2, help="two directories holding a raytrace2_tpu_torch")
    p.add_argument("--what", nargs="+", default=["grad", "fwd"],
                   choices=["grad", "fwd", "v4", "wf", "v3", "b5", "pallas"])
    p.add_argument("--cli-spp", type=int, default=64, help="samples of each CLI render")
    p.add_argument("--sweeps", nargs=2, default=["hier", "hier"], choices=["hier", "bvh"],
                   help="RT2_SWEEP_MODE of A's and of B's runs")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("ab_kernels: needs a CUDA device", file=sys.stderr)
        return 1
    if args.child:
        _child(args.roots[0], args.what[0], args.cli_spp)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    a, b = ((os.path.abspath(r), m) for r, m in zip(args.roots, args.sweeps))
    for what in args.what:
        for root, sweep in (a, b, b, a):
            # Run as a script, so that the child imports the package from root.
            r = subprocess.run([sys.executable, os.path.abspath(__file__), root, root,
                                "--what", what, "--cli-spp", str(args.cli_spp), "--child"],
                               cwd=REPO, env=dict(os.environ, RT2_SWEEP_MODE=sweep),
                               capture_output=True, text=True, timeout=900)
            if r.returncode:
                print(r.stdout[-2000:], r.stderr[-4000:], file=sys.stderr)
                return r.returncode
            line = json.loads(r.stdout.strip().splitlines()[-1])
            print(json.dumps(dict(line, sweep=sweep)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
