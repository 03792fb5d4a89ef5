"""Time the port's kernels from two package trees in turns, on one card.

    python -m raytrace2_tpu_torch.tools.ab_kernels ROOT_A ROOT_B [--what grad fwd]
        [--cli-spp 64]

Each ROOT is a directory that holds a ``raytrace2_tpu_torch`` package: a
checkout, a ``git archive`` of another commit, or a copy with one change.
The trees run in turns A, B, B, A, each in a process of its own that builds
its kernels into its own ``_build/``, so two versions are compared inside
one call on one card. One JSON line per run:

* ``grad``: the gradient kernel (B3) at Cornell 600², depth 50, 64 spp,
  sqrt_spp 2, and book 2 600², depth 50, 4 spp, CUDA events over 3
  launches after a warm-up, with the sums of its outputs;
* ``fwd``: the v4 kernel at Cornell 600², depth 50, 6 spp (20 launches),
  and the CLI main paths' Mpaths/s (``app.main --metrics``, ``--cli-spp``
  samples, 64 by default, depth 50; Cornell 5 runs, book 2 2 runs, in one
  process; above 64 spp Cornell only, as book 2 takes a second per 64).

Needs a CUDA device; the scenes come from this checkout's
``tools/make_scene.py``.
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
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import make_scene

    paths = {}
    for name, build in (("cornell", make_scene.cornell_box_original),
                        ("book2", lambda: make_scene.book2_final(rng_seed=0))):
        paths[name] = os.path.join(work, f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(build().to_json(), f)
    return paths


def _prepare(path, spp, sqrt_spp, dev):
    from raytrace2_tpu_torch.ops import camera
    from raytrace2_tpu_torch.ops.kernels import megakernel as mk
    from raytrace2_tpu_torch.scene import loader, schema

    host, _ = loader.load_scene(path)
    feats = host.features()
    sizes = tuple(feats["mega_sizes"])
    scene = schema.to_device(host, dev)
    camv = camera.make_camv(host.camera, 600, 600, 0, spp, sqrt_spp, 0).to(dev)
    kw = dict(n_pix=PIX, max_depth=50, sizes=sizes, has_checker=feats["has_checker"],
              has_noise=feats["has_noise"])
    return (camv, 0, mk.pack_buffer(scene, sizes), scene.background), kw


def _events(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def _run_grad(paths, dev):
    import numpy as np
    import torch

    from raytrace2_tpu_torch.ops.kernels import megakernel_grad as mkg

    out = {}
    g = torch.from_numpy(np.random.RandomState(5).uniform(0, 1, (PIX, 3))
                         .astype(np.float32)).to(dev)
    for name, spp in (("cornell", 64), ("book2", 4)):
        args, kw = _prepare(paths[name], spp, 2, dev)
        res, out[f"b3_{name}_ms"] = _events(lambda: mkg.grad_call(*args, g, **kw), 3)
        out[f"b3_{name}_sums"] = [float(res[1].sum()), float(res[2].abs().sum())]
    return out


def _run_fwd(paths, dev, cli_spp):
    from raytrace2_tpu_torch import app
    from raytrace2_tpu_torch.ops.kernels import megakernel as mk

    args, kw = _prepare(paths["cornell"], 6, 2, dev)
    _, v4_ms = _events(lambda: mk.trace_megakernel_batch(*args, **kw), 20)
    out = {"v4_cornell_ms": v4_ms}
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
    return out


def _child(root, what, cli_spp):
    sys.path.insert(0, root)
    import torch

    import raytrace2_tpu_torch
    from raytrace2_tpu_torch.ops.kernels import build

    if not raytrace2_tpu_torch.__file__.startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {raytrace2_tpu_torch.__file__}, not the tree at {root}")
    build.build_all()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as work:
        paths = _scenes(work)
        out = {"root": root, "what": what}
        out.update(_run_grad(paths, dev) if what == "grad" else _run_fwd(paths, dev, cli_spp))
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("roots", nargs=2, help="two directories holding a raytrace2_tpu_torch")
    p.add_argument("--what", nargs="+", default=["grad", "fwd"], choices=["grad", "fwd"])
    p.add_argument("--cli-spp", type=int, default=64, help="samples of each CLI render")
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
    a, b = (os.path.abspath(r) for r in args.roots)
    for what in args.what:
        for root in (a, b, b, a):
            # Run as a script, so that the child imports the package from root.
            r = subprocess.run([sys.executable, os.path.abspath(__file__), root, root,
                                "--what", what, "--cli-spp", str(args.cli_spp), "--child"],
                               cwd=REPO,
                               capture_output=True, text=True, timeout=900)
            if r.returncode:
                print(r.stdout[-2000:], r.stderr[-4000:], file=sys.stderr)
                return r.returncode
            print(r.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
