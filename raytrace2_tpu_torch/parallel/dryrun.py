"""The multi-device surface, run once at tiny shapes (the port's analog of
``__graft_entry__.dryrun_multichip``).

    python -m raytrace2_tpu_torch.parallel.dryrun --nproc 4 --device cpu
    torchrun --nproc_per_node 4 -m raytrace2_tpu_torch.parallel.dryrun --device cuda

Without torchrun's variables the module spawns ``--nproc`` ranks itself
(``torch.multiprocessing``, a ``file://`` rendezvous in a temporary
directory); under torchrun each process is one rank. At two mesh shapes
(sp x dp, and dp only) every rank runs ``train_step_analog``,
``render_grad_sharded`` and ``render_samples_sharded_mega``, and at the first
shape ``grad_sharded_auto``, and checks that each result is finite and that
the kernel route's gradient is not all zero. Rank 0 prints one line per
shape.

The backend is ``nccl`` for ``--device cuda`` (one card per rank) and
``gloo`` for ``--device cpu`` unless ``--backend`` names it; two ranks on one
card need ``--backend gloo``, since NCCL refuses them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

from raytrace2_tpu_torch.parallel import distributed

# A small closed box: five walls, a ceiling light and two spheres (one of
# them glass), so that paths bounce, escape through the open front and hit
# the light; every kernel family but boxes and media.
SCENE = {
    "background_color": [0.1, 0.1, 0.15],
    "camera": {"fov": 40, "center": [0, 1, 5], "look_at": [0, 1, 0]},
    "materials": [
        {"type": "lambertian", "albedo": [0.73, 0.73, 0.73]},
        {"type": "lambertian", "albedo": [0.65, 0.05, 0.05]},
        {"type": "lambertian", "albedo": [0.12, 0.45, 0.15]},
        {"type": "diffuse_light", "albedo": [8, 8, 8]},
        {"type": "dielectric", "refraction_index": 1.5},
    ],
    "primitives": [
        {"type": "quad", "q": [-2, 0, -2], "u": [4, 0, 0], "v": [0, 0, 4], "material": 0},
        {"type": "quad", "q": [-2, 2.5, -2], "u": [4, 0, 0], "v": [0, 0, 4], "material": 0},
        {"type": "quad", "q": [-2, 0, -2], "u": [4, 0, 0], "v": [0, 2.5, 0], "material": 0},
        {"type": "quad", "q": [-2, 0, -2], "u": [0, 0, 4], "v": [0, 2.5, 0], "material": 1},
        {"type": "quad", "q": [2, 0, -2], "u": [0, 0, 4], "v": [0, 2.5, 0], "material": 2},
        {"type": "quad", "q": [-0.5, 2.49, -0.5], "u": [1, 0, 0], "v": [0, 0, 1],
         "material": 3},
        {"type": "sphere", "center": [-0.6, 0.5, -0.4], "radius": 0.5, "material": 0},
        {"type": "sphere", "center": [0.7, 0.5, 0.3], "radius": 0.5, "material": 4},
    ],
}


def _rank_main(rank, fn, nproc, backend, init_dir, args, timeout_s):
    distributed.initialize(backend, init_method=f"file://{init_dir}/rdzv", world_size=nproc,
                           rank=rank, timeout_s=timeout_s)
    try:
        torch.save(fn(*args), os.path.join(init_dir, f"rank{rank}.pt"))
    finally:
        distributed.shutdown()


def run_ranks(fn, nproc: int, *, backend: str, args=(), timeout_s: float = 120.0) -> list:
    """Spawn ``nproc`` ranks, each in a process group over a ``file://``
    rendezvous of its own, run ``fn(*args)`` (a module-level function) on
    each and return their results in rank order. A collective that waits
    longer than ``timeout_s`` fails its rank; the whole run is killed after
    ``4 * timeout_s`` seconds."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="rt2_ranks_") as init_dir:
        ctx = mp.spawn(_rank_main, args=(fn, nproc, backend, init_dir, args, timeout_s),
                       nprocs=nproc, join=False)
        deadline = time.monotonic() + 4 * timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{nproc} ranks did not finish in {4 * timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(os.path.join(init_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(nproc)]


def _floats(tree) -> list:
    from raytrace2_tpu_torch.scene import schema

    out = []
    schema.map_leaves(tree, lambda x: out.append(x))
    return out


def dryrun(device="cuda") -> list:
    """This rank's part of the dry run (module doc); returns one summary
    dict per mesh shape."""
    from raytrace2_tpu_torch import render as render_mod
    from raytrace2_tpu_torch.parallel import sharding
    from raytrace2_tpu_torch.scene import loader, schema

    n = distributed.global_device_count()
    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))  # a share of the cores each
    with tempfile.TemporaryDirectory(prefix="rt2_dryrun_") as tmp:
        path = os.path.join(tmp, "box.json")
        with open(path, "w") as f:
            json.dump(SCENE, f)
        host, _ = loader.load_scene(path)
    features = dict(host.features(), use_megakernel=True)
    width = height = 16
    sp0 = 2 if n % 2 == 0 and n >= 2 else 1
    shapes = [(sp0, None)] + ([(1, None)] if sp0 != 1 else [])
    out = []
    for sp, dp in shapes:
        mesh = sharding.make_mesh(sp=sp, dp=dp, device=device)
        scene = schema.to_device(host, mesh.device)
        state = sharding.train_step_analog(
            scene, features, render_mod.init_state(width, height, mesh.device), 0,
            width=width, height=height, max_depth=4, sqrt_spp=1, samples_per_device=1,
            mesh=mesh)
        assert tuple(state.accum.shape) == (height, width, 3)
        assert bool(torch.isfinite(state.accum).all()) and state.frame_idx == sp
        target = torch.zeros((height, width, 3), device=mesh.device)
        loss, g = sharding.render_grad_sharded(
            scene, features, target, 0, width=width, height=height, max_depth=3, sqrt_spp=1,
            n_samples=1, mesh=mesh)
        assert bool(torch.isfinite(loss)) and all(bool(torch.isfinite(x).all())
                                                  for x in _floats(g))
        r = sharding.render_samples_sharded_mega(
            scene, features, 0, 0, width=width, height=height, max_depth=4, sqrt_spp=1,
            samples_per_device=1, mesh=mesh)
        assert bool(torch.isfinite(r).all())
        row = {"mesh": mesh.shape, "accum_mean": float(state.accum.mean()),
               "scan_loss": float(loss), "mega_mean": float(r.mean() / sp)}
        if (sp, dp) == shapes[0]:
            loss_m, g_m = sharding.grad_sharded_auto(
                scene, features, target, 0, width=width, height=height, max_depth=2,
                sqrt_spp=1, n_samples=sp, mesh=mesh)
            floats = _floats(g_m)
            assert bool(torch.isfinite(loss_m)) and all(bool(torch.isfinite(x).all())
                                                        for x in floats)
            nonzero = sum(int((x != 0).sum()) for x in floats)
            assert nonzero > 0, "the kernel route's gradient is all zero"
            row.update(kernel_loss=float(loss_m), kernel_grad_nonzero=nonzero)
        out.append(row)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m raytrace2_tpu_torch.parallel.dryrun",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--nproc", type=int, default=4,
                   help="ranks to spawn (ignored under torchrun, which sets the world)")
    p.add_argument("--device", default="cuda",
                   help="cuda (each rank its card; default) or cpu")
    p.add_argument("--backend", default=None,
                   help="nccl or gloo (default: nccl for cuda, gloo for cpu)")
    p.add_argument("--timeout", type=float, default=300.0,
                   help="seconds a collective may wait before its rank fails")
    args = p.parse_args(argv)
    backend = args.backend or ("nccl" if torch.device(args.device).type == "cuda" else "gloo")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but torch.cuda.is_available() is false; pass "
              "--device cpu", file=sys.stderr)
        return 1
    if "WORLD_SIZE" in os.environ:  # under torchrun: this process is one rank
        distributed.initialize(backend, timeout_s=args.timeout)
        rank = distributed.process_index()
        try:
            rows = dryrun(args.device)
        finally:
            distributed.shutdown()
        if rank == 0:
            for row in rows:
                print(json.dumps(row))
        return 0
    rows = run_ranks(dryrun, args.nproc, backend=backend, args=(args.device,),
                     timeout_s=args.timeout)[0]
    for row in rows:
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
