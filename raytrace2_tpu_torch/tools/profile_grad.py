"""Where the gradient kernel's time goes, on the card: the forward, B3's
pre-pass alone, and B3 whole.

    python -m raytrace2_tpu_torch.tools.profile_grad [SCENE.json ...] [--reps 3]
        [--features scene|all]

Port of ``tools/profile_grad.py`` of the JAX package. Without scenes it
profiles its two main-path shapes: Cornell (``make_scene.
cornell_box_original``) at 600², depth 50, 64 spp, sqrt_spp 2 — the JAX
bench's fwd+bwd gradient — and book 2 (``book2_final(0)``) at 64², depth 50,
4 spp, sqrt_spp 2; a scene given on the command line takes ``--res``,
``--spp``, ``--sqrt-spp`` and ``--depth``. For each, CUDA events time

* ``fwd_ms``: the forward the gradient runs (v4, ``trace_megakernel_batch``);
* ``prepass_ms``: B3's pre-pass alone (camera rays, winner search and
  forward carries, its results kept observable), a template instance built
  only for this tool (``csrc/grad_profile.cu``), as JAX's
  ``_grad_kernel(phase="prepass")``;
* ``full_ms``: B3 as the gradient launches it (``megakernel_grad.grad_call``);
* ``full_no_atomics_ms``: the same with the table-cotangent atomics
  compiled out (``csrc/grad_profile.cu``);
* ``full_device_cot_ms``: the same with the table cotangents in device
  memory, where the launch keeps a shared copy (``shared_cot``);

``full - prepass`` is the reverse pass. With them: the mean replayed
bounces per path, the instance's feature mask, and ptxas's registers, stack
and spills of each instance built here, whether its launch keeps the table
cotangents in shared memory, its shared memory per block and resident
threads per SM. ``--features all`` times the
instance that holds every feature instead of the scene's own. One JSON line
per scene, the card's name and power limit first.

Needs a CUDA device; raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile



def _events(fn, reps):
    import torch

    fn()  # warm-up (and first build)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def main_shapes(work: str) -> list:
    """(label, path, res, spp, sqrt_spp, depth) of the two main-path shapes."""
    from raytrace2_tpu_torch.tools import make_scene

    out = []
    for name, build_scene, res, spp in (
            ("cornell", make_scene.cornell_box_original, 600, 64),
            ("book2", lambda: make_scene.book2_final(rng_seed=0), 64, 4)):
        path = os.path.join(work, f"{name}.json")
        with open(path, "w") as f:
            json.dump(build_scene().to_json(), f)
        out.append((name, path, res, spp, 2, 50))
    return out


def profile(path, res, spp, sqrt_spp, depth, reps, features="scene") -> dict:
    """The fwd / prepass / full split of one scene at one shape."""
    import numpy as np
    import torch

    from raytrace2_tpu_torch.ops import camera
    from raytrace2_tpu_torch.ops.kernels import build
    from raytrace2_tpu_torch.ops.kernels import megakernel as mk
    from raytrace2_tpu_torch.ops.kernels import megakernel_grad as mkg
    from raytrace2_tpu_torch.scene import loader, schema

    from raytrace2_tpu_torch.tools.profile_wavefront import require_cuda

    dev = require_cuda()
    host, _ = loader.load_scene(path)
    feats = host.features()
    sizes = tuple(feats["mega_sizes"])
    ds = schema.to_device(host, dev)
    packed = mk.pack_buffer(ds, sizes)
    bg = ds.background.to(torch.float32).contiguous()
    camv = camera.make_camv(host.camera, res, res, 0, spp, sqrt_spp, 0).to(dev)
    n_pix = res * res
    kw = dict(n_pix=n_pix, max_depth=depth, sizes=sizes, has_checker=feats["has_checker"],
              has_noise=feats["has_noise"])
    g = torch.from_numpy(np.random.RandomState(5).uniform(0.0, 1.0, (n_pix, 3))
                         .astype(np.float32)).to(dev)
    mask = mkg.F_ALL if features == "all" else mkg.grad_features(
        packed, sizes, feats["has_checker"], feats["has_noise"])
    counts = mk.counts(sizes)

    lib = build.load(build.grad_target(mask))
    prof_lib = build.load(build.grad_target(mask, True))
    shared_cot = int(lib.megakernel_grad_smem_bytes(*counts, 1) <= build.MAX_SMEM_BYTES)
    smem = lib.megakernel_grad_smem_bytes(*counts, shared_cot)

    def b3(bounces=None):
        outs = [torch.zeros_like(camv), torch.zeros_like(bg), torch.zeros_like(packed)]
        build.launch_megakernel_grad(
            camv, 0, bg, packed, None, g, *outs, n_pix=n_pix, max_depth=depth, counts=counts,
            checker_depth=int(feats["has_checker"]), has_noise=bool(feats["has_noise"]),
            features=mask, bounces=bounces)
        return outs

    def variant(entry, cot):
        """A launch of the profiling build's ``entry`` with the production
        launch's arguments, the table cotangents in shared memory if
        ``cot``."""
        outs = [torch.zeros_like(camv), torch.zeros_like(bg), torch.zeros_like(packed)]
        err = getattr(prof_lib, entry)(
            dev.index or 0, camv.data_ptr(), 0, bg.data_ptr(), packed.data_ptr(),
            *counts[:8], None, 0, n_pix, depth, int(feats["has_checker"]),
            int(bool(feats["has_noise"])), g.data_ptr(), *(x.data_ptr() for x in outs),
            int(cot), None, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"grad_profile {entry} failed: "
                               f"{prof_lib.megakernel_grad_error_string(err).decode()}")
        return outs

    _, fwd_ms = _events(lambda: mk.trace_megakernel_batch(camv, 0, packed, bg, **kw), reps)
    _, prepass_ms = _events(lambda: variant("megakernel_grad_prepass_launch", shared_cot),
                            reps)
    _, full_ms = _events(b3, reps)
    _, no_atomics_ms = _events(
        lambda: variant("megakernel_grad_no_atomics_launch", shared_cot), reps)
    _, device_cot_ms = _events(lambda: variant("megakernel_grad_launch", False), reps)
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    b3(count)
    torch.cuda.synchronize()
    usage = {}
    for prepass in (False, True):
        key = build.target_key(build.grad_target(mask, prepass))
        usage[key] = [u for u in build.ptxas_usage(key) if "megakernel_grad" in u["kernel"]]
    return {"scene": os.path.basename(path), "res": res, "spp": spp, "sqrt_spp": sqrt_spp,
            "depth": depth, "features": mask, "fwd_ms": fwd_ms, "prepass_ms": prepass_ms,
            "full_ms": full_ms, "reverse_ms": full_ms - prepass_ms,
            "full_no_atomics_ms": no_atomics_ms, "full_device_cot_ms": device_cot_ms,
            "replayed_bounces": int(count), "bounces_per_path": int(count) / (n_pix * spp),
            "shared_cot": shared_cot, "smem_bytes": smem,
            "threads_per_sm": lib.megakernel_grad_threads_per_sm(smem),
            "ptxas": usage}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("scenes", nargs="*", help="scene JSONs (default: the two main-path shapes)")
    p.add_argument("--res", type=int, default=600)
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--sqrt-spp", type=int, default=2)
    p.add_argument("--depth", type=int, default=50)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--features", choices=("scene", "all"), default="scene",
                   help="the scene's own instance, or the one holding every feature")
    args = p.parse_args(argv)
    from raytrace2_tpu_torch.tools.profile_wavefront import card_line, require_cuda

    require_cuda()
    print(card_line(), flush=True)
    with tempfile.TemporaryDirectory() as work:
        shapes = [(os.path.basename(s), s, args.res, args.spp, args.sqrt_spp, args.depth)
                  for s in args.scenes] or main_shapes(work)
        for _, path, res, spp, sqrt_spp, depth in shapes:
            print(json.dumps(profile(path, res, spp, sqrt_spp, depth, args.reps,
                                     args.features)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
