"""The port's bench: Cornell box progressive throughput on the card (port of
the root ``bench.py``, :65-215).

    python -m raytrace2_tpu_torch.tools.bench [--grad [--grad-depth N]
        [--grad-samples N]] [--device cuda|cpu] [--scene SCENE.json]

Prints ONE JSON line on stdout, with the JAX bench's keys: ``metric``,
``value``, ``unit`` and ``vs_baseline``; heartbeat lines go to stderr.

Workload and calibration are the JAX bench's: the Cornell box at its own
dimensions (600x600), depth 50, stratification grid ``sqrt_spp`` 10,
batches of at most 128 samples per kernel pass; a one-sample warm-up, 4
preliminary samples, then, when those took under 4 s, a measurement of
about 8 s (between 8 and 512 samples). Each batch ends in a host read of
its mean, after ``torch.cuda.synchronize()``. ``metric`` is
``cornell600_paths_per_sec``; ``vs_baseline`` divides by the reference's
1.17e6 paths/s (the JAX bench's measurement of the CPU reference,
``BASELINE.md``).

``--grad``: fwd+bwd throughput of ``grad.value_and_grad_scene`` (the
forward kernel and the indexed-replay backward) with loss = the mean
image, 64 samples per gradient (``--grad-samples``), sqrt_spp 2, depth 50
(``--grad-depth``), timed until the backward's readback; metric
``cornell600_fwdbwd_d{depth}_paths_per_sec``, ``vs_baseline`` against the
reference's forward rate scaled by 50 / depth.

The scene: ``--scene`` (the reference corpus's
``cornell_box_original.json``, which the JAX bench reads) where it is
given, else ``make_scene.cornell_box_original`` (the port's copy of
``tools/make_scene.py``), built in the process; stderr names the scene
taken. The two differ: the built Cornell's light is larger, its mean
linear radiance 0.536 against about 0.159. The device is explicit:
``cuda`` (the default) fails without a card; ``cpu`` runs the kernels'
plain versions. The bench writes no file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# The reference's forward rate on the JAX bench's workload (bench.py:35).
BASELINE_PATHS_PER_SEC = 1.17e6
# The JAX bench's workload (bench.py:87-104, :158-177).
DEPTH, SQRT_SPP, MAX_BATCH = 50, 10, 128
GRAD_SAMPLES, GRAD_SQRT_SPP = 64, 2


def _log(msg: str) -> None:
    print(f"# bench {time.strftime('%H:%M:%S')} {msg}", file=sys.stderr, flush=True)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_scene(path: str | None):
    """(host scene, dims, name): the scene file at ``path``, or
    ``make_scene.cornell_box_original`` built in the process."""
    from raytrace2_tpu_torch.tools import make_scene

    return make_scene.load(path or "cornell_original")


def measure_forward(scene, device, *, width, height, max_depth=DEPTH, sqrt_spp=SQRT_SPP,
                    max_batch=MAX_BATCH, prelim=4, target_s=8.0, max_iters=512,
                    log=_log) -> dict:
    """The forward metric's record: paths/s of progressive samples through
    ``integrator.render_progressive`` on the kernel path (the plain versions
    on a CPU device), after a one-sample warm-up, over ``prelim`` samples
    and, when those took under ``target_s / 2``, over a calibrated count
    (JAX ``bench.py:96-143``)."""
    from raytrace2_tpu_torch.ops import integrator
    from raytrace2_tpu_torch.scene import schema

    features = dict(scene.features(), use_megakernel=True)
    dev_scene = schema.to_device(scene, device)
    packed = integrator.pack_scene(dev_scene, features)

    def timed(s0, n):
        _sync(device)
        t0 = time.perf_counter()
        done = 0
        while done < n:
            step = min(max_batch, n - done)
            val = float(integrator.render_progressive(
                dev_scene, features, width, height, s0 + done, step, 0, max_depth, sqrt_spp,
                packed=packed).mean())
            if not 0.0 < val < 100.0 * step:
                raise RuntimeError(f"batch mean radiance sum {val}: no render happened")
            done += step
        return time.perf_counter() - t0

    log("warm-up start")
    t_w = time.perf_counter()
    timed(0, 1)
    log(f"warm-up done in {time.perf_counter() - t_w:.1f} s; calibrating")
    iters = prelim
    dt = timed(1, iters)
    log(f"prelim: {iters * width * height / dt / 1e6:.1f} Mpaths/s ({iters} spp in {dt:.2f} s)")
    if dt < target_s / 2:
        iters = min(max(int(iters * target_s / dt), 8), max_iters)
        dt = timed(1 + prelim, iters)
    paths_per_sec = iters * width * height / dt
    log(f"{iters} spp in {dt:.3f} s")
    return {"metric": "cornell600_paths_per_sec", "value": round(paths_per_sec, 1),
            "unit": "paths/s",
            "vs_baseline": round(paths_per_sec / BASELINE_PATHS_PER_SEC, 3)}


def measure_grad(scene, device, *, width, height, max_depth=DEPTH, n_samples=GRAD_SAMPLES,
                 sqrt_spp=GRAD_SQRT_SPP, prelim=2, target_s=8.0, max_iters=256,
                 log=_log) -> dict:
    """The ``--grad`` metric's record: paths/s of ``value_and_grad_scene``
    (loss = the mean image), each gradient read back to the host (the loss
    and the albedo gradient's sum), after one warm-up gradient, over
    ``prelim`` gradients and, when those took under ``target_s / 2``, over a
    calibrated count (JAX ``bench.py:146-215``)."""
    import torch

    from raytrace2_tpu_torch import grad as grad_mod
    from raytrace2_tpu_torch.scene import schema

    features = scene.features()
    dev_scene = schema.to_device(scene, device)

    def timed(iters):
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            loss, g = grad_mod.value_and_grad_scene(
                torch.mean, dev_scene, features, 0, width=width, height=height,
                n_samples=n_samples, max_depth=max_depth, sqrt_spp=sqrt_spp)
            if not 0.0 < float(loss) < 100.0:
                raise RuntimeError(f"loss {float(loss)}: no render happened")
            float(g.materials.albedo.sum())  # the backward's readback
        return time.perf_counter() - t0

    log("grad warm-up start")
    t_w = time.perf_counter()
    timed(1)
    log(f"grad warm-up done in {time.perf_counter() - t_w:.1f} s")
    iters = prelim
    dt = timed(iters)
    log(f"prelim: {iters * n_samples * width * height / dt / 1e6:.1f} Mpaths/s fwd+bwd")
    if dt < target_s / 2:
        iters = min(max(int(iters * target_s / dt), 4), max_iters)
        dt = timed(iters)
    paths_per_sec = iters * n_samples * width * height / dt
    log(f"{iters} gradients of {n_samples} spp in {dt:.3f} s")
    return {"metric": f"cornell600_fwdbwd_d{max_depth}_paths_per_sec",
            "value": round(paths_per_sec, 1), "unit": "paths/s",
            "vs_baseline": round(paths_per_sec
                                 / (BASELINE_PATHS_PER_SEC * 50 / max_depth), 3)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--grad", action="store_true",
                   help="fwd+bwd throughput of the differentiable render")
    p.add_argument("--grad-depth", type=int, default=DEPTH)
    p.add_argument("--grad-samples", type=int, default=GRAD_SAMPLES,
                   help="samples per gradient")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--scene", default=None,
                   help="scene JSON (default: make_scene's cornell_box_original)")
    args = p.parse_args(argv)

    import torch

    from raytrace2_tpu_torch.render import resolve_device

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    scene, dims, name = load_scene(args.scene)
    width, height = dims or (600, 600)
    _log(f"scene {name}, {width}x{height}; device "
         f"{torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}, "
         f"torch {torch.__version__}")
    if args.grad:
        rec = measure_grad(scene, device, width=width, height=height,
                           max_depth=args.grad_depth, n_samples=args.grad_samples)
    else:
        rec = measure_forward(scene, device, width=width, height=height)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
