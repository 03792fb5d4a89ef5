"""CLI app shell (port of ``raytrace2_tpu/app.py:59-108, 179-384``).

``python -m raytrace2_tpu_torch <scene.json> [out.png] --device cuda|cpu``:
the same argv, ``local/data/settings.json`` and output naming as the JAX
package's CLI, with its resume (``--checkpoint``, ``--checkpoint-every``:
the accumulator as one ``.npz``, interchangeable with the JAX package's)
and progressive previews (``--preview-every``: the output PNG rewritten
every N samples). The device is explicit: ``cuda`` (the default) renders
through the Hopper kernels and fails when no card is present; ``cpu`` runs
their plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from datetime import datetime

# Flags of the JAX CLI that a later slice of the port brings (the live CLI).
_NOT_PORTED_FLAGS = ("live", "watch", "profile")


def load_app_settings(path: str) -> dict:
    """AppSettings with reference defaults (Serialize.cpp:56-65); silently
    empty on a missing or invalid file (Util.cpp:21-32)."""
    obj = {}
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, json.JSONDecodeError):
        pass
    return {
        "num_samples": int(obj.get("num_samples", 1)),
        "render_once": bool(obj.get("render_once", False)),
        "save_after_render_once": bool(obj.get("save_after_render_once", False)),
        "max_depth": int(obj.get("max_depth", 50)),
        "render_window": bool(obj.get("render_window", True)),
    }


def _resolve_scene(arg: str | None, root: str) -> tuple[str, str]:
    """argv[1] handling (App.cpp:86-100): default scene2, optional .json."""
    if not arg:
        return os.path.join(root, "data", "scene2.json"), "scene2"
    path = arg
    if path.endswith(".json"):
        name = os.path.basename(path)[: -len(".json")]
    else:
        name = os.path.basename(path)
        path += ".json"
    return path, name


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raytrace2-tpu-torch",
        description="Progressive path tracer (PyTorch/CUDA port of raytrace2_tpu).",
    )
    p.add_argument("scene", nargs="?", help="scene JSON path (default data/scene2.json)")
    p.add_argument("output", nargs="?", help="output image path (.png or .ppm)")
    p.add_argument("--root", default=".", help="project root for data/ and local/ dirs")
    p.add_argument("--settings", default=None, help="settings.json path (default local/data/settings.json)")
    p.add_argument("--samples", type=int, default=None, help="override num_samples")
    p.add_argument("--depth", type=int, default=None, help="override max_depth")
    p.add_argument("--width", type=int, default=None, help="override image width")
    p.add_argument("--height", type=int, default=None, help="override image height")
    p.add_argument("--seed", type=int, default=0, help="deterministic render seed")
    p.add_argument("--camera", default=None, metavar="CAM_JSON",
                   help="override the scene camera with a standalone camera JSON "
                        "(the format write_camera emits)")
    p.add_argument("--batch", type=int, default=0,
                   help="samples per kernel launch (0 = auto)")
    p.add_argument("--metrics", default=None, metavar="JSONL",
                   help="append one JSON line of metrics per launch plus a final "
                        "summary record")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "xla", "bvh", "pallas", "mega", "wavefront"],
                   help="auto: the kernel path (the v4 kernel, or the sorted wavefront "
                        "above 256 records) when the scene fits it, else the non-kernel "
                        "path (ellipsoids, more than 4,096 records); mega: the kernel "
                        "path; wavefront: force the sorted wavefront; xla: the non-kernel "
                        "path with the dense closest hit; pallas: the non-kernel path "
                        "with the fused intersect kernel; bvh is not ported yet")
    p.add_argument("--chunk-size", type=int, default=None,
                   help="rays per chunk on the non-kernel path (default 65536, or 16384 "
                        "above 1,024 records)")
    p.add_argument("--device", default="cuda",
                   help="render device: cuda (the Hopper kernels; default) or cpu "
                        "(their plain PyTorch versions)")
    p.add_argument("--preview-every", type=int, default=0,
                   help="write a progressive preview PNG every N samples")
    p.add_argument("--checkpoint", default=None,
                   help="accumulator checkpoint path (resume if it exists)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="checkpoint the accumulator every N samples")
    p.add_argument("--quiet", action="store_true")
    # Accepted so that they can be refused with a clear message.
    p.add_argument("--live", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--watch", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--profile", default=None, help=argparse.SUPPRESS)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    refused = [f"--{name.replace('_', '-')}" for name in _NOT_PORTED_FLAGS
               if getattr(args, name)]
    if refused:
        print(f"error: {', '.join(refused)} not ported yet (ROADMAP queue A item 5)",
              file=sys.stderr)
        return 2

    import torch

    from raytrace2_tpu_torch.io import checkpoint as ckpt_io
    from raytrace2_tpu_torch.io import image as image_io
    from raytrace2_tpu_torch.ops.kernels import intersect_kernel, megakernel, wavefront
    from raytrace2_tpu_torch.render import CHUNK_SIZE, Renderer, resolve_device
    from raytrace2_tpu_torch.scene import loader

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    settings_path = args.settings or os.path.join(args.root, "local", "data", "settings.json")
    settings = load_app_settings(settings_path)
    if args.samples is not None:
        settings["num_samples"] = args.samples
    if args.depth is not None:
        settings["max_depth"] = args.depth
    scene_path, scene_name = _resolve_scene(args.scene, args.root)

    def log(*a):
        if not args.quiet:
            print(*a, flush=True)

    # Startup echo (App.cpp:108-113).
    log(f"Render window: {int(settings['render_window'])}")
    log(f"Render once: {int(settings['render_once'])}")
    log(f"Num Samples: {settings['num_samples']}")
    log(f"Max Depth: {settings['max_depth']}")
    log(f"Scene Path: {scene_path}")

    try:
        scene, dims = loader.load_scene(scene_path, seed=args.seed)
        if args.camera:
            scene = dataclasses.replace(scene, camera=loader.load_camera_file(args.camera))
    except (OSError, loader.SceneError, json.JSONDecodeError) as e:
        print(f"Failed to load scene: {e}", file=sys.stderr)
        return 1

    width, height = dims or (1600, 900)  # initial_dims default (App.cpp:115)
    if args.width:
        width = args.width
        height = args.height or width
    elif args.height:
        height = args.height

    try:
        renderer = Renderer(scene, width, height, num_samples=settings["num_samples"],
                            max_depth=settings["max_depth"], seed=args.seed,
                            backend=args.backend, device=device,
                            chunk_size=args.chunk_size or CHUNK_SIZE)
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    if args.checkpoint and os.path.exists(args.checkpoint):
        try:
            renderer.set_state(ckpt_io.load_state(args.checkpoint, device))
        except (OSError, KeyError, ValueError) as e:
            print(f"error: checkpoint {args.checkpoint}: {e}", file=sys.stderr)
            return 1
        log(f"Resumed from {args.checkpoint} at sample {renderer.frame_idx}")

    out_path = args.output
    if not out_path:
        outdir = os.path.join(args.root, "local", "output")
        os.makedirs(outdir, exist_ok=True)
        stamp = datetime.now().strftime("%Y-%m-%d.%H:%M:%S")
        out_path = os.path.join(outdir, f"{scene_name}_{stamp}.png")

    device_name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu")
    total = settings["num_samples"]
    rays_per_sample = width * height
    batch = args.batch or max(min(total // 10, 64), 1)
    for gate in (args.preview_every, args.checkpoint_every):
        if gate:
            batch = min(batch, gate)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    counters = {"megakernel_v4": megakernel, "wavefront_step": wavefront,
                "intersect_kernel": intersect_kernel}
    module = counters.get(renderer.kernel)
    launches0 = module.LAUNCHES if module else 0
    sorts0 = wavefront.SORTS
    t0 = time.perf_counter()
    done0 = renderer.frame_idx
    while renderer.frame_idx < total:
        renderer.update(min(batch, total - renderer.frame_idx))
        sync()  # the launch is asynchronous; time what the card did
        i = renderer.frame_idx
        dt = time.perf_counter() - t0
        rate = (i - done0) * rays_per_sample / max(dt, 1e-9) / 1e6
        if args.metrics:
            rec = {"event": "dispatch", "sample": i, "total": total,
                   "elapsed_s": round(dt, 4), "mpaths_per_s": round(rate, 4),
                   "width": width, "height": height, "scene": scene_name,
                   "device": device_name}
            if device.type == "cuda":
                rec["device_mem_bytes"] = int(torch.cuda.memory_allocated(device))
            with open(args.metrics, "a") as f:
                f.write(json.dumps(rec) + "\n")
        log(f"sample {i}/{total}  {rate:.2f} Mpaths/s")
        if args.preview_every and i % args.preview_every == 0 and i < total:
            image_io.write_image(renderer.linear_pixels(), out_path)
        if args.checkpoint and args.checkpoint_every and i % args.checkpoint_every == 0:
            ckpt_io.save_state(args.checkpoint, renderer.state)

    lin = renderer.linear_pixels()
    if args.metrics:
        dt = time.perf_counter() - t0
        # The route and its kernel's launches on the card (0 where the plain
        # version ran, on the CPU); the dense route has no kernel.
        kernel = {"route": renderer.route, "kernel": renderer.kernel}
        if module:
            kernel["launches"] = module.LAUNCHES - launches0
        if renderer.kernel == "wavefront_step":
            kernel["sorts"] = wavefront.SORTS - sorts0
        with open(args.metrics, "a") as f:
            f.write(json.dumps({
                "event": "done", "samples": renderer.frame_idx, "total": total,
                **kernel,
                "elapsed_s": round(dt, 4),
                "mpaths_per_s": round((renderer.frame_idx - done0) * rays_per_sample
                                      / max(dt, 1e-9) / 1e6, 4),
                "width": width, "height": height, "scene": scene_name,
                "device": device_name, "mean_linear": float(lin.mean()),
                "output": out_path,
            }) + "\n")
    log(f"Writing image: {out_path}")
    image_io.write_image(lin, out_path)
    if args.checkpoint:
        ckpt_io.save_state(args.checkpoint, renderer.state)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
