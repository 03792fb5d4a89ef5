"""CLI app shell (port of ``raytrace2_tpu/app.py:59-108, 179-384``).

``python -m raytrace2_tpu_torch <scene.json> [out.png] --device cuda|cpu``:
the same argv, ``local/data/settings.json`` and output naming as the JAX
package's CLI, with its resume (``--checkpoint``, ``--checkpoint-every``:
the accumulator as one ``.npz``, interchangeable with the JAX package's)
and progressive previews (``--preview-every``: the output PNG rewritten
every N samples), and its live surface: ``--live`` (an ANSI preview redrawn
in the terminal after each batch, ``--live-cols`` wide; implies
``--watch``), ``--watch`` (reload the scene and restart the accumulation
when its file changes), single keys on a TTY (q finish, w snapshot, r reset,
c write the camera) and ``--profile DIR`` (a ``torch.profiler`` Chrome trace
of the render loop, the card's kernels included). The device is explicit:
``cuda`` (the default) renders through the Hopper kernels and fails when no
card is present; ``cpu`` runs their plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from datetime import datetime


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
    p.add_argument("--live", action="store_true",
                   help="progressive ANSI preview in the terminal (the headless analog of "
                        "the reference's render window); implies --watch")
    p.add_argument("--watch", action="store_true",
                   help="reload the scene and restart the accumulation when the scene file "
                        "changes mid-render (the reference's load-scene panel, "
                        "App.cpp:210-229)")
    p.add_argument("--live-cols", type=int, default=100,
                   help="columns of the --live preview")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the render loop into DIR")
    p.add_argument("--quiet", action="store_true")
    return p


class _KeyControls:
    """Single keys that steer a running render (JAX ``app._KeyControls``):
    the headless analog of the reference's ImGui panel (App.cpp:210-229).
    Active only when stdin is a TTY; elsewhere ``poll`` returns nothing, so
    piped and CI runs are unaffected.

    Keys: q finish now (write the image and exit), w write a snapshot, r
    reset the accumulation, c write the camera JSON (WriteCamera,
    src/Serialize.cpp:47-54)."""

    def __init__(self, enabled: bool):
        self.active = False
        if not enabled:
            return
        try:
            import termios
            import tty

            self._fd = sys.stdin.fileno()
            if not os.isatty(self._fd):
                return
            self._termios = termios
            self._saved = termios.tcgetattr(self._fd)
            tty.setcbreak(self._fd)
            self.active = True
            # Restore the terminal on any exit (Ctrl-C, a render error);
            # close() is idempotent.
            import atexit

            atexit.register(self.close)
        except (ImportError, OSError, ValueError):
            self.active = False

    def poll(self) -> str:
        """The keys pressed since the last poll ('' if none)."""
        if not self.active:
            return ""
        import select

        keys = []
        while select.select([sys.stdin], [], [], 0)[0]:
            keys.append(sys.stdin.read(1))
        return "".join(keys)

    def close(self) -> None:
        if self.active:
            self._termios.tcsetattr(self._fd, self._termios.TCSADRAIN, self._saved)
            self.active = False


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from raytrace2_tpu_torch.io import checkpoint as ckpt_io
    from raytrace2_tpu_torch.io import image as image_io
    from raytrace2_tpu_torch.io import term
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

    def load():
        scene, dims = loader.load_scene(scene_path, seed=args.seed)
        if args.camera:
            scene = dataclasses.replace(scene, camera=loader.load_camera_file(args.camera))
        return scene, dims

    load_errors = (OSError, loader.SceneError, json.JSONDecodeError)
    try:
        scene, dims = load()
    except load_errors as e:
        print(f"Failed to load scene: {e}", file=sys.stderr)
        return 1

    width, height = dims or (1600, 900)  # initial_dims default (App.cpp:115)
    if args.width:
        width = args.width
        height = args.height or width
    elif args.height:
        height = args.height

    renderer_kw = dict(num_samples=settings["num_samples"], max_depth=settings["max_depth"],
                       seed=args.seed, backend=args.backend, device=device,
                       chunk_size=args.chunk_size or CHUNK_SIZE)
    try:
        renderer = Renderer(scene, width, height, **renderer_kw)
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
    batch = args.batch or max(min(total // 10, 64), 1)
    for gate in (args.preview_every, args.checkpoint_every):
        if gate:
            batch = min(batch, gate)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    counters = {"megakernel_v4": megakernel, "wavefront_step": wavefront,
                "intersect_kernel": intersect_kernel}

    def start():
        """(kernel module, its launches, wavefront sorts, t0, first sample)
        at the start of the current renderer's timed run."""
        module = counters.get(renderer.kernel)
        return (module, module.LAUNCHES if module else 0, wavefront.SORTS,
                time.perf_counter(), renderer.frame_idx)

    watch = args.watch or args.live
    watch_mtime = os.stat(scene_path).st_mtime if watch else None
    keys = _KeyControls(enabled=watch)
    if keys.active:
        log("Keys: [q]uit+save  [w]rite snapshot  [r]eset  [c]amera save")
    profiler = None
    if args.profile:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.__enter__()
    module, launches0, sorts0, t0, done0 = start()
    first_frame = True
    while renderer.frame_idx < total:
        if watch:
            try:
                mtime = os.stat(scene_path).st_mtime
            except OSError:
                mtime = watch_mtime  # mid-swap: retry on the next batch
            if mtime != watch_mtime:
                try:
                    new_scene, new_dims = load()
                    # The edited file's size unless the command line pinned
                    # one: the accumulation restarts either way (the
                    # reference's resize, RayTracer.cpp:87-104).
                    new_w, new_h = ((new_dims or (width, height))
                                    if not (args.width or args.height) else (width, height))
                    new_renderer = Renderer(new_scene, new_w, new_h, **renderer_kw)
                except (*load_errors, NotImplementedError) as e:
                    # A partial write or a bad edit: keep rendering the old
                    # scene; the next change retries.
                    log(f"Scene reload failed (keeping current): {e}")
                else:
                    watch_mtime = mtime
                    renderer, width, height = new_renderer, new_w, new_h
                    module, launches0, sorts0, t0, done0 = start()
                    log(f"Scene reloaded: {scene_path} (accumulation reset)")
        renderer.update(min(batch, total - renderer.frame_idx))
        sync()  # the launch is asynchronous; time what the card did
        i = renderer.frame_idx
        dt = time.perf_counter() - t0
        rate = (i - done0) * width * height / max(dt, 1e-9) / 1e6
        if args.metrics:
            rec = {"event": "dispatch", "sample": i, "total": total,
                   "elapsed_s": round(dt, 4), "mpaths_per_s": round(rate, 4),
                   "width": width, "height": height, "scene": scene_name,
                   "device": device_name}
            if device.type == "cuda":
                rec["device_mem_bytes"] = int(torch.cuda.memory_allocated(device))
            with open(args.metrics, "a") as f:
                f.write(json.dumps(rec) + "\n")
        pressed = keys.poll()
        if "r" in pressed:
            renderer.reset()
            module, launches0, sorts0, t0, done0 = start()
            log("Accumulation reset")
        if "w" in pressed:
            image_io.write_image(renderer.linear_pixels(), out_path)
            log(f"Snapshot written: {out_path}")
        if "c" in pressed:
            cam_path = out_path + ".camera.json"
            loader.write_camera(renderer.scene.camera, cam_path)
            log(f"Camera written: {cam_path}")
        if "q" in pressed:
            log("Quit requested: writing image")
            break
        if args.live:
            term.redraw(renderer.linear_pixels(), args.live_cols, first=first_frame,
                        status=f"sample {i}/{total}  {rate:.2f} Mpaths/s"
                               + ("  [q/w/r/c]" if keys.active else ""))
            first_frame = False
        else:
            log(f"sample {i}/{total}  {rate:.2f} Mpaths/s")
        if args.preview_every and i % args.preview_every == 0 and i < total:
            image_io.write_image(renderer.linear_pixels(), out_path)
        if args.checkpoint and args.checkpoint_every and i % args.checkpoint_every == 0:
            ckpt_io.save_state(args.checkpoint, renderer.state)

    keys.close()
    if profiler is not None:
        sync()
        profiler.__exit__(None, None, None)
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, "trace.json")
        profiler.export_chrome_trace(trace)
        log(f"Profile written: {trace}")
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
                "mpaths_per_s": round((renderer.frame_idx - done0) * width * height
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
