"""Tuning sweep of the sorted wavefront's scheduling knobs (port of
``tools/sweep_wavefront.py``).

    python -m raytrace2_tpu_torch.tools.sweep_wavefront [SCENE] [--spp 8] [--res 600]
        [--keys pos,pos8,depth] [--kb 8,16,32] [--sort-every 1,2] [--tail-k 0]
        [--tail-frac 0.0] [--tail-compact 0] [--sort-impl gather,multi]
        [--out JSONL] [--device cuda|cpu]

``SCENE`` is a scene JSON or a canned scene of the port's ``make_scene``
(default ``book2_final``). Each configuration (the product of the comma
lists) renders ``--spp`` samples at ``--res``², depth 50, sqrt_spp 10,
through ``integrator.render_progressive`` on the wavefront (``mega_*``
features), after a one-sample warm-up: one JSON line with its Mpaths/s and
mean, then the best. The knobs only reorder work, so every configuration
must give the first one's image bit for bit; the tool exits 1 where one
does not. The JAX tool's ``--sublanes`` and ``--state-packed`` choose the
TPU kernel's tile and operand layout, which the port's step does not have:
they are refused.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time

from raytrace2_tpu_torch.tools.dump_wavefront_states import refuse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sweep_wavefront")
    p.add_argument("scene", nargs="?", default="book2_final")
    p.add_argument("--spp", type=int, default=8)
    p.add_argument("--res", type=int, default=600)
    p.add_argument("--keys", default="pos,pos8,depth")
    p.add_argument("--kb", default="8,16,32")
    p.add_argument("--sort-every", default="1,2")
    p.add_argument("--tail-k", default="0", help="tail bounces a launch (0: one phase)")
    p.add_argument("--tail-frac", default="0.0",
                   help="runnable share of the slots below which the tail runs")
    p.add_argument("--tail-compact", default="0", help="0 | 1 (comma list)")
    p.add_argument("--sort-impl", default="gather", help="gather | gather_unstable | multi")
    p.add_argument("--sublanes", default=None, help="refused (a TPU tile)")
    p.add_argument("--state-packed", default=None, help="refused (a TPU operand layout)")
    p.add_argument("--out", default=None, help="JSONL file the records are appended to")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    refuse("--sublanes", args.sublanes)
    refuse("--state-packed", args.state_packed)

    import torch

    from raytrace2_tpu_torch.ops import integrator
    from raytrace2_tpu_torch.render import resolve_device
    from raytrace2_tpu_torch.scene import schema
    from raytrace2_tpu_torch.tools import make_scene

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    host, _, label = make_scene.load(args.scene)
    scene = schema.to_device(host, device)
    base = dict(host.features(), use_megakernel=True, mega_wavefront=True)
    packed = integrator.pack_scene(scene, base)
    w = h = args.res

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def run(feat, spp):
        return integrator.render_progressive(scene, feat, w, h, 0, spp, 0, 50, 10,
                                             packed=packed)

    def ints(s):
        return [int(x) for x in s.split(",")]

    combos = itertools.product(args.keys.split(","), ints(args.kb), ints(args.sort_every),
                               ints(args.tail_k), [float(x) for x in args.tail_frac.split(",")],
                               ints(args.tail_compact), args.sort_impl.split(","))
    results, ref, ok = [], None, True
    for key_mode, kb, se, tk, tf, tc, si in combos:
        feat = dict(base, mega_sort_key=key_mode, mega_k_bounces=kb, mega_sort_every=se,
                    mega_tail_k=tk, mega_tail_frac=tf, mega_tail_compact=bool(tc),
                    mega_sort_impl=si)
        run(feat, 1)
        sync()
        t0 = time.perf_counter()
        img = run(feat, args.spp)
        sync()
        dt = time.perf_counter() - t0
        ref = img if ref is None else ref
        same = bool(torch.equal(img, ref))
        ok &= same
        rec = {"scene": label, "key": key_mode, "k_bounces": kb, "sort_every": se,
               "tail_k": tk, "tail_frac": tf, "tail_compact": tc, "sort_impl": si,
               "mpaths_s": args.spp * w * h / dt / 1e6, "seconds": dt,
               "mean": float(img.mean()) / args.spp, "same_image": same,
               "device": str(device)}
        results.append(rec)
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    print("BEST:", json.dumps(max(results, key=lambda r: r["mpaths_s"])))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
