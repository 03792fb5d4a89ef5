"""Dump sorted wavefront states of a real render for offline analysis
(port of ``tools/dump_wavefront_states.py``; ``analyze_sweep`` reads them).

    python -m raytrace2_tpu_torch.tools.dump_wavefront_states [SCENE] --out DIR
        [--res 600] [--spp 32] [--bounces 8] [--device cuda|cpu]

``SCENE`` is a scene JSON or a canned scene of the port's ``make_scene``
(default ``book2_final``). From the first slots of a batch, each launch
sorts the state (the production sort, ``wavefront.sort_state``) and runs
one bounce (``wavefront_step`` with K = 1, the kernel on a CUDA device);
each sorted state is written as ``DIR/state_NN.npz``, one array per state
column (``wavefront.STATE_KEYS``), with ``n_samples`` beside them. The JAX
tool's ``--sublanes`` sets the TPU tile of its step, which the port does not
have: the option is refused.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


class Inputs:
    """A scene's wavefront inputs on ``device``: packed tables, background,
    noise tables, camv of a batch of ``spp`` samples at ``res``², the step's
    keyword arguments and the scene bounds of the sort keys."""

    def __init__(self, scene_arg, res, spp, depth, device):
        import torch

        from raytrace2_tpu_torch.ops import camera, integrator
        from raytrace2_tpu_torch.ops.kernels import megakernel as mk
        from raytrace2_tpu_torch.ops.kernels import wavefront as wf
        from raytrace2_tpu_torch.scene import schema
        from raytrace2_tpu_torch.tools import make_scene

        host, _, self.label = make_scene.load(scene_arg)
        self.features = dict(host.features(), use_megakernel=True, mega_wavefront=True)
        self.sizes = tuple(self.features["mega_sizes"])
        ds = schema.to_device(host, device)
        self.scene = ds
        self.packed = mk.pack_buffer(ds, self.sizes)
        self.background = ds.background.to(torch.float32).contiguous()
        self.camv = camera.make_camv(host.camera, res, res, 0, spp, max(int(spp ** 0.5), 1),
                                     0).to(device)
        self.ntab = integrator.noise_tables(ds, self.features)
        self.kw = dict(max_depth=depth, sizes=self.sizes,
                       has_checker=int(self.features["has_checker"]),
                       has_noise=bool(self.features["has_noise"]), ntab=self.ntab)
        self.n_rays = -(-res * res // wf.SLOT_TILE) * wf.SLOT_TILE
        self.n_samples = float(spp)
        self.bounds = wf.scene_bounds(self.packed, self.sizes)

    def init_state(self):
        from raytrace2_tpu_torch.ops.kernels import wavefront as wf

        return wf.init_wavefront_state(self.n_rays, [float(x) for x in self.camv.tolist()],
                                       self.packed.device)

    def sort(self, state, sort_impl="gather"):
        from raytrace2_tpu_torch.ops.kernels import wavefront as wf

        return wf.sort_state(state, self.n_samples, *self.bounds, "pos", sort_impl)

    def step(self, state, k=1):
        from raytrace2_tpu_torch.ops.kernels import wavefront as wf

        return wf.wavefront_step(state, self.camv, 0, self.packed, self.background,
                                 k_bounces=k, **self.kw)


def refuse(name: str, value) -> None:
    """Exit 2 for a JAX option that has no meaning on the card."""
    if value is not None:
        print(f"error: {name} sets the TPU kernel's tile and has no meaning on the card "
              "(the port's step runs one thread a slot)", file=sys.stderr)
        raise SystemExit(2)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dump_wavefront_states")
    p.add_argument("scene", nargs="?", default="book2_final")
    p.add_argument("--out", required=True)
    p.add_argument("--res", type=int, default=600)
    p.add_argument("--spp", type=int, default=32)
    p.add_argument("--depth", type=int, default=50)
    p.add_argument("--bounces", type=int, default=8)
    p.add_argument("--sublanes", type=int, default=None, help="refused (a TPU tile)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    refuse("--sublanes", args.sublanes)

    from raytrace2_tpu_torch.ops.kernels import wavefront as wf
    from raytrace2_tpu_torch.render import resolve_device

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    inp = Inputs(args.scene, args.res, args.spp, args.depth, device)
    os.makedirs(args.out, exist_ok=True)
    state = inp.init_state()
    for it in range(args.bounces):
        srt = inp.sort(state)
        cols = srt.cpu().numpy()
        np.savez_compressed(os.path.join(args.out, f"state_{it:02d}.npz"),
                            n_samples=np.float32(inp.n_samples),
                            **{k: cols[i] for i, k in enumerate(wf.STATE_KEYS)})
        state = inp.step(srt)
        print(f"dumped bounce {it}, alive {int((cols[wf.COL['al']] > 0).sum())}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
