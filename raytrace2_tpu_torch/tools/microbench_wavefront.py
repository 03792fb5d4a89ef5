"""The wavefront's fixed cost per launch, piece by piece, on a real
mid-render state (port of ``tools/microbench_wavefront.py``).

    python -m raytrace2_tpu_torch.tools.microbench_wavefront [SCENE]
        [--state DIR/state_03.npz] [--res 600] [--spp 32] [--reps 20]
        [--device cuda|cpu]

``SCENE`` is a scene JSON or a canned scene of the port's ``make_scene``
(default ``book2_final``). The state is ``--state`` (a dump of
``dump_wavefront_states`` at the same scene, ``--res`` and ``--spp``), or
the sorted state before the fourth launch of a K = 1 run made here. Times,
in ms, with CUDA events on the card (a host clock after a synchronise on
the CPU): ``keys`` (the sort keys), ``argsort``, ``gather`` (the [17, n]
state by a fixed permutation), ``sort_full`` (``sort_state``) and
``step_k1`` (one launch of the K = 1 step on a copy of the state, the copy
included). The JAX
tool's other step variants (no sweep, other sublane counts, the material
table operand) choose a TPU tiling or a Pallas operand, which the port's
step does not have. One JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from raytrace2_tpu_torch.tools.dump_wavefront_states import Inputs


def timer(device):
    """ms of one call of ``fn``, averaged over ``reps`` after a warm-up."""
    import torch

    def timed(fn, reps):
        fn()
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize(device)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize(device)
            return start.elapsed_time(end) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3

    return timed


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="microbench_wavefront")
    p.add_argument("scene", nargs="?", default="book2_final")
    p.add_argument("--state", default=None)
    p.add_argument("--res", type=int, default=600)
    p.add_argument("--spp", type=int, default=32)
    p.add_argument("--depth", type=int, default=50)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from raytrace2_tpu_torch.ops.kernels import wavefront as wf
    from raytrace2_tpu_torch.render import resolve_device

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    inp = Inputs(args.scene, args.res, args.spp, args.depth, device)
    if args.state:
        z = np.load(args.state)
        state = torch.from_numpy(np.stack([z[k] for k in wf.STATE_KEYS])).to(device)
        if state.shape[1] != inp.n_rays:
            raise SystemExit(f"error: the state has {state.shape[1]} slots, --res "
                             f"{args.res} gives {inp.n_rays}")
    else:
        state = inp.init_state()
        for _ in range(3):
            state = inp.step(inp.sort(state))
        state = inp.sort(state)
    timed = timer(device)
    keys = wf.sort_keys(state, inp.n_samples, *inp.bounds)
    perm = torch.argsort(keys, stable=True)
    res = {"scene": inp.label, "n_rays": inp.n_rays,
           "alive": int((state[wf.COL["al"]] > 0).sum()), "device": str(device),
           "keys_ms": timed(lambda: wf.sort_keys(state, inp.n_samples, *inp.bounds), args.reps),
           "argsort_ms": timed(lambda: torch.argsort(keys, stable=True), args.reps),
           "gather_ms": timed(lambda: state.index_select(1, perm), args.reps),
           "sort_full_ms": timed(lambda: inp.sort(state), args.reps)}
    res["step_k1_ms"] = timed(lambda: inp.step(state.clone()), args.reps)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
