"""Where the sorted wavefront's time goes, on the card: sort and step timed
apart on real mid-render state snapshots, the step against its variants,
and a per-phase split of the step.

    python -m raytrace2_tpu_torch.tools.profile_wavefront [SCENE.json] [--res 600]
        [--spp 6] [--depth 50] [--snapshots 1,3,6,7,12,18] [--reps 5]

Port of ``tools/profile_wavefront.py`` of the JAX package. Without a scene
it renders book 2 (``make_scene.book2_final(0)``). One batch of
``--spp`` samples runs through ``wavefront.trace_wavefront_batch`` (the
production schedule: K=2 launches with a sort before each, then K=16 tail
launches); the state before the sort of each launch in ``--snapshots`` and
the sorted state the step got are kept. For each snapshot, CUDA events
time:

* ``sort_ms``: keys, argsort and gather (``wavefront.sort_state``);
* ``step_ms``: the production step (``csrc/wavefront_step.cu``);
* ``nosweep_ms``: the step with the sphere and AA-box sweeps compiled out
  (everything but those sweeps);
* ``linear_ms``: the step with the clusters compiled out (both families
  swept flat);
* ``profiled_ms``: the step with a per-thread clock (its state must equal
  the production step's bit for bit).

``step - nosweep`` is the sweep's cost, ``(linear - nosweep) / (step -
nosweep)`` the cluster skip's factor. The variants are template instances
built only for this tool (``csrc/wavefront_profile.cu``). Then the whole
batch runs again with the profiled step, and its clock gives the split:
the share of the summed per-thread cycles in block staging, state load,
camera rays, slab tests, record tests, shading (noise excluded), noise and
state store, and the share of warp-steps of the closest hit over a
clustered family in which the converged lanes take more than one visit
order (with the mean number of orders). One JSON line per snapshot, then
one for the batch, the card's name and power limit first.

Needs a CUDA device; raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

VARIANTS = {"nosweep": 0, "linear": 1, "profiled": 2}
PHASES = ("stage", "load", "camera", "slab", "record", "shade", "noise", "store", "wait",
          "total")


def card_line() -> str:
    """nvidia-smi's name and power limit of the card."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def require_cuda():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("this profiler times the CUDA kernels and needs a CUDA device")
    return torch.device("cuda")


def book2_scene(work: str) -> str:
    from raytrace2_tpu_torch.tools import make_scene

    path = os.path.join(work, "book2.json")
    with open(path, "w") as f:
        json.dump(make_scene.book2_final(rng_seed=0).to_json(), f)
    return path


def _events(fn, reps):
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def split(counters) -> dict:
    """Shares of the profiled step's counters (``csrc/wavefront_profile.cu``)."""
    cyc = dict(zip(PHASES, (int(x) for x in counters[:len(PHASES)])))
    steps, mixed, distinct, lanes = (int(x) for x in counters[len(PHASES):len(PHASES) + 4])
    cyc["shade"] -= cyc["noise"]
    parts = {k: v for k, v in cyc.items() if k != "total"}
    total = max(cyc["total"], 1)
    out = {f"{k}_share": v / total for k, v in parts.items()}
    out["other_share"] = 1.0 - sum(parts.values()) / total
    out.update(cycles_per_thread_total=cyc["total"], warp_steps=steps,
               mixed_order_share=mixed / max(steps, 1),
               mean_orders_per_warp_step=distinct / max(steps, 1),
               mean_lanes_per_warp_step=lanes / max(steps, 1))
    return out


class Profiler:
    """The scene's kernel inputs on the card, and the variant launches."""

    def __init__(self, scene_path, res, spp, depth, table=False):
        import torch

        from raytrace2_tpu_torch.ops import camera, integrator
        from raytrace2_tpu_torch.ops.kernels import megakernel as mk
        from raytrace2_tpu_torch.ops.kernels import wavefront as wf
        from raytrace2_tpu_torch.scene import loader, schema

        self.dev = require_cuda()
        host, _ = loader.load_scene(scene_path)
        feats = host.features()
        self.sizes = tuple(feats["mega_sizes"])
        ds = schema.to_device(host, self.dev)
        self.packed = mk.pack_buffer(ds, self.sizes)
        self.bg = ds.background.to(torch.float32).contiguous()
        self.camv = camera.make_camv(host.camera, res, res, 0, spp, max(int(spp ** 0.5), 1),
                                     0).to(self.dev)
        self.ntab = integrator.noise_tables(ds, dict(feats, noise_impl="table")) if table \
            else None
        self.kw = dict(max_depth=depth, sizes=self.sizes, has_checker=feats["has_checker"],
                       has_noise=feats["has_noise"], ntab=self.ntab)
        self.n_rays = -(-res * res // wf.SLOT_TILE) * wf.SLOT_TILE
        self.spp = spp

    def args(self):
        return (self.camv, 0, self.packed, self.bg)

    def variant(self, name, state, k, prof=None):
        """Launch variant ``name`` of the profiling build on ``state`` in
        place, with the production launch's arguments; the profiled one adds
        its counters to ``prof`` (``counters()``)."""
        import torch

        from raytrace2_tpu_torch.ops.kernels import build
        from raytrace2_tpu_torch.ops.kernels import megakernel as mk

        lib = build.load(build.step_target("wavefront_profile"))
        if (name == "profiled") != (prof is not None):
            raise ValueError("the profiled variant, and only it, takes the counters")
        counts = mk.counts(self.sizes, mk.n_noise_of(self.ntab))
        kw = self.kw
        seed = build.seed_buffer(0, self.dev)
        err = lib.wavefront_profile_launch(
            VARIANTS[name], self.dev.index or 0, self.camv.data_ptr(), seed.data_ptr(),
            self.bg.data_ptr(), self.packed.data_ptr(), *counts[:8],
            None if self.ntab is None else self.ntab.data_ptr(), counts[8], state.data_ptr(),
            state.shape[1], k, kw["max_depth"], int(kw["has_checker"]),
            int(bool(kw["has_noise"])), None if prof is None else prof.data_ptr(),
            torch.cuda.current_stream(self.dev).cuda_stream)
        if err:
            raise RuntimeError(f"wavefront_profile launch of {name} failed: "
                               f"{lib.wavefront_step_error_string(err).decode()}")

    def occupancy(self) -> dict:
        """Shared memory per block and resident threads per SM of the
        production step, and ptxas's usage of the step and its variants."""
        from raytrace2_tpu_torch.ops.kernels import build
        from raytrace2_tpu_torch.ops.kernels import megakernel as mk

        lib = build.load(build.step_target())
        build.load(build.step_target("wavefront_profile"))
        smem = lib.wavefront_step_smem_bytes(*mk.counts(self.sizes, mk.n_noise_of(self.ntab)))
        return {"smem_bytes": smem, "threads_per_sm": lib.wavefront_step_threads_per_sm(smem),
                "ptxas": {k: build.ptxas_usage(k) for k in map(build.target_key, (
                    build.step_target(), build.step_target("wavefront_profile")))}}

    def counters(self):
        import torch

        from raytrace2_tpu_torch.ops.kernels import build

        n = build.load(build.step_target("wavefront_profile")).wavefront_profile_counters()
        return torch.zeros(n, dtype=torch.int64, device=self.dev)

    def batch(self, step=None, sort=None):
        """One batch through the production schedule; ``step`` and ``sort``
        stand in for ``trace_wavefront_batch``'s own."""
        from raytrace2_tpu_torch.ops.kernels import wavefront as wf

        orig_sort = wf.sort_state
        if sort is not None:
            wf.sort_state = sort
        try:
            return wf.trace_wavefront_batch(*self.args(), n_rays=self.n_rays, step=step,
                                            **self.kw)
        finally:
            wf.sort_state = orig_sort

    def snapshots(self, at):
        """{launch: (state before its sort, sorted state, k)} of one batch."""
        from raytrace2_tpu_torch.ops.kernels import wavefront as wf

        snaps, pre, orig_sort = {}, {}, wf.sort_state
        launch = [0]

        def sort(state, *a, **k):
            pre["state"] = state.clone()
            return orig_sort(state, *a, **k)

        def step(state, *a, k_bounces, **k):
            launch[0] += 1
            if launch[0] in at:
                snaps[launch[0]] = (pre["state"], state.clone(), k_bounces)
            return wf.wavefront_step(state, *a, k_bounces=k_bounces, **k)

        image = self.batch(step=step, sort=sort)
        return snaps, launch[0], image

    def time_snapshot(self, pre, srt, k, reps):
        import torch

        from raytrace2_tpu_torch.ops.kernels import wavefront as wf

        row = {"k": k, "alive": int((srt[wf.COL["al"]] > 0).sum()),
               "runnable": int(wf.runnable(srt, float(self.spp)).sum())}
        bb = wf.scene_bounds(self.packed, self.sizes)
        row["sort_ms"] = _events(lambda: wf.sort_state(pre, float(self.spp), *bb), reps)

        def timed(launch):
            launch(srt.clone())  # warm-up: an instance's first launch loads it
            ms = 0.0
            for _ in range(reps):
                st = srt.clone()
                ms += _events(lambda: launch(st), 1) / reps
            return st, ms

        prod, row["step_ms"] = timed(lambda st: wf.wavefront_step(
            st, *self.args(), k_bounces=k, **self.kw))
        for name in VARIANTS:
            prof = self.counters() if name == "profiled" else None
            st, row[f"{name}_ms"] = timed(lambda st, n=name: self.variant(n, st, k, prof))
            if name == "profiled" and not torch.equal(st, prod):
                raise RuntimeError("the profiled step's state differs from the production "
                                   "step's")
        return row

    def batch_split(self):
        """The profiled step over a whole batch: the split, its image
        against the production batch's."""
        import torch

        from raytrace2_tpu_torch.ops.kernels import wavefront as wf

        prof = self.counters()
        n = {"launches": 0}

        def step(state, *a, k_bounces, **k):
            n["launches"] += 1
            self.variant("profiled", state, k_bounces, prof)
            return state

        image = self.batch(step=step)
        torch.cuda.synchronize()
        ref = self.batch()
        if not torch.equal(image, ref):
            raise RuntimeError("the profiled batch's image differs from the production one")
        out = split(prof.cpu().tolist())
        out["launches"] = n["launches"]
        return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("scene", nargs="?", help="scene JSON (default: book 2 built in-process)")
    p.add_argument("--res", type=int, default=600)
    p.add_argument("--spp", type=int, default=6, help="samples of the batch (the CLI's 6)")
    p.add_argument("--depth", type=int, default=50)
    p.add_argument("--snapshots", default="1,3,6,7,12,18",
                   help="launches whose states are timed (1-based)")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--noise-impl", choices=("hash", "table"), default="hash")
    args = p.parse_args(argv)
    require_cuda()
    print(card_line(), flush=True)
    with tempfile.TemporaryDirectory() as work:
        scene = args.scene or book2_scene(work)
        prof = Profiler(scene, args.res, args.spp, args.depth, args.noise_impl == "table")
        at = {int(x) for x in args.snapshots.split(",")}
        prof.batch()  # build and warm up
        snaps, launches, _ = prof.snapshots(at)
        print(json.dumps({"scene": os.path.basename(scene), "res": args.res, "spp": args.spp,
                          "depth": args.depth, "n_rays": prof.n_rays, "launches": launches,
                          "noise_impl": args.noise_impl, **prof.occupancy()}), flush=True)
        for i, (pre, srt, k) in sorted(snaps.items()):
            row = {"snapshot": i, **prof.time_snapshot(pre, srt, k, args.reps)}
            print(json.dumps(row), flush=True)
        print(json.dumps({"batch_split": prof.batch_split()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
