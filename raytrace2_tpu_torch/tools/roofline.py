"""The card's measured ceilings, and where the v4 render (B1), the v3
pass (B4) and the fused closest hit (B5) spend their time.

    python -m raytrace2_tpu_torch.tools.roofline --mode ceilings [--reps 5]
    python -m raytrace2_tpu_torch.tools.roofline --mode split [--reps 3] [--kernels v4 v3 b5]

Port of ``tools/roofline.py`` of the JAX package, whose ``--mode ceilings``
measures the chip's vector ceiling with a dependent FMA chain and its
memory rate with a streaming copy. Here ``--mode ceilings`` times four
microkernels of ``csrc/roofline.cu`` with CUDA events:

* ``fma``: chains of fused multiply-adds, 2 f32 operations each: the rate
  the data sheet's 67 TFLOP/s counts;
* ``mul_add``: the same chains as a multiply and an add rounded apart, as
  the port's kernels compute (they are built with ``-fmad=false`` for the
  bitwise gates): the f32 ceiling of that code, which the bounds divide by;
* ``mix``: chains of the murmur ``mix`` of ``csrc/path_common.cuh`` (the
  RNG's hashing, which the bounds leave out), 9 integer operations each;
* ``copy``: a streaming float4 copy, bytes read plus written per second.

``--mode split`` runs each production launch and its profiling instance
(``csrc/megakernel_profile.cu``: the same kernel with a per-thread phase
clock, whose results must equal the production ones bit for bit) on the
same inputs, and gives the shares of the summed per-thread ``clock64()``
cycles in staging, state load, camera rays and regeneration, slab tests,
record tests (the sweep), shading, noise, the store, and the block-wide
lockstep counts (``wait``), with the idle-lane share: per lane, the cycles
from its last bounce to its warp's last, over the warp's span. The launches
are the main paths': v4 at Cornell 600², depth 50, 6 spp (the CLI's batch);
v4 forced on book 2 600², depth 50, 2 spp (the block-tiled layout, wave
regeneration at 0.5); one B4 pass of Cornell 600² camera rays, depth 50,
``min_alive`` 8 (the first of ``render_sample``'s two passes). For B5
(``csrc/intersect_profile.cu``) the phases are staging with its barriers,
the ray load, sphere tests, quad tests, the lane group's reduction and the
store, at the ``pallas`` route's launches that ``chip_smoke.py`` holds
against the plain version (``ab_kernels.B5_CASES``): the first and fourth
of the first 16,384-ray chunk of book 2 600², the first of a 65,536-ray
Cornell chunk, and on each the first after each of its two compactions;
with the resident warps per SM (``intersect_kernel.blocks_per_sm``) and
the records tested per ray against the live ones. One JSON line each, the card's name
and power limit first.

Needs a CUDA device; raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from raytrace2_tpu_torch.tools.profile_wavefront import PHASES, card_line, require_cuda

CHAINS = {"fma": 0, "mul_add": 1, "mix": 2}
# Operations per chain step: an FMA counts 2; a multiply and an add 2; the
# murmur mix of h ^ k 9 (1 xor, 3 shift-xor pairs, 2 multiplies).
OPS_PER_STEP = {"fma": 2, "mul_add": 2, "mix": 9}


# GPU cycles the stream spins before a timed window (about 25 ms): the host
# queues the window's launches meanwhile, so the events bracket back-to-back
# kernels and not the host's pace, which sets a short launch's time when the
# host shares its cores.
QUEUE_AHEAD_CYCLES = 50_000_000


def queued_events(fn, reps):
    """(last result, mean ms per call) of ``reps`` calls of ``fn`` after a
    warm-up: CUDA events around the calls, queued behind a device spin."""
    import torch

    fn()  # warm-up (and the first launch's load)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def _check(lib, err, what):
    if err:
        raise RuntimeError(f"{what} failed: {lib.roofline_error_string(err).decode()}")


def ceilings(reps: int = 5) -> dict:
    """The four measured ceilings: f32 operations per second of the FMA and
    the multiply-add chains, integer operations and mixes per second of the
    mix chain, and bytes per second of the copy."""
    import torch

    from raytrace2_tpu_torch.ops.kernels import build

    dev = require_cuda()
    lib = build.load("roofline")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    blocks, threads, iters = sms * 16, 256, 8192
    out = torch.empty(blocks * threads, dtype=torch.float32, device=dev)
    res = {"sms": sms, "blocks": blocks, "threads": threads, "iters": iters,
           "chains_per_thread": lib.roofline_chains()}
    for name, which in CHAINS.items():
        _, ms = queued_events(lambda w=which: _check(lib, lib.roofline_chain_launch(
            w, dev.index or 0, out.data_ptr(), blocks, threads, iters, stream), name), reps)
        steps = blocks * threads * iters * lib.roofline_chains()
        res[f"{name}_ms"] = ms
        res[f"{name}_ops_per_s"] = steps * OPS_PER_STEP[name] / (ms * 1e-3)
    res["mix_per_s"] = res["mix_ops_per_s"] / OPS_PER_STEP["mix"]
    n4 = (1 << 30) // 16  # 1 GiB each way: far past the 50 MB L2
    src = torch.ones(4 * n4, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    _, ms = queued_events(lambda: _check(lib, lib.roofline_copy_launch(
        dev.index or 0, src.data_ptr(), dst.data_ptr(), n4, sms * 8, stream), "copy"), reps)
    res["copy_ms"] = ms
    res["copy_bytes_per_s"] = 2 * 16 * n4 / (ms * 1e-3)
    if not bool(torch.equal(dst, src)):
        raise RuntimeError("the copy kernel's output differs from its input")
    return res


def shares(counters) -> dict:
    """Shares of the profiling instance's counters (``csrc/phase_clock.cuh``):
    each phase's share of the summed per-thread cycles (shading without
    noise), ``sweep`` = slab + record tests, ``other`` the rest (loop
    control, the clock, lanes idling in a divergent branch), and the
    idle-lane share."""
    n = len(PHASES)
    cyc = dict(zip(PHASES, (int(x) for x in counters[:n])))
    idle, span = (int(x) for x in counters[n + 4:n + 6])
    cyc["shade"] -= cyc["noise"]
    parts = {k: v for k, v in cyc.items() if k != "total"}
    total = max(cyc["total"], 1)
    out = {f"{k}_share": v / total for k, v in parts.items()}
    out["sweep_share"] = (cyc["slab"] + cyc["record"]) / total
    out["other_share"] = 1.0 - sum(parts.values()) / total
    out["idle_lane_share"] = idle / max(span, 1)
    out["cycles_total"] = cyc["total"]
    return out


def _scene(work, name):
    from raytrace2_tpu_torch.tools import make_scene

    build_scene = {"cornell": make_scene.cornell_box_original,
                   "book2": lambda: make_scene.book2_final(rng_seed=0)}[name]
    path = os.path.join(work, f"{name}.json")
    with open(path, "w") as f:
        json.dump(build_scene().to_json(), f)
    return path


class _Inputs:
    """A scene's kernel inputs on the card."""

    def __init__(self, path, dev):
        import torch

        from raytrace2_tpu_torch.ops.kernels import megakernel as mk
        from raytrace2_tpu_torch.ops.kernels import megakernel_v3 as mk3
        from raytrace2_tpu_torch.scene import loader, schema

        self.host, _ = loader.load_scene(path)
        self.feats = self.host.features()
        self.sizes = tuple(self.feats["mega_sizes"])
        self.ds = schema.to_device(self.host, dev)
        self.packed = mk.pack_buffer(self.ds, self.sizes)
        self.bg = self.ds.background.to(torch.float32).contiguous()
        self.dev = dev
        # The material types read once, as the renderer does: no launch
        # reads the device.
        self.kw = dict(max_depth=50, sizes=self.sizes, has_checker=self.feats["has_checker"],
                       has_noise=self.feats["has_noise"],
                       mat_types=mk.scene_material_types(self.ds.materials.mtype))
        # The v4 and B4 instances' feature masks (hash noise).
        args = (self.packed, self.sizes, self.feats["has_checker"], self.feats["has_noise"])
        self.masks = {"megakernel_v4": mk.scene_features(*args, None, self.kw["mat_types"]),
                      "megakernel_v3": mk3.instance_features(*args, self.kw["mat_types"])}


def _prof_lib(inp):
    from raytrace2_tpu_torch.ops.kernels import build

    return build.load(build.profile_target(inp.masks["megakernel_v4"],
                                           inp.masks["megakernel_v3"]))


def _occupancy(inp, kernel, wave=False) -> dict:
    """The production instance's mask, shared memory per block and resident
    threads per SM."""
    from raytrace2_tpu_torch.ops.kernels import build
    from raytrace2_tpu_torch.ops.kernels import megakernel as mk

    mask = inp.masks[kernel]
    lib = build.load(build.feature_target(kernel, mask))
    counts = mk.counts(inp.sizes)
    if kernel == "megakernel_v4":
        smem = lib.megakernel_v4_smem_bytes(*counts)
        tps = None if wave else lib.megakernel_v4_threads_per_sm(smem)
    else:
        smem = lib.megakernel_v3_smem_bytes(*counts[:8])
        tps = lib.megakernel_v3_threads_per_sm(smem)
    return {"features": mask, "smem_bytes": smem, "threads_per_sm": tps}


def _counters(lib, dev):
    import torch

    return torch.zeros(lib.megakernel_profile_counters(), dtype=torch.int64, device=dev)


def split_v4(inp, size, spp, sqrt_spp, block, wave_frac, reps) -> dict:
    """The production v4 launch and its profiled instance at one shape."""
    import torch

    from raytrace2_tpu_torch.ops import camera
    from raytrace2_tpu_torch.ops.kernels import megakernel as mk

    dev = inp.dev
    camv = camera.make_camv(inp.host.camera, size, size, 0, spp, sqrt_spp, 0,
                            **({"block": mk.BLOCK} if block else {})).to(dev)
    n_slots = mk.pixel_slots(size, size, block=block)[0]
    kw = dict(inp.kw, n_pix=n_slots, block=block, wave_frac=wave_frac)
    prod, ms = queued_events(
        lambda: mk.trace_megakernel_batch(camv, 0, inp.packed, inp.bg, **kw), reps)
    lib = _prof_lib(inp)
    counts = mk.counts(inp.sizes)
    stream = torch.cuda.current_stream(dev).cuda_stream

    next_slot = torch.empty(1, dtype=torch.int32, device=dev)

    def profiled(prof):
        out = torch.empty((n_slots, 3), dtype=torch.float32, device=dev)
        err = lib.megakernel_v4_profile_launch(
            dev.index or 0, camv.data_ptr(), 0, inp.bg.data_ptr(), inp.packed.data_ptr(),
            *counts[:8], None, 0, n_slots, int(block), float(wave_frac), 50,
            int(inp.feats["has_checker"]), int(bool(inp.feats["has_noise"])),
            next_slot.data_ptr(), out.data_ptr(), prof.data_ptr(), stream)
        if err:
            raise RuntimeError(f"megakernel_v4_profile_launch failed: "
                               f"{lib.megakernel_v4_error_string(err).decode()}")
        return out

    _, prof_ms = queued_events(lambda: profiled(_counters(lib, dev)), reps)
    prof = _counters(lib, dev)
    out = profiled(prof)
    torch.cuda.synchronize()
    if not torch.equal(out, prod):
        raise RuntimeError("the profiled v4 instance's image differs from the production one")
    return {"ms": ms, "profiled_ms": prof_ms, "n_slots": n_slots,
            **_occupancy(inp, "megakernel_v4", wave_frac < 1.0), **shares(prof.cpu().tolist())}


def split_v3(inp, size, reps) -> dict:
    """One production B4 pass and its profiled instance on the camera rays
    of a size² image (min_alive 8 of 128: the first of two passes)."""
    import torch

    from raytrace2_tpu_torch.ops import camera, integrator, rng
    from raytrace2_tpu_torch.ops.kernels import megakernel as mk
    from raytrace2_tpu_torch.ops.kernels import megakernel_v3 as mk3

    dev = inp.dev
    seed_lane = integrator.mega_seed_of(0, 0)
    pix = torch.arange(size * size, dtype=torch.int32, device=dev)
    u = rng.murmur_uniforms(seed_lane, pix, tuple(rng.CAMERA_CTR_BASE + k for k in range(5)))
    o, d, tm = camera.generate_rays(inp.ds.camera, size, size, 0, 4, None, uniforms=u)
    pad = -o.shape[0] % mk3.TILE_R
    state, rid = mk3.init_state(torch.nn.functional.pad(o, (0, 0, 0, pad)),
                                torch.nn.functional.pad(d, (0, 0, 0, pad), value=1.0),
                                torch.nn.functional.pad(tm, (0, pad)))
    min_alive = mk3.TILE_R // 16
    (rad, new), ms = queued_events(lambda: mk3.megakernel_pass(
        state, rid, seed_lane, min_alive, inp.packed, inp.bg, **inp.kw), reps)
    lib = _prof_lib(inp)
    counts = mk.counts(inp.sizes)
    stream = torch.cuda.current_stream(dev).cuda_stream
    n = rid.numel()

    def profiled(prof):
        st = state.clone()
        radiance = torch.empty((n, 3), dtype=torch.float32, device=dev)
        err = lib.megakernel_v3_profile_launch(
            dev.index or 0, inp.bg.data_ptr(), inp.packed.data_ptr(), *counts[:8],
            st.data_ptr(), rid.data_ptr(), n, seed_lane, min_alive, 50,
            int(inp.feats["has_checker"]), int(bool(inp.feats["has_noise"])),
            radiance.data_ptr(), prof.data_ptr(), stream)
        if err:
            raise RuntimeError(f"megakernel_v3_profile_launch failed: "
                               f"{lib.megakernel_v3_error_string(err).decode()}")
        return radiance, st

    _, prof_ms = queued_events(lambda: profiled(_counters(lib, dev)), reps)
    prof = _counters(lib, dev)
    rad_p, new_p = profiled(prof)
    torch.cuda.synchronize()
    if not (torch.equal(rad_p, rad) and torch.equal(new_p, new)):
        raise RuntimeError("the profiled B4 instance's pass differs from the production one")
    bounces = int((new[mk3.COL["bounce"]] - state[mk3.COL["bounce"]]).sum())
    return {"ms": ms, "profiled_ms": prof_ms, "rays": n, "bounces": bounces,
            **_occupancy(inp, "megakernel_v3"), **shares(prof.cpu().tolist())}


# B5's phases in PhaseClock's slots (csrc/intersect_profile.cu).
B5_SLOTS = {"stage": "stage", "load": "ray_load", "slab": "sphere", "record": "quad",
            "wait": "reduce", "store": "store"}


def b5_shares(counters) -> dict:
    """Shares of B5's profiling counters: each phase's share of the summed
    per-thread cycles, ``other`` the rest (loop control, the clock), and
    the idle-lane share."""
    n = len(PHASES)
    cyc = dict(zip(PHASES, (int(x) for x in counters[:n])))
    idle, span = (int(x) for x in counters[n + 4:n + 6])
    total = max(cyc["total"], 1)
    out = {f"{name}_share": cyc[slot] / total for slot, name in B5_SLOTS.items()}
    out["other_share"] = 1.0 - sum(cyc[slot] for slot in B5_SLOTS) / total
    out["idle_lane_share"] = idle / max(span, 1)
    out["cycles_total"] = cyc["total"]
    return out


def split_b5_launch(args, kwargs, extents, reps) -> dict:
    """One production B5 launch and its profiled instance on the same
    arguments and launch: the time of each, the clock's shares, the launch's
    shape on the card (lane group, threads a block, staging, resident warps
    per SM) and the records each ray tests against the live ones."""
    import torch

    from raytrace2_tpu_torch.ops.kernels import build
    from raytrace2_tpu_torch.ops.kernels import intersect_kernel as pk

    o, d, tm, t_min, t_max, sph, qd = (x.contiguous() for x in args)
    dev, n = o.device, o.shape[0]
    # The pallas route passes the live extents by keyword.
    n_sph, n_quad = kwargs.get("n_sph", sph.shape[1]), kwargs.get("n_quad", qd.shape[1])
    prod, ms = queued_events(lambda: pk.closest_hit(*args, **kwargs), reps)
    sms = build.sm_count(dev)
    config = pk.launch_config(n, n_sph, n_quad, sms)
    group, threads, cap_s, cap_q = config
    smem = pk.smem_bytes(cap_s, cap_q)
    lib = build.load("intersect_profile")
    stream = torch.cuda.current_stream(dev).cuda_stream

    def profiled(prof):
        t = torch.empty(n, dtype=torch.float32, device=dev)
        code = torch.empty(n, dtype=torch.int32, device=dev)
        err = lib.intersect_profile_launch(
            dev.index or 0, *(x.data_ptr() for x in (o, d, tm, t_min, t_max, sph)),
            sph.shape[1], n_sph, qd.data_ptr(), qd.shape[1], n_quad, n, *config, smem,
            t.data_ptr(), code.data_ptr(), prof.data_ptr(), stream)
        if err:
            raise RuntimeError(f"intersect_profile_launch failed: "
                               f"{lib.intersect_kernel_error_string(err).decode()}")
        return t, code

    def counters():
        return torch.zeros(lib.intersect_profile_counters(), dtype=torch.int64, device=dev)

    _, prof_ms = queued_events(lambda: profiled(counters()), reps)
    prof = counters()
    t, code = profiled(prof)
    torch.cuda.synchronize()
    if not (torch.equal(t.view(torch.int32), prod[0].view(torch.int32))
            and torch.equal(code, prod[1])):
        raise RuntimeError("the profiled B5 instance's hits differ from the production one's")
    per_sm = pk.blocks_per_sm(threads, smem)
    grid_warps = -(-n * group // threads) * threads // 32
    return {"ms": ms, "profiled_ms": prof_ms, "rays": n, "hits": int((code >= 0).sum()),
            "group": group, "threads_per_block": threads,
            "staging": "whole" if (cap_s, cap_q) == (n_sph, n_quad) else "tiles",
            "smem_bytes": smem, "blocks_per_sm": per_sm,
            "threads_per_sm": per_sm * threads,
            "resident_warps_per_sm": min(per_sm * threads // 32, grid_warps / sms),
            "records_tested_per_ray": n_sph + n_quad, "records_per_lane": -(-(n_sph + n_quad)
                                                                              // group),
            "padded_records": sph.shape[1] + qd.shape[1], "live_records": sum(extents),
            **b5_shares(prof.cpu().tolist())}


def b5_launch_name(pick) -> str:
    """The words for a pick of ``ab_kernels.b5_launches``."""
    if isinstance(pick, str):
        return f"the first launch after compaction {pick[1:]}"
    return f"launch {pick}"


def split_b5(paths, dev, reps) -> dict:
    """B5's split at each of its main-path launches (``ab_kernels.B5_CASES``)."""
    from raytrace2_tpu_torch.ops.kernels import intersect_kernel as pk
    from raytrace2_tpu_torch.scene import loader
    from raytrace2_tpu_torch.tools import ab_kernels

    out = {}
    for name, chunk, picks in ab_kernels.B5_CASES:
        extents = pk.live_extents(loader.load_scene(paths[name])[0])
        _, launches, _ = ab_kernels.b5_launches(paths[name], dev, 600, chunk, picks)
        for i, a, k in launches:
            out[f"b5_{name}_{i}"] = dict(
                shape=f"{name} 600x600, the pallas route's {chunk}-ray chunk, "
                      f"{b5_launch_name(i)}", **split_b5_launch(a, k, extents, reps))
    return out


SPLIT_KERNELS = ("v4", "v3", "b5")


def split(reps: int = 3, kernels=SPLIT_KERNELS) -> dict:
    """The main-path launches' splits of ``kernels``, with ptxas's usage of
    the production and profiling instances."""
    from raytrace2_tpu_torch.ops.kernels import build

    dev = require_cuda()
    out = {}
    with tempfile.TemporaryDirectory() as work:
        paths = {name: _scene(work, name) for name in ("cornell", "book2")}
        if "v4" in kernels or "v3" in kernels:
            cornell = _Inputs(paths["cornell"], dev)
        if "v4" in kernels:
            book2 = _Inputs(paths["book2"], dev)
            out["v4_cornell"] = dict(shape="cornell 600x600, depth 50, 6 spp, linear",
                                     **split_v4(cornell, 600, 6, 2, False, 1.0, reps))
            out["v4_book2_block"] = dict(
                shape="book2 600x600, depth 50, 2 spp, block layout, wave_frac 0.5",
                **split_v4(book2, 600, 2, 1, True, 0.5, reps))
        if "v3" in kernels:
            out["v3_cornell_pass"] = dict(
                shape="cornell 600x600, depth 50, one pass, min_alive 8",
                **split_v3(cornell, 600, reps))
        if "b5" in kernels:
            out.update(split_b5(paths, dev, reps))
    out["ptxas"] = {k: [(u["kernel"].split("(")[0], u["registers"], u["stack"],
                         u["spill_stores"]) for u in build.ptxas_usage(k)]
                    for k in sorted(build.BUILD_LOGS)
                    if k.startswith(("megakernel_v4", "megakernel_v3", "megakernel_profile",
                                     "intersect_kernel", "intersect_profile"))}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", choices=("ceilings", "split"), required=True)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--kernels", nargs="+", choices=SPLIT_KERNELS, default=list(SPLIT_KERNELS),
                   help="the kernels --mode split profiles")
    args = p.parse_args(argv)
    require_cuda()
    print(card_line(), flush=True)
    if args.mode == "ceilings":
        print(json.dumps(ceilings(args.reps)), flush=True)
    else:
        for name, row in split(args.reps, args.kernels).items():
            print(json.dumps({name: row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
