#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (raytrace2_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. the device, with nvidia-smi's name and power limit;
  2. build every library the run reaches from csrc/ with nvcc, one process
     per library, all started together: the kernels, the instance of v4, B4
     and the gradient kernel for each scene feature mask the run meets, and
     the profiling builds and ceiling microkernels of phases 15-16 (each
     timed, with ptxas registers, stack and spills);
  3. closed-form scenes through both kernels (v4, and the wavefront forced),
     exact (rtol 1e-5), and each scene's v4 instance bitwise against its
     plain version;
  4. each kernel vs its plain PyTorch version on the card, same inputs, gate
     |Δmean| < 1e-3 and PSNR ≥ 45 dB, and v4 bitwise: v4 on Cornell 600x600
     4 spp depth 8, the feature scene 256x256 4 spp depth 8, and Cornell at
     its main path's launch shape (600x600, depth 50, the CLI's 6-sample
     batch), both timed, and the smoke-and-fog box (v4's quads-and-media
     instance) at its benchmark cell's batch (600x600, depth 50, 20
     samples), timed, then launched once with v4's counter: the same image,
     the plain version's segment and medium-scatter counts, and its bound
     from those segments;
     the wavefront on Cornell 600x600 4 spp depth 8 (forced) and book 2
     64x64 2 spp depth 4, driven by the kernel and by its plain step; the
     wavefront's step at its main path's launch shapes (book 2 600x600,
     depth 50, 6-sample batch: a K=2 launch and a K=16 tail launch) bitwise
     against the plain step on the same captured state (over the flat
     tables too, on a 32,768-slot slice), timed with the
     cluster skip and over the flat tables in turns, its bound from the
     records and cluster boxes the plain step tested; where a book-2 batch's
     time goes (kernel, sort, runnable counts, host); v4 (block-tiled
     layout, wave_frac 0.5) bitwise equal to the wavefront on book 2 600x600
     16 spp depth 50, with the skip and flat, timed in turns, and the skip's
     image against the flat sweep's (at most 0.01 % of pixels: exact ties);
  5. the v4 main path through the CLI entry (app.main): Cornell 600x600,
     depth 50, 64 spp, PNG written, launch counts reset before and read
     after, mean linear radiance checked, Mpaths/s reported; then three
     warm Renderer.update(64) batches under torch's sync debug mode
     "error" (none may synchronise), bitwise the image of batches that
     each read the camera;
  6. the wavefront main path through app.main with the default backend:
     book 2 600x600, depth 50, 64 spp; wavefront launches and sorts > 0 and
     no v4 launch, PNG written, mean linear radiance checked against the
     16-spp render of phase 4; then the same run with and without the
     cluster skip in turns;
  7. the gradient kernel (B3) vs its plain PyTorch version (the replay
     under torch.autograd), same inputs and radiance cotangent, gate
     max|d| <= 1e-3 max|g_plain| + 1e-6 per leaf group (camv, background,
     each table family): the three gradient-test scenes at 64x64, 2 spp,
     depth 8, the noise scene with table noise too, and Cornell 600x600
     depth 50 at 2 spp (lanes chunked), where both are timed; each
     instance's replayed bounces must be the plain pre-pass's; then B3 alone at the
     main path's launch (Cornell 600x600, depth 50, 64 spp), timed with CUDA
     events;
  8. the gradient main path through grad.value_and_grad_scene: Cornell
     600x600, depth 50, 64 spp, sqrt_spp 2, loss = mean (the JAX bench's
     cornell600_fwdbwd_d50_paths_per_sec, with the forward/backward split);
     book 2 600x600, depth 50, 4 spp through the wavefront forward and B3;
  9. 5 Adam steps of python -m raytrace2_tpu_torch.tools.optimize_scene on
     Cornell 600x600 (materials.albedo, 4 spp, depth 50): the loss falls;
 10. the card's ceilings (tools/roofline.py --mode ceilings), then the
     fused closest hit B5 over the live records vs its plain version over
     the padded rows at its main-path launch shapes (t bitwise, codes
     equal): the inputs of the pallas route's first and fourth B5 launches
     on the first 16,384-ray chunk of book 2 600x600, of its first launch
     on a 65,536-ray Cornell chunk, and on each chunk of the first launch
     after each of its two compactions (tools/ab_kernels.py B5_CASES,
     b5_launches); the launch rule's lane group G, threads and staging,
     live against padded records per ray, the kernel (CUDA events) and its
     alternatives (every G, whole table and tiles, 64 to 1,024 threads a
     block, each bitwise too), the plain version and the xla route's dense
     sweep timed, the bound (the operations of the tests this launch's data
     takes) at the data sheet's rates and at the measured ceilings;
 11. the v3 state-passing kernel B4 vs its plain version, bitwise, on one
     pass of Cornell 600x600 depth 50 camera rays (Cornell's instance),
     timed, bound;
 12. the non-kernel main paths: app.main --backend pallas on Cornell
     600x600 4 spp and book 2 600x600 1 spp (B5 launches > 0, no other
     kernel, means in their bands), with where a pallas Cornell sample
     spends its time; the ellipsoid scene through app.main --backend auto
     (the dense route, no kernel), and at 64x64 on the card against the
     CPU; integrator.render_sample with use_megakernel (B4) on Cornell
     600x600, 16 samples, depth 50, its mean against v4's;
 13. B1's options against the plain versions on book 2: v4 on the block
     layout with wave_frac 0.5 (600x600, 2 spp, depth 50) bitwise, timed,
     bound from the tests the plain run counted; one B4 pass of its camera
     rays bitwise; B3 (64x64, 4 spp, depth 50, hash and table noise) within
     1e-3 of the largest cotangent with the same replayed bounces; table noise (noise_impl
     "table", 200x200, 2 spp) in v4 and in the wavefront's K=2 and K=16
     launches bitwise;
 14. this slice's main paths, launch counts reset before each and read
     after: v4 forced (mega_wavefront=False) through
     integrator.render_progressive on book 2 600x600 16 spp, bitwise phase
     4's image; table noise through render_progressive (the wavefront) and
     through grad.value_and_grad_scene (wavefront + B3), book 2 600x600;
 15. where the final B2 and B3 spend their time (tools/profile_wavefront.py,
     tools/profile_grad.py): the step's per-phase clock split over a book-2
     batch, its share of warp-steps with mixed visit orders, its variants
     (sort, step, nosweep, linear) on two launches; B3's forward, pre-pass
     and full times on Cornell 600x600 64 spp and book 2 64x64 4 spp;
 16. the card's ceilings of phase 10 (FMA, separate multiply and add,
     murmur mix, copy) and where the final v4, B4 and B5 spend their time
     (tools/roofline.py --mode split: v4 on Cornell 600x600 6 spp and on
     book 2's block layout, one B4 Cornell pass, B5 at phase 10's
     launches; idle-lane shares, B5's resident warps per SM);
 17. B1's last option, the threaded-BVH sweep (RT2_SWEEP_MODE=bvh), in the
     bvh instances of v4, the wavefront step, B4 and B3 on book 2: each
     against its plain version in "bvh" mode (v4 on both layouts, the
     step's K=2 and K=16 launches on captured states and one B4 pass
     bitwise, B3 at 64x64 4 spp within 1e-3 with the same replayed
     bounces), the BVH walk's slab and record tests per bounce against the
     cluster skip's and the bound from them, each timed in turns with
     "hier"; the "bvh" image at 16 spp against the "hier" one (at most
     0.01 % of pixels: exact ties); the main paths in "bvh" mode, launch
     counts set to 0 before each and read after: v4 forced through
     render_progressive, the book-2 CLI (in turns with "hier"), the
     Renderer, value_and_grad_scene, B4 through render_sample;
 18. the port's bench, python -m raytrace2_tpu_torch.tools.bench and
     ... --grad as subprocesses: each last line one JSON object with the
     JAX bench's keys and metric names;
 19. resume through app.main --checkpoint on the kernel path: Cornell
     600x600, 4 + 4 samples bitwise the one-shot 8;
 20. one JSON line describing each kernel, with the options it carries
     (status, design), its built instances (registers, stack, spills,
     feature masks, the bvh instances; threads per SM of the main paths' v4
     and B4 instances),
     the splits of phases 15-16, and its bound (f32 operations counted from
     csrc/path_common.cuh, csrc/grad_adjoint.cuh and csrc/intersect_kernel.cu
     for the work this run's data took, or bytes moved, over the card's
     peak rates; beside it the same operations over the measured -fmad=false
     ceiling of phase 16), and the ceilings;
 21. the differentiable scan (grad.render_image's fallback) at full width:
     Cornell 600x600 depth 65 and the ellipsoid scene 600x600 depth 50, 1
     spp each, an L2 loss against a fixed target: forward and backward
     wall, peak device memory, every cotangent finite, no v4 or B3 launch;
     the card's scan gradient against the CPU's at 64x64 depth 8 (1e-3 of
     each group's largest cotangent, flipped paths out of the loss);
 22. the sharded paths (parallel/sharding.py) on the one card: a world of 1
     under NCCL (render_samples_sharded_mega Cornell 600x600 64 spp bitwise
     the Renderer's image; grad_sharded_auto at 64 spp against
     value_and_grad_scene, one B3 launch), then two gloo ranks on cuda:0
     (parallel.dryrun.run_ranks): Cornell 600x600 16 spp at meshes (1, 2)
     bitwise and (2, 1) within 1e-6 relative, book 2 at (1, 2) through the
     wavefront bitwise, book 2 at (1, 2) through v4 forced (the block-tiled
     layout with wave regeneration) bitwise, grad_sharded_auto at (1, 2)
     under B3's gate; the second dp rank's slots start at camv[25] > 0 in
     v4, the wavefront step and B3. On the same ranks the non-kernel
     drivers: train_step_analog with use_pallas (render_samples_sharded
     through B5) on Cornell 600x600 depth 50, 1 spp, against the
     single-device pallas route, and render_grad_sharded (the scan) on
     Cornell 64x64 depth 8 against value_and_grad_scene's scan under B3's
     gate. Last the dry run's entry point, python -m
     raytrace2_tpu_torch.parallel.dryrun, as two gloo ranks on cuda:0 and
     under torchrun as a world of 1 under NCCL;
 23. the live CLI: app.main --live --live-cols 80 on Cornell 600x600 16 spp
     (one ANSI frame per launch, the PNG of the run without --live), and
     --profile DIR (a Chrome trace whose kernel events name each v4
     launch).
 24. the sphere BVH's main paths through app.main at 600x600, 1 spp, depth
     50: book 1 --backend bvh, book 2 --backend xla (the walk from 256
     spheres on) and the 5,000-sphere grid through auto (above 4,096
     records); the walk (csrc/bvh_traverse.cu) launches and no other
     kernel; on each path's first and fourth launches the walk's hits
     against the dense sweep's, the float64 roots deciding; each path's
     image at 48x48, 2 spp, depth 8 against the dense sweep's;
 25. the walk against its plain version, bitwise, on those launches (book
     1's 65,536-ray chunk and book 2's 16,384-ray chunk among them), timed
     beside the plain walk and the dense sphere sweep, with its bound;
 26. RAYTRACE2_DOUBLE=1, then 0, in subprocesses: the corpus Cornell on the
     non-kernel path at 64x64 card against CPU, and one 600x600 sample
     timed;
 27. the tools: tools.validate (the golden gate on renders/
     cornell32k_mega.npy and the throughput ladder at 2 spp),
     check_table_grad, bench_big_grad (book 2 600x600, 4 spp) and
     sweep_wavefront (book 2 600x600, the production schedule at K=2 and
     K=4: the same image).
Phases 21-27 run after phase 19 and before the kernels line of phase 20,
whose JSON also carries their numbers (the walk's entry, bvh_traverse,
beside the kernels).
The last line is {"ok": true, "device": {...}}. Any failure exits non-zero
before printing it, as does a machine without CUDA or a directory without
the package.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# Cornell mean linear radiance at 64 spp (sqrt_spp 8), depth 50. The scene
# of tools/make_scene.py cornell_box_original has a larger light (330x305 of
# radiance 7) than the reference corpus file whose telltale is 0.159-0.160;
# the JAX package renders this scene to 0.5373 (64x64) and 0.5358 (120x120)
# on its XLA path with the kernel's RNG streams. See PERF.md.
CORNELL_MEAN_BAND = (0.52, 0.55)
MATCH_MEAN, MATCH_PSNR = 1e-3, 45.0
# Book 2 at 64 spp against the same scene's 16-spp render: the same
# estimator, so the means agree to Monte-Carlo noise (well under 10 %).
BOOK2_MEAN_RTOL = 0.10
# H100 SXM peaks (NVIDIA data sheet, 700 W): f32 outside the tensor cores,
# and device memory.
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# f32 arithmetic operations (add, sub, mul, div, sqrt, compare, min/max) of
# one closest-hit test per record family and of one bounce's shading,
# counted from csrc/path_common.cuh (closest_hit, bounce). Integer hashing,
# selects and the camera ray are not counted, so the bound is a low one.
OPS_PER_RECORD = {"sph": 35, "quad": 46, "box": 28, "med": 85}
OPS_SHADE = 120
# f32 operations of one slab test of a cluster's or supercluster's AABB
# (could_hit in csrc/path_common.cuh: 6 sub, 6 mul, 6 min/max per axis, 4 to
# combine, 1 max with t_min, 2 compares).
OPS_AABB = 25
# The gradient kernel replays each bounce after its pre-pass (the forward's
# sweep and shade): the winner's record test, the shade again, and the
# adjoint — 60 f32 operations for a Lambertian quad hit, the cheapest case,
# counted from csrc/grad_adjoint.cuh (bounce_adjoint, resolve_adjoint).
OPS_ADJOINT = 60
# f32 operations of one noise evaluation, counted from csrc/path_common.cuh:
# perlin_noise 121 (3 floor, 3 fraction, 12 Hermite weights, 7 weight
# complements, 12 per lattice corner x 8; the TableLattice gathers are
# integer work), turbulence 7 x (121 + 6) + 1, noise_factor's marble 6 and
# Perlin 5 around them, and 3 to scale the albedo.
OPS_NOISE = {"marble": 7 * (121 + 6) + 1 + 6 + 3, "perlin": 3 + 121 + 2 + 3}
# The non-kernel path's chunk on Cornell (render.py CHUNK_SIZE; B5's launch
# shapes are tools/ab_kernels.py B5_CASES).
CHUNK_CORNELL = 65536
# Book 2's mean linear radiance at 600x600, 64 spp, depth 50 on the card
# through the kernel path (PERF.md, the wavefront main path); its pallas
# render at 4 spp is the same estimator on other streams.
BOOK2_MEAN_64 = 0.4436
# Gate of B3 against its plain version, per leaf group: float atomics sum in
# another order than autograd.
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6
# Gate of a sharded non-kernel render against one device (JAX's
# test_sharding tolerance): its shards trace other batches of rays.
PALLAS_RTOL, PALLAS_ATOL = 2e-4, 2e-5
# The gradient main path (bench.py --grad): 64 samples per dispatch,
# sqrt_spp 2, depth 50.
GRAD_SPP, GRAD_SQRT_SPP, GRAD_DEPTH = 64, 2, 50
# Slots of the captured wavefront states on which the flat sweep's launches
# are held bitwise against the plain step.
FLAT_SLICE = 32768
# GPU cycles the stream spins before a timed run of launches (about 25 ms),
# so that the host queues the launches meanwhile and the events bracket
# back-to-back kernels, not the host's pace (tools/roofline.py).
QUEUE_AHEAD_CYCLES = 50_000_000
B5_DESIGN = ("live record extents; one ray's sweep split over a group of G lanes of a warp, "
             "reduced to the lexicographic minimum of (t, code) by shuffles; records staged "
             "as float4 planes in shared memory, the whole live table once per block where "
             "it fits, else in tiles; blocks down to 128 threads where the grid has fewer "
             "blocks than SMs (the route's compacted launches)")
# The designs of B1 and B4 (csrc/megakernel_v4.cu, csrc/megakernel_v3.cu).
V4_DESIGN = ("instant regeneration: persistent blocks (at most 6 resident blocks an SM x "
             "the SMs) with per-lane pixel fetch from a device counter, one instance per "
             "scene feature mask; wave regeneration: the parent's per-tile lockstep with "
             "every feature")
V3_DESIGN = ("on scenes without a clustered family: live rays compacted into the first warps "
             "of their block through shared memory, one instance per scene feature mask; "
             "else the parent's pass with every feature")

# Closed-form scenes (phase 3): JSON and the exact linear radiance.
CLOSED = [
    ("enclosure", {"background_color": [0, 0, 0],
                   "camera": {"fov": 90, "center": [0, 0, 0], "look_at": [0, 0, -1]},
                   "materials": [{"type": "diffuse_light", "albedo": [2.0, 3.0, 4.0]}],
                   "primitives": [{"type": "sphere", "center": [0, 0, 0],
                                   "radius": 10.0, "material": 0}]},
     [2.0, 3.0, 4.0]),
    ("lambertian_plane", {"background_color": [1.0, 0.8, 0.6],
                          "camera": {"fov": 40, "center": [0, 5, 0],
                                     "look_at": [0, 0, -10]},
                          "materials": [{"type": "lambertian", "albedo": [0.3, 0.5, 0.7]}],
                          "primitives": [{"type": "quad", "q": [-1000, 0, -1000],
                                          "u": [2000, 0, 0], "v": [0, 0, 2000],
                                          "material": 0}]},
     [0.3 * 1.0, 0.5 * 0.8, 0.7 * 0.6]),
    ("aa_box", {"background_color": [0, 0, 0],
                "camera": {"fov": 90, "center": [0, 0, 0], "look_at": [0, 0, -1]},
                "materials": [{"type": "diffuse_light", "albedo": [1.5, 2.5, 3.5]}],
                "primitives": [{"type": "box", "a": [-5, -5, -5], "b": [5, 5, 5],
                                "material": 0}]},
     [1.5, 2.5, 3.5]),
]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


@contextlib.contextmanager
def flat_sweep():
    """Inside: every family sweeps flat, in record order (the cluster tables
    are left out of the packed buffer and the kernels' counts), the sweep
    the port ran before the cluster skip. For A/B timings and the image
    check only; no user-facing option selects it."""
    from raytrace2_tpu_torch.ops.kernels import megakernel as mk

    orig = mk.hier_flags
    mk.hier_flags = lambda sizes: (False, False)
    try:
        yield
    finally:
        mk.hier_flags = orig


@contextlib.contextmanager
def sweep_mode(mode):
    """Inside: megakernel.SWEEP_MODE is ``mode``, as RT2_SWEEP_MODE=``mode``
    sets it at import: tables packed and build targets chosen inside take
    that mode's layout and instances."""
    from raytrace2_tpu_torch.ops.kernels import megakernel as mk

    orig = mk.SWEEP_MODE
    mk.SWEEP_MODE = mode
    try:
        yield
    finally:
        mk.SWEEP_MODE = orig


def sweep_ops(stats) -> int:
    """f32 operations of the bounces a plain run counted (``stats`` of
    megakernel.make_bounce): each record test by family, each AABB slab
    test, and the shading of each bounce."""
    return (sum(stats[f] * OPS_PER_RECORD[f] for f in OPS_PER_RECORD)
            + stats["aabb"] * OPS_AABB + stats["bounces"] * OPS_SHADE)


def main() -> None:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"needs numpy and torch: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    try:
        from test_torch_scenes import feature_scene_json

        from test_torch_scenes import GRAD_SCENES

        from raytrace2_tpu_torch import app, grad
        from raytrace2_tpu_torch.io import compare, image
        from raytrace2_tpu_torch.ops import camera, integrator
        from raytrace2_tpu_torch.ops.kernels import build
        from raytrace2_tpu_torch.ops.kernels import megakernel as mk
        from raytrace2_tpu_torch.ops.kernels import megakernel_grad as mkg
        from raytrace2_tpu_torch.ops.kernels import megakernel_v3 as mk3
        from raytrace2_tpu_torch.ops.kernels import wavefront as wf
        from raytrace2_tpu_torch.render import Renderer
        from raytrace2_tpu_torch.scene import loader, schema
        from raytrace2_tpu_torch.tools import check_table_grad, make_scene, optimize_scene
    except ImportError as e:
        fail(f"run from the root of a checkout of the repository: {e}")
    for name in ("jax", "raytrace2_tpu"):
        check(name not in sys.modules, f"{name} was imported")

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    # ---- phase 1: device ---------------------------------------------------
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi: {e}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say(f"phase 1 device: {kind} x{count}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    work = tempfile.mkdtemp(prefix="chip_smoke_")

    def scene_file(name: str, obj: dict) -> str:
        path = os.path.join(work, f"{name}.json")
        with open(path, "w") as f:
            json.dump(obj, f)
        return path

    # ---- phase 2: build ----------------------------------------------------
    # Every library the run reaches, one nvcc each, all started together:
    # the kernels, the instance of v4, B4 and the gradient kernel for each
    # scene feature mask the run meets, the profiling builds of the split
    # phases and the ceiling microkernels.
    cornell = scene_file("cornell", make_scene.cornell_box_original().to_json())
    book2 = scene_file("book2", make_scene.book2_final(rng_seed=0).to_json())
    feature = scene_file("feature", feature_scene_json())
    volume = scene_file("cornell_volume", make_scene.cornell_box_volume().to_json())
    v4, v3, b3 = "megakernel_v4", "megakernel_v3", "megakernel_grad"
    masks = {v4: {}, v3: {}, b3: {}}
    for name, path, table, kernels in [
            ("cornell", cornell, False, (v4, v3, b3)), ("book2", book2, False, (v4, v3, b3)),
            ("book2 (table noise)", book2, True, (v4, b3)), ("feature", feature, False, (v4,)),
            *((f"closed {n}", scene_file(n, obj), False, (v4,)) for n, obj, _ in CLOSED),
            *((f"grad_{k}", scene_file(f"grad_{k}", GRAD_SCENES[k]), False, (b3,))
              for k in ("solid", "noise", "media")),
            ("grad_noise (table noise)", os.path.join(work, "grad_noise.json"), True, (b3,)),
            ("cornell_corpus", scene_file("cornell_corpus",
                                          make_scene.cornell_box_corpus().to_json()), False,
             (v4,)),
            # The smoke-and-fog box: v4's quads-and-media instance.
            ("cornell_volume", volume, False, (v4,)),
            ("table_grad (table noise)", scene_file("table_grad", check_table_grad.NOISE_SCENE),
             True, (v4, b3))]:
        host = loader.load_scene(path)[0]
        f = host.features()
        ds = schema.to_device(host, "cpu")
        ntab = integrator.noise_tables(ds, dict(f, noise_impl="table")) if table else None
        packed = mk.pack_buffer(ds, f["mega_sizes"])
        args = (packed, f["mega_sizes"], f["has_checker"], f["has_noise"])
        for k in kernels:
            masks[k][name] = (mk3.instance_features(*args) if k == v3
                              else mk.scene_features(*args, ntab))
    grad_masks = masks[b3]
    targets = ["wavefront_step", "intersect_kernel", "bvh_traverse"]
    targets += sorted({build.feature_target(k, m) for k in masks for m in masks[k].values()})
    targets += ["wavefront_profile", *sorted({build.grad_target(grad_masks[k], True)
                                              for k in ("cornell", "book2")}),
                *(build.profile_target(masks[v4][k], masks[v3][k]) for k in ("cornell", "book2")),
                "intersect_profile", "roofline"]
    # The bvh instances of book 2's kernels (RT2_SWEEP_MODE=bvh; phase 17).
    with sweep_mode("bvh"):
        bvh_targets = [build.step_target(), build.feature_target(v4, masks[v4]["book2"]),
                       build.feature_target(v3, masks[v3]["book2"]),
                       build.grad_target(masks[b3]["book2"])]
    targets += bvh_targets
    t0 = time.perf_counter()
    build.build_all(targets)
    build_s = time.perf_counter() - t0
    say(f"phase 2 build: {len(targets)} libraries in {build_s:.1f} s, one nvcc each, all "
        f"started together (nvcc {' '.join(build.NVCC_FLAGS)}); instances by scene: "
        + "; ".join(f"{k} " + ", ".join(f"{n} {m}" for n, m in masks[k].items())
                    for k in masks))
    usage = {}
    for t in targets:
        key = build.target_key(t)
        usage[key] = build.ptxas_usage(key)
        for u in usage[key]:
            secs = build.BUILD_SECONDS.get(key)
            say(f"  {key} ({'cached' if secs is None else f'{secs:.1f} s'}): "
                f"{u['kernel'].split('(')[0]}: "
                f"{u['registers']} registers, {u['stack']} B stack, spills {u['spill_stores']}"
                f"/{u['spill_loads']} B")

    # ---- phase 3: closed forms through the kernel ---------------------------
    for name, obj, want in CLOSED:
        scene, _ = loader.load_scene(scene_file(name, obj))
        for backend, module in (("auto", mk), ("wavefront", wf)):
            before = module.LAUNCHES
            img = Renderer(scene, 32, 32, num_samples=3, max_depth=4, backend=backend,
                           device=dev).render(batch=3)
            check(module.LAUNCHES > before, f"{name} ({backend}): the kernel was not launched")
            err = float(np.max(np.abs(img / np.asarray(want) - 1.0)))
            check(err <= 1e-5, f"{name} ({backend}): relative error {err:.3g} > 1e-5")
            say(f"phase 3 closed form {name} through {module.__name__.rsplit('.', 1)[1]}: "
                f"max relative error {err:.3g} (rtol 1e-5) ok")
        # The scene's own v4 instance against its plain version, bitwise.
        f = scene.features()
        ds = schema.to_device(scene, dev)
        camv = camera.make_camv(scene.camera, 32, 32, 0, 3, 1, 0).to(dev)
        args = (camv, 0, mk.pack_buffer(ds, f["mega_sizes"]), ds.background)
        kw = dict(n_pix=1024, max_depth=4, sizes=tuple(f["mega_sizes"]),
                  has_checker=f["has_checker"], has_noise=f["has_noise"])
        kern = mk.trace_megakernel_batch(*args, **kw)
        check(torch.equal(kern, mk.trace_plain(*args, **kw)),
              f"{name}: v4 instance {masks[v4]['closed ' + name]} differs from its plain version")
        say(f"phase 3 closed form {name}: v4 instance {masks[v4]['closed ' + name]} bitwise "
            f"equal to its plain version")

    # ---- phase 4: kernel vs plain on the card --------------------------------
    def prepare(path, w, h, spp, depth, table=False):
        """Inputs of a kernel call at w x h, spp samples: (camv, seed, packed,
        background) and the keywords; with ``table`` the ntab operand of
        table noise."""
        scene, _ = loader.load_scene(path)
        feats = scene.features()
        sizes = tuple(feats["mega_sizes"])
        ds = schema.to_device(scene, dev)
        packed = mk.pack_buffer(ds, sizes)
        camv = camera.make_camv(scene.camera, w, h, 0, spp, max(int(spp ** 0.5), 1), 0).to(dev)
        kw = dict(n_pix=w * h, max_depth=depth, sizes=sizes,
                  has_checker=feats["has_checker"], has_noise=feats["has_noise"])
        if table:
            kw["ntab"] = integrator.noise_tables(ds, dict(feats, noise_impl="table"))
        return (camv, 0, packed, ds.background), kw

    def with_types(kw, args):
        """``kw`` with the scene's material types, read once as the renderer
        reads them, so that a timed v4 launch does no host read."""
        return dict(kw, mat_types=mk.material_types(args[2], kw["sizes"]))

    def timed(fn, reps):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end) / reps

    results = {}
    cases = [("cornell 600x600 4spp depth 8", cornell, 600, 4, 8, 1),
             ("feature 256x256 4spp depth 8", feature, 256, 4, 8, 1),
             ("cornell 600x600 6spp depth 50 (main-path launch)", cornell, 600, 6, 50, 5),
             ("cornell_volume 600x600 20spp depth 50 (volume cell's batch)", volume, 600, 20,
              50, 5)]
    kept = {}
    for label, path, size, spp, depth, reps in cases:
        args, kw = prepare(path, size, size, spp, depth)
        kw = with_types(kw, args)
        mk.trace_megakernel_batch(*args, **kw)  # warm-up (and first launch)
        torch.cuda.synchronize()
        kern, ms = timed(lambda: mk.trace_megakernel_batch(*args, **kw), reps)
        by_plain = torch.zeros(2, dtype=torch.int64, device=dev)
        plain, plain_ms = timed(lambda: mk.trace_plain(*args, tally=by_plain, **kw), 1)
        kept[label] = (args, kw, spp, plain, by_plain)
        n_bits = int((kern != plain).any(-1).sum())
        k = kern.cpu().numpy() / spp
        p = plain.cpu().numpy() / spp
        check(np.isfinite(k).all(), f"{label}: kernel output not finite")
        d_mean = abs(float(k.mean() - p.mean()))
        psnr = compare.psnr(k, p)
        max_err = float(np.max(np.abs(k - p)))
        n_diff = int((np.abs(k - p).max(-1) > 1e-4).sum())
        mask = mk.scene_features(args[2], kw["sizes"], kw["has_checker"], kw["has_noise"],
                                 mat_types=kw["mat_types"])
        say(f"phase 4 kernel vs plain, {label}, instance {mask}: |dmean| {d_mean:.3g}, PSNR "
            f"{psnr:.2f} dB, max abs err {max_err:.3g}, pixels differing >1e-4: {n_diff}, "
            f"in any bit: {n_bits} of {size * size}; kernel {ms:.3f} ms, plain "
            f"{plain_ms:.1f} ms ({card})")
        check(d_mean < MATCH_MEAN and psnr >= MATCH_PSNR,
              f"{label}: kernel disagrees with its plain version")
        check(n_bits == 0, f"{label}: {n_bits} slots differ from the plain version")
        results[label] = dict(max_abs_err=max_err, psnr=psnr, ms=ms, plain_ms=plain_ms)

    def ops_per_bounce(sizes):
        n_sph, n_quad, _, _, n_med, n_box = sizes
        return (n_sph * OPS_PER_RECORD["sph"] + n_quad * OPS_PER_RECORD["quad"]
                + n_box * OPS_PER_RECORD["box"] + n_med * OPS_PER_RECORD["med"] + OPS_SHADE)

    # The volume box's batch once more through the launch wrapper with v4's
    # counter: the plain version's image and counts; its bound from those
    # segments.
    label = cases[3][0]
    args, kw, spp, plain, by_plain = kept[label]
    camv, seed, packed, background = args
    tally = torch.zeros(2, dtype=torch.int64, device=dev)
    counted_img = torch.empty((kw["n_pix"], 3), dtype=torch.float32, device=dev)
    build.launch_megakernel_v4(
        camv, seed, background, packed, None, counted_img, n_pix=kw["n_pix"],
        max_depth=kw["max_depth"], counts=mk.counts(kw["sizes"]),
        checker_depth=int(kw["has_checker"]), has_noise=bool(kw["has_noise"]),
        features=mk.scene_features(packed, kw["sizes"], kw["has_checker"], kw["has_noise"],
                                   mat_types=kw["mat_types"]), tally=tally)
    counted = tally.tolist()
    check(torch.equal(counted_img, plain),
          f"{label}: the counted launch differs from the plain version")
    check(counted == by_plain.tolist(),
          f"{label}: v4 counted {counted} (segments, medium scatters), the plain version "
          f"{by_plain.tolist()}")
    vol_ops = counted[0] * ops_per_bounce(kw["sizes"])
    vol_bytes = 12 * kw["n_pix"] + args[2].numel() * 4
    results[label]["bound_ms"] = max(vol_ops / PEAK_F32_OPS, vol_bytes / PEAK_BYTES) * 1e3
    say(f"phase 4 v4 counter, {label}: {counted[0]} segments "
        f"({counted[0] / (kw['n_pix'] * spp):.4f} per path), {counted[1]} medium scatters "
        f"(share {counted[1] / counted[0]:.4f}), equal to the plain version's, image bitwise; "
        f"bound {ops_per_bounce(kw['sizes'])} f32 ops a segment = {vol_ops:.4g} ops -> "
        f"{results[label]['bound_ms']:.4f} ms against {results[label]['ms']:.3f} ms ({card})")

    def n_rays_of(n_pix):
        return -(-n_pix // wf.SLOT_TILE) * wf.SLOT_TILE

    def gate(label, k, p):
        check(np.isfinite(k).all(), f"{label}: kernel output not finite")
        d_mean = abs(float(k.mean() - p.mean()))
        psnr = compare.psnr(k, p)
        max_err = float(np.max(np.abs(k - p)))
        check(d_mean < MATCH_MEAN and psnr >= MATCH_PSNR,
              f"{label}: kernel disagrees with its plain version "
              f"(|dmean| {d_mean:.3g}, PSNR {psnr:.2f} dB)")
        return d_mean, psnr, max_err

    wf_cases = [("cornell 600x600 4spp depth 8 (wavefront forced)", cornell, 600, 4, 8),
                ("book2 64x64 2spp depth 4", book2, 64, 2, 4)]
    for label, path, size, spp, depth in wf_cases:
        args, kw = prepare(path, size, size, spp, depth)
        kw.pop("n_pix")
        n_pix = size * size
        t0 = time.perf_counter()
        kern = wf.trace_wavefront_batch(*args, n_rays=n_rays_of(n_pix), **kw)[:n_pix]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        plain = wf.trace_wavefront_batch(*args, n_rays=n_rays_of(n_pix), step=wf.step_plain,
                                         **kw)[:n_pix]
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        k, p = kern.cpu().numpy() / spp, plain.cpu().numpy() / spp
        d_mean, psnr, max_err = gate(label, k, p)
        say(f"phase 4 wavefront kernel vs plain step, {label}: |dmean| {d_mean:.3g}, "
            f"PSNR {psnr:.2f} dB, max abs err {max_err:.3g}; whole batch with the kernel "
            f"{ms:.1f} ms, with the plain step {plain_ms:.1f} ms ({card})")

    # B1's bound at its main-path launch shape: bounces counted by the plain
    # version (single steps of the same per-slot semantics).
    args, kw = prepare(cornell, 600, 600, 6, 50)
    n_pix = kw.pop("n_pix")
    state = wf.init_wavefront_state(n_rays_of(n_pix), args[0].tolist(), dev)
    v4_bounces = 0
    while (c := int(wf.runnable(state, 6.0).sum())) > 0:
        v4_bounces += c
        state = wf.step_plain(state, *args, k_bounces=1, **kw)
    v4_ops = v4_bounces * ops_per_bounce(kw["sizes"])
    v4_bytes = 12 * n_pix + args[2].numel() * 4
    results[cases[2][0]]["bound_ms"] = max(v4_ops / PEAK_F32_OPS, v4_bytes / PEAK_BYTES) * 1e3
    say(f"phase 4 v4 bound at the main-path launch: {v4_bounces} bounces "
        f"({v4_bounces / (n_pix * 6):.3f} per path) x {ops_per_bounce(kw['sizes'])} f32 ops "
        f"= {v4_ops:.4g} ops, {v4_bytes} B -> {results[cases[2][0]]['bound_ms']:.4f} ms "
        f"(by operations, 67 TFLOP/s f32)")

    # The wavefront at its main path's launch shape (book 2 600x600, depth
    # 50, the CLI's 6-sample batch): one batch with every launch, sort and
    # runnable count timed by CUDA events, and the state captured before a
    # K=2 launch and before the first K=16 tail launch.
    args, kw = prepare(book2, 600, 600, 6, 50)
    n_pix = kw.pop("n_pix")
    n_rays = n_rays_of(n_pix)
    ev = {"step2": [], "step16": [], "sort": [], "count": []}
    captured = {}

    def timed(fn, bucket):
        def run(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            ev[bucket(k) if callable(bucket) else bucket].append((start, end))
            return out
        return run

    def capture_step(state, *a, k_bounces, **k):
        tag = f"k{k_bounces}"
        if tag not in captured and (k_bounces != wf.K_BOUNCES or len(ev["step2"]) == 4):
            captured[tag] = state.clone()
        return wf.wavefront_step(state, *a, k_bounces=k_bounces, **k)

    orig_sort, orig_count = wf.sort_state, wf.count_and_keys
    wf.sort_state = timed(orig_sort, "sort")
    wf.count_and_keys = timed(orig_count, "count")
    try:
        wf.trace_wavefront_batch(*args, n_rays=n_rays, **kw)  # warm-up
        for v in ev.values():
            v.clear()
        captured.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wf.trace_wavefront_batch(
            *args, n_rays=n_rays,
            step=timed(capture_step, lambda k: f"step{min(k['k_bounces'], 16)}"), **kw)
        torch.cuda.synchronize()
        batch_ms = (time.perf_counter() - t0) * 1e3
    finally:
        wf.sort_state, wf.count_and_keys = orig_sort, orig_count
    dev_ms = {b: sum(s_.elapsed_time(e_) for s_, e_ in v) for b, v in ev.items()}
    n2, n16 = len(ev["step2"]), len(ev["step16"])
    busy = sum(dev_ms.values())
    say(f"phase 4 where a book-2 batch goes (600x600, 6 spp, depth 50, {n2} K=2 + {n16} "
        f"K=16 launches, {len(ev['sort'])} sorts, {len(ev['count'])} keys launches, each "
        f"count read on the host after its pass's step is queued): wall {batch_ms:.2f} ms; "
        f"kernel {dev_ms['step2']:.2f} ms (K=2) + {dev_ms['step16']:.2f} ms (K=16); "
        f"argsort+gather {dev_ms['sort']:.2f} ms; keys and counts {dev_ms['count']:.2f} ms; "
        f"host gaps {batch_ms - busy:.2f} ms; per launch K=2 "
        f"{dev_ms['step2'] / max(n2, 1):.4f} ms, K=16 {dev_ms['step16'] / max(n16, 1):.4f} ms "
        f"({card})")
    check("k2" in captured and "k16" in captured, "no K=2 or K=16 launch to capture")

    # The keys kernel on those states: the keys and the runnable count bit
    # for bit those of the plain sort_keys and runnable.
    def check_keys_kernel(tag, st):
        bb = wf.scene_bounds(args[2], kw["sizes"])
        keys = torch.empty(n_rays, dtype=torch.int32, device=dev)
        count = torch.empty(1, dtype=torch.int32, device=dev)
        want_n = int(wf.runnable(st, 6.0).sum())
        wf.count_and_keys(st, 6.0, *bb, keys, count)
        n = int(count)
        n_diff = int((keys != wf.sort_keys(st, 6.0, *bb)).sum())
        check(n == want_n and n_diff == 0,
              f"keys kernel on the {tag} state: count {n} (plain {want_n}), "
              f"{n_diff} keys differ")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            build.launch_wavefront_keys(st, *bb, keys, count, regen_below=5.0)
        end.record()
        torch.cuda.synchronize()
        say(f"phase 4 keys kernel on the {tag} state (book2 600x600, {n_rays} slots): keys "
            f"and count bitwise the plain versions; "
            f"{start.elapsed_time(end) / 10:.4f} ms a launch ({card})")

    for tag, st in captured.items():
        check_keys_kernel(tag, st)

    # The same launches over the skip-free (flat) tables, timed in turns with
    # the cluster skip's (skip, flat, flat, skip), on the same captured states.
    with flat_sweep():
        args_flat, _ = prepare(book2, 600, 600, 6, 50)

    def launch_ms(st0, a, k, reps=3):
        ms = 0.0
        for _ in range(reps):
            st = st0.clone()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            wf.wavefront_step(st, *a, k_bounces=k, **kw)
            end.record()
            torch.cuda.synchronize()
            ms += start.elapsed_time(end) / reps
        return st, ms

    wf_launch = {}
    for tag, k in (("k2", wf.K_BOUNCES), ("k16", wf.TAIL_K)):
        st0 = captured[tag]
        times = {"skip": [], "flat": []}
        for which in ("skip", "flat", "flat", "skip"):
            if which == "flat":
                with flat_sweep():
                    st_flat, t = launch_ms(st0, args_flat, k)
            else:
                st, t = launch_ms(st0, args, k)
            times[which].append(t)
        ms = sum(times["skip"]) / 2
        flat_ms = sum(times["flat"]) / 2
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sp = wf.step_plain(st0.clone(), *args, k_bounces=k, stats=stats, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        max_err = float((st - sp).abs().max())
        n_diff = int(((st != sp).any(0)).sum())
        check(n_diff == 0, f"wavefront {tag} launch: {n_diff} slots differ from the plain step "
                           f"(max abs err {max_err:.3g})")
        n_flat_diff = int(((st != st_flat).any(0)).sum())
        check(n_flat_diff <= 1e-4 * n_rays, f"wavefront {tag} launch: the flat sweep's state "
                                            f"differs in {n_flat_diff} slots")
        # The flat sweep's launch bitwise against the plain step over the
        # flat tables, on the first FLAT_SLICE slots (slots are independent;
        # the plain flat sweep is too slow for the whole state here).
        with flat_sweep():
            st_fk = wf.wavefront_step(st0[:, :FLAT_SLICE].contiguous(), *args_flat,
                                      k_bounces=k, **kw)
            st_fp = wf.step_plain(st0[:, :FLAT_SLICE].contiguous(), *args_flat, k_bounces=k,
                                  **kw)
        torch.cuda.synchronize()
        n_fdiff = int(((st_fk != st_fp).any(0)).sum())
        check(n_fdiff == 0, f"wavefront {tag} launch over the flat tables: {n_fdiff} of "
                            f"{FLAT_SLICE} slots differ from the plain step")
        bounces = stats["bounces"]
        ops = sweep_ops(stats)
        flat_ops = bounces * ops_per_bounce(kw["sizes"])
        nbytes = 2 * 17 * 4 * n_rays + args[2].numel() * 4
        bound_ms = max(ops / PEAK_F32_OPS, nbytes / PEAK_BYTES) * 1e3
        bound_by = "operations" if ops / PEAK_F32_OPS >= nbytes / PEAK_BYTES else "bytes"
        wf_launch[tag] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=max_err,
                              bound_ms=bound_ms, bound_by=bound_by, flat_ms=flat_ms,
                              times_skip=times["skip"], times_flat=times["flat"],
                              aabb_per_bounce=stats["aabb"] / max(bounces, 1),
                              sph_per_bounce=stats["sph"] / max(bounces, 1),
                              box_per_bounce=stats["box"] / max(bounces, 1),
                              flat_bound_ms=max(flat_ops / PEAK_F32_OPS,
                                                nbytes / PEAK_BYTES) * 1e3)
        say(f"phase 4 wavefront {tag} launch at the main-path shape (book2 600x600, "
            f"{n_rays} slots): kernel {ms:.4f} ms with the cluster skip "
            f"({'/'.join(f'{t:.4f}' for t in times['skip'])}), {flat_ms:.4f} ms flat "
            f"({'/'.join(f'{t:.4f}' for t in times['flat'])}; in turns skip, flat, flat, "
            f"skip), plain step {plain_ms:.1f} ms; state bitwise equal to the plain step's "
            f"(flat: bitwise on {FLAT_SLICE} slots), {n_flat_diff} slots differ from the flat "
            f"sweep's; {bounces} bounces, per bounce "
            f"{stats['aabb'] / max(bounces, 1):.2f} AABB slab tests, "
            f"{stats['sph'] / max(bounces, 1):.2f} sphere and "
            f"{stats['box'] / max(bounces, 1):.2f} box record tests (flat: {kw['sizes'][0]} "
            f"and {kw['sizes'][5]}) -> {ops:.4g} f32 ops, {nbytes} B -> bound "
            f"{bound_ms:.4f} ms by {bound_by} (the flat sweep's count: "
            f"{wf_launch[tag]['flat_bound_ms']:.4f} ms) ({card})")

    # Wavefront vs v4 on book 2, bitwise, timed in turns (v4, wf, wf, v4),
    # with the cluster skip and then over the flat tables. v4 is forced as
    # JAX's mega_schedule would run it there: the block-tiled layout, wave
    # regeneration at 0.5 of a tile's in-image lanes.
    def book2_v4_wf(spp):
        (camv_, seed_, packed_, bg_), kw_ = prepare(book2, 600, 600, spp, 50)
        n_pix_ = kw_.pop("n_pix")
        camv_b = camera.make_camv(loader.load_scene(book2)[0].camera, 600, 600, 0, spp,
                                  max(int(spp ** 0.5), 1), 0, block=mk.BLOCK).to(dev)
        n_slots, slot_of_pixel = mk.pixel_slots(600, 600, block=True)
        slot_of_pixel = slot_of_pixel.reshape(-1).to(dev)

        types = mk.material_types(packed_, kw_["sizes"])

        def v4():
            return mk.trace_megakernel_batch(camv_b, seed_, packed_, bg_, n_pix=n_slots,
                                             block=True, wave_frac=0.5, mat_types=types,
                                             **kw_)[slot_of_pixel]

        def wavefront():
            return wf.trace_wavefront_batch(camv_, seed_, packed_, bg_,
                                            n_rays=n_rays_of(n_pix_), **kw_)[:n_pix_]
        return v4, wavefront

    runs, imgs = {}, {}
    for sweep in ("skip", "flat"):
        with flat_sweep() if sweep == "flat" else contextlib.nullcontext():
            v4_run, wf_run = book2_v4_wf(16)
            for which in ("v4", "wf", "wf", "v4"):
                out, t = wall_ms(v4_run if which == "v4" else wf_run)
                runs.setdefault((sweep, which), []).append(t)
                imgs[(sweep, which)] = out.cpu().numpy()
    for sweep in ("skip", "flat"):
        n_diff = int((imgs[(sweep, "v4")] != imgs[(sweep, "wf")]).any(-1).sum())
        check(n_diff == 0, f"book2 600x600 16spp depth 50 ({sweep}): the wavefront differs "
                           f"from v4 in {n_diff} pixels")
    n_flat = int((imgs[("skip", "wf")] != imgs[("flat", "wf")]).any(-1).sum())
    book2_mean16 = float(imgs[("skip", "wf")].mean() / 16)
    check(n_flat <= 1e-4 * 360000, f"book2 16 spp: {n_flat} pixels differ between the "
                                   f"cluster-skip and the flat sweep (more than exact ties)")
    check(abs(book2_mean16 / BOOK2_MEAN_64 - 1.0) < BOOK2_MEAN_RTOL,
          f"book2 16-spp mean {book2_mean16:.4f} vs {BOOK2_MEAN_64}")
    t_v4, t_wf = runs[("skip", "v4")], runs[("skip", "wf")]
    f_v4, f_wf = runs[("flat", "v4")], runs[("flat", "wf")]
    book2_16 = dict(v4_ms=t_v4, wf_ms=t_wf, v4_flat_ms=f_v4, wf_flat_ms=f_wf,
                    pixels_differing_from_flat=n_flat, mean=book2_mean16)
    say(f"phase 4 wavefront == v4 (block layout, wave_frac 0.5) bitwise, book2 600x600 16spp "
        f"depth 50, mean linear radiance {book2_mean16:.4f}: with the cluster skip v4 "
        f"{t_v4[0]:.1f}/{t_v4[1]:.1f} ms, wavefront {t_wf[0]:.1f}/{t_wf[1]:.1f} ms "
        f"({16 * 360000 / min(t_v4) / 1e3:.2f} vs {16 * 360000 / min(t_wf) / 1e3:.2f} "
        f"Mpaths/s); flat v4 {f_v4[0]:.1f}/{f_v4[1]:.1f} ms, wavefront {f_wf[0]:.1f}/"
        f"{f_wf[1]:.1f} ms ({16 * 360000 / min(f_v4) / 1e3:.2f} vs "
        f"{16 * 360000 / min(f_wf) / 1e3:.2f} Mpaths/s); the image with the skip differs "
        f"from the flat sweep's in {n_flat} of 360000 pixels (gate 0.01 %) ({card})")

    # ---- phase 5: main path through the CLI ----------------------------------
    out_png = os.path.join(work, "cornell.png")
    metrics = os.path.join(work, "metrics.jsonl")
    mk.LAUNCHES = wf.LAUNCHES = 0
    rc = app.main([cornell, out_png, "--samples", "64", "--depth", "50",
                   "--device", "cuda", "--metrics", metrics, "--quiet"])
    launches = mk.LAUNCHES
    check(rc == 0, f"app.main exited {rc}")
    check(launches > 0, "the main path launched no kernel")
    check(wf.LAUNCHES == 0, "the Cornell main path launched the wavefront kernel")
    with open(metrics) as f:
        done = [json.loads(line) for line in f][-1]
    with open(out_png, "rb") as f:
        png = image.decode_png(f.read())
    check(png.shape == (600, 600, 3), f"PNG shape {png.shape}")
    mean = done["mean_linear"]
    lo, hi = CORNELL_MEAN_BAND
    check(lo <= mean <= hi, f"Cornell mean linear radiance {mean:.4f} outside [{lo}, {hi}]")
    say(f"phase 5 main path: app.main Cornell 600x600 64 spp depth 50, {launches} kernel "
        f"launches, mean linear radiance {mean:.4f} in [{lo}, {hi}], "
        f"{done['mpaths_per_s']:.2f} Mpaths/s over {done['elapsed_s']:.3f} s on {card}")
    from test_torch_cuda import warm_and_cold_batches

    warm, cold, hits = warm_and_cold_batches(loader.load_scene(cornell)[0], 600, 50, dev)
    check(hits == 3, f"{hits} camera frame cache hits in 3 warm batches")
    check(torch.equal(warm, cold), "warm v4 batches differ from batches that read the camera")
    say(f"phase 5 warm v4 batches: Cornell 600x600 depth 50, 3 Renderer.update(64) under "
        f"sync debug mode 'error' raise nothing, {hits} frame cache hits, image bitwise a "
        f"renderer's whose cache is cleared before each batch ({card})")

    # ---- phase 6: the wavefront main path through the CLI ------------------
    out_png = os.path.join(work, "book2.png")
    metrics = os.path.join(work, "metrics_book2.jsonl")
    mk.LAUNCHES = wf.LAUNCHES = wf.SORTS = 0
    rc = app.main([book2, out_png, "--samples", "64", "--depth", "50",
                   "--device", "cuda", "--metrics", metrics, "--quiet"])
    wf_launches, wf_sorts, v4_launches = wf.LAUNCHES, wf.SORTS, mk.LAUNCHES
    check(rc == 0, f"app.main exited {rc}")
    check(wf_launches > 0 and wf_sorts > 0, "the book-2 main path did not run the wavefront")
    check(v4_launches == 0, "the book-2 main path launched the v4 kernel")
    with open(metrics) as f:
        done = [json.loads(line) for line in f][-1]
    check(done["kernel"] == "wavefront_step" and done["launches"] == wf_launches
          and done["sorts"] == wf_sorts, f"done record {done}")
    with open(out_png, "rb") as f:
        png = image.decode_png(f.read())
    check(png.shape == (600, 600, 3), f"PNG shape {png.shape}")
    mean = done["mean_linear"]
    check(np.isfinite(mean) and abs(mean / book2_mean16 - 1.0) < BOOK2_MEAN_RTOL,
          f"book2 mean linear radiance {mean:.4f} vs {book2_mean16:.4f} at 16 spp")
    say(f"phase 6 wavefront main path: app.main book2 600x600 64 spp depth 50, "
        f"{wf_launches} wavefront launches, {wf_sorts} sorts, {v4_launches} v4 launches, "
        f"mean linear radiance {mean:.4f} (16 spp: {book2_mean16:.4f}), "
        f"{done['mpaths_per_s']:.2f} Mpaths/s over {done['elapsed_s']:.3f} s on {card}")
    # The same CLI run with and without the cluster skip, in turns (the run
    # above, then flat, flat, skip).
    cli_mp = {"skip": [done["mpaths_per_s"]], "flat": []}
    for which in ("flat", "flat", "skip"):
        m = os.path.join(work, f"metrics_book2_{which}{len(cli_mp[which])}.jsonl")
        with flat_sweep() if which == "flat" else contextlib.nullcontext():
            rc = app.main([book2, os.path.join(work, "book2_ab.png"), "--samples", "64",
                           "--depth", "50", "--device", "cuda", "--metrics", m, "--quiet"])
        check(rc == 0, f"app.main ({which} sweep) exited {rc}")
        with open(m) as f:
            cli_mp[which].append([json.loads(line) for line in f][-1]["mpaths_per_s"])
    say(f"phase 6 book-2 CLI (64 spp) with and without the cluster skip, in turns: skip "
        f"{cli_mp['skip'][0]:.2f}, flat {cli_mp['flat'][0]:.2f}, flat {cli_mp['flat'][1]:.2f}, "
        f"skip {cli_mp['skip'][1]:.2f} Mpaths/s ({card})")

    # ---- phase 7: the gradient kernel vs its plain version ------------------
    def grad_args(path, size, spp, depth, sqrt_spp=None, table=False):
        (camv_, seed_, packed_, bg_), kw_ = prepare(path, size, size, spp, depth, table)
        if sqrt_spp is not None:
            camv_[23] = float(sqrt_spp)
        g = torch.from_numpy(np.random.RandomState(5).uniform(
            0.0, 1.0, (size * size, 3)).astype(np.float32)).to(dev)
        return (camv_, seed_, packed_, bg_.to(torch.float32).contiguous(), g), kw_

    def grad_gate(label, kern, plain, sizes):
        """Per leaf group: camv, background, each table family."""
        groups = [("camv", kern[0], plain[0]), ("background", kern[1], plain[1])]
        ck, cp = mk.unpack_buffer(kern[2], sizes), mk.unpack_buffer(plain[2], sizes)
        for fam, keys in mk.FAMILIES:
            groups.append((fam, torch.cat([ck[fam][k] for k in keys]),
                           torch.cat([cp[fam][k] for k in keys])))
        worst, parts = 0.0, []
        for name, a, b in groups:
            a, b = a.cpu().numpy(), b.cpu().numpy()
            check(np.isfinite(a).all(), f"{label}: B3 {name} cotangent not finite")
            err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
            check(err <= GRAD_RTOL * scale + GRAD_ATOL,
                  f"{label}: B3 {name} cotangent max|d| {err:.3g} vs max|g| {scale:.3g}")
            worst = max(worst, err)
            if scale > 0.0:
                parts.append(f"{name} {err:.3g}/{scale:.3g}")
        return worst, ", ".join(parts)

    def timed_grad(args, kw, reps):
        mkg.grad_call(*args, **kw)  # warm-up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            out = mkg.grad_call(*args, **kw)
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end) / reps

    for name, table in (("solid", False), ("noise", False), ("media", False),
                        ("noise", True)):
        label = f"grad_{name}{' (table noise)' if table else ''} 64x64 2spp depth 8"
        args, kw = grad_args(scene_file(f"grad_{name}", GRAD_SCENES[name]), 64, 2, 8,
                             table=table)
        kern, ms = timed_grad(args, kw, 3)
        count_k = torch.zeros(1, dtype=torch.int64, device=dev)
        count_p = torch.zeros(1, dtype=torch.int64, device=dev)
        mkg.grad_call(*args, bounces=count_k, **kw)
        t0 = time.perf_counter()
        plain = mkg.grad_plain(*args, bounces=count_p, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        _, detail = grad_gate(label, kern, plain, kw["sizes"])
        check(int(count_k) == int(count_p) > 0,
              f"{label}: B3 replayed {int(count_k)} bounces, the plain pre-pass {int(count_p)}")
        mask = mkg.grad_features(args[2], kw["sizes"], kw["has_checker"], kw["has_noise"],
                                 kw.get("ntab"))
        say(f"phase 7 B3 vs plain, {label}, instance {mask}: max|d|/max|g| per group: {detail} "
            f"(gate {GRAD_RTOL:g} max|g| + {GRAD_ATOL:g}); replayed bounces {int(count_k)} == "
            f"{int(count_p)}; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms ({card})")

    def grad_bound(bounces, sizes):
        ops = bounces * (ops_per_bounce(sizes) + OPS_PER_RECORD["quad"] + OPS_SHADE
                         + OPS_ADJOINT)
        return ops, ops / PEAK_F32_OPS * 1e3

    # At the main path's width: Cornell 600x600 depth 50, 2 spp, lanes chunked.
    label = "cornell 600x600 2spp depth 50"
    args, kw = grad_args(cornell, 600, 2, GRAD_DEPTH, GRAD_SQRT_SPP)
    count_k = torch.zeros(1, dtype=torch.int64, device=dev)
    count_p = torch.zeros(1, dtype=torch.int64, device=dev)
    mkg.grad_call(*args, **kw)  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    kern = mkg.grad_call(*args, bounces=count_k, **kw)
    end.record()
    torch.cuda.synchronize()
    ms2 = start.elapsed_time(end)
    t0 = time.perf_counter()
    plain = mkg.grad_plain(*args, bounces=count_p, **kw)
    torch.cuda.synchronize()
    plain_ms2 = (time.perf_counter() - t0) * 1e3
    b3_err, detail = grad_gate(label, kern, plain, kw["sizes"])
    check(int(count_k) == int(count_p), f"{label}: B3 replayed {int(count_k)} bounces, the "
                                        f"plain pre-pass {int(count_p)}")
    say(f"phase 7 B3 vs plain at the main path's width, {label}: {detail}; replayed bounces "
        f"{int(count_k)} (kernel) == {int(count_p)} (plain pre-pass); kernel {ms2:.3f} ms, "
        f"plain {plain_ms2:.1f} ms ({card})")

    # B3 alone at the main path's launch: 64 spp.
    args, kw = grad_args(cornell, 600, GRAD_SPP, GRAD_DEPTH, GRAD_SQRT_SPP)
    count_k.zero_()
    mkg.grad_call(*args, bounces=count_k, **kw)
    torch.cuda.synchronize()
    b3_bounces = int(count_k)
    _, b3_ms = timed_grad(args, kw, 3)
    b3_ops, b3_bound_ms = grad_bound(b3_bounces, kw["sizes"])
    b3_bytes = 12 * 360000 + 2 * args[2].numel() * 4 + 2 * 31 * 4
    b3_bound_ms = max(b3_bound_ms, b3_bytes / PEAK_BYTES * 1e3)
    say(f"phase 7 B3 at the main path's launch (cornell 600x600, {GRAD_SPP} spp, depth "
        f"{GRAD_DEPTH}): {b3_ms:.3f} ms (mean of 3); {b3_bounces} replayed bounces "
        f"({b3_bounces / (360000 * GRAD_SPP):.3f} per path) x "
        f"{ops_per_bounce(kw['sizes']) + OPS_PER_RECORD['quad'] + OPS_SHADE + OPS_ADJOINT} "
        f"f32 ops = {b3_ops:.4g} ops -> bound {b3_bound_ms:.4f} ms by operations "
        f"(67 TFLOP/s f32) ({card})")

    # ---- phase 8: the gradient main path ------------------------------------
    def float_leaves(tree):
        out = []
        schema.map_leaves(tree, lambda x: out.append(x) if x is not None else None)
        return out

    host, _ = loader.load_scene(cornell)
    feats = host.features()
    scene = schema.to_device(host, dev)
    render_kw = dict(width=600, height=600, n_samples=GRAD_SPP, max_depth=GRAD_DEPTH,
                     sqrt_spp=GRAD_SQRT_SPP)
    grad.value_and_grad_scene(torch.mean, scene, feats, 0, **render_kw)  # warm-up
    torch.cuda.synchronize()
    iters = 3
    mk.LAUNCHES = wf.LAUNCHES = mkg.LAUNCHES = 0
    t0 = time.perf_counter()
    for _ in range(iters):
        loss, g = grad.value_and_grad_scene(torch.mean, scene, feats, 0, **render_kw)
        albedo_g = g.materials.albedo.cpu()
    dt = time.perf_counter() - t0
    v4_grad_launches, b3_launches = mk.LAUNCHES, mkg.LAUNCHES
    check(v4_grad_launches == iters and b3_launches == iters and wf.LAUNCHES == 0,
          f"gradient main path launches: v4 {v4_grad_launches}, B3 {b3_launches}, "
          f"wavefront {wf.LAUNCHES} over {iters} gradients")
    lo, hi = CORNELL_MEAN_BAND
    check(lo <= float(loss) <= hi, f"Cornell gradient loss (mean radiance) {float(loss):.4f} "
                                   f"outside [{lo}, {hi}]")
    check(all(bool(torch.isfinite(x).all()) for x in float_leaves(g)),
          "Cornell gradient not finite")
    check(float(albedo_g.abs().max()) > 0.0, "Cornell albedo gradient is zero")
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(iters):
            float(torch.mean(grad.render_image(scene, feats, 0, **render_kw)))
    fwd_s = (time.perf_counter() - t0) / iters
    step_s = dt / iters
    paths = GRAD_SPP * 600 * 600
    say(f"phase 8 gradient main path: grad.value_and_grad_scene Cornell 600x600, {GRAD_SPP} "
        f"spp, depth {GRAD_DEPTH}, sqrt_spp {GRAD_SQRT_SPP}, loss mean = {float(loss):.4f}; "
        f"{iters} gradients, {v4_grad_launches} v4 + {b3_launches} B3 launches; fwd+bwd "
        f"{step_s * 1e3:.1f} ms per gradient (forward {fwd_s * 1e3:.1f} ms, backward "
        f"{(step_s - fwd_s) * 1e3:.1f} ms) on {card}")
    say(json.dumps({"metric": f"cornell600_fwdbwd_d{GRAD_DEPTH}_paths_per_sec",
                    "value": paths / step_s, "unit": "paths/s",
                    "mpaths_per_s": paths / step_s / 1e6,
                    "forward_ms": fwd_s * 1e3, "backward_ms": (step_s - fwd_s) * 1e3,
                    "device": card}))

    host, _ = loader.load_scene(book2)
    feats = host.features()
    scene = schema.to_device(host, dev)
    book2_kw = dict(width=600, height=600, n_samples=4, max_depth=GRAD_DEPTH, sqrt_spp=2)
    mk.LAUNCHES = wf.LAUNCHES = mkg.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, g = grad.value_and_grad_scene(torch.mean, scene, feats, 0, **book2_kw)
    leaves = float_leaves(g)
    torch.cuda.synchronize()
    book2_s = time.perf_counter() - t0
    check(wf.LAUNCHES > 0 and mkg.LAUNCHES == 1 and mk.LAUNCHES == 0,
          f"book-2 gradient launches: wavefront {wf.LAUNCHES}, B3 {mkg.LAUNCHES}, v4 "
          f"{mk.LAUNCHES}")
    check(all(bool(torch.isfinite(x).all()) for x in leaves), "book-2 gradient not finite")
    check(float(g.spheres.center0.abs().max()) > 0.0,
          "book-2 sphere-centre gradient is zero (its marble noise should give one)")
    say(f"phase 8 book-2 gradient: grad.value_and_grad_scene book2 600x600, 4 spp, depth "
        f"{GRAD_DEPTH}: loss {float(loss):.4f}, {wf.LAUNCHES} wavefront + {mkg.LAUNCHES} B3 "
        f"launches, every leaf finite, max |d center0| {float(g.spheres.center0.abs().max()):.3g}, "
        f"{book2_s * 1e3:.1f} ms ({card})")

    # ---- phase 9: inverse rendering -----------------------------------------
    out = io.StringIO()
    mkg.LAUNCHES = 0
    with contextlib.redirect_stdout(out):
        rc = optimize_scene.main([cornell, "--leaves", "materials.albedo", "--steps", "5",
                                  "--width", "600", "--height", "600", "--samples", "4",
                                  "--depth", "50", "--lr", "0.05", "--device", "cuda"])
    recs = [json.loads(line) for line in out.getvalue().splitlines()]
    check(rc == 0 and recs and recs[-1].get("event") == "done", f"optimize_scene: rc {rc}")
    losses = [r["loss"] for r in recs[:-1]]
    check(mkg.LAUNCHES == 5, f"optimize_scene launched B3 {mkg.LAUNCHES} times for 5 steps")
    check(losses[-1] < losses[0], f"optimize_scene loss did not fall: {losses}")
    say(f"phase 9 optimize_scene Cornell 600x600 materials.albedo, 4 spp, depth 50, 5 Adam "
        f"steps: loss {' -> '.join(f'{x:.3g}' for x in losses)} (improvement "
        f"{recs[-1]['improvement']}), rel_err {recs[0]['rel_err[materials.albedo]']} -> "
        f"{recs[-2]['rel_err[materials.albedo]']}")
    non_kernel, ceil = non_kernel_phases(dev, card, scene_file, cornell, book2,
                                         ops_per_bounce)
    book2_16["image"] = imgs[("skip", "wf")]
    b1 = b1_option_phases(dev, card, book2, book2_16)
    splits = split_phase(card, book2, cornell)
    roof = roofline_phase(card, ceil)
    bvh = bvh_phases(dev, card, work, book2, book2_16, wf_launch, captured, b1)
    bench = bench_phase(card)
    resume = resume_phase(card, cornell, work)
    walls = [time.perf_counter()]
    scan = scan_grad_phase(card, cornell, work)
    walls.append(time.perf_counter())
    sharded = sharded_phase(card, cornell, book2, work)
    walls.append(time.perf_counter())
    live = live_cli_phase(card, cornell, work)
    walls.append(time.perf_counter())
    say("phases 21-23 wall: " + ", ".join(f"{b - a:.1f} s" for a, b in zip(walls, walls[1:]))
        + f", {walls[-1] - walls[0]:.1f} s together ({card})")
    walls = [time.perf_counter()]
    walk, bvh_paths = sphere_bvh_phases(dev, card, scene_file, book2)
    walls.append(time.perf_counter())
    double = double_phase(card)
    walls.append(time.perf_counter())
    tools = tools_phase(card, work)
    walls.append(time.perf_counter())
    say("phases 24-27 wall: " + ", ".join(f"{b - a:.1f} s" for a, b in zip(walls, walls[1:]))
        + f", {walls[-1] - walls[0]:.1f} s together ({card})")
    shutil.rmtree(work)
    for name in ("jax", "raytrace2_tpu"):
        check(name not in sys.modules, f"{name} was imported")

    def instance(key, mask=None):
        """ptxas usage of a built target's kernels, with the feature mask."""
        out = {"build": key, "usage": usage.get(key, [])}
        if mask is not None:
            out["features"] = mask
        return out

    def instances(kernel):
        """Every instance of ``kernel`` the run built, by feature mask."""
        return [instance(build.target_key(build.feature_target(kernel, m)), m)
                for m in sorted(set(masks[kernel].values()))]

    def bvh_instance(i, mask):
        """The bvh instance phase 2 built: bvh_targets[i] (step, v4, B4, B3)."""
        return dict(instance(build.target_key(bvh_targets[i]), mask), sweep="bvh")

    # ---- phase 20: the kernels ------------------------------------------------
    main_shape = results[cases[2][0]]
    k2, k16 = wf_launch["k2"], wf_launch["k16"]
    v4b = b1["v4_book2"]
    kernels = [{
        "name": "megakernel_v4", "route": "cuda",
        "source": "raytrace2_tpu_torch/csrc/megakernel_v4.cu",
        "replaces": "raytrace2_tpu/ops/pallas/megakernel.py:1786 (_render_kernel_v4)",
        "status": "ported, with the cluster-skip sweep (_hier_sweep), table Perlin (ntab) "
                  "and the block-tiled layout with wave regeneration; redesigned for Hopper "
                  "(design)",
        "design": V4_DESIGN,
        "launches": launches,
        "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"], "bound_by": "operations",
        "library_ms": None,
        "shape": "cornell 600x600, depth 50, 6 spp (the CLI's batch; no clustered family)",
        "book2_block": dict(v4b, shape="book2 600x600, depth 50, 2 spp, block layout, "
                                       "wave_frac 0.5 (ms, plain_ms, bound_ms)",
                            launches_forced=b1["v4_forced_launches"]),
        "book2_16spp_ms": {"skip": book2_16["v4_ms"], "flat": book2_16["v4_flat_ms"]},
        "instances": instances(v4) + [bvh_instance(1, masks[v4]["book2"])],
        "occupancy": {k: {x: roof[k][x] for x in ("features", "smem_bytes", "threads_per_sm")}
                      for k in ("v4_cornell", "v4_book2_block")},
        "split": {k: roof[k] for k in ("v4_cornell", "v4_book2_block")},
    }, {
        "name": "wavefront_step", "route": "cuda",
        "source": "raytrace2_tpu_torch/csrc/wavefront_step.cu",
        "replaces": "raytrace2_tpu/ops/pallas/wavefront_sorted.py:117 (_bounce_step_kernel)",
        "status": "ported, PR 3; PR 6 adds the cluster-skip sweep and table Perlin",
        "design": "one visit order per warp with the lane's own tie rule, 256-thread blocks",
        "launches": wf_launches,
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "library_ms": None,
        "shape": "book2 600x600, depth 50, 6 spp, a K=2 launch",
        "k16": k16, "k2_flat_ms": k2["flat_ms"],
        "launches_table_noise": b1["table_launches"],
        "table_noise_launch": b1["table_noise"],
        "cli_mpaths_per_s": cli_mp,
        "instances": [instance("wavefront_step"), bvh_instance(0, None)],
        "split": splits["wavefront"],
    }, {
        "name": "megakernel_grad", "route": "cuda",
        "source": "raytrace2_tpu_torch/csrc/megakernel_grad.cu",
        "replaces": "raytrace2_tpu/ops/pallas/megakernel_grad.py:350 (_grad_kernel)",
        "status": "ported, PR 4; PR 6 adds the cluster-skip winner search and the "
                  "table-Perlin adjoint",
        "design": "one instance per scene feature mask",
        "launches": b3_launches,
        "max_abs_err": b3_err,
        "ms": b3_ms, "plain_ms": plain_ms2,
        "bound_ms": b3_bound_ms, "bound_by": "operations",
        "library_ms": None,
        "shape": f"cornell 600x600, depth {GRAD_DEPTH}, {GRAD_SPP} spp (ms, bound_ms)",
        "plain_shape": f"cornell 600x600, depth {GRAD_DEPTH}, 2 spp (plain_ms, max_abs_err; "
                       f"the kernel there: {ms2:.3f} ms)",
        "book2_64x64_4spp": b1["b3_book2"],
        "instances": instances(b3) + [bvh_instance(3, masks[b3]["book2"])],
        "split": splits["grad"],
    }, *non_kernel]
    b5 = kernels[-2]
    b5.update(instances=[instance("intersect_kernel")],
              occupancy={k: {x: roof[k][x] for x in ("group", "threads_per_block", "staging",
                                                      "smem_bytes", "threads_per_sm",
                                                      "resident_warps_per_sm")}
                         for k in roof if k.startswith("b5_")},
              split={k: roof[k] for k in roof if k.startswith("b5_")})
    b4 = kernels[-1]
    b4.update(status=b4["status"] + "; redesigned for Hopper (design)", design=V3_DESIGN,
              instances=instances(v3) + [bvh_instance(2, masks[v3]["book2"])],
              occupancy={x: roof["v3_cornell_pass"][x]
                         for x in ("features", "smem_bytes", "threads_per_sm")},
              split=roof["v3_cornell_pass"])
    k2b = bvh["k2"]
    kernels.append({
        "name": "bvh_sweep", "route": "cuda",
        "source": "raytrace2_tpu_torch/csrc/path_common.cuh",
        "replaces": "raytrace2_tpu/ops/pallas/megakernel.py:500 (_bvh_sweep, over "
                    "_build_threaded_bvh :180)",
        "status": "ported: RT2_SWEEP_MODE=bvh builds the bvh instances of v4, the "
                  "wavefront step, B3 and B4 (off by default, as in JAX)",
        "design": "per-lane stackless walk of the threaded BVH over the 16-record clusters, "
                  "each lane on its own direction's threading (megakernel.threaded_bvh on the "
                  "host; csrc/path_common.cuh bvh_sweep)",
        "launches": bvh["main_paths"]["cli_launches"],
        "max_abs_err": k2b["max_abs_err"],
        "ms": k2b["ms"], "plain_ms": k2b["plain_ms"],
        "bound_ms": k2b["bound_ms"], "bound_by": k2b["bound_by"],
        "library_ms": None,
        "shape": "the wavefront step's bvh instance, book2 600x600 depth 50 6 spp, a K=2 "
                 "launch (launches: the book-2 CLI at 64 spp in bvh mode)",
        "hier_ms": k2b["hier_ms"], "k16": bvh["k16"], "v4_block": bvh["v4_block"],
        "b4_book2": bvh["b4_book2"], "b3_book2": bvh["b3_book2"],
        "forced_16spp": bvh["forced_16spp"], "cli": bvh["cli"],
        "main_paths": bvh["main_paths"],
        "instances": [bvh_instance(i, m) for i, m in enumerate(
            (None, masks[v4]["book2"], masks[v3]["book2"], masks[b3]["book2"]))],
    })
    kernels.append(walk)
    for k in kernels:
        # The same bound against the card's measured ceiling for code built
        # with -fmad=false (a multiply and an add issued apart; phase 16).
        if k["bound_by"] == "operations":
            k["bound_ms_fmad_false"] = k["bound_ms"] * PEAK_F32_OPS / ceil["mul_add_ops_per_s"]
    say(json.dumps({"kernels": kernels, "ceilings": ceil, "bench": bench, "resume": resume,
                    "scan_grad": scan, "sharded": sharded, "live_cli": live,
                    "bvh_paths": bvh_paths, "double": double, "tools": tools}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


def split_phase(card, book2, cornell) -> dict:
    """Phase 15: where the final B2 and B3 spend their time, by the
    profiling tools (raytrace2_tpu_torch/tools/profile_wavefront.py and
    profile_grad.py): the step's per-phase split over one book-2 batch
    (600x600, 6 spp, depth 50) and its variants on two of its launches;
    B3's forward, pre-pass and full times on Cornell 600x600 64 spp and
    book 2 64x64 4 spp."""
    from raytrace2_tpu_torch.tools import profile_grad, profile_wavefront

    prof = profile_wavefront.Profiler(book2, 600, 6, 50)
    sp = prof.batch_split()
    say(f"phase 15 B2 split, book2 600x600 6 spp depth 50, {sp['launches']} launches, the "
        f"profiled step (its image bitwise the production one's): per-thread cycles "
        + ", ".join(f"{k[:-6]} {v:.3f}" for k, v in sp.items() if k.endswith("_share"))
        + f"; warp-steps over a clustered family {sp['warp_steps']}, with mixed orders "
        f"{sp['mixed_order_share']:.3f}, orders per warp-step "
        f"{sp['mean_orders_per_warp_step']:.2f} ({card})")
    snaps, _, _ = prof.snapshots({3, 7})
    rows = []
    for i, (pre, srt, k) in sorted(snaps.items()):
        row = {"snapshot": i, **prof.time_snapshot(pre, srt, k, 3)}
        rows.append(row)
        say(f"phase 15 B2 launch {i} (K={k}, {row['runnable']} runnable): sort "
            f"{row['sort_ms']:.3f} ms, step {row['step_ms']:.3f}, nosweep "
            f"{row['nosweep_ms']:.3f}, linear {row['linear_ms']:.3f}, profiled "
            f"{row['profiled_ms']:.3f} ms ({card})")
    grads = []
    for path, res, spp in ((cornell, 600, GRAD_SPP), (book2, 64, 4)):
        r = profile_grad.profile(path, res, spp, GRAD_SQRT_SPP, GRAD_DEPTH, 2)
        grads.append(r)
        regs = {k: [(u["registers"], u["stack"]) for u in v] for k, v in r["ptxas"].items()}
        say(f"phase 15 B3 split, {os.path.basename(path)} {res}x{res} {spp} spp depth "
            f"{GRAD_DEPTH}, instance {r['features']}: forward {r['fwd_ms']:.3f} ms, pre-pass "
            f"{r['prepass_ms']:.3f} ms, full {r['full_ms']:.3f} ms (reverse "
            f"{r['reverse_ms']:.3f} ms), without its cotangent atomics "
            f"{r['full_no_atomics_ms']:.3f} ms, with its cotangents in device memory "
            f"{r['full_device_cot_ms']:.3f} ms; {r['bounces_per_path']:.3f} replayed bounces per "
            f"path; shared cotangent copy {r['shared_cot']}, {r['smem_bytes']} B of "
            f"shared memory per block, {r['threads_per_sm']} threads per SM; (registers, stack) "
            f"{regs} ({card})")
    return {"wavefront": {"batch": sp, "launches": rows}, "grad": grads}


def roofline_phase(card, ceil):
    """Phase 16: the card's ceilings (measured in phase 10) and where the
    final v4, B4 and B5 spend their time (raytrace2_tpu_torch/tools/
    roofline.py): the per-phase clock split of v4 at Cornell 600x600 6 spp
    and on book 2's block layout (2 spp), of one B4 Cornell pass, and of B5
    at its main-path launches, each profiled instance's results bitwise the
    production one's."""
    from raytrace2_tpu_torch.tools import roofline

    say(f"phase 16 ceilings: FMA chain {ceil['fma_ops_per_s'] / 1e12:.2f} TFLOP/s, a multiply "
        f"and an add apart (-fmad=false) {ceil['mul_add_ops_per_s'] / 1e12:.2f} TFLOP/s, murmur "
        f"mix {ceil['mix_ops_per_s'] / 1e12:.2f} T int ops/s, copy "
        f"{ceil['copy_bytes_per_s'] / 1e12:.3f} TB/s ({card})")
    roof = roofline.split(3)
    for name in ("v4_cornell", "v4_book2_block", "v3_cornell_pass",
                 *(k for k in roof if k.startswith("b5_"))):
        r = roof[name]
        say(f"phase 16 split, {name} ({r['shape']}), "
            + (f"instance {r['features']}, " if "features" in r else
               f"G={r['group']}, {r['threads_per_block']} threads a block, {r['staging']} "
               f"table staged, {r['resident_warps_per_sm']:.1f} resident warps per SM, "
               f"{r['records_tested_per_ray']} records tested per ray of "
               f"{r['padded_records']} padded, ")
            + f"{r['threads_per_sm']} threads per SM: production {r['ms']:.4f} ms, profiled "
            f"{r['profiled_ms']:.4f} ms (bitwise); thread-cycle shares "
            + ", ".join(f"{k[:-6]} {v:.3f}" for k, v in r.items() if k.endswith("_share"))
            + f" ({card})")
    say(f"phase 16 ptxas: {json.dumps(roof['ptxas'])}")
    return roof


def event_ms(fn, reps):
    """(last result, mean ms per call) of ``reps`` calls timed by CUDA events,
    queued behind a device spin (QUEUE_AHEAD_CYCLES)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def wall_ms(fn):
    """(result, ms) of one call by the host clock, synchronised."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def b1_option_phases(dev, card, book2, book2_16) -> dict:
    """Phases 13-14: B1's options — the cluster skip, the block-tiled layout
    with wave regeneration, table Perlin — in every kernel that shares
    path_common.cuh. Phase 13 holds each kernel against its plain version
    on the card; phase 14 drives this slice's own main paths on book 2 (v4
    forced, table noise forward and gradient), each with the launch counts
    set to 0 before it and read after. Returns what the kernels line
    reports."""
    import numpy as np
    import torch

    from raytrace2_tpu_torch import grad
    from raytrace2_tpu_torch.ops import camera, integrator, rng
    from raytrace2_tpu_torch.ops.kernels import megakernel as mk
    from raytrace2_tpu_torch.ops.kernels import megakernel_grad as mkg
    from raytrace2_tpu_torch.ops.kernels import megakernel_v3 as mk3
    from raytrace2_tpu_torch.ops.kernels import wavefront as wf
    from raytrace2_tpu_torch.scene import loader, schema

    host, _ = loader.load_scene(book2)
    feats = host.features()
    sizes = tuple(feats["mega_sizes"])
    ds = schema.to_device(host, dev)
    packed = mk.pack_buffer(ds, sizes)
    bg = ds.background.to(torch.float32).contiguous()
    base_kw = dict(max_depth=50, sizes=sizes, has_checker=feats["has_checker"],
                   has_noise=feats["has_noise"])
    types = mk.scene_material_types(ds.materials.mtype)
    out = {}

    # ---- phase 13a: v4 on the block layout with wave regeneration ----------
    spp = 2
    camv = camera.make_camv(host.camera, 600, 600, 0, spp, 1, 0, block=mk.BLOCK).to(dev)
    n_slots, _ = mk.pixel_slots(600, 600, block=True)
    kw = dict(base_kw, n_pix=n_slots, block=True, wave_frac=0.5, mat_types=types)
    mk.trace_megakernel_batch(camv, 0, packed, bg, **kw)  # warm-up
    kern, ms = event_ms(lambda: mk.trace_megakernel_batch(camv, 0, packed, bg, **kw), 3)
    stats = {}
    plain, plain_ms = wall_ms(lambda: mk.trace_plain(camv, 0, packed, bg, stats=stats, **kw))
    n_diff = int((kern != plain).any(-1).sum())
    check(n_diff == 0, f"v4 book2 block layout: {n_diff} slots differ from the plain version")
    ops = sweep_ops(stats)
    nbytes = 12 * n_slots + packed.numel() * 4
    bound_ms = max(ops / PEAK_F32_OPS, nbytes / PEAK_BYTES) * 1e3
    out["v4_book2"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, max_abs_err=0.0,
                           bounces=stats["bounces"],
                           aabb_per_bounce=stats["aabb"] / stats["bounces"],
                           sph_per_bounce=stats["sph"] / stats["bounces"],
                           box_per_bounce=stats["box"] / stats["bounces"])
    say(f"phase 13 v4 vs plain, book2 600x600 {spp} spp depth 50, block-tiled layout "
        f"({n_slots} slots) with wave_frac 0.5: bitwise equal; kernel {ms:.3f} ms (mean of "
        f"3), plain {plain_ms:.1f} ms; {stats['bounces']} bounces, per bounce "
        f"{stats['aabb'] / stats['bounces']:.2f} AABB slab tests, "
        f"{stats['sph'] / stats['bounces']:.2f} sphere and "
        f"{stats['box'] / stats['bounces']:.2f} box record tests -> {ops:.4g} f32 ops "
        f"-> bound {bound_ms:.4f} ms by operations ({card})")

    # ---- phase 13b: B4 on book 2 -----------------------------------------
    seed_lane = integrator.mega_seed_of(0, 0)
    pix = torch.arange(600 * 600, dtype=torch.int32, device=dev)
    u = rng.murmur_uniforms(seed_lane, pix, tuple(rng.CAMERA_CTR_BASE + k for k in range(5)))
    o, d, tm = camera.generate_rays(ds.camera, 600, 600, 0, 1, None, uniforms=u)
    pad = -o.shape[0] % mk3.TILE_R
    o = torch.nn.functional.pad(o, (0, 0, 0, pad))
    d = torch.nn.functional.pad(d, (0, 0, 0, pad), value=1.0)
    tm = torch.nn.functional.pad(tm, (0, pad))
    state, rid = mk3.init_state(o, d, tm)
    min_alive = mk3.TILE_R // 16
    b4_kw = dict(base_kw, mat_types=types)
    mk3.megakernel_pass(state, rid, seed_lane, min_alive, packed, bg, **b4_kw)  # warm-up
    (rad_k, new_k), b4_ms = event_ms(
        lambda: mk3.megakernel_pass(state, rid, seed_lane, min_alive, packed, bg, **b4_kw), 3)
    (rad_p, new_p), b4_plain_ms = wall_ms(
        lambda: mk3.pass_plain(state, rid, seed_lane, min_alive, packed, bg, **base_kw))
    check(torch.equal(rad_k, rad_p) and torch.equal(new_k, new_p),
          "B4 book2 pass: kernel and plain version differ")
    out["b4_book2"] = dict(ms=b4_ms, plain_ms=b4_plain_ms)
    say(f"phase 13 B4 vs plain, one pass of book2 600x600 camera rays (min_alive "
        f"{min_alive} of {mk3.TILE_R}), spheres and boxes through the cluster skip: radiance "
        f"and state bitwise; kernel {b4_ms:.3f} ms (mean of 3), plain {b4_plain_ms:.1f} ms "
        f"({card})")

    # ---- phase 13c: B3 with the cluster skip on book 2 -------------------
    # 64x64, 4 spp: the timed launches held against the plain replay, with
    # hash noise, and with table noise (the instance phase 14's gradient
    # runs).
    size, spp = 64, 4
    camv = camera.make_camv(host.camera, size, size, 0, spp, 2, 0).to(dev)
    g = torch.from_numpy(np.random.RandomState(5).uniform(
        0.0, 1.0, (size * size, 3)).astype(np.float32)).to(dev)
    tfeats = dict(feats, noise_impl="table")
    ntab = integrator.noise_tables(ds, tfeats)
    for noise, gkw in (("hash", dict(base_kw, n_pix=size * size)),
                       ("table", dict(base_kw, n_pix=size * size, ntab=ntab))):
        counts = [torch.zeros(1, dtype=torch.int64, device=dev) for _ in range(2)]
        mkg.grad_call(camv, 0, packed, bg, g, **gkw)  # warm-up
        kern, ms = event_ms(lambda: mkg.grad_call(camv, 0, packed, bg, g, **gkw), 3)
        mkg.grad_call(camv, 0, packed, bg, g, bounces=counts[0], **gkw)
        plain, plain_ms = wall_ms(lambda: mkg.grad_plain(camv, 0, packed, bg, g,
                                                         bounces=counts[1], **gkw))
        check(int(counts[0]) == int(counts[1]) > 0,
              f"B3 book2 ({noise} noise): replayed {int(counts[0])} bounces, the plain "
              f"pre-pass {int(counts[1])}")
        detail = []
        for name, a, b in grad_groups(kern, plain, sizes):
            err, scale = float((a - b).abs().max()), float(b.abs().max())
            check(bool(torch.isfinite(a).all()) and err <= GRAD_RTOL * scale + GRAD_ATOL,
                  f"B3 book2 ({noise} noise) {name}: max|d| {err:.3g} vs max|g| {scale:.3g}")
            if scale > 0:
                detail.append(f"{name} {err:.3g}/{scale:.3g}")
        mask = mkg.grad_features(packed, sizes, feats["has_checker"], feats["has_noise"],
                                 gkw.get("ntab"))
        say(f"phase 13 B3 vs plain, book2 {size}x{size} {spp} spp depth 50, {noise} noise "
            f"(winner search through the cluster skip), instance {mask}: {', '.join(detail)}; "
            f"replayed bounces {int(counts[0])} == {int(counts[1])}; kernel {ms:.3f} ms, "
            f"plain {plain_ms:.1f} ms ({card})")
        if noise == "hash":
            b3_ms, b3_plain_ms = ms, plain_ms

    # ---- phase 13d: table noise in v4 and the wavefront step ------------------
    size, spp = 200, 2
    camv = camera.make_camv(host.camera, size, size, 0, spp, 1, 0).to(dev)
    kw = dict(base_kw, n_pix=size * size, ntab=ntab)
    kern = mk.trace_megakernel_batch(camv, 0, packed, bg, **kw)
    plain = mk.trace_plain(camv, 0, packed, bg, **kw)
    hashed = mk.trace_megakernel_batch(camv, 0, packed, bg, **dict(kw, ntab=None))
    torch.cuda.synchronize()
    n_diff = int((kern != plain).any(-1).sum())
    check(n_diff == 0, f"v4 with table noise: {n_diff} pixels differ from the plain version")
    n_noise = int((kern != hashed).any(-1).sum())
    check(n_noise > 0, "v4 with table noise renders the hash-noise image")
    wkw = dict(base_kw, ntab=ntab)
    n_rays = -(-size * size // wf.SLOT_TILE) * wf.SLOT_TILE
    state = wf.init_wavefront_state(n_rays, camv.tolist(), dev)
    bb = wf.scene_bounds(packed, sizes)
    for k in (wf.K_BOUNCES, wf.TAIL_K):
        state = wf.sort_state(state, float(spp), *bb)
        stats = {}
        st_k = wf.wavefront_step(state.clone(), camv, 0, packed, bg, k_bounces=k, **wkw)
        st_p = wf.step_plain(state.clone(), camv, 0, packed, bg, k_bounces=k, stats=stats,
                             **wkw)
        torch.cuda.synchronize()
        check(torch.equal(st_k, st_p), f"wavefront K={k} with table noise differs from plain")
        if k == wf.K_BOUNCES:
            # The table-noise launch's time and bound: the sweep and shading
            # operations plus each noise evaluation's (csrc/path_common.cuh
            # TableLattice, perlin_noise, turbulence, noise_factor).
            _, noise_ms = event_ms(lambda: wf.wavefront_step(
                state.clone(), camv, 0, packed, bg, k_bounces=k, **wkw), 5)
            noise_ops = sum(stats[f"noise_{t}"] * OPS_NOISE[t] for t in OPS_NOISE)
            ops = sweep_ops(stats) + noise_ops
            nbytes = 2 * 17 * 4 * n_rays + packed.numel() * 4 + ntab.numel() * 4
            table_noise = dict(
                ms=noise_ms, bound_ms=max(ops / PEAK_F32_OPS, nbytes / PEAK_BYTES) * 1e3,
                bound_by="operations" if ops / PEAK_F32_OPS >= nbytes / PEAK_BYTES else "bytes",
                noise_ops_share=noise_ops / ops, bounces=stats["bounces"],
                **{f"noise_{t}": stats[f"noise_{t}"] for t in OPS_NOISE},
                shape=f"book2 {size}x{size} {spp} spp depth 50, the first K={k} launch")
        state = st_k
    say(f"phase 13 table noise (noise_impl='table'), book2 {size}x{size} {spp} spp depth 50: "
        f"v4 bitwise equal to its plain version ({n_noise} pixels differ from hash noise); "
        f"the wavefront step's K={wf.K_BOUNCES} and K={wf.TAIL_K} launches bitwise equal to "
        f"the plain step; the K={wf.K_BOUNCES} launch {table_noise['ms']:.4f} ms (mean of 5), "
        f"{table_noise['bounces']} bounces, {table_noise['noise_marble']} marble and "
        f"{table_noise['noise_perlin']} Perlin noise evaluations "
        f"({table_noise['noise_ops_share']:.3f} of its f32 operations), bound "
        f"{table_noise['bound_ms']:.4f} ms by {table_noise['bound_by']} ({card})")

    # ---- phase 14: this slice's main paths -------------------------------
    mk.LAUNCHES = wf.LAUNCHES = 0
    img, v4_wall = wall_ms(lambda: integrator.render_progressive(
        ds, dict(feats, mega_wavefront=False), 600, 600, 0, 16, 0, 50, 4))
    v4_main = mk.LAUNCHES
    check(v4_main == 1 and wf.LAUNCHES == 0,
          f"v4-forced main path launches: v4 {v4_main}, wavefront {wf.LAUNCHES}")
    img = img.reshape(-1, 3).cpu().numpy()
    check(np.array_equal(img, book2_16["image"]),
          "v4 forced through render_progressive differs from phase 4's 16-spp image")
    say(f"phase 14 v4 forced (mega_wavefront=False -> block layout, wave_frac 0.5) through "
        f"integrator.render_progressive, book2 600x600 16 spp depth 50: {v4_main} v4 launch, "
        f"no wavefront launch, image bitwise phase 4's, {16 * 360000 / v4_wall / 1e3:.2f} "
        f"Mpaths/s over {v4_wall:.1f} ms ({card})")

    mk.LAUNCHES = wf.LAUNCHES = 0
    timg, t_wall = wall_ms(lambda: integrator.render_progressive(
        ds, tfeats, 600, 600, 0, 16, 0, 50, 4))
    table_launches = wf.LAUNCHES
    check(table_launches > 0 and mk.LAUNCHES == 0,
          f"table-noise main path launches: wavefront {table_launches}, v4 {mk.LAUNCHES}")
    t_mean = float(timg.mean()) / 16
    check(np.isfinite(t_mean) and abs(t_mean / BOOK2_MEAN_64 - 1.0) < BOOK2_MEAN_RTOL,
          f"book2 table-noise mean {t_mean:.4f} vs {BOOK2_MEAN_64}")
    n_noise = int((timg.reshape(-1, 3).cpu().numpy() != book2_16["image"]).any(-1).sum())
    say(f"phase 14 table-noise forward through integrator.render_progressive "
        f"(noise_impl='table'), book2 600x600 16 spp depth 50: {table_launches} wavefront "
        f"launches, mean linear radiance {t_mean:.4f} ({n_noise} pixels differ from hash "
        f"noise), {16 * 360000 / t_wall / 1e3:.2f} Mpaths/s over {t_wall:.1f} ms ({card})")

    scene = schema.to_device(host, dev)
    mk.LAUNCHES = wf.LAUNCHES = mkg.LAUNCHES = 0
    (loss, gr), g_wall = wall_ms(lambda: grad.value_and_grad_scene(
        torch.mean, scene, tfeats, 0, width=600, height=600, n_samples=4, max_depth=50,
        sqrt_spp=2))
    check(wf.LAUNCHES > 0 and mkg.LAUNCHES == 1 and mk.LAUNCHES == 0,
          f"table-noise gradient launches: wavefront {wf.LAUNCHES}, B3 {mkg.LAUNCHES}, "
          f"v4 {mk.LAUNCHES}")
    leaves = []
    schema.map_leaves(gr, lambda x: leaves.append(x) if x is not None else None)
    check(all(bool(torch.isfinite(x).all()) for x in leaves), "table-noise gradient not finite")
    dc = float(gr.spheres.center0.abs().max())
    check(dc > 0.0, "table-noise book-2 sphere-centre gradient is zero")
    say(f"phase 14 table-noise gradient through grad.value_and_grad_scene, book2 600x600, "
        f"4 spp, depth 50: loss {float(loss):.4f}, {wf.LAUNCHES} wavefront + {mkg.LAUNCHES} "
        f"B3 launches, every leaf finite, max |d center0| {dc:.3g}, {g_wall:.1f} ms ({card})")
    out.update(v4_forced_launches=v4_main, table_launches=table_launches,
               b3_book2=dict(ms=b3_ms, plain_ms=b3_plain_ms), table_noise=table_noise)
    return out


def bvh_phases(dev, card, work, book2, book2_16, wf_hier, captured_hier, b1) -> dict:
    """Phase 17: B1's last option, the threaded-BVH sweep (RT2_SWEEP_MODE=bvh;
    sweep_mode patches megakernel.SWEEP_MODE), in the bvh instances of every
    kernel that walks the clusters, on book 2. Each kernel against its
    plain version in "bvh" mode: v4 on the block layout (600x600, 2 spp)
    and the linear one (200x200, 2 spp) bitwise, the wavefront step's K=2
    and K=16 launches on the states a "bvh" batch (600x600, 6 spp) captures
    bitwise, one B4 pass of book 2's camera rays bitwise, B3 at 64x64, 4
    spp within 1e-3 of the largest cotangent with the same replayed
    bounces; the slab and record tests per bounce of the BVH walk (its
    plain version's counts) against the cluster skip's (phases 4 and 13)
    and the bound from them; each timed in turns against "hier" (hier,
    bvh, bvh, hier) on the same inputs. Then the main paths in "bvh" mode,
    the launch counts set to 0 before each and read after: v4 forced
    through integrator.render_progressive (600x600, 16 spp; its image
    against phase 4's "hier" image, at most 0.01 % of pixels: exact
    ties), the CLI on book 2 (600x600, 64 spp, in turns with "hier"), the
    Renderer, grad.value_and_grad_scene and B4 through render_sample.
    Returns what the kernels line reports."""
    import numpy as np
    import torch

    from raytrace2_tpu_torch import app, grad
    from raytrace2_tpu_torch.ops import camera, integrator, rng
    from raytrace2_tpu_torch.ops.kernels import megakernel as mk
    from raytrace2_tpu_torch.ops.kernels import megakernel_grad as mkg
    from raytrace2_tpu_torch.ops.kernels import megakernel_v3 as mk3
    from raytrace2_tpu_torch.ops.kernels import wavefront as wf
    from raytrace2_tpu_torch.render import Renderer
    from raytrace2_tpu_torch.scene import loader, schema

    host, _ = loader.load_scene(book2)
    feats = host.features()
    sizes = tuple(feats["mega_sizes"])
    ds = schema.to_device(host, dev)
    bg = ds.background.to(torch.float32).contiguous()
    base_kw = dict(max_depth=50, sizes=sizes, has_checker=feats["has_checker"],
                   has_noise=feats["has_noise"])
    types = mk.scene_material_types(ds.materials.mtype)
    packed = {}
    for mode in ("hier", "bvh"):
        with sweep_mode(mode):
            packed[mode] = mk.pack_buffer(ds, sizes)
    check(packed["bvh"].numel() == packed["hier"].numel()
          + 19 * sum(mk.bvh_nodes(n) for n in (sizes[0], sizes[5])),
          "the bvh buffer is not the hier buffer plus 19 floats a BVH node")
    out = {}

    def in_turns(run):
        """{mode: [ms, ms]} of ``run(mode)`` in turns hier, bvh, bvh, hier."""
        times = {"hier": [], "bvh": []}
        for mode in ("hier", "bvh", "bvh", "hier"):
            with sweep_mode(mode):
                times[mode].append(run(mode))
        return times

    def per_bounce(stats):
        b = max(stats["bounces"], 1)
        return {k: stats[k] / b for k in ("aabb", "sph", "box")}

    def bound(stats, nbytes):
        ops = sweep_ops(stats)
        by = "operations" if ops / PEAK_F32_OPS >= nbytes / PEAK_BYTES else "bytes"
        return max(ops / PEAK_F32_OPS, nbytes / PEAK_BYTES) * 1e3, by, ops

    def fmt(times):
        return ", ".join(f"{m} {'/'.join(f'{t:.4f}' for t in v)}" for m, v in times.items())

    # ---- phase 17a: v4, block layout with wave regeneration, and linear ----
    spp = 2
    camv = camera.make_camv(host.camera, 600, 600, 0, spp, 1, 0, block=mk.BLOCK).to(dev)
    n_slots, _ = mk.pixel_slots(600, 600, block=True)
    kw = dict(base_kw, n_pix=n_slots, block=True, wave_frac=0.5, mat_types=types)
    with sweep_mode("bvh"):
        mk.trace_megakernel_batch(camv, 0, packed["bvh"], bg, **kw)  # warm-up
        kern = mk.trace_megakernel_batch(camv, 0, packed["bvh"], bg, **kw)
        stats = {}
        plain, plain_ms = wall_ms(lambda: mk.trace_plain(camv, 0, packed["bvh"], bg,
                                                         stats=stats, **kw))
    n_diff = int((kern != plain).any(-1).sum())
    check(n_diff == 0, f"bvh v4 book2 block layout: {n_diff} slots differ from the plain version")
    times = in_turns(lambda m: event_ms(lambda: mk.trace_megakernel_batch(
        camv, 0, packed[m], bg, **kw), 3)[1])
    bound_ms, bound_by, ops = bound(stats, 12 * n_slots + packed["bvh"].numel() * 4)
    hier_tests = {k: b1["v4_book2"][f"{k}_per_bounce"] for k in ("aabb", "sph", "box")}
    out["v4_block"] = dict(ms=sum(times["bvh"]) / 2, hier_ms=sum(times["hier"]) / 2,
                           times=times, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                           max_abs_err=0.0, tests_per_bounce=per_bounce(stats),
                           hier_tests_per_bounce=hier_tests)
    say(f"phase 17 bvh v4 vs plain, book2 600x600 {spp} spp depth 50, block layout with "
        f"wave_frac 0.5: bitwise equal; in turns (ms) {fmt(times)}; plain {plain_ms:.1f} ms; "
        f"per bounce {per_bounce(stats)['aabb']:.2f} slab, {per_bounce(stats)['sph']:.2f} "
        f"sphere and {per_bounce(stats)['box']:.2f} box record tests (hier: "
        f"{hier_tests['aabb']:.2f}, {hier_tests['sph']:.2f}, {hier_tests['box']:.2f}) -> "
        f"{ops:.4g} f32 ops -> bound {bound_ms:.4f} ms by {bound_by} ({card})")
    size = 200
    camv_l = camera.make_camv(host.camera, size, size, 0, spp, 1, 0).to(dev)
    kw_l = dict(base_kw, n_pix=size * size, mat_types=types)
    with sweep_mode("bvh"):
        kern = mk.trace_megakernel_batch(camv_l, 0, packed["bvh"], bg, **kw_l)
        plain = mk.trace_plain(camv_l, 0, packed["bvh"], bg, **kw_l)
    n_diff = int((kern != plain).any(-1).sum())
    check(n_diff == 0, f"bvh v4 book2 linear layout: {n_diff} pixels differ from the plain "
                       f"version")
    say(f"phase 17 bvh v4 vs plain, book2 {size}x{size} {spp} spp depth 50, linear layout "
        f"(the persistent kernel): bitwise equal ({card})")

    # ---- phase 17b: the wavefront step's K=2 and K=16 launches -------------
    camv6 = camera.make_camv(host.camera, 600, 600, 0, 6, 2, 0).to(dev)
    n_rays = -(-360000 // wf.SLOT_TILE) * wf.SLOT_TILE
    captured, n2 = {}, [0]

    def capture(state, *a, k_bounces, **k):
        tag = f"k{k_bounces}"
        if tag not in captured and (k_bounces != wf.K_BOUNCES or n2[0] == 4):
            captured[tag] = state.clone()
        n2[0] += k_bounces == wf.K_BOUNCES
        return wf.wavefront_step(state, *a, k_bounces=k_bounces, **k)

    with sweep_mode("bvh"):
        wf.trace_wavefront_batch(camv6, 0, packed["bvh"], bg, n_rays=n_rays, step=capture,
                                 **base_kw)
    check("k2" in captured and "k16" in captured, "bvh: no K=2 or K=16 launch to capture")

    def launch_ms(st0, mode, k, reps=3):
        ms = 0.0
        for _ in range(reps):
            st = st0.clone()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            wf.wavefront_step(st, camv6, 0, packed[mode], bg, k_bounces=k, **base_kw)
            end.record()
            torch.cuda.synchronize()
            ms += start.elapsed_time(end) / reps
        return ms

    for tag, k in (("k2", wf.K_BOUNCES), ("k16", wf.TAIL_K)):
        st0 = captured[tag]
        same_state = int((st0 != captured_hier[tag]).any(0).sum())
        times = in_turns(lambda m: launch_ms(st0, m, k))
        stats = {}
        with sweep_mode("bvh"):
            st_k = wf.wavefront_step(st0.clone(), camv6, 0, packed["bvh"], bg, k_bounces=k,
                                     **base_kw)
            st_p, plain_ms = wall_ms(lambda: wf.step_plain(
                st0.clone(), camv6, 0, packed["bvh"], bg, k_bounces=k, stats=stats, **base_kw))
        n_diff = int((st_k != st_p).any(0).sum())
        check(n_diff == 0, f"bvh wavefront {tag} launch: {n_diff} slots differ from the plain "
                           f"step")
        bound_ms, bound_by, ops = bound(stats, 2 * 17 * 4 * n_rays + packed["bvh"].numel() * 4)
        hier_tests = {x: wf_hier[tag][f"{x}_per_bounce"] for x in ("aabb", "sph", "box")}
        out[tag] = dict(ms=sum(times["bvh"]) / 2, hier_ms=sum(times["hier"]) / 2, times=times,
                        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                        max_abs_err=0.0, tests_per_bounce=per_bounce(stats),
                        hier_tests_per_bounce=hier_tests, bounces=stats["bounces"],
                        state_slots_differing_from_hier_capture=same_state)
        say(f"phase 17 bvh wavefront {tag} launch, book2 600x600 ({n_rays} slots) on the state a "
            f"bvh batch captured ({same_state} slots differ from phase 4's hier capture): "
            f"bitwise equal to the plain step; in turns (ms) {fmt(times)}; plain step "
            f"{plain_ms:.1f} ms; {stats['bounces']} bounces, per bounce "
            f"{per_bounce(stats)['aabb']:.2f} slab, {per_bounce(stats)['sph']:.2f} sphere and "
            f"{per_bounce(stats)['box']:.2f} box record tests (hier: {hier_tests['aabb']:.2f}, "
            f"{hier_tests['sph']:.2f}, {hier_tests['box']:.2f}) -> {ops:.4g} f32 ops -> bound "
            f"{bound_ms:.4f} ms by {bound_by} ({card})")

    # ---- phase 17c: one B4 pass of book 2's camera rays ---------------------
    seed_lane = integrator.mega_seed_of(0, 0)
    pix = torch.arange(360000, dtype=torch.int32, device=dev)
    u = rng.murmur_uniforms(seed_lane, pix, tuple(rng.CAMERA_CTR_BASE + k for k in range(5)))
    o, d, tm = camera.generate_rays(ds.camera, 600, 600, 0, 1, None, uniforms=u)
    pad = -o.shape[0] % mk3.TILE_R
    o = torch.nn.functional.pad(o, (0, 0, 0, pad))
    d = torch.nn.functional.pad(d, (0, 0, 0, pad), value=1.0)
    tm = torch.nn.functional.pad(tm, (0, pad))
    state, rid = mk3.init_state(o, d, tm)
    min_alive = mk3.TILE_R // 16
    b4_kw = dict(base_kw, mat_types=types)
    with sweep_mode("bvh"):
        rad_k, new_k = mk3.megakernel_pass(state, rid, seed_lane, min_alive, packed["bvh"], bg,
                                           **b4_kw)
        (rad_p, new_p), b4_plain_ms = wall_ms(lambda: mk3.pass_plain(
            state, rid, seed_lane, min_alive, packed["bvh"], bg, **base_kw))
    check(torch.equal(rad_k, rad_p) and torch.equal(new_k, new_p),
          "bvh B4 book2 pass: kernel and plain version differ")
    times = in_turns(lambda m: event_ms(lambda: mk3.megakernel_pass(
        state, rid, seed_lane, min_alive, packed[m], bg, **b4_kw), 3)[1])
    out["b4_book2"] = dict(ms=sum(times["bvh"]) / 2, hier_ms=sum(times["hier"]) / 2,
                           times=times, plain_ms=b4_plain_ms, max_abs_err=0.0)
    say(f"phase 17 bvh B4 vs plain, one pass of book2 600x600 camera rays (min_alive "
        f"{min_alive} of {mk3.TILE_R}): radiance and state bitwise; in turns (ms) {fmt(times)}; "
        f"plain {b4_plain_ms:.1f} ms ({card})")

    # ---- phase 17d: B3 at 64x64, 4 spp ---------------------------------------
    size, spp = 64, 4
    camv_g = camera.make_camv(host.camera, size, size, 0, spp, 2, 0).to(dev)
    g = torch.from_numpy(np.random.RandomState(5).uniform(
        0.0, 1.0, (size * size, 3)).astype(np.float32)).to(dev)
    gkw = dict(base_kw, n_pix=size * size, mat_types=types)
    counts = [torch.zeros(1, dtype=torch.int64, device=dev) for _ in range(2)]
    with sweep_mode("bvh"):
        kern = mkg.grad_call(camv_g, 0, packed["bvh"], bg, g, bounces=counts[0], **gkw)
        plain, b3_plain_ms = wall_ms(lambda: mkg.grad_plain(
            camv_g, 0, packed["bvh"], bg, g, bounces=counts[1], **gkw))
    check(int(counts[0]) == int(counts[1]) > 0,
          f"bvh B3 book2: replayed {int(counts[0])} bounces, the plain pre-pass "
          f"{int(counts[1])}")
    detail, worst = [], 0.0
    for name, a, b in grad_groups(kern, plain, sizes):
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        check(bool(torch.isfinite(a).all()) and err <= GRAD_RTOL * scale + GRAD_ATOL,
              f"bvh B3 book2 {name}: max|d| {err:.3g} vs max|g| {scale:.3g}")
        worst = max(worst, err)
        if scale > 0:
            detail.append(f"{name} {err:.3g}/{scale:.3g}")
    times = in_turns(lambda m: event_ms(lambda: mkg.grad_call(
        camv_g, 0, packed[m], bg, g, **gkw), 3)[1])
    out["b3_book2"] = dict(ms=sum(times["bvh"]) / 2, hier_ms=sum(times["hier"]) / 2,
                           times=times, plain_ms=b3_plain_ms, max_abs_err=worst,
                           bounces=int(counts[0]))
    say(f"phase 17 bvh B3 vs plain, book2 {size}x{size} {spp} spp depth 50: {', '.join(detail)} "
        f"(gate {GRAD_RTOL:g} max|g| + {GRAD_ATOL:g}); replayed bounces {int(counts[0])} == "
        f"{int(counts[1])}; in turns (ms) {fmt(times)}; plain {b3_plain_ms:.1f} ms ({card})")

    # ---- phase 17e: the main paths in "bvh" mode ------------------------------
    def forced(mode):
        mk.LAUNCHES = wf.LAUNCHES = 0
        img, ms = wall_ms(lambda: integrator.render_progressive(
            ds, dict(feats, mega_wavefront=False), 600, 600, 0, 16, 0, 50, 4))
        check(mk.LAUNCHES == 1 and wf.LAUNCHES == 0,
              f"v4 forced ({mode}): v4 {mk.LAUNCHES}, wavefront {wf.LAUNCHES} launches")
        out.setdefault("forced_images", {})[mode] = img.reshape(-1, 3).cpu().numpy()
        return ms

    times = in_turns(forced)
    imgs = out.pop("forced_images")
    check(np.array_equal(imgs["hier"], book2_16["image"]),
          "v4 forced (hier) differs from phase 4's 16-spp image")
    n_tie = int((imgs["bvh"] != book2_16["image"]).any(-1).sum())
    check(n_tie <= 1e-4 * 360000, f"book2 16 spp: the bvh image differs from the hier image in "
                                  f"{n_tie} pixels (more than exact ties)")
    out["forced_16spp"] = dict(times=times, pixels_differing_from_hier=n_tie)
    say(f"phase 17 bvh main path, v4 forced through integrator.render_progressive, book2 "
        f"600x600 16 spp depth 50: 1 v4 launch a run; the image differs from the hier image "
        f"in {n_tie} of 360000 pixels (gate 0.01 %); in turns (ms, wall) {fmt(times)} "
        f"({card})")

    def cli(mode):
        m = os.path.join(work, f"metrics_book2_{mode}_{len(cli_runs[mode])}.jsonl")
        mk.LAUNCHES = wf.LAUNCHES = wf.SORTS = 0
        rc = app.main([book2, os.path.join(work, f"book2_{mode}.png"), "--samples", "64",
                       "--depth", "50", "--device", "cuda", "--metrics", m, "--quiet"])
        check(rc == 0, f"app.main book2 ({mode}) exited {rc}")
        with open(m) as f:
            done = [json.loads(line) for line in f][-1]
        check(wf.LAUNCHES > 0 and mk.LAUNCHES == 0 and done["launches"] == wf.LAUNCHES,
              f"book-2 CLI ({mode}): wavefront {wf.LAUNCHES}, v4 {mk.LAUNCHES}, done {done}")
        check(abs(done["mean_linear"] / BOOK2_MEAN_64 - 1.0) < BOOK2_MEAN_RTOL,
              f"book-2 CLI ({mode}) mean {done['mean_linear']:.4f}")
        cli_runs[mode].append(dict(mpaths_per_s=done["mpaths_per_s"], launches=wf.LAUNCHES,
                                   sorts=wf.SORTS, mean=done["mean_linear"]))
        return done["mpaths_per_s"]

    cli_runs = {"hier": [], "bvh": []}
    cli_mp = in_turns(cli)
    out["cli"] = cli_runs
    say(f"phase 17 bvh main path, app.main book2 600x600 64 spp depth 50, in turns (Mpaths/s) "
        + ", ".join(f"{m} {'/'.join(f'{x:.2f}' for x in v)}" for m, v in cli_mp.items())
        + f"; bvh runs {cli_runs['bvh'][0]['launches']} wavefront launches each, mean "
        f"{cli_runs['bvh'][0]['mean']:.4f} (hier {cli_runs['hier'][0]['mean']:.4f}) ({card})")

    with sweep_mode("bvh"):
        mk.LAUNCHES = wf.LAUNCHES = 0
        r = Renderer(host, 64, 64, num_samples=4, max_depth=50, device=dev)
        img_r = r.render(batch=4)
        r_launches = wf.LAUNCHES
        check(r.kernel == "wavefront_step" and r_launches > 0 and mk.LAUNCHES == 0,
              f"bvh Renderer: kernel {r.kernel}, wavefront {r_launches}, v4 {mk.LAUNCHES}")
        check(np.isfinite(img_r).all() and img_r.max() > 0, "bvh Renderer image")
        mk.LAUNCHES = wf.LAUNCHES = mkg.LAUNCHES = 0
        scene = schema.to_device(host, dev)
        loss, gr = grad.value_and_grad_scene(torch.mean, scene, feats, 0, width=64, height=64,
                                             n_samples=4, max_depth=50, sqrt_spp=2)
        g_launches = (wf.LAUNCHES, mkg.LAUNCHES)
        check(wf.LAUNCHES > 0 and mkg.LAUNCHES == 1 and mk.LAUNCHES == 0,
              f"bvh gradient launches: wavefront {wf.LAUNCHES}, B3 {mkg.LAUNCHES}")
        leaves = []
        schema.map_leaves(gr, lambda x: leaves.append(x) if x is not None else None)
        check(all(bool(torch.isfinite(x).all()) for x in leaves), "bvh gradient not finite")
        mk3.LAUNCHES = 0
        acc = integrator.render_sample(ds, dict(feats, use_megakernel=True), 200, 200, 0, 0,
                                       50, 1)
        b4_launches = mk3.LAUNCHES
        check(b4_launches > 0 and bool(torch.isfinite(acc).all()),
              f"bvh B4 main path: {b4_launches} launches")
    loss_h = grad.value_and_grad_scene(torch.mean, schema.to_device(host, dev), feats, 0,
                                       width=64, height=64, n_samples=4, max_depth=50,
                                       sqrt_spp=2)[0]
    acc_h = integrator.render_sample(ds, dict(feats, use_megakernel=True), 200, 200, 0, 0,
                                     50, 1)
    n_b4 = int((acc != acc_h).any(-1).sum())
    out["main_paths"] = dict(renderer_launches=r_launches, grad_launches=g_launches,
                             b4_launches=b4_launches, cli_launches=cli_runs["bvh"][0]["launches"])
    say(f"phase 17 bvh main paths: Renderer book2 64x64 4 spp {r_launches} wavefront launches; "
        f"grad.value_and_grad_scene book2 64x64 4 spp: {g_launches[0]} wavefront + "
        f"{g_launches[1]} B3 launches, every leaf finite, loss {float(loss):.6f} (hier "
        f"{float(loss_h):.6f}); render_sample with use_megakernel, book2 200x200: "
        f"{b4_launches} B4 launches, {n_b4} pixels differ from hier ({card})")
    return out


def bench_phase(card) -> dict:
    """Phase 18: the port's bench, python -m raytrace2_tpu_torch.tools.bench
    and ... --grad, each as a subprocess from the checkout's root: the last
    line of its stdout is one JSON object with the JAX bench's keys
    (metric, value, unit, vs_baseline), its metric name and a positive
    value."""
    out = {}
    for args, metric in (([], "cornell600_paths_per_sec"),
                         (["--grad"], "cornell600_fwdbwd_d50_paths_per_sec")):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "raytrace2_tpu_torch.tools.bench", *args],
                           cwd=ROOT, capture_output=True, text=True, timeout=400)
        wall = time.perf_counter() - t0
        check(r.returncode == 0, f"bench {args} exited {r.returncode}: {r.stderr[-2000:]}")
        lines = r.stdout.strip().splitlines()
        check(len(lines) == 1, f"bench {args} printed {len(lines)} lines on stdout")
        rec = json.loads(lines[-1])
        check(sorted(rec) == ["metric", "unit", "value", "vs_baseline"]
              and rec["metric"] == metric and rec["unit"] == "paths/s" and rec["value"] > 0,
              f"bench {args} record {rec}")
        out[metric] = dict(rec, wall_s=wall, stderr=r.stderr.strip().splitlines()[-3:])
        say(f"phase 18 bench {' '.join(args) or '(forward)'}: {lines[-1]} "
            f"({rec['value'] / 1e6:.2f} Mpaths/s; {wall:.1f} s with the process; "
            f"{r.stderr.strip().splitlines()[-1]}) ({card})")
    return out


def resume_phase(card, cornell, work) -> dict:
    """Phase 19: resume through app.main on the kernel path: Cornell 600x600
    depth 50, 4 samples with --checkpoint, then the same command at 8
    samples resumes at sample 4; its accumulator is bitwise the one-shot
    8-sample render's, each run launching v4."""
    import torch

    from raytrace2_tpu_torch import app
    from raytrace2_tpu_torch.io import checkpoint
    from raytrace2_tpu_torch.ops.kernels import megakernel as mk

    def run(samples, ck):
        mk.LAUNCHES = 0
        rc = app.main([cornell, os.path.join(work, "resume.png"), "--samples", str(samples),
                       "--depth", "50", "--device", "cuda", "--checkpoint", ck, "--quiet"])
        check(rc == 0 and mk.LAUNCHES > 0, f"app.main --checkpoint: rc {rc}, {mk.LAUNCHES} "
                                           f"v4 launches")
        return mk.LAUNCHES

    ck, one = os.path.join(work, "resume.npz"), os.path.join(work, "one.npz")
    launches = [run(4, ck), run(8, ck), run(8, one)]
    resumed, once = checkpoint.load_state(ck), checkpoint.load_state(one)
    check(resumed.frame_idx == once.frame_idx == 8, "resume: frame counts")
    check(torch.equal(resumed.accum, once.accum), "resume: 4 + 4 samples differ from a "
                                                  "one-shot render of 8")
    say(f"phase 19 resume through app.main --checkpoint, Cornell 600x600 depth 50: 4 samples "
        f"({launches[0]} v4 launches), then 4 more ({launches[1]}), bitwise the one-shot "
        f"8-sample accumulator ({launches[2]} launches) ({card})")
    return {"launches": launches}


def grad_groups(kern, plain, sizes):
    """(name, kernel, plain) per leaf group of two grad_call results: camv,
    background, each table family."""
    import torch

    from raytrace2_tpu_torch.ops.kernels import megakernel as mk

    groups = [("camv", kern[0], plain[0]), ("background", kern[1], plain[1])]
    ck, cp = mk.unpack_buffer(kern[2], sizes), mk.unpack_buffer(plain[2], sizes)
    for fam, keys in mk.FAMILIES:
        groups.append((fam, torch.cat([ck[fam][k] for k in keys]),
                       torch.cat([cp[fam][k] for k in keys])))
    return groups


def non_kernel_phases(dev, card, scene_file, cornell, book2, ops_per_bounce):
    """Phases 10-12: the non-kernel path. Returns the kernels-line entries of
    B5 (the fused closest hit) and B4 (the v3 state-passing kernel), and the
    card's ceilings (tools/roofline.py --mode ceilings), measured for B5's
    bound."""
    import numpy as np
    import torch

    from test_torch_scenes import ellipsoid_scene_json

    from raytrace2_tpu_torch import app
    from raytrace2_tpu_torch.io import compare, image
    from raytrace2_tpu_torch.ops import camera, integrator, intersect, materials, rng
    from raytrace2_tpu_torch.ops.kernels import build
    from raytrace2_tpu_torch.ops.kernels import intersect_kernel as pk
    from raytrace2_tpu_torch.ops.kernels import megakernel as mk
    from raytrace2_tpu_torch.ops.kernels import megakernel_v3 as mk3
    from raytrace2_tpu_torch.ops.kernels import wavefront as wf
    from raytrace2_tpu_torch.render import Renderer
    from raytrace2_tpu_torch.scene import loader, schema
    from raytrace2_tpu_torch.tools import ab_kernels, roofline

    # ---- phase 10: B5 against its plain version at its launch shapes --------
    # The card's f32 ceiling for code built with -fmad=false (phase 16 prints
    # the ceilings), for B5's bound beside the data sheet's.
    ceil = roofline.ceilings(5)
    b5 = {}
    sms = build.sm_count(dev)

    def b5_launch(args, kwargs, config):
        # One launch at a given (G, threads, cap_s, cap_q), past the rule.
        t = torch.empty(args[0].shape[0], dtype=torch.float32, device=dev)
        c = torch.empty(args[0].shape[0], dtype=torch.int32, device=dev)
        build.launch_intersect_kernel(*args, t, c, **kwargs, config=config,
                                      smem=pk.smem_bytes(*config[2:]))
        return t, c

    for name, chunk, picks in ab_kernels.B5_CASES:
        path = {"book2": book2, "cornell": cornell}[name]
        ds, launches, widths = ab_kernels.b5_launches(path, dev, 600, chunk, picks)
        for pick, args, kwargs in launches:
            o, d, tm, t0, t1, sph, qd = args
            n_sph, n_quad = kwargs["n_sph"], kwargs["n_quad"]
            n = o.shape[0]
            label = (f"{name} 600x600 {chunk}-ray chunk, {roofline.b5_launch_name(pick)} "
                     f"({n} rays; the chunk's launches by ray count {widths})")
            group, threads, cap_s, cap_q = pk.launch_config(n, n_sph, n_quad, sms)
            pk.closest_hit(*args, **kwargs)  # warm-up
            (t_k, c_k), ms = event_ms(lambda: pk.closest_hit(*args, **kwargs), 5)
            # The reference: the plain version over the padded rows.
            (t_p, c_p), plain_ms = wall_ms(lambda: pk.closest_hit_plain(*args))

            def dense():
                bt_s, bi_s = intersect._first_min(intersect._sphere_ts(ds.spheres, o, d, tm, t0, t1))
                bt_q, bi_q = intersect._first_min(intersect._quad_ts(ds.quads, o, d, t0, t1))
                return bt_s, bt_q

            dense()  # warm-up
            _, dense_ms = event_ms(dense, 3)
            n_diff = int((c_k != c_p).sum()) + int((t_k.view(torch.int32)
                                                   != t_p.view(torch.int32)).sum())
            check(n_diff == 0, f"B5 {label}: kernel and plain version differ at {n_diff} "
                               f"places")
            # The alternatives to the rule's launch: every lane group, whole
            # table and tiles, 64 to 1,024 threads a block, each bitwise the
            # plain version too; the wrapper's forced G and tiles as well.
            alt = {}
            for g in (1, 2, 4, 8, 16, 32):
                for tiles in (False, True):
                    t_a, c_a = pk.closest_hit(*args, **kwargs, group=g, tiles=tiles)
                    check(torch.equal(c_a, c_p) and torch.equal(t_a.view(torch.int32),
                                                                t_p.view(torch.int32)),
                          f"B5 {label} at G={g}, tiles={tiles} differs from the plain version")
                    caps = pk.launch_config(n, n_sph, n_quad, sms, g, tiles)[2:]
                    for th in (64, 128, 256, 512, 1024):
                        cfg = (g, th, *caps)
                        (t_a, c_a), alt[f"G{g} {'tiles' if tiles else 'whole'} {th}"] = \
                            event_ms(lambda: b5_launch(args, kwargs, cfg), 5)
                        check(torch.equal(c_a, c_p) and torch.equal(t_a.view(torch.int32),
                                                                    t_p.view(torch.int32)),
                              f"B5 {label} at {cfg} differs from the plain version")
            best = min(alt, key=alt.get)
            max_err = float((t_k - t_p).abs().max())
            hits = int((c_k >= 0).sum())
            # Operations of the tests this launch's data takes: a sphere
            # without a real root stops at its discriminant.
            ops = pk.record_test_ops(o, d, tm, t0, t1, sph, n_sph, n_quad)
            nbytes = n * (9 + 2) * 4 + (8 * n_sph + 13 * n_quad) * 4
            bound_ms = max(ops / PEAK_F32_OPS, nbytes / PEAK_BYTES) * 1e3
            bound_by = "operations" if ops / PEAK_F32_OPS >= nbytes / PEAK_BYTES else "bytes"
            bound_ceil_ms = max(ops / ceil["mul_add_ops_per_s"],
                                nbytes / ceil["copy_bytes_per_s"]) * 1e3
            staging = "whole" if (cap_s, cap_q) == (n_sph, n_quad) else "tiles"
            b5[(name, pick)] = dict(n=n, ms=ms, plain_ms=plain_ms, dense_ms=dense_ms,
                                    bound_ms=bound_ms, bound_by=bound_by,
                                    bound_ms_measured_ceilings=bound_ceil_ms, ops=ops,
                                    max_abs_err=max_err, group=group,
                                    threads_per_block=threads, staging=staging,
                                    live_records=n_sph + n_quad,
                                    padded_records=sph.shape[1] + qd.shape[1],
                                    launches_by_rays=widths,
                                    fastest_alternative={best: alt[best]})
            say(f"phase 10 B5 vs plain, {label}: {hits} hit; t bitwise and codes equal at "
                f"the rule's launch (G={group}, {threads} threads a block, {staging} table "
                f"staged) and at every alternative; {n_sph + n_quad} live records per ray of "
                f"{sph.shape[1] + qd.shape[1]} padded; kernel {ms:.4f} ms (mean of 5, CUDA "
                f"events); fastest alternative {best} {alt[best]:.4f} ms; plain "
                f"{plain_ms:.1f} ms, the xla route's dense sphere+quad sweep {dense_ms:.3f} ms; "
                f"{ops:.6g} f32 ops ({n_sph} spheres: {pk.OPS_SPHERE_MISS}, or "
                f"{pk.OPS_SPHERE} with a real root; {n_quad} quads x {pk.OPS_QUAD}), {nbytes} B "
                f"-> bound {bound_ms:.5f} ms by {bound_by} at the data sheet's rates, "
                f"{bound_ceil_ms:.5f} ms at the measured -fmad=false and copy ceilings "
                f"({ceil['mul_add_ops_per_s'] / 1e12:.2f} TFLOP/s, "
                f"{ceil['copy_bytes_per_s'] / 1e12:.3f} TB/s) ({card})")
            say(f"phase 10 B5 alternatives, {name} {roofline.b5_launch_name(pick)}, ms by "
                f"(G, staging, threads a block): "
                + ", ".join(f"{k} {v:.4f}" for k, v in alt.items()))

    # ---- phase 11: B4 against its plain version, one pass -----------------
    host, _ = loader.load_scene(cornell)
    feats = host.features()
    sizes = tuple(feats["mega_sizes"])
    ds = schema.to_device(host, dev)
    seed_lane = integrator.mega_seed_of(0, 0)
    pix = torch.arange(600 * 600, dtype=torch.int32, device=dev)
    u = rng.murmur_uniforms(seed_lane, pix, tuple(rng.CAMERA_CTR_BASE + k for k in range(5)))
    o, d, tm = camera.generate_rays(ds.camera, 600, 600, 0, 4, None, uniforms=u)
    pad = -o.shape[0] % mk3.TILE_R
    o = torch.nn.functional.pad(o, (0, 0, 0, pad))
    d = torch.nn.functional.pad(d, (0, 0, 0, pad), value=1.0)
    tm = torch.nn.functional.pad(tm, (0, pad))
    state, rid = mk3.init_state(o, d, tm)
    packed = mk.pack_buffer(ds, sizes)
    bg = ds.background.to(torch.float32)
    min_alive = mk3.TILE_R // 16  # the first of the integrator's two passes
    kw = dict(max_depth=50, sizes=sizes, has_checker=feats["has_checker"],
              has_noise=feats["has_noise"], mat_types=mk.scene_material_types(ds.materials.mtype))
    b4_mask = mk3.instance_features(packed, sizes, feats["has_checker"], feats["has_noise"],
                                    kw["mat_types"])
    mk3.megakernel_pass(state, rid, seed_lane, min_alive, packed, bg, **kw)  # warm-up
    (rad_k, new_k), b4_ms = event_ms(
        lambda: mk3.megakernel_pass(state, rid, seed_lane, min_alive, packed, bg, **kw), 5)
    (rad_p, new_p), b4_plain_ms = wall_ms(
        lambda: mk3.pass_plain(state, rid, seed_lane, min_alive, packed, bg, **kw))
    b4_err = max(float((rad_k - rad_p).abs().max()), float((new_k - new_p).abs().max()))
    check(torch.equal(rad_k, rad_p) and torch.equal(new_k, new_p),
          f"B4 one pass: kernel and plain version differ (max abs err {b4_err:.3g})")
    live = (new_k[mk3.COL["alive"]] > 0).view(-1, mk3.TILE_R).sum(1)
    check(int(live.max()) <= min_alive, f"B4 left a tile with {int(live.max())} live rays")
    n = rid.numel()
    b4_bounces = int((new_k[mk3.COL["bounce"]] - state[mk3.COL["bounce"]]).sum())
    b4_ops = b4_bounces * ops_per_bounce(sizes)
    b4_bytes = n * (12 * 4 + 4) + n * (11 * 4 + 12) + packed.numel() * 4
    b4_bound_ms = max(b4_ops / PEAK_F32_OPS, b4_bytes / PEAK_BYTES) * 1e3
    b4_bound_by = "operations" if b4_ops / PEAK_F32_OPS >= b4_bytes / PEAK_BYTES else "bytes"
    say(f"phase 11 B4 vs plain, one pass of cornell 600x600 depth 50 ({n} rays, min_alive "
        f"{min_alive} of {mk3.TILE_R}), instance {b4_mask}: radiance and state bitwise, "
        f"{int(live.sum())} rays "
        f"live after; kernel {b4_ms:.3f} ms (mean of 5), plain {b4_plain_ms:.1f} ms; "
        f"{b4_bounces} bounces x {ops_per_bounce(sizes)} f32 ops, {b4_bytes} B -> bound "
        f"{b4_bound_ms:.4f} ms by {b4_bound_by} ({card})")

    # ---- phase 12: the non-kernel main paths ------------------------------
    def cli(path, out, *argv):
        metrics = out + ".jsonl"
        pk.LAUNCHES = mk.LAUNCHES = wf.LAUNCHES = mk3.LAUNCHES = 0
        rc = app.main([path, out, "--depth", "50", "--device", "cuda", "--metrics", metrics,
                       "--quiet", *argv])
        counts = dict(b5=pk.LAUNCHES, v4=mk.LAUNCHES, wavefront=wf.LAUNCHES, b4=mk3.LAUNCHES)
        check(rc == 0, f"app.main {os.path.basename(path)} {argv} exited {rc}")
        with open(metrics) as f:
            done = [json.loads(line) for line in f][-1]
        with open(out, "rb") as f:
            png = image.decode_png(f.read())
        check(png.shape == (600, 600, 3), f"PNG shape {png.shape}")
        check(np.isfinite(done["mean_linear"]), f"{path}: mean not finite")
        return done, counts

    work = os.path.dirname(cornell)
    done, counts = cli(cornell, os.path.join(work, "cornell_pallas.png"), "--samples", "4",
                       "--backend", "pallas")
    b5_main = counts["b5"]
    lo, hi = CORNELL_MEAN_BAND
    check(b5_main > 0 and counts["v4"] == counts["wavefront"] == counts["b4"] == 0,
          f"Cornell pallas main path launches {counts}")
    check((done["route"], done["kernel"], done["launches"]) == ("pallas", "intersect_kernel",
                                                                b5_main), f"done record {done}")
    check(lo <= done["mean_linear"] <= hi,
          f"Cornell pallas mean linear radiance {done['mean_linear']:.4f} outside [{lo}, {hi}]")
    say(f"phase 12 pallas main path: app.main Cornell 600x600 4 spp depth 50 --backend pallas, "
        f"{b5_main} B5 launches, no other kernel, mean linear radiance "
        f"{done['mean_linear']:.4f} in [{lo}, {hi}], {done['mpaths_per_s']:.4f} Mpaths/s over "
        f"{done['elapsed_s']:.3f} s on {card}")

    # Where one pallas Cornell sample (600x600, depth 50) spends its time:
    # CUDA-event spans of each part of the bounce loop, against the wall.
    spans = {k: [] for k in ("b5", "rng", "hit", "shade", "step")}

    def span(fn, bucket):
        def run(*a, **k):
            s_, e_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s_.record()
            out = fn(*a, **k)
            e_.record()
            spans[bucket].append((s_, e_))
            return out
        return run

    def make_step(*a, **k):
        return span(orig["make_step"](*a, **k), "step")

    orig = dict(b5=pk.closest_hit, rng=rng.bounce_uniforms, hit=intersect.closest_hit,
                shade=materials.shade, make_step=integrator._make_step)
    feats_p = dict(feats, use_megakernel=False, use_pallas=True,
                   pallas_extents=pk.live_extents(host))
    pk.closest_hit = span(orig["b5"], "b5")
    rng.bounce_uniforms = span(orig["rng"], "rng")
    intersect.closest_hit = span(orig["hit"], "hit")
    materials.shade = span(orig["shade"], "shade")
    integrator._make_step = make_step
    try:
        _, sample_ms = wall_ms(lambda: integrator.render_sample(
            ds, feats_p, 600, 600, 0, 0, 50, 4, chunk_size=CHUNK_CORNELL))
    finally:
        (pk.closest_hit, rng.bounce_uniforms, intersect.closest_hit, materials.shade,
         integrator._make_step) = (orig["b5"], orig["rng"], orig["hit"], orig["shade"],
                                   orig["make_step"])
    tot = {k: sum(s_.elapsed_time(e_) for s_, e_ in v) for k, v in spans.items()}
    n_steps = len(spans["step"])
    say(f"phase 12 where a pallas Cornell sample goes (600x600, depth 50, chunks of "
        f"{CHUNK_CORNELL}; {n_steps} bounce steps, each ending in a host read of the live "
        f"count): wall {sample_ms:.1f} ms; B5 {tot['b5']:.1f} ms ({len(spans['b5'])} launches); "
        f"rest of the closest hit (records, media) {tot['hit'] - tot['b5']:.1f} ms; threefry "
        f"draws {tot['rng']:.1f} ms; shading {tot['shade']:.1f} ms; step glue "
        f"{tot['step'] - tot['hit'] - tot['rng'] - tot['shade']:.1f} ms; outside the steps "
        f"(camera, keys, compaction, chunking, host) {sample_ms - tot['step']:.1f} ms "
        f"(CUDA-event spans) ({card})")

    done, counts = cli(book2, os.path.join(work, "book2_pallas.png"), "--samples", "1",
                       "--backend", "pallas")
    b5_book2 = counts["b5"]
    check(b5_book2 > 0 and counts["v4"] == counts["wavefront"] == counts["b4"] == 0,
          f"book-2 pallas main path launches {counts}")
    mean = done["mean_linear"]
    check(abs(mean / BOOK2_MEAN_64 - 1.0) < BOOK2_MEAN_RTOL,
          f"book-2 pallas mean linear radiance {mean:.4f} vs {BOOK2_MEAN_64}")
    say(f"phase 12 pallas main path: app.main book2 600x600 1 spp depth 50 --backend pallas, "
        f"{b5_book2} B5 launches, no other kernel, mean linear radiance {mean:.4f} (kernel "
        f"path, 64 spp: {BOOK2_MEAN_64}), {done['mpaths_per_s']:.4f} Mpaths/s over "
        f"{done['elapsed_s']:.3f} s on {card}")

    ell = scene_file("ellipsoid", ellipsoid_scene_json())
    done, counts = cli(ell, os.path.join(work, "ellipsoid.png"), "--samples", "4",
                       "--width", "600", "--height", "600")
    check(done["route"] == "xla" and done["kernel"] is None and not any(counts.values()),
          f"ellipsoid main path: done {done}, launches {counts}")
    say(f"phase 12 dense main path: app.main ellipsoid scene 600x600 4 spp depth 50 "
        f"--backend auto -> route {done['route']}, no kernel launched, mean linear radiance "
        f"{done['mean_linear']:.4f}, {done['mpaths_per_s']:.4f} Mpaths/s over "
        f"{done['elapsed_s']:.3f} s on {card}")
    ell_host, _ = loader.load_scene(ell)
    img_card = Renderer(ell_host, 64, 64, num_samples=4, max_depth=8, device=dev).render(batch=4)
    img_cpu = Renderer(ell_host, 64, 64, num_samples=4, max_depth=8,
                       device="cpu").render(batch=4)
    d_mean = abs(float(img_card.mean() - img_cpu.mean()))
    flipped = np.abs(img_card - img_cpu).max(-1) > 1e-4
    psnr = compare.psnr(img_card[~flipped], img_cpu[~flipped]) if (~flipped).any() else 0.0
    check(d_mean < 1e-3 and flipped.mean() <= 0.005 and psnr >= 60.0,
          f"ellipsoid 64x64 card vs CPU: |dmean| {d_mean:.3g}, {int(flipped.sum())} pixels "
          f"flipped, PSNR {psnr:.2f} dB over the rest")
    say(f"phase 12 ellipsoid 64x64 4 spp depth 8, card vs CPU: |dmean| {d_mean:.3g}, "
        f"{int(flipped.sum())} of 4096 pixels differ > 1e-4, PSNR {psnr:.2f} dB over the "
        f"others (gate 1e-3, 0.5 %, 60 dB)")

    feats_b4 = dict(feats, use_megakernel=True)
    pk.LAUNCHES = mk.LAUNCHES = wf.LAUNCHES = mk3.LAUNCHES = 0
    acc, b4_wall = wall_ms(lambda: sum(
        integrator.render_sample(ds, feats_b4, 600, 600, s, 0, 50, 4) for s in range(16)))
    b4_main = mk3.LAUNCHES
    check(b4_main > 0 and mk.LAUNCHES == wf.LAUNCHES == pk.LAUNCHES == 0,
          f"B4 main path launches: B4 {b4_main}, v4 {mk.LAUNCHES}, wavefront {wf.LAUNCHES}, "
          f"B5 {pk.LAUNCHES}")
    mean_b4 = float(acc.mean()) / 16
    v4_mean = float(Renderer(host, 600, 600, num_samples=16, max_depth=50, seed=0,
                             device=dev).render(batch=16).mean())
    check(np.isfinite(mean_b4) and abs(mean_b4 - v4_mean) < 1e-3,
          f"B4 Cornell mean {mean_b4:.5f} vs v4's {v4_mean:.5f}")
    say(f"phase 12 B4 main path: integrator.render_sample with use_megakernel, Cornell "
        f"600x600, 16 samples, depth 50: {b4_main} B4 launches, mean linear radiance "
        f"{mean_b4:.5f} (v4 at the same seed and samples: {v4_mean:.5f}), "
        f"{16 * 360000 / b4_wall / 1e3:.3f} Mpaths/s over {b4_wall:.1f} ms on {card}")

    main = b5[("cornell", 0)]
    return [{
        "name": "intersect_kernel", "route": "cuda",
        "source": "raytrace2_tpu_torch/csrc/intersect_kernel.cu",
        "replaces": "raytrace2_tpu/ops/pallas/intersect_kernel.py:159 (_kernel)",
        "status": "ported, PR 5; redesigned, PR 9",
        "design": B5_DESIGN,
        "launches": b5_main, "max_abs_err": main["max_abs_err"],
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "group": main["group"], "threads_per_block": main["threads_per_block"],
        "shape": f"cornell 600x600, a {CHUNK_CORNELL}-ray chunk at its first launch",
        "launches_book2": b5_book2,
        "launches_measured": {f"{name} {roofline.b5_launch_name(pick)}": r
                              for (name, pick), r in b5.items()},
    }, {
        "name": "megakernel_v3", "route": "cuda",
        "source": "raytrace2_tpu_torch/csrc/megakernel_v3.cu",
        "replaces": "raytrace2_tpu/ops/pallas/megakernel.py:1422 (_render_kernel)",
        "status": "ported, PR 5; PR 6 adds the cluster-skip sweep (hash noise, as the JAX v3 "
                  "kernel)",
        "launches": b4_main, "max_abs_err": b4_err,
        "ms": b4_ms, "plain_ms": b4_plain_ms,
        "bound_ms": b4_bound_ms, "bound_by": b4_bound_by,
        "library_ms": None,
        "shape": "cornell 600x600, depth 50, the first pass (min_alive 8 of 128)",
    }], ceil


def scene_groups(tree) -> dict:
    """{leaf group: [float leaves]} of a gradient FlatScene: the top-level
    fields (spheres, quads, ..., camera) and the background."""
    import dataclasses

    out = {}
    for f in dataclasses.fields(tree):
        node = getattr(tree, f.name)
        if node is None:
            continue
        leaves = ([getattr(node, g.name) for g in dataclasses.fields(node)]
                  if dataclasses.is_dataclass(node) else [node])
        leaves = [x for x in leaves if x is not None]
        if leaves:
            out[f.name] = leaves
    return out


def grad_gate(ours, ref, rtol=GRAD_RTOL, atol=GRAD_ATOL) -> dict:
    """max|ours - ref| / max|ref| per leaf group of two gradient FlatScenes;
    fails unless every group is finite and within ``rtol`` of its largest
    cotangent (+ ``atol``)."""
    import torch

    out = {}
    a, b = scene_groups(ours), scene_groups(ref)
    for name, leaves in b.items():
        scale = max(float(x.abs().max()) if x.numel() else 0.0 for x in leaves)
        err = max(float((x.cpu() - y.cpu()).abs().max()) if y.numel() else 0.0
                  for x, y in zip(a[name], leaves))
        check(all(bool(torch.isfinite(x).all()) for x in a[name]) and err <= rtol * scale + atol,
              f"gradient group {name}: max|d| {err:.4g} against max|g| {scale:.4g} (gate "
              f"{rtol:g} max|g| + {atol:g})")
        out[name] = err / scale if scale else 0.0
    return out


def scan_grad_phase(card, cornell, work) -> dict:
    """Phase 21: the differentiable scan (grad.render_image's fallback) on the
    card at full width: grad.value_and_grad_scene's steps (L2 loss against a
    fixed target) on Cornell 600x600 at depth 65 (above B3's 64, so the scan,
    with no v4 or B3 launch) and on the ellipsoid scene 600x600 at depth 50,
    1 sample each: forward and backward wall, peak device memory, every
    float cotangent finite. Then the card's scan gradient against the CPU's
    at 64x64, depth 8, within 1e-3 of each leaf group's largest cotangent,
    with the pixels whose path flips between the two (found from the
    forward images under the scene's background and a white one) out of the
    loss on both sides."""
    import dataclasses

    import numpy as np
    import torch

    from test_torch_scenes import ellipsoid_scene_json

    from raytrace2_tpu_torch import grad
    from raytrace2_tpu_torch.ops.kernels import megakernel as mk
    from raytrace2_tpu_torch.ops.kernels import megakernel_grad as mkg
    from raytrace2_tpu_torch.ops.kernels import wavefront as wf
    from raytrace2_tpu_torch.scene import loader, schema

    dev = torch.device("cuda", 0)
    ell = os.path.join(work, "ellipsoid_scan.json")
    with open(ell, "w") as f:
        json.dump(ellipsoid_scene_json(), f)
    out = {}
    for name, path, depth in (("cornell", cornell, 65), ("ellipsoid", ell, 50)):
        host, _ = loader.load_scene(path)
        feats = dict(host.features(), use_megakernel=True)
        check(not grad.takes_kernel(feats, depth), f"{name} at depth {depth} takes the kernels")
        scene = schema.to_device(host, dev)
        target = torch.full((600, 600, 3), 0.25, device=dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        mk.LAUNCHES = wf.LAUNCHES = mkg.LAUNCHES = 0
        params, leaves = grad.scene_params(scene)
        t0 = time.perf_counter()
        img = grad.render_image(params, feats, 0, width=600, height=600, n_samples=1,
                                max_depth=depth, sqrt_spp=1)
        loss = torch.sum((img - target) ** 2)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        g = grad.grad_tree(params, torch.autograd.grad(loss, leaves, allow_unused=True))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        loss = loss.detach()
        peak = torch.cuda.max_memory_allocated(dev)
        check(mk.LAUNCHES == wf.LAUNCHES == mkg.LAUNCHES == 0,
              f"{name} scan launched v4 {mk.LAUNCHES}, wavefront {wf.LAUNCHES}, B3 "
              f"{mkg.LAUNCHES} times")
        floats = [x for xs in scene_groups(g).values() for x in xs]
        check(all(bool(torch.isfinite(x).all()) for x in floats), f"{name} scan gradient "
                                                                 "not finite")
        img = img.detach()
        check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0,
              f"{name} scan image mean {float(img.mean())}")
        nonzero = sum(int((x != 0).sum()) for x in floats)
        out[name] = {"depth": depth, "forward_ms": (t1 - t0) * 1e3,
                     "backward_ms": (t2 - t1) * 1e3, "peak_bytes": int(peak),
                     "loss": float(loss), "nonzero_cotangents": nonzero}
        say(f"phase 21 scan gradient, grad.render_image + torch.autograd.grad, {name} 600x600 "
            f"1 spp depth {depth}: loss {float(loss):.6g}, forward {(t1 - t0) * 1e3:.1f} ms, "
            f"backward {(t2 - t1) * 1e3:.1f} ms, peak device memory {peak / 2**30:.2f} GiB, "
            f"{len(floats)} float leaves finite ({nonzero} nonzero entries), no v4/B3 launch "
            f"({card})")
        del img, loss, g, params, leaves, floats
        torch.cuda.empty_cache()

    kw = dict(width=64, height=64, n_samples=1, max_depth=8, sqrt_spp=1)
    target = np.random.RandomState(0).uniform(size=(64, 64, 3)).astype(np.float32)
    for name, path in (("cornell", cornell), ("ellipsoid", ell)):
        host, _ = loader.load_scene(path)
        feats = dict(host.features(), use_megakernel=False)
        res = {}
        for d in ("cpu", dev):
            scene = schema.to_device(host, d)
            with torch.no_grad():
                imgs = [grad.render_image(s, feats, 0, **kw).cpu().numpy() for s in (
                    scene, dataclasses.replace(scene, background=torch.ones(3, device=d)))]
            res[str(d)] = (scene, imgs)
        (s_cpu, i_cpu), (s_dev, i_dev) = res["cpu"], res[str(dev)]
        flipped = np.zeros((64, 64), bool)
        for a, b in zip(i_dev, i_cpu):
            flipped |= np.any(np.abs(a - b) > 2e-5 + 2e-4 * np.abs(b), axis=-1)
        check(flipped.mean() <= 0.005, f"{name} 64x64 card vs CPU scan: {int(flipped.sum())} "
                                       "pixels flip")
        weight = torch.from_numpy((~flipped).astype(np.float32)[..., None])
        tt = torch.from_numpy(target)
        grads = []
        for scene, d in ((s_cpu, "cpu"), (s_dev, dev)):
            w, t = weight.to(d), tt.to(d)
            grads.append(grad.value_and_grad_scene(lambda im: torch.sum(w * (im - t) ** 2),
                                                   scene, feats, 0, **kw))
        (l_cpu, g_cpu), (l_dev, g_dev) = grads
        check(abs(float(l_dev) - float(l_cpu)) <= 1e-4 * abs(float(l_cpu)),
              f"{name} scan loss card {float(l_dev)} vs CPU {float(l_cpu)}")
        rel = grad_gate(g_dev, g_cpu, rtol=1e-3, atol=1e-6)
        out[name]["card_vs_cpu_64"] = {"flipped": int(flipped.sum()), "rel": rel}
        say(f"phase 21 scan gradient card vs CPU, {name} 64x64 1 spp depth 8: "
            f"{int(flipped.sum())} of 4096 pixels flip (out of the loss), max|d|/max|g| per "
            f"group " + ", ".join(f"{k} {v:.2g}" for k, v in rel.items()) + " (gate 1e-3)")
    return out


def _sharded_ranks(cornell, book2) -> dict:
    """One rank of phase 22's pair of gloo ranks on cuda:0: the kernel path
    sharded at meshes (1, 2) and (2, 1) on Cornell 600x600 16 spp, book 2
    at (1, 2) through the wavefront and through v4 forced (the block-tiled
    layout), grad_sharded_auto at (1, 2) (B3 on each rank's run of slots),
    train_step_analog through B5 and render_grad_sharded (the scan)."""
    import torch

    from raytrace2_tpu_torch import render as render_mod
    from raytrace2_tpu_torch.ops.kernels import intersect_kernel as pk
    from raytrace2_tpu_torch.ops.kernels import megakernel as mk
    from raytrace2_tpu_torch.ops.kernels import megakernel_grad as mkg
    from raytrace2_tpu_torch.ops.kernels import wavefront as wf
    from raytrace2_tpu_torch.parallel import sharding
    from raytrace2_tpu_torch.scene import loader, schema

    dev = torch.device("cuda", 0)
    kw = dict(width=600, height=600, max_depth=50, sqrt_spp=4)
    out = {}
    meshes = {}
    for name, path, (sp, dp), extra in (("cornell_1x2", cornell, (1, 2), {}),
                                        ("cornell_2x1", cornell, (2, 1), {}),
                                        ("book2_1x2", book2, (1, 2), {}),
                                        ("book2v4_1x2", book2, (1, 2),
                                         {"mega_wavefront": False})):
        host, _ = loader.load_scene(path)
        scene = schema.to_device(host, dev)
        feats = dict(host.features(), use_megakernel=True, **extra)
        mesh = meshes.setdefault((sp, dp), sharding.make_mesh(sp=sp, dp=dp, device=dev))
        spd = 16 // sp
        sharding.render_samples_sharded_mega(scene, feats, 0, 0, samples_per_device=1,
                                             mesh=mesh, **kw)  # warm-up
        mk.LAUNCHES = wf.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = sharding.render_samples_sharded_mega(scene, feats, 0, 0, samples_per_device=spd,
                                                   mesh=mesh, **kw)
        torch.cuda.synchronize()
        out[name] = {"image": img.cpu(), "ms": (time.perf_counter() - t0) * 1e3,
                     "v4": mk.LAUNCHES, "wavefront": wf.LAUNCHES,
                     "pix0": mesh.dp_index * sharding._slot_chunk(feats, 600, 600, dp)[0]}
        if name == "cornell_1x2":
            target = torch.full((600, 600, 3), 0.3, device=dev)
            # Warm-up: the first backward loads torch's kernels for it.
            sharding.grad_sharded_auto(scene, feats, target, 0, n_samples=1, mesh=mesh, **kw)
            mkg.LAUNCHES = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, g = sharding.grad_sharded_auto(scene, feats, target, 0, n_samples=16,
                                                 mesh=mesh, **kw)
            torch.cuda.synchronize()
            out["grad_1x2"] = {"loss": float(loss), "b3": mkg.LAUNCHES,
                               "ms": (time.perf_counter() - t0) * 1e3,
                               "grad": schema.map_leaves(g, lambda x: x.cpu())}
    host, _ = loader.load_scene(cornell)
    scene = schema.to_device(host, dev)
    mesh = meshes[(1, 2)]
    # The non-kernel drivers. The features carry no B5 extents: the sharded
    # render reads them.
    pk.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = sharding.train_step_analog(
        scene, dict(host.features(), use_pallas=True), render_mod.init_state(600, 600, dev), 0,
        width=600, height=600, max_depth=50, sqrt_spp=1, samples_per_device=1, mesh=mesh)
    torch.cuda.synchronize()
    out["pallas_1x2"] = {"image": state.accum.cpu(), "frame_idx": state.frame_idx,
                         "ms": (time.perf_counter() - t0) * 1e3, "b5": pk.LAUNCHES}
    target = torch.full((64, 64, 3), 0.3, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, g = sharding.render_grad_sharded(scene, host.features(), target, 0, width=64,
                                           height=64, max_depth=8, sqrt_spp=1, n_samples=1,
                                           mesh=mesh)
    torch.cuda.synchronize()
    out["scan_1x2"] = {"loss": float(loss), "ms": (time.perf_counter() - t0) * 1e3,
                       "grad": schema.map_leaves(g, lambda x: x.cpu())}
    return out


def sharded_phase(card, cornell, book2, work) -> dict:
    """Phase 22: the sharded paths on the one card. A world of 1 under NCCL:
    render_samples_sharded_mega on Cornell 600x600 depth 50 64 spp at mesh
    (1, 1), bitwise the Renderer's image of the same samples, and
    grad_sharded_auto at 64 spp against value_and_grad_scene (B3's gate,
    one B3 launch). Two gloo ranks on cuda:0: Cornell 600x600 16 spp at
    (1, 2) bitwise and (2, 1) within 1e-6 relative, book 2 at (1, 2)
    through the wavefront (the second rank's slots start past 0) and through
    v4 forced (the block-tiled layout) bitwise, grad_sharded_auto at (1, 2)
    within B3's gate; train_step_analog through B5 against the pallas route
    and render_grad_sharded (the scan) against value_and_grad_scene; then
    the dry run's entry point as two gloo ranks on cuda:0 and under
    torchrun as a world of 1 under NCCL."""
    import torch

    from raytrace2_tpu_torch import grad
    from raytrace2_tpu_torch.ops import integrator
    from raytrace2_tpu_torch.ops.kernels import intersect_kernel as pk
    from raytrace2_tpu_torch.ops.kernels import megakernel as mk
    from raytrace2_tpu_torch.ops.kernels import megakernel_grad as mkg
    from raytrace2_tpu_torch.parallel import distributed, dryrun, sharding
    from raytrace2_tpu_torch.render import Renderer
    from raytrace2_tpu_torch.scene import loader, schema

    dev = torch.device("cuda", 0)
    out = {}
    host, _ = loader.load_scene(cornell)
    scene = schema.to_device(host, dev)
    feats = dict(host.features(), use_megakernel=True)
    distributed.initialize("nccl", init_method=f"file://{work}/nccl_rdzv", world_size=1,
                           rank=0, timeout_s=300)
    try:
        check(torch.distributed.get_backend() == "nccl", "the world of 1 is not NCCL")
        mesh = sharding.make_mesh(sp=1, dp=1, device=dev)
        r = Renderer(host, 600, 600, num_samples=64, max_depth=50, seed=0, device=dev)
        r.update(64)
        ref = r.state.accum
        kw = dict(width=600, height=600, max_depth=50, sqrt_spp=r.sqrt_spp)
        sharding.render_samples_sharded_mega(scene, feats, 0, 0, samples_per_device=1,
                                             mesh=mesh, **kw)  # warm-up
        mk.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = sharding.render_samples_sharded_mega(scene, feats, 0, 0, samples_per_device=64,
                                                   mesh=mesh, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check(mk.LAUNCHES == 1 and torch.equal(img, ref),
              f"NCCL world of 1: {mk.LAUNCHES} v4 launches, image equal to the Renderer's: "
              f"{torch.equal(img, ref)}")
        out["nccl_render"] = {"ms": ms, "launches": 1}
        say(f"phase 22 NCCL world of 1, render_samples_sharded_mega Cornell 600x600 64 spp "
            f"depth 50 mesh (1, 1): 1 v4 launch, bitwise the Renderer's image, {ms:.1f} ms "
            f"({card})")
        target = torch.full((600, 600, 3), 0.3, device=dev)
        gkw = dict(width=600, height=600, max_depth=GRAD_DEPTH, sqrt_spp=GRAD_SQRT_SPP,
                   n_samples=GRAD_SPP)
        # Warm-up: the first backward loads torch's kernels for it.
        sharding.grad_sharded_auto(scene, feats, target, 0, mesh=mesh, **dict(gkw, n_samples=1))
        mkg.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, g = sharding.grad_sharded_auto(scene, feats, target, 0, mesh=mesh, **gkw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        b3 = mkg.LAUNCHES
        check(b3 == 1, f"grad_sharded_auto launched B3 {b3} times")
        ref_loss, ref_g = grad.value_and_grad_scene(lambda im: torch.sum((im - target) ** 2),
                                                    scene, feats, 0, **gkw)
        check(abs(float(loss) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss)),
              f"sharded loss {float(loss)} vs {float(ref_loss)}")
        rel = grad_gate(g, ref_g)
        out["nccl_grad"] = {"ms": ms, "b3": b3, "rel": rel}
        say(f"phase 22 NCCL world of 1, grad_sharded_auto Cornell 600x600 {GRAD_SPP} spp depth "
            f"{GRAD_DEPTH}: 1 B3 launch, {ms:.1f} ms, against value_and_grad_scene max|d|/max|g| "
            + ", ".join(f"{k} {v:.2g}" for k, v in rel.items()) + f" (gate {GRAD_RTOL:g}) "
            f"({card})")
    finally:
        distributed.shutdown()

    t0 = time.perf_counter()
    ranks = dryrun.run_ranks(_sharded_ranks, 2, backend="gloo", args=(cornell, book2),
                             timeout_s=300.0)
    spawn_s = time.perf_counter() - t0
    for name in ("cornell_1x2", "cornell_2x1", "book2_1x2", "book2v4_1x2", "pallas_1x2"):
        check(torch.equal(ranks[0][name]["image"], ranks[1][name]["image"]),
              f"{name}: the two ranks hold different images")
    singles = {}
    for name, path, extra in (("cornell", cornell, {}), ("book2", book2, {}),
                              ("book2v4", book2, {"mega_wavefront": False})):
        h, _ = loader.load_scene(path)
        s = schema.to_device(h, dev)
        singles[name] = integrator.render_progressive(
            s, dict(h.features(), use_megakernel=True, **extra), 600, 600, 0, 16, 0, 50,
            4).cpu()
    for name, exact in (("cornell_1x2", True), ("cornell_2x1", False), ("book2_1x2", True),
                        ("book2v4_1x2", True)):
        img = ranks[0][name]["image"]
        ref = singles[name.split("_")[0]]
        if exact:
            check(torch.equal(img, ref), f"gloo {name}: not bitwise the single-device image")
            detail = "bitwise"
        else:
            d = (img - ref).abs()
            rel = float((d / ref.abs().clamp(min=1e-30)).max())
            check(bool((d <= 1e-6 * ref.abs()).all()), f"gloo {name}: max rel {rel:.3g}")
            detail = f"max rel {rel:.3g} (gate 1e-6)"
        kern = "wavefront" if name == "book2_1x2" else "v4"
        launches = [ranks[r][name][kern] for r in (0, 1)]
        check(all(n > 0 for n in launches), f"gloo {name}: launches per rank {launches}")
        out[f"gloo_{name}"] = {"ms": [ranks[r][name]["ms"] for r in (0, 1)],
                               "launches": launches,
                               "pix0": [ranks[r][name]["pix0"] for r in (0, 1)]}
        say(f"phase 22 gloo ranks on cuda:0, render_samples_sharded_mega {name} 600x600 16 spp "
            f"depth 50: {kern} launches per rank {launches}, slot0 per rank "
            f"{out[f'gloo_{name}']['pix0']}, {detail} against one device, ms per rank "
            + ", ".join(f"{x:.1f}" for x in out[f"gloo_{name}"]["ms"]) + f" ({card})")
    gr = ranks[0]["grad_1x2"]
    h, _ = loader.load_scene(cornell)
    target = torch.full((600, 600, 3), 0.3, device=dev)
    ref_loss, ref_g = grad.value_and_grad_scene(
        lambda im: torch.sum((im - target) ** 2), schema.to_device(h, dev),
        dict(h.features(), use_megakernel=True), 0, width=600, height=600, n_samples=16,
        max_depth=50, sqrt_spp=4)
    check(all(ranks[r]["grad_1x2"]["b3"] == 1 for r in (0, 1)), "gloo grad: B3 launches")
    check(abs(gr["loss"] - float(ref_loss)) <= 1e-5 * abs(float(ref_loss)),
          f"gloo grad loss {gr['loss']} vs {float(ref_loss)}")
    rel = grad_gate(gr["grad"], ref_g)
    out["gloo_grad_1x2"] = {"ms": [ranks[r]["grad_1x2"]["ms"] for r in (0, 1)], "rel": rel}
    say(f"phase 22 gloo ranks on cuda:0, grad_sharded_auto Cornell 600x600 16 spp depth 50 mesh "
        f"(1, 2): one B3 launch per rank (the second at slot0 "
        f"{ranks[1]['cornell_1x2']['pix0']}), max|d|/max|g| "
        + ", ".join(f"{k} {v:.2g}" for k, v in rel.items()) + f" (gate {GRAD_RTOL:g}), ms per "
        "rank " + ", ".join(f"{x:.1f}" for x in out["gloo_grad_1x2"]["ms"])
        + f"; both ranks spawned and done in {spawn_s:.1f} s ({card})")
    # The non-kernel drivers against one device: the pallas route (B5) and
    # the scan.
    h, _ = loader.load_scene(cornell)
    s = schema.to_device(h, dev)
    pallas = ranks[0]["pallas_1x2"]
    ref = integrator.render_sample(s, dict(h.features(), use_pallas=True,
                                           pallas_extents=pk.live_extents(h)),
                                   600, 600, 0, 0, 50, 1).cpu()
    d = (pallas["image"] - ref).abs()
    b5 = [ranks[r]["pallas_1x2"]["b5"] for r in (0, 1)]
    check(pallas["frame_idx"] == 1 and all(n > 0 for n in b5)
          and bool(torch.isfinite(pallas["image"]).all())
          and bool((d <= PALLAS_ATOL + PALLAS_RTOL * ref.abs()).all()),
          f"gloo train_step_analog with use_pallas: frame_idx {pallas['frame_idx']}, B5 "
          f"launches per rank {b5}, max|d| {float(d.max()):.3g} against the pallas route")
    out["gloo_pallas_1x2"] = {"ms": [ranks[r]["pallas_1x2"]["ms"] for r in (0, 1)],
                              "b5": b5, "max_abs": float(d.max()),
                              "bitwise": bool(torch.equal(pallas["image"], ref))}
    say(f"phase 22 gloo ranks on cuda:0, train_step_analog with use_pallas (the sharded "
        f"non-kernel render through B5, extents read by render_samples_sharded) Cornell 600x600 1 spp "
        f"depth 50 mesh (1, 2): B5 launches per rank {b5}, max|d| {float(d.max()):.3g} "
        f"against the single-device pallas route (bitwise: "
        f"{out['gloo_pallas_1x2']['bitwise']}; gate {PALLAS_RTOL:g} rel + {PALLAS_ATOL:g}), "
        "ms per rank (first call) " + ", ".join(f"{x:.1f}" for x in out["gloo_pallas_1x2"]["ms"])
        + f" ({card})")
    scan = ranks[0]["scan_1x2"]
    check(ranks[1]["scan_1x2"]["loss"] == scan["loss"], "gloo scan: the ranks' losses differ")
    target = torch.full((64, 64, 3), 0.3, device=dev)
    ref_loss, ref_g = grad.value_and_grad_scene(
        lambda im: torch.sum((im - target) ** 2), s, dict(h.features(), use_megakernel=False),
        0, width=64, height=64, n_samples=1, max_depth=8, sqrt_spp=1)
    check(abs(scan["loss"] - float(ref_loss)) <= 1e-5 * abs(float(ref_loss)),
          f"gloo scan loss {scan['loss']} vs {float(ref_loss)}")
    rel = grad_gate(scan["grad"], ref_g)
    out["gloo_scan_1x2"] = {"ms": [ranks[r]["scan_1x2"]["ms"] for r in (0, 1)], "rel": rel}
    say(f"phase 22 gloo ranks on cuda:0, render_grad_sharded (the scan) Cornell 64x64 1 spp "
        f"depth 8 mesh (1, 2): against value_and_grad_scene's scan max|d|/max|g| "
        + ", ".join(f"{k} {v:.2g}" for k, v in rel.items()) + f" (gate {GRAD_RTOL:g}), ms per "
        "rank (first call) " + ", ".join(f"{x:.1f}" for x in out["gloo_scan_1x2"]["ms"])
        + f" ({card})")
    out["gloo_spawn_s"] = spawn_s

    # The dry run's entry point (every sharded entry point at 16x16, finite
    # results, a nonzero kernel-route gradient): two gloo ranks on cuda:0,
    # then under torchrun a world of 1 under NCCL.
    env = dict(os.environ, PYTHONPATH=ROOT)
    for label, cmd in (
            ("2 gloo ranks on cuda:0", [sys.executable, "-m", "raytrace2_tpu_torch.parallel.dryrun",
                                        "--nproc", "2", "--device", "cuda:0", "--backend",
                                        "gloo", "--timeout", "300"]),
            ("torchrun, a world of 1 under NCCL",
             [sys.executable, "-m", "torch.distributed.run", "--standalone",
              "--nproc_per_node", "1", "-m", "raytrace2_tpu_torch.parallel.dryrun",
              "--device", "cuda", "--timeout", "300"])):
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=400)
        wall = time.perf_counter() - t0
        rows = [json.loads(line) for line in r.stdout.splitlines() if line.startswith("{")]
        check(r.returncode == 0 and rows and "kernel_grad_nonzero" in rows[0],
              f"dryrun, {label}: rc {r.returncode}, {len(rows)} rows; stderr "
              f"{r.stderr[-1500:]}")
        out[f"dryrun {label}"] = {"s": wall, "rows": rows}
        say(f"phase 22 python -m raytrace2_tpu_torch.parallel.dryrun, {label}: "
            + "; ".join(json.dumps(row) for row in rows) + f"; {wall:.1f} s ({card})")
    return out


def live_cli_phase(card, cornell, work) -> dict:
    """Phase 23: the live CLI on the card. app.main --live --live-cols 80 on
    Cornell 600x600 16 spp (stdout captured): one ANSI frame per launch,
    and the PNG of the run without --live; --profile DIR writes a Chrome
    trace whose kernel events name v4's launches."""
    from raytrace2_tpu_torch import app
    from raytrace2_tpu_torch.ops.kernels import megakernel as mk

    args = ["--samples", "16", "--width", "600", "--height", "600", "--depth", "50",
            "--device", "cuda"]
    plain, live = os.path.join(work, "plain.png"), os.path.join(work, "live.png")
    check(app.main([cornell, plain, "--quiet", *args]) == 0, "app.main without --live")
    buf = io.StringIO()
    mk.LAUNCHES = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = app.main([cornell, live, "--live", "--live-cols", "80", *args])
    live_s = time.perf_counter() - t0
    text = buf.getvalue()
    frames = text.count("\x1b[0m\n\x1b[2Ksample ")
    check(rc == 0 and mk.LAUNCHES > 0 and frames == mk.LAUNCHES,
          f"--live: rc {rc}, {frames} frames for {mk.LAUNCHES} v4 launches")
    with open(plain, "rb") as f, open(live, "rb") as g:
        check(f.read() == g.read(), "--live wrote another PNG than the run without it")
    say(f"phase 23 live CLI: app.main --live --live-cols 80 Cornell 600x600 16 spp depth 50: "
        f"{frames} ANSI frames for {mk.LAUNCHES} v4 launches, {len(text)} characters, "
        f"{live_s:.2f} s, PNG equal to the run without --live ({card})")
    prof = os.path.join(work, "prof")
    mk.LAUNCHES = 0
    t0 = time.perf_counter()
    check(app.main([cornell, os.path.join(work, "prof.png"), "--quiet", "--profile", prof,
                    *args]) == 0, "app.main --profile")
    prof_s = time.perf_counter() - t0
    with open(os.path.join(prof, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    v4_events = [e for e in events if e.get("cat") == "kernel"
                 and "megakernel_v4" in e.get("name", "")]
    check(len(v4_events) == mk.LAUNCHES > 0,
          f"--profile: {len(v4_events)} kernel events name megakernel_v4 for {mk.LAUNCHES} "
          f"launches ({len(events)} events)")
    v4_us = sum(float(e.get("dur", 0.0)) for e in v4_events)
    say(f"phase 23 --profile: trace.json with {len(events)} events, {len(v4_events)} kernel "
        f"events of megakernel_v4 (= its launches), {v4_us / 1e3:.2f} ms of v4 on the card's "
        f"clock, run {prof_s:.2f} s ({card})")
    return {"live_s": live_s, "frames": frames, "profile_s": prof_s,
            "profile_v4_events": len(v4_events), "profile_v4_ms": v4_us / 1e3}


# The image gate of a BVH path against the dense sweep on the same streams:
# the dense sweep's expanded quadratic (c0.c0 - 2 o.c0 + o.o - r^2) cancels
# at these scenes' scales, so it finds false hits just past t_min next to a
# sphere a ray leaves (self-intersection) and the paths part there: the
# means within 5 % and 85 % of the pixels within 1e-3 (book 1, book 2 and
# the 5,000-sphere grid at 48x48, 2 spp, depth 8 on the CPU: 99 %, 99 % and
# 90 %). The hit gate on the main paths' launches decides which is right.
BVH_IMAGE_MEAN_RTOL, BVH_IMAGE_NEAR, BVH_IMAGE_SHARE = 0.05, 1e-3, 0.85
# The hit gate on a launch: a ray passes where the walk and the dense sweep
# pick the same sphere, where the walk's sphere is the nearer by the float64
# roots, or where the nearer root lies within BVH_NEAR_SURFACE of the origin
# (a ray leaving a surface: both float32 tests cancel there, the walk's
# oc.oc - r^2 on book 1's radius-1,000 ground too); at least this share of
# the rays passes.
BVH_HIT_OK_SHARE, BVH_NEAR_SURFACE = 0.995, 1e-2

def exact_sphere_t(spheres, o, d, tm, t_min, prim):
    """Float64 nearest root above t_min of each ray's sphere ``prim`` (inf
    where the sphere is missed or prim is -1)."""
    import torch

    p = prim.clamp(min=0).long()
    c = spheres.center0[p].double() + tm.double()[:, None] * spheres.displacement[p].double()
    oc, dd = c - o.double(), d.double()
    a, h = (dd * dd).sum(1), (dd * oc).sum(1)
    cc = (oc * oc).sum(1) - spheres.radius[p].double() ** 2
    disc = h * h - a * cc
    sq = torch.sqrt(disc.clamp(min=0.0))
    r0, r1 = (h - sq) / a, (h + sq) / a
    t = torch.where(r0 > t_min.double(), r0, torch.where(r1 > t_min.double(), r1, float("inf")))
    return torch.where((disc >= 0) & (prim >= 0), t, float("inf"))


def sphere_bvh_phases(dev, card, scene_file, book2):
    """Phases 24-25: the sphere BVH walk (csrc/bvh_traverse.cu).

    24. The three BVH main paths through app.main at 600x600, 1 spp, depth
        50, the launch counts reset before each and read after: book 1
        --backend bvh (65,536-ray chunks), book 2 --backend xla (1,005
        spheres: the walk from 256 on; 16,384-ray chunks) and the
        5,000-sphere grid through auto (above 4,096 records: the non-kernel
        path). The walk launches and no other kernel; the done record
        names the route and kernel. Each path's first launch and its fourth
        are captured; on them the walk's hits are held against the dense
        sweep's (BVH_HIT_OK_SHARE, the float64 roots deciding); then
        each path's image at 48x48, 2 spp, depth 8 against the dense
        sweep's on the same streams (BVH_IMAGE_*).
    25. The walk against its plain version, bitwise, on the captured
        launches (book 1's 65,536-ray chunk and book 2's 16,384-ray chunk
        among them), timed with CUDA events beside the plain walk and the
        dense sphere sweep of the same rays; its bound from the nodes and
        leaves the plain walk visited.
    Returns the kernels-line entry of bvh_traverse and the paths' records."""
    import numpy as np
    import torch

    from test_torch_scenes import separated_spheres_json

    from raytrace2_tpu_torch import app
    from raytrace2_tpu_torch.ops import bvh_traverse, integrator, intersect
    from raytrace2_tpu_torch.ops.kernels import intersect_kernel as pk
    from raytrace2_tpu_torch.ops.kernels import megakernel as mk
    from raytrace2_tpu_torch.ops.kernels import megakernel_v3 as mk3
    from raytrace2_tpu_torch.ops.kernels import wavefront as wf
    from raytrace2_tpu_torch.render import Renderer
    from raytrace2_tpu_torch.scene import loader
    from raytrace2_tpu_torch.tools import make_scene

    paths = (("book1", scene_file("book1", make_scene.book1_final(0).to_json()), "bvh"),
             ("book2", book2, "xla"),
             ("grid5000", scene_file("grid5000", separated_spheres_json(5000)), "auto"))
    work = os.path.dirname(book2)
    records, captured = {}, {}
    orig = bvh_traverse.closest_sphere
    for name, path, backend in paths:
        calls = []

        def capture(tables, o, d, time_, t_min, t_max, max_depth, stats=None):
            if len(calls) in (0, 3):
                captured[(name, len(calls))] = (tables, *(x.clone() for x in
                                                          (o, d, time_, t_min, t_max)),
                                                max_depth)
            calls.append(o.shape[0])
            return orig(tables, o, d, time_, t_min, t_max, max_depth, stats)

        out, metrics = os.path.join(work, f"{name}_bvh.png"), os.path.join(work, f"{name}.jsonl")
        bvh_traverse.LAUNCHES = pk.LAUNCHES = mk.LAUNCHES = wf.LAUNCHES = mk3.LAUNCHES = 0
        bvh_traverse.closest_sphere = capture
        try:
            rc = app.main([path, out, "--samples", "1", "--width", "600", "--height", "600",
                           "--depth", "50", "--device", "cuda", "--metrics", metrics,
                           "--quiet", "--backend", backend])
        finally:
            bvh_traverse.closest_sphere = orig
        counts = dict(walk=bvh_traverse.LAUNCHES, b5=pk.LAUNCHES, v4=mk.LAUNCHES,
                      wavefront=wf.LAUNCHES, b4=mk3.LAUNCHES)
        check(rc == 0, f"app.main {name} --backend {backend} exited {rc}")
        with open(metrics) as f:
            done = [json.loads(line) for line in f][-1]
        check(counts["walk"] == len(calls) > 0 and not any(
            v for k, v in counts.items() if k != "walk"), f"{name} BVH main path: {counts}")
        check((done["route"], done["kernel"], done["launches"]) == (
            "bvh", "bvh_traverse", counts["walk"]), f"{name} done record {done}")
        check(np.isfinite(done["mean_linear"]) and done["mean_linear"] > 0,
              f"{name}: mean linear radiance {done['mean_linear']}")
        host, _ = loader.load_scene(path)
        r = Renderer(host, 48, 48, num_samples=2, max_depth=8, backend=backend, device=dev)
        img = r.render(batch=2)
        feats = {k: v for k, v in r._features.items() if k != "use_bvh_spheres"}
        dense = (integrator.render_progressive(r.scene, feats, 48, 48, 0, 2, 0, 8, 1)
                 / 2).cpu().numpy()
        d_mean = abs(float(img.mean()) / float(dense.mean()) - 1.0)
        near = float((np.abs(img - dense).max(-1) <= BVH_IMAGE_NEAR).mean())
        check(d_mean <= BVH_IMAGE_MEAN_RTOL and near >= BVH_IMAGE_SHARE,
              f"{name} BVH image vs the dense sweep's: means {d_mean:.3%} apart, "
              f"{near:.1%} of pixels within {BVH_IMAGE_NEAR}")
        records[name] = dict(backend=backend, launches=counts["walk"], chunks=sorted(
            set(calls), reverse=True)[:3], mean_linear=done["mean_linear"],
            mpaths_per_s=done["mpaths_per_s"], elapsed_s=done["elapsed_s"],
            bvh_depth=r._features["bvh_depth"], nodes=r.scene.sphere_bvh.num_nodes,
            image_48=dict(mean_rel_diff=d_mean, share_within_1e3=near))
        say(f"phase 24 BVH main path {name}: app.main 600x600 1 spp depth 50 --backend "
            f"{backend} -> route bvh, {counts['walk']} walk launches (= launches per sample), "
            f"no other kernel, tree of {r.scene.sphere_bvh.num_nodes} nodes, depth "
            f"{r._features['bvh_depth']}; mean linear radiance {done['mean_linear']:.4f}, "
            f"{done['mpaths_per_s']:.4f} Mpaths/s over {done['elapsed_s']:.3f} s; 48x48 2 spp "
            f"depth 8 against the dense sweep: means {d_mean:.3%} apart, {near:.1%} of pixels "
            f"within {BVH_IMAGE_NEAR} ({card})")

    launches = {}
    for (name, idx), (tables, o, d, tm, t0, t1, depth) in sorted(captured.items()):
        label = f"{name} launch {idx} ({o.shape[0]} rays)"
        (t_k, p_k), ms = event_ms(lambda: bvh_traverse.closest_sphere(tables, o, d, tm, t0, t1,
                                                                      depth), 5)
        stats = {}
        (t_p, p_p), plain_ms = wall_ms(lambda: bvh_traverse.closest_sphere_plain(
            tables, o, d, tm, t0, t1, depth, stats))
        check(torch.equal(p_k, p_p) and torch.equal(t_k.view(torch.int32),
                                                    t_p.view(torch.int32)),
              f"the walk on {label} differs from its plain version")
        spheres = captured_spheres(tables)
        dense_fn = lambda: intersect._first_min(intersect._sphere_ts(  # noqa: E731
            spheres, o, d, tm, t0, t1))
        (t_d, i_d), dense_ms = event_ms(dense_fn, 3)
        p_d = torch.where(t_d < intersect.BIG, i_d, -1)
        differ = p_d != p_k.long()
        e_k = exact_sphere_t(spheres, o, d, tm, t0, p_k)
        e_d = exact_sphere_t(spheres, o, d, tm, t0, p_d)
        right = differ & (e_k <= e_d * (1 + 1e-6))
        near = differ & ~right & (torch.minimum(e_k, e_d) < BVH_NEAR_SURFACE)
        n_diff, n_right, n_near = int(differ.sum()), int(right.sum()), int(near.sum())
        share_ok = 1.0 - (n_diff - n_right - n_near) / o.shape[0]
        check(share_ok >= BVH_HIT_OK_SHARE,
              f"{label}: the walk and the dense sweep differ on {n_diff} rays, the walk the "
              f"nearer by the float64 roots on {n_right}, {n_near} within "
              f"{BVH_NEAR_SURFACE} of the origin: {share_ok:.3%} of rays agree or are right")
        ops, nbytes = bvh_traverse.bound_counts(stats, o.shape[0], tables[2].numel(),
                                                tables[7].numel())
        bound_ms = max(ops / PEAK_F32_OPS, nbytes / PEAK_BYTES) * 1e3
        bound_by = "operations" if ops / PEAK_F32_OPS >= nbytes / PEAK_BYTES else "bytes"
        launches[label] = dict(n=o.shape[0], ms=ms, plain_ms=plain_ms, dense_ms=dense_ms,
                               bound_ms=bound_ms, bound_by=bound_by, ops=ops, bytes=nbytes,
                               nodes=stats["nodes"], leaves=stats["leaves"],
                               longest_walk=stats["steps"], hits=int((p_k >= 0).sum()),
                               dense_differs=n_diff, walk_right=n_right, near_surface=n_near,
                               share_ok=share_ok,
                               max_abs_err=float((t_k - t_p).abs().max()))
        say(f"phase 25 walk vs plain, {label}: bitwise (t and sphere); {int((p_k >= 0).sum())} "
            f"hit; kernel {ms:.4f} ms (mean of 5, CUDA events), plain walk {plain_ms:.1f} ms "
            f"({stats['steps']} steps), the dense sphere sweep of the same rays "
            f"{dense_ms:.3f} ms; {stats['nodes']} nodes and {stats['leaves']} leaves visited "
            f"-> {ops:.6g} f32 ops, {nbytes} B -> bound {bound_ms:.5f} ms by {bound_by}; the "
            f"dense sweep picks another sphere on {n_diff} rays: the walk's the nearer by the "
            f"float64 roots on {n_right}, {n_near} within {BVH_NEAR_SURFACE} of the origin "
            f"(f32's reach) ({card})")
    main = launches[next(k for k in launches if k.startswith("book1 launch 0"))]
    return {
        "name": "bvh_traverse", "route": "cuda",
        "source": "raytrace2_tpu_torch/csrc/bvh_traverse.cu",
        "replaces": "raytrace2_tpu/ops/bvh_traverse.py:38 (traverse_one, XLA while_loop)",
        "status": "ported, PR 12: a device loop of the JAX package outside Pallas, written as "
                  "a kernel",
        "design": "one thread a ray, the stack in local memory (64 entries, the depth "
                  "checked on the host), the slab test with NaN as a miss, the sphere leaf of "
                  "_sphere_best_bvh",
        "launches": records["book1"]["launches"],
        "max_abs_err": main["max_abs_err"],
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "shape": "book1 600x600 --backend bvh, the first 65,536-ray chunk's first launch "
                 "(launches: that path's 1-spp run)",
        "dense_ms": main["dense_ms"],
        "launches_measured": launches,
    }, records


def captured_spheres(tables):
    """The spheres of the walk's tables (``bvh_traverse.pack``) under the
    field names of ``schema.Spheres`` that ``intersect._sphere_ts`` reads."""
    import types

    import torch

    c0, disp, rad = tables[5:]
    return types.SimpleNamespace(center0=c0, displacement=disp, radius=rad,
                                 active=torch.ones_like(rad, dtype=torch.bool))


DOUBLE_WORKER = """
import json, time, numpy as np, torch
from raytrace2_tpu_torch import defs
from raytrace2_tpu_torch.ops import integrator
from raytrace2_tpu_torch.scene import schema
from raytrace2_tpu_torch.tools import make_scene
host, _, _ = make_scene.load("cornell_corpus")
feat = dict(host.features(), use_megakernel=False)
imgs = {}
for dev in ("cuda", "cpu"):
    scene = schema.to_device(host, dev)
    imgs[dev] = integrator.render_progressive(scene, feat, 64, 64, 0, 2, 0, 50, 1).cpu().numpy()
scene = schema.to_device(host, "cuda")
integrator.render_sample(scene, feat, 600, 600, 0, 0, 50, 1, chunk_size=65536)
torch.cuda.synchronize()
t0 = time.perf_counter()
img = integrator.render_sample(scene, feat, 600, 600, 1, 0, 50, 1, chunk_size=65536)
torch.cuda.synchronize()
ms = (time.perf_counter() - t0) * 1e3
diff = np.abs(imgs["cuda"] - imgs["cpu"])
scale = float(np.abs(imgs["cpu"]).max())
print(json.dumps({"real": defs.REAL.__name__, "dtype": str(img.dtype),
                  "image_dtype": str(imgs["cuda"].dtype), "scale": scale,
                  "median_rel": float(np.median(diff)) / scale,
                  "share_apart": float((diff > (1e-9 if defs.DOUBLE else 1e-4) * scale).mean()),
                  "sample_ms": ms, "mean": float(img.mean())}))
"""


def double_phase(card) -> dict:
    """Phase 26: RAYTRACE2_DOUBLE in subprocesses (the dtype binds at
    import), =1 then =0: the corpus Cornell on the non-kernel path at 64x64,
    2 spp, depth 50, card against CPU (float64: the median |diff| at most
    1e-12 of the scale and at most 5 % of values apart by more than 1e-9 of
    it, where a path parts at a transcendental's ulp; float32: 1e-5 and
    1e-4), and one 600x600 sample, depth 50, timed."""
    out = {}
    for double in ("1", "0"):
        env = dict(os.environ, RAYTRACE2_DOUBLE=double, PYTHONPATH=ROOT)
        p = subprocess.run([sys.executable, "-c", DOUBLE_WORKER], capture_output=True,
                           text=True, env=env, cwd=ROOT, timeout=600)
        check(p.returncode == 0, f"RAYTRACE2_DOUBLE={double} worker: {p.stderr[-2000:]}")
        rec = json.loads(p.stdout.strip().splitlines()[-1])
        want = "float64" if double == "1" else "float32"
        check(rec["real"] == want and rec["dtype"] == f"torch.{want}"
              and rec["image_dtype"] == want, f"RAYTRACE2_DOUBLE={double}: {rec}")
        check(rec["median_rel"] <= (1e-12 if double == "1" else 1e-5)
              and rec["share_apart"] <= 0.05,
              f"RAYTRACE2_DOUBLE={double}: card against CPU {rec}")
        out[want] = rec
        say(f"phase 26 RAYTRACE2_DOUBLE={double}: the corpus Cornell on the non-kernel path, "
            f"{want}; 64x64 2 spp depth 50 card against CPU: median |diff| "
            f"{rec['median_rel']:.3g} of the scale, {rec['share_apart']:.2%} of values apart; "
            f"one 600x600 sample depth 50: {rec['sample_ms']:.1f} ms, mean {rec['mean']:.4f} "
            f"({card})")
    out["f64_over_f32"] = out["float64"]["sample_ms"] / out["float32"]["sample_ms"]
    return out


def tools_phase(card, work) -> dict:
    """Phase 27: the tools on the card. tools.validate: the golden step
    (the corpus Cornell at 600x600, depth 50, 1,024 spp on v4 against
    renders/cornell32k_mega.npy: the mean within 1 % of 0.15941 and block
    PSNR >= 40 dB) and the ladder at 2 spp; check_table_grad (64x64, depth
    3: AD against FD of three leaves through B3 with table noise);
    bench_big_grad (book 2 600x600, 4 spp, depth 50, one timed step beyond
    the first, AD against FD at 64x64); sweep_wavefront (book 2 600x600, 8
    spp, the production schedule at K=2 and K=4 before the tail: the same
    image). Each exits 0, its JSON lines parsed."""
    from raytrace2_tpu_torch.tools import (bench_big_grad, check_table_grad, sweep_wavefront,
                                           validate)

    def run(main, argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        wall = time.perf_counter() - t0
        lines = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
        check(rc == 0, f"{main.__module__} {argv} exited {rc}: {buf.getvalue()[-2000:]}")
        return lines, wall

    out = {}
    vdir = os.path.join(work, "validate")
    _, wall = run(validate.main, ["--golden-spp", "1024", "--bench-spp", "2", "--out", vdir])
    with open(os.path.join(vdir, "results.json")) as f:
        res = json.load(f)
    g = res["golden"]
    out["validate"] = dict(res, wall_s=wall)
    say(f"phase 27 tools.validate: golden corpus Cornell 600x600 1024 spp depth 50 on "
        f"{g['kernel']}: mean {g['mean']:.5f} (golden {g['golden_mean']}), block PSNR "
        f"{g['block_psnr_db']:.2f} dB (gate {g['gate']}), {g['seconds']:.2f} s, "
        f"{g['paths_per_sec'] / 1e6:.1f} Mpaths/s; ladder at 2 spp: "
        + ", ".join(f"{k} {res[k]['paths_per_sec'] / 1e6:.2f} Mpaths/s (route {res[k]['route']})"
                    for k, *_ in validate.LADDER) + f"; {wall:.1f} s ({card})")
    lines, wall = run(check_table_grad.main, [])
    out["check_table_grad"] = dict(leaves=lines[:-1], wall_s=wall)
    say("phase 27 check_table_grad 64x64 depth 3, table noise: " + ", ".join(
        f"{r['leaf']} AD {r['ad']:.5g} FD {r['fd']:.5g}" for r in lines[:-1])
        + f"; all within the rule; {wall:.1f} s ({card})")
    lines, wall = run(bench_big_grad.main, ["--res", "600", "--spp", "4", "--steps", "1"])
    step = next(r for r in lines if "train_step_s" in r)
    first = next(r for r in lines if "first_step_s" in r)
    fd = next(r for r in lines if "leaf" in r)
    out["bench_big_grad"] = dict(lines=lines, wall_s=wall)
    say(f"phase 27 bench_big_grad book2 600x600 4 spp depth 50: first step "
        f"{first['first_step_s']:.2f} s, a step {step['train_step_s']:.3f} s "
        f"({step['fwdbwd_mpaths_s']:.3f} Mpaths/s fwd+bwd), grad finite; AD {fd['ad']:.5g} "
        f"against FD {fd['fd']:.5g} at 64x64 ({card})")
    lines, wall = run(sweep_wavefront.main, [
        "book2_final", "--res", "600", "--spp", "8", "--kb", "2,4", "--tail-k", "16",
        "--tail-frac", "0.65"])
    out["sweep_wavefront"] = dict(configs=lines, wall_s=wall)
    check(all(r["same_image"] for r in lines), "sweep_wavefront: images differ")
    say("phase 27 sweep_wavefront book2 600x600 8 spp depth 50, K then K=16 below 65 %: "
        + ", ".join(f"K={r['k_bounces']} {r['mpaths_s']:.2f} Mpaths/s" for r in lines)
        + f", the same image bit for bit ({card})")
    return out


if __name__ == "__main__":
    main()
