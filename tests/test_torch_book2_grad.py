"""Inverse rendering of a scene of book 2's kinds against the benchmark's
reference ``rtbench/reference/gradient_full.py``, on the CPU, where the
forward runs the wavefront's plain step and the backward ``grad_plain``:

* the program's loss and ``materials.albedo`` gradient against the
  reference's product rule, on a seeded scene over 256 records (the
  wavefront forward) with a clustered sphere family, a marble-noise sphere,
  a dielectric, a metal and an isotropic medium;
* ``gradient_full`` against ``gradient.py`` on a scene of albedo materials;
* the ``grad_full`` mode (cell ``book2_600.grad``) correct on the CPU, and
  false with each fault planted in the program;
* the span ``integrator.cluster`` and the counter
  ``megakernel_grad.REPLAY_BOUNCES``: it counts the replay's bounces while a
  profiler records and is neither touched nor read otherwise.

The ``cuda`` test holds the counter to no host sync on the card:
python -m pytest tests/test_torch_book2_grad.py -q --noconftest -m cuda
"""

import dataclasses
import json
import math
import random
import warnings

import pytest
import torch

from raytrace2_tpu_torch import grad, tracing
from raytrace2_tpu_torch.ops import integrator
from raytrace2_tpu_torch.ops.kernels import megakernel as mk
from raytrace2_tpu_torch.ops.kernels import megakernel_grad as mkg
from raytrace2_tpu_torch.scene import loader, schema
from rtbench import harness, scenes
from rtbench.reference import gradient, gradient_full, pathtrace, scene as rscene
from rtbench.tests import test_rtbench_faults as faults
from rtbench.tests._tiny import run_cpu

SEED = 2**31 + 977
KW = dict(width=16, height=16, n_samples=2, max_depth=8, sqrt_spp=1)
# The cell at a size the CPU runs in seconds; one check step (the window's
# two replayed steps come on top), so that each planted fault costs a few
# seconds. Every pixel is checked, so the traced segments are exact.
MODE_SIZE = dict(width=8, height=8, depth=4, check_steps=1, check_pixels=64)


def book2_kinds_json(seed: int) -> dict:
    """Book 2's kinds at its camera, from a seeded stream: 144 ground boxes,
    a light, 120 spheres in a cluster over four lambertian materials, a
    metal, glass, glass holding an isotropic medium, a marble sphere and a
    thin fog over the whole scene; albedos drawn from the seed. 271 records:
    the wavefront forward; the spheres and the boxes sweep by clusters."""
    rnd = random.Random(seed)
    b = scenes.SceneBuilder()

    def albedo():
        return [rnd.uniform(0.2, 0.9) for _ in range(3)]

    ground = b.add_lambertian(albedo())
    for i in range(12):
        for j in range(12):
            x0, z0 = -1000.0 + i * 500 / 3, -1000.0 + j * 500 / 3
            b.add_box([x0, 0.0, z0], [x0 + 500 / 3, rnd.uniform(1, 101), z0 + 500 / 3], ground)
    b.add_quad([123, 554, 147], [300, 0, 0], [0, 0, 265], b.add_diffuse_light([7, 7, 7]))
    b.add_sphere_moving([400, 400, 200], [30, 0, 0], 50, b.add_lambertian(albedo()))
    glass = b.add_dielectric(1.5)
    b.add_sphere([260, 150, 45], 50, glass)
    b.add_sphere([0, 150, 145], 50, b.add_metal(albedo(), 0.3))
    b.add_sphere([360, 150, 145], 70, glass)
    b.add_sphere([360, 150, 145], 70, glass, scenes.constant_medium(0.2, [0.2, 0.4, 0.9]))
    b.add_sphere([0, 0, 0], 5000, glass, scenes.constant_medium(0.0001, [1, 1, 1]))
    b.add_sphere([220, 280, 300], 80, b.add_texture_mat(b.add_noise_tex(0.2, 1)))
    for i in range(len(b.primitives)):
        b.add_node(None, i)
    whites = [b.add_lambertian(albedo()) for _ in range(4)]
    cluster = [b.add_sphere([rnd.uniform(0, 165) for _ in range(3)], 10, rnd.choice(whites))
               for _ in range(120)]
    b.add_node({"transform": scenes.transform([-100, 270, 395], [15, 0, 1, 0]),
                "children": [{"primitive": i} for i in cluster]})
    b.camera.update(center=[478, 278, -600], look_at=[278, 278, 0])
    return b.to_json()


@pytest.fixture(scope="module")
def book2_kinds(tmp_path_factory):
    obj = book2_kinds_json(SEED)
    path = tmp_path_factory.mktemp("book2_grad") / "book2_kinds.json"
    path.write_text(json.dumps(obj))
    host, _ = loader.load_scene(str(path))
    ref = rscene.parse(obj)
    tables = pathtrace.Tables.of(ref, "cpu")
    cv = rscene.camv(ref, KW["width"], KW["height"])
    return host, tables, cv


def _ref_kw(**over):
    kw = dict(KW, **over)
    return dict(width=kw["width"], height=kw["height"], n_samples=kw["n_samples"],
                depth=kw["max_depth"], sqrt_spp=kw["sqrt_spp"])


def test_scene_takes_every_route_and_material(book2_kinds):
    host, tables, cv = book2_kinds
    feats = host.features()
    assert integrator.n_records(feats) > integrator.WAVEFRONT_MIN_RECORDS
    assert integrator.mega_schedule(feats)[3]  # the wavefront forward
    assert mk.hier_flags(tuple(feats["mega_sizes"])) == (True, True)
    assert grad.takes_kernel(feats, KW["max_depth"])
    # Each path of the image: its scatters off every material. Paths
    # scatter off the noise texture, the dielectric, the metal and the
    # isotropic media, which gradient.py refuses.
    n = KW["width"] * KW["height"] * KW["n_samples"]
    flat = torch.arange(n)
    out = pathtrace.trace(tables, cv, flat // KW["n_samples"], flat % KW["n_samples"],
                          seed=SEED, width=KW["width"], depth=KW["max_depth"],
                          sqrt_spp=KW["sqrt_spp"], count_mats=True)
    kinds = set(tables.mat["mtype"][out["scatters"].amax(0) > 0].tolist())
    assert {rscene.MAT_TEXTURE, rscene.MAT_DIELECTRIC, rscene.MAT_METAL,
            rscene.MAT_ISOTROPIC, rscene.MAT_LAMBERTIAN} <= kinds
    with pytest.raises(ValueError, match="not its albedo"):
        gradient.trace_image(tables, cv, seed=SEED, **_ref_kw())


def test_program_gradient_matches_gradient_full(book2_kinds):
    """Loss and ``materials.albedo`` gradient of an L2 step, program against
    the reference, at albedos perturbed from the scene's by the seed."""
    host, tables, cv = book2_kinds
    scene = schema.to_device(host, "cpu")
    truth = scene.materials.albedo
    g = torch.Generator().manual_seed(SEED)
    theta = truth * (1.0 + 0.3 * (2.0 * torch.rand(tuple(truth.shape), generator=g) - 1.0))
    target = gradient_full.image(
        gradient_full.trace_image(tables, cv, seed=SEED + 1, **_ref_kw()),
        torch.stack([tables.mat["alr"], tables.mat["alg"], tables.mat["alb"]], -1))
    cur = dataclasses.replace(scene, materials=dataclasses.replace(scene.materials,
                                                                   albedo=theta))
    tgt = target.reshape(KW["height"], KW["width"], 3).to(torch.float32)
    loss, g_prog = grad.value_and_grad_scene(lambda img: torch.mean((img - tgt) ** 2), cur,
                                             host.features(), SEED, **KW)
    paths = gradient_full.trace_image(tables, cv, seed=SEED, **_ref_kw())
    loss_ref, g_ref = gradient_full.loss_and_grad(paths, theta, target)
    g_prog = g_prog.materials.albedo.double()
    # The paths are the same (the plain step's arithmetic is the reference's
    # bounce for bounce), so what is left is rounding: the program's float32
    # throughput over at most 8 factors and its float32 mean and loss against
    # the reference's float64 product: 9e-8 here. 1e-5 is ~100 float32
    # roundings; a factor of a path left out or taken twice moves the loss
    # by percents.
    assert abs(float(loss) - float(loss_ref)) <= 1e-5 * float(loss_ref)
    # The gradient: autograd's float32 adjoint of the same products, summed
    # over 512 paths in another order: 1.2e-7 of the largest entry here.
    # 1e-5 of it leaves room for that and fails on any row whose paths or
    # factors differ.
    scale = float(g_ref.abs().max())
    assert scale > 0
    assert torch.allclose(g_prog, g_ref, rtol=0.0, atol=1e-5 * scale), (g_prog, g_ref)
    # Materials that take no albedo row (light, dielectric, marble, media)
    # get exactly 0 from both.
    lamb_metal = torch.zeros_like(tables.mat["mtype"], dtype=torch.bool)
    for kind in gradient_full.ALBEDO_MATERIALS:
        lamb_metal |= tables.mat["mtype"] == float(kind)
    assert (g_ref[~lamb_metal] == 0).all() and (g_prog[~lamb_metal] == 0).all()
    reached = g_ref.abs().sum(1) > 0
    assert reached[tables.mat["mtype"] == float(rscene.MAT_METAL)].all()
    assert int(reached.sum()) >= 3


def test_gradient_full_is_gradient_on_albedo_materials():
    run = harness.make_run("cornell600.grad", 5, 1.0, False, device="cpu",
                           overrides={"width": 10, "height": 10})
    tables, cv, _ = run.reference()
    kw = dict(seed=SEED, width=10, height=10, n_samples=4, depth=8, sqrt_spp=2)
    full, plain = gradient_full.trace_image(tables, cv, **kw), gradient.trace_image(tables, cv,
                                                                                      **kw)
    assert torch.equal(full["emitted"], plain["emitted"])
    assert torch.equal(full["scatters"], plain["scatters"])
    assert full["n_samples"] == plain["n_samples"]
    # Images traced together are each image traced alone.
    both = gradient_full.trace_images(tables, cv, [(SEED + 1, 2), (SEED, 4)], width=10,
                                      height=10, depth=8, sqrt_spp=2)
    alone = gradient.trace_image(tables, cv, **dict(kw, seed=SEED + 1, n_samples=2))
    for got, want in zip(both, (alone, plain)):
        assert got["n_samples"] == want["n_samples"]
        assert torch.equal(got["emitted"], want["emitted"])
        assert torch.equal(got["scatters"], want["scatters"])


def test_mode_is_correct_on_the_cpu_and_its_control_and_faults_are_not():
    """The cell's own limits: the program's run is under each; the control
    (the reference in bfloat16) and each fault planted in the reference, as
    ``rtbench.calibrate`` reads them on the card, fail at least one."""
    run, result, _ = run_cpu("book2_600.grad", seconds=0.01, overrides=MODE_SIZE)
    assert run.traffic["mode"] == "grad_full"
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"loss_gap", "grad_gap", "change_gap"}
    assert set(result["metrics"]) == {"grad_step_ms", "setup_s"}
    mode = harness.mode_module("grad_full")
    limits = harness.read_json(harness.PKG / "limits" / "book2_600.grad.json")
    readings = dict(mode.faults(run), control=mode.control(run))
    assert set(readings) == {"unchanged", "half", "altered", "control"}
    for name, numbers in readings.items():
        ok, checks = harness.compare(numbers, limits)
        assert not ok, (name, checks)


@pytest.mark.parametrize("fault", [faults._grad_unchanged, faults._grad_half,
                                   faults._grad_altered])
def test_fault_planted_in_the_program_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    _, result, _ = run_cpu("book2_600.grad", seconds=0.01, overrides=MODE_SIZE)
    assert not result["correct"], result["checks"]


def test_traced_run_reads_the_cluster_span_and_the_replay_counter():
    """On the CPU the counter is exact: every pixel is checked, so the
    traced segments (the reference's bounces of the traced steps' paths)
    are the bounces the replay made."""
    run, result, _ = run_cpu("book2_600.grad", seconds=0.01, trace=True,
                             overrides=dict(MODE_SIZE, trace_start_s=0.0, trace_s=0.01))
    assert result["correct"], result["checks"]
    m = result["metrics"]
    assert m["grad.cluster_ms_per_step"]["value"] > 0
    assert m["grad.syncs_per_step"]["value"] > 0
    paths = run.traced_work["spp"] * run.n_pix
    bounces = sum(run.traced_work["segments"].values())
    assert math.isclose(m["grad.replay_bounces_per_path"]["value"] * paths, bounces,
                        rel_tol=1e-12)


def _step(host, kw=KW):
    scene = schema.to_device(host, "cpu")
    return lambda: grad.value_and_grad_scene(lambda img: (img ** 2).mean(), scene,
                                             host.features(), 3, **kw)


def test_counter_counts_only_while_a_profiler_records(book2_kinds, monkeypatch):
    host, _, _ = book2_kinds
    step = _step(host, dict(KW, width=6, height=6, max_depth=4))
    seen = []
    orig = mkg.grad_call

    def spy(*a, bounces=None, **kw):
        seen.append(bounces)
        return orig(*a, bounces=bounces, **kw)
    monkeypatch.setattr(mkg, "grad_call", spy)
    step()  # the material types, read once per scene tensor
    before, syncs = mkg.REPLAY_BOUNCES, tracing.HOST_SYNCS
    loss0, g0 = step()
    untraced = tracing.HOST_SYNCS - syncs
    assert seen[-1] is None and mkg.REPLAY_BOUNCES == before
    syncs = tracing.HOST_SYNCS
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        loss1, g1 = step()
    assert tracing.HOST_SYNCS - syncs == untraced
    assert seen[-1] is not None and mkg.REPLAY_BOUNCES > before
    assert torch.equal(loss0, loss1) and torch.equal(g0.materials.albedo, g1.materials.albedo)


def test_cluster_span_nests_in_the_pack(book2_kinds, tmp_path):
    host, _, _ = book2_kinds
    step = _step(host, dict(KW, width=4, height=4, max_depth=2))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"]
    packs = [e for e in events if e["name"] == "integrator.pack"]
    clusters = [e for e in events if e["name"] == "integrator.cluster"]
    assert len(packs) == len(clusters) == 1
    p, c = packs[0], clusters[0]
    assert p["ts"] <= c["ts"] and c["ts"] + c["dur"] <= p["ts"] + p["dur"]
    assert "integrator.cluster" in tracing.SPANS


@pytest.mark.cuda
def test_counter_adds_no_host_sync_on_the_card(book2_kinds):
    """A traced step of the clustered instance: every synchronising call
    torch reports went through ``tracing.sync``, and the counter moved."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    host, _, _ = book2_kinds
    scene = schema.to_device(host, torch.device("cuda"))
    kw = dict(width=64, height=64, n_samples=4, max_depth=8, sqrt_spp=2)

    def step():
        return grad.value_and_grad_scene(lambda img: (img ** 2).mean(), scene,
                                         host.features(), 3, **kw)
    step()  # builds, and the reads made once per scene
    torch.cuda.synchronize()
    before, syncs = mkg.REPLAY_BOUNCES, tracing.HOST_SYNCS
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    reported = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    assert tracing.HOST_SYNCS - syncs == len(reported)
    assert mkg.REPLAY_BOUNCES > before
