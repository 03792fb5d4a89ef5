"""Book 1's final render (the configuration ``book1_1200``) on the CPU,
through the program's plain versions:

* the normal route (``Renderer`` on ``auto``: 486 sphere records, so the
  sorted wavefront and the clustered sweep) against the benchmark's
  reference ``rtbench/reference/pathtrace.py`` on the same samples;
* the configuration file: ``make_scene.book1_final(0)``'s scene at the
  book's 1200 x 675, depth 50, 500 spp;
* the counter ``wavefront.SEGMENTS`` (the step's closest-hit queries): the
  plain step against a hand count, counted only while a profiler records
  and never read on the host otherwise, and the cell's traced reading
  against the reference's segments.

The ``cuda`` test in ``tests/test_torch_cuda.py`` holds the kernel's count
to the plain step's on the card.
"""

import json
import math

import pytest
import torch

from raytrace2_tpu_torch import tracing
from raytrace2_tpu_torch.ops import camera
from raytrace2_tpu_torch.ops.kernels import megakernel as mk
from raytrace2_tpu_torch.ops.kernels import wavefront as wf
from raytrace2_tpu_torch.render import Renderer
from raytrace2_tpu_torch.scene import loader, schema
from raytrace2_tpu_torch.tools import make_scene
from rtbench import harness, scenes_book1
from rtbench.reference import pathtrace, scene as rscene
from rtbench.tests._tiny import run_cpu

SEED = 2**31 + 1201
CFG = harness.read_json(harness.PKG / "configs" / "book1_1200.json")


@pytest.fixture(scope="module")
def book1(tmp_path_factory):
    path = tmp_path_factory.mktemp("book1") / "book1_1200.json"
    path.write_text(json.dumps(CFG["scene"]))
    scene, _ = loader.load_scene(str(path))
    return scene


def test_config_is_book1_final_at_the_books_size():
    assert CFG["scene"] == make_scene.book1_final(0).to_json()
    assert CFG == json.loads(json.dumps(scenes_book1.config()))
    assert (CFG["width"], CFG["height"], CFG["depth"], CFG["samples"]) == (1200, 675, 50, 500)
    assert CFG["reduced"] == []
    spheres = [p for p in CFG["scene"]["primitives"] if p["type"] == "sphere"]
    assert len(spheres) == len(CFG["scene"]["primitives"]) == 486
    assert CFG["scene"]["background_color"] == [0.7, 0.8, 1.0]
    cam = CFG["scene"]["camera"]
    assert (cam["fov"], cam["center"], cam["look_at"], cam["defocus_angle"],
            cam["focus_distance"]) == (20, [13, 2, 3], [0, 0, 0], 0.6, 10.0)
    bench = harness.load_benchmark()
    entry = {c["name"]: c for c in bench["configs"]}["book1_1200"]
    assert entry["file"] == "rtbench/configs/book1_1200.json" and entry["reduced"] == []
    assert entry["source"] == CFG["source"] and len(entry["source"]) <= 200


def test_normal_route_matches_the_reference(book1):
    """48 x 27 (the book's 16:9), 4 spp, depth 8 through ``Renderer`` on
    ``auto``: the wavefront's plain step. The reference traces the same
    (pixel, sample) paths with the same arithmetic, so each path's radiance
    is the program's bit for bit; the program sums a pixel's samples in its
    float32 slot, the reference in float64, so a sum of 4 samples may differ
    by a few float32 roundings: 1e-6 of the sum, with 1e-7 absolute for
    sums near 0."""
    w, h, spp, depth = 48, 27, 4, 8
    r = Renderer(book1, w, h, num_samples=spp, max_depth=depth, seed=SEED, device="cpu")
    assert r.kernel == "wavefront_step"
    sorts = wf.SORTS
    r.update(spp)
    assert wf.SORTS > sorts
    pixels = torch.randperm(w * h, generator=torch.Generator().manual_seed(SEED))[:96]
    sums = r.state.accum.reshape(-1, 3)[pixels].double()
    sc = rscene.parse(CFG["scene"])
    ref, segments = pathtrace.pixel_sums(
        pathtrace.Tables.of(sc, torch.device("cpu"), torch.float32), rscene.camv(sc, w, h),
        pixels, 0, spp, seed=SEED, width=w, depth=depth, sqrt_spp=r.sqrt_spp)
    assert segments[pathtrace.FAMILIES.index("sphere")] > 0
    assert segments[pathtrace.FAMILIES.index("miss")] > 0  # the sky
    assert float(ref.mean()) > 0.1
    assert torch.all((sums - ref).abs() <= 1e-6 * ref.abs() + 1e-7)


def _tiny_state(scene, w=8, h=8, spp=3, bounces=3):
    """A book-1 slot state after ``bounces`` single steps: live, dead and
    regenerating slots, and padding past the last pixel."""
    feats = scene.features()
    sizes = tuple(feats["mega_sizes"])
    dev = schema.to_device(scene, "cpu")
    camv = camera.make_camv(scene.camera, w, h, 0, spp, 1, 0)
    args = (camv, 7, mk.pack_buffer(dev, sizes), dev.background)
    kw = dict(max_depth=6, sizes=sizes, has_checker=feats["has_checker"],
              has_noise=feats["has_noise"])
    state = wf.init_wavefront_state(128, camv)
    for _ in range(bounces):
        state = wf.step_plain(state, *args, k_bounces=1, **kw)
    return state, args, kw, float(spp)


def test_plain_step_counts_its_segments_by_hand(book1):
    """One step of K=4 adds to ``segments`` the closest-hit queries it makes:
    by hand, the runnable slots before each of four single steps (a slot
    that can run takes exactly one query a step), and the K=4 state is the
    four single steps' bit for bit."""
    state, args, kw, n_samples = _tiny_state(book1)
    one = state.clone()
    by_hand = 0
    for _ in range(4):
        by_hand += int(wf.runnable(one, n_samples).sum())
        one = wf.step_plain(one, *args, k_bounces=1, **kw)
    assert by_hand > 0
    segments = torch.zeros(1, dtype=torch.int64)
    four = wf.step_plain(state.clone(), *args, k_bounces=4, segments=segments, **kw)
    assert int(segments) == by_hand
    assert torch.equal(four, one)
    # The wrapper passes it on to the plain step on the CPU.
    again = torch.zeros(1, dtype=torch.int64)
    wf.wavefront_step(state.clone(), *args, k_bounces=4, segments=again, **kw)
    assert int(again) == by_hand


def test_segments_count_only_while_a_profiler_records(book1, monkeypatch):
    """Without a profiler no step gets the counter and ``SEGMENTS`` stays
    as it was; under one every step gets it, ``SEGMENTS`` grows, and the
    image and the host syncs are the same."""
    seen = []
    orig = wf.wavefront_step

    def spy(*a, segments=None, **k):
        seen.append(segments)
        return orig(*a, segments=segments, **k)
    monkeypatch.setattr(wf, "wavefront_step", spy)

    def render():
        r = Renderer(book1, 16, 9, num_samples=2, max_depth=4, seed=SEED, device="cpu")
        syncs = tracing.HOST_SYNCS
        r.update(2)
        return r.state.accum.clone(), tracing.HOST_SYNCS - syncs

    before = wf.SEGMENTS
    image0, syncs0 = render()
    assert seen and all(s is None for s in seen)
    assert wf.SEGMENTS == before
    seen.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        image1, syncs1 = render()
    assert seen and all(s is seen[0] for s in seen) and seen[0] is not None
    assert wf.SEGMENTS > before
    assert syncs1 == syncs0
    assert torch.equal(image0, image1)


def test_traced_cell_reads_the_reference_segments_per_path():
    """The cell ``book1_1200.final`` at 16 x 9 on the CPU, every pixel
    checked, so the traced segments (the reference's bounces of the traced
    batches' paths) are exact: the counter reads them, and the run is
    under the cell's limits."""
    run, result, _ = run_cpu("book1_1200.final", seconds=0.01, trace=True,
                             overrides=dict(width=16, height=9, samples=4, batch_spp=2,
                                            check_pixels=144, trace_start_s=0.0,
                                            trace_s=0.01))
    assert result["correct"], result["checks"]
    m = result["metrics"]
    paths = run.traced_work["spp"] * run.n_pix
    segments = sum(run.traced_work["segments"].values())
    assert math.isclose(m["wavefront.segments_per_path"]["value"] * paths, segments,
                        rel_tol=1e-12)
    assert m["wavefront.sorts_per_spp"]["value"] > 0
    assert m["wavefront.syncs_per_spp"]["value"] > 0
