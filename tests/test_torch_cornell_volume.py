"""The Cornell box with smoke and fog (the configuration
``cornell_volume600``) on the CPU, through the program's plain versions:

* the normal route (``Renderer`` on ``auto``: 6 quads and 2 medium boxes,
  so v4's ``F_QUAD | F_MED`` instance) against the benchmark's reference
  ``rtbench/reference/pathtrace.py`` on the same samples;
* the configuration file: ``make_scene.cornell_box_volume()``'s scene at the
  book's 600 x 600, depth 50, 200 spp;
* v4's counters ``megakernel.SEGMENTS`` and ``MEDIUM_SCATTERS``: the plain
  version's counts against the reference's by family, counted only while a
  profiler records, and the cell's traced readings.

The ``cuda`` test in ``tests/test_torch_cuda.py`` holds the kernel's counts
to the plain version's on the card.
"""

import json
import math

import pytest
import torch

from raytrace2_tpu_torch import tracing
from raytrace2_tpu_torch.ops import camera
from raytrace2_tpu_torch.ops.kernels import megakernel as mk
from raytrace2_tpu_torch.render import Renderer
from raytrace2_tpu_torch.scene import loader, schema
from raytrace2_tpu_torch.tools import make_scene
from rtbench import harness, scenes_volume
from rtbench.reference import pathtrace, scene as rscene
from rtbench.tests._tiny import run_cpu

SEED = 2**31 + 601
CFG = harness.read_json(harness.PKG / "configs" / "cornell_volume600.json")


@pytest.fixture(scope="module")
def volume(tmp_path_factory):
    path = tmp_path_factory.mktemp("volume") / "cornell_volume600.json"
    path.write_text(json.dumps(CFG["scene"]))
    scene, _ = loader.load_scene(str(path))
    return scene


def _reference(w, h, spp, depth, sqrt_spp):
    """The reference's sums at every pixel and its segments by family."""
    sc = rscene.parse(CFG["scene"])
    return pathtrace.pixel_sums(
        pathtrace.Tables.of(sc, torch.device("cpu"), torch.float32), rscene.camv(sc, w, h),
        torch.arange(w * h), 0, spp, seed=SEED, width=w, depth=depth, sqrt_spp=sqrt_spp)


def test_config_is_the_smoke_and_fog_box_at_the_books_size():
    assert CFG["scene"] == make_scene.cornell_box_volume().to_json()
    assert CFG == json.loads(json.dumps(scenes_volume.config()))
    assert (CFG["width"], CFG["height"], CFG["depth"], CFG["samples"]) == (600, 600, 50, 200)
    assert CFG["reduced"] == []
    kinds = [p["type"] for p in CFG["scene"]["primitives"]]
    assert kinds.count("quad") == 6 and kinds.count("box") == 2
    media = [p["constant_medium"] for p in CFG["scene"]["primitives"] if p["type"] == "box"]
    assert media == [{"density": 0.01, "albedo": [1, 1, 1]}, {"density": 0.01, "albedo": [0, 0, 0]}]
    bench = harness.load_benchmark()
    entry = {c["name"]: c for c in bench["configs"]}["cornell_volume600"]
    assert entry["file"] == "rtbench/configs/cornell_volume600.json" and entry["reduced"] == []
    assert entry["source"] == CFG["source"] and len(entry["source"]) <= 200


def test_normal_route_matches_the_reference(volume):
    """32 x 32, 4 spp, depth 50 through ``Renderer`` on ``auto``: v4's plain
    version, whose instance on the card is the quads-and-media one. The
    reference traces the same (pixel, sample) paths with the same
    arithmetic; the program sums a pixel's samples in float32, the
    reference in float64: 1e-6 of the sum, with 1e-7 absolute for sums
    near 0."""
    w = h = 32
    spp, depth = 4, 50
    r = Renderer(volume, w, h, num_samples=spp, max_depth=depth, seed=SEED, device="cpu")
    assert r.kernel == "megakernel_v4"
    feats = volume.features()
    packed = mk.pack_buffer(schema.to_device(volume, "cpu"), feats["mega_sizes"])
    assert mk.scene_features(packed, feats["mega_sizes"], feats["has_checker"],
                             feats["has_noise"]) == mk.F_QUAD | mk.F_MED
    r.update(spp)
    ref, segments = _reference(w, h, spp, depth, r.sqrt_spp)
    assert segments[pathtrace.FAMILIES.index("medium")] > 0
    assert float(ref.mean()) > 0.1
    sums = r.state.accum.reshape(-1, 3).double()
    assert torch.all((sums - ref).abs() <= 1e-6 * ref.abs() + 1e-7)


def test_plain_counts_equal_the_reference_by_family(volume):
    """Every pixel of a 16 x 16, 3-spp render: the plain version's segments
    are the reference's segments of every family, and its medium scatters
    the reference's medium family, exactly; the image is the one traced
    without the counter."""
    w = h = 16
    spp, depth = 3, 50
    feats = volume.features()
    sizes = tuple(feats["mega_sizes"])
    dev = schema.to_device(volume, "cpu")
    camv = camera.make_camv(volume.camera, w, h, 0, spp, 1, 0)
    args = (camv, SEED, mk.pack_buffer(dev, sizes), dev.background)
    kw = dict(n_pix=w * h, max_depth=depth, sizes=sizes, has_checker=feats["has_checker"],
              has_noise=feats["has_noise"])
    tally = torch.zeros(2, dtype=torch.int64)
    counted = mk.trace_plain(*args, tally=tally, **kw)
    assert torch.equal(counted, mk.trace_plain(*args, **kw))
    _, segments = _reference(w, h, spp, depth, 1)
    assert int(tally[0]) == int(segments.sum())
    assert int(tally[1]) == int(segments[pathtrace.FAMILIES.index("medium")]) > 0


def test_counts_only_while_a_profiler_records(volume, monkeypatch):
    """Without a profiler the plain version gets no counter, the counts stay
    as they were and nothing more is read from the device; under one it gets
    the counter, the counts grow, and the image and the host syncs are the
    same."""
    seen = []
    orig = mk.trace_plain

    def spy(*a, tally=None, **k):
        seen.append(tally)
        return orig(*a, tally=tally, **k)
    monkeypatch.setattr(mk, "trace_plain", spy)

    def render():
        r = Renderer(volume, 12, 12, num_samples=2, max_depth=8, seed=SEED, device="cpu")
        syncs = tracing.HOST_SYNCS
        r.update(2)
        return r.state.accum.clone(), tracing.HOST_SYNCS - syncs

    before = (mk.SEGMENTS, mk.MEDIUM_SCATTERS)
    image0, syncs0 = render()
    assert seen and all(t is None for t in seen)
    assert (mk.SEGMENTS, mk.MEDIUM_SCATTERS) == before
    seen.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        image1, syncs1 = render()
    assert seen and all(t is seen[0] for t in seen) and seen[0] is not None
    assert mk.SEGMENTS > before[0] and mk.MEDIUM_SCATTERS > before[1]
    assert syncs1 == syncs0
    assert torch.equal(image0, image1)


def test_traced_cell_reads_the_reference_segments_per_path():
    """The cell ``cornell_volume600.final`` at 12 x 12 on the CPU, every
    pixel checked, so the traced segments (the reference's bounces of the
    traced batches' paths) are exact: the counters read them, and the run
    is under the cell's limits."""
    run, result, _ = run_cpu("cornell_volume600.final", seconds=0.01, trace=True,
                             overrides=dict(samples=4, batch_spp=2, depth=50,
                                            check_pixels=144, trace_start_s=0.0,
                                            trace_s=0.01))
    assert result["correct"], result["checks"]
    m = result["metrics"]
    paths = run.traced_work["spp"] * run.n_pix
    segments = run.traced_work["segments"]
    total = sum(segments.values())
    assert math.isclose(m["megakernel_v4.segments_per_path"]["value"] * paths, total,
                        rel_tol=1e-12)
    assert math.isclose(m["megakernel_v4.medium_share"]["value"],
                        segments["medium"] / total, rel_tol=1e-12)
