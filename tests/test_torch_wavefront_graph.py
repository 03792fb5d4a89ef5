"""The wavefront driver's replayed passes (``wavefront._PassGraphs``): on the
card, each pass's sort, gather and step are one CUDA graph replay, held bit
for bit (state and image) against the same driver run eagerly, with the
same pass counters, no capture after a shape's first batch, and a traced
batch counting the plain step's segments; on the CPU nothing is captured
or replayed. The card tests skip where torch.cuda.is_available() is false.
Run on a machine with the card:
python -m pytest tests/test_torch_wavefront_graph.py -q --noconftest"""

import pytest
import torch

from raytrace2_tpu_torch.ops import camera
from raytrace2_tpu_torch.ops.kernels import megakernel as mk
from raytrace2_tpu_torch.ops.kernels import wavefront as wf
from raytrace2_tpu_torch.scene import loader, schema
from test_torch_scenes import write_scene

# The pass counters that the replayed driver keeps as the eager one does.
PASS_COUNTERS = ("SORTS", "LAUNCHES", "KEY_LAUNCHES", "OVERRUN_LAUNCHES")
# The default two-phase schedule (K=2, then K=16), and one phase of K=16.
SCHEDULES = {"k2_k16": {}, "k16": dict(k_bounces=16, tail_k=0)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scene(tmp_path, name, w, h, depth, device):
    scene, _ = loader.load_scene(write_scene(tmp_path, name))
    feats = scene.features()
    sizes = tuple(feats["mega_sizes"])
    dev = schema.to_device(scene, device)
    kw = dict(max_depth=depth, sizes=sizes, has_checker=feats["has_checker"],
              has_noise=feats["has_noise"])
    n_rays = -(-w * h // wf.SLOT_TILE) * wf.SLOT_TILE
    return scene, dev, kw, n_rays


def _counters():
    return [getattr(wf, name) for name in PASS_COUNTERS]


def _replayed(args, n_rays, kw):
    """(image, final state, pass counters' change, captures) of one batch
    on the replayed driver."""
    before, replays, captures = _counters(), wf.GRAPH_REPLAYS, wf.GRAPH_CAPTURES
    image = wf.trace_wavefront_batch(*args, n_rays=n_rays, **kw)
    passes = wf.GRAPH_REPLAYS - replays
    graphs = next(reversed(wf._GRAPHS.values()))
    # The passes alternate between the two buffers, from states[0].
    state = graphs.states[passes % 2].clone()
    changed = [b - a for a, b in zip(before, _counters())]
    assert passes == changed[1] > 0
    return image, state, changed, wf.GRAPH_CAPTURES - captures


def _eager(args, n_rays, kw):
    """The same on the eager driver: the kernel's wrapper as a given step."""
    before, replays, last = _counters(), wf.GRAPH_REPLAYS, {}

    def step(state, *a, **k):
        last["state"] = wf.wavefront_step(state, *a, **k)
        return last["state"]

    image = wf.trace_wavefront_batch(*args, n_rays=n_rays, step=step, **kw)
    assert wf.GRAPH_REPLAYS == replays
    return image, last["state"], [b - a for a, b in zip(before, _counters())]


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("name,w,h", [("book1", 64, 36), ("book2", 32, 32)])
def test_replayed_batches_are_the_eager_batches(tmp_path, cuda, name, w, h, schedule):
    """Three batches that change the seed, camv's first sample and, in the
    third, the packed tables (every material's red albedo halved, which
    changes the eager image): each replayed batch's image and final state
    are bitwise the eager driver's, with the same sorts, launches, keys
    launches and overruns; only the shape's first batch may capture."""
    spp = 4
    scene, dev, kw, n_rays = _scene(tmp_path, name, w, h, 50, cuda)
    kw.update(SCHEDULES[schedule])
    packed = mk.pack_buffer(dev, kw["sizes"])
    base, rows = mk.table_layout(kw["sizes"])["mat"]
    edited = packed.clone()
    edited[base + rows:base + 2 * rows] *= 0.5
    for i, (seed, tables) in enumerate(((11, packed), (-123456789, packed),
                                        (2**31 + 3, edited))):
        camv = camera.make_camv(scene.camera, w, h, i * spp, spp, 2, seed).to(cuda)
        args = (camv, seed, tables, dev.background)
        image, state, counts, captures = _replayed(args, n_rays, kw)
        e_image, e_state, e_counts = _eager(args, n_rays, kw)
        assert torch.equal(image, e_image) and torch.equal(state, e_state), i
        assert counts == e_counts, i
        assert captures <= (8 if i == 0 else 0), (i, captures)
    unedited, _, _ = _eager((camv, seed, packed, dev.background), n_rays, kw)
    assert not torch.equal(unedited, e_image)


@pytest.mark.cuda
def test_traced_replay_counts_the_plain_segments(tmp_path, cuda):
    """Book 1 at 64x36, 4 spp: under a recording profiler the replayed
    batch adds to ``SEGMENTS`` what the plain step adds, gives the untraced
    batch's image, and captures nothing (the shape's first batch, untraced,
    captured the counted graphs too)."""
    scene, dev, kw, n_rays = _scene(tmp_path, "book1", 64, 36, 50, cuda)
    camv = camera.make_camv(scene.camera, 64, 36, 0, 4, 2, 5).to(cuda)
    args = (camv, 5, mk.pack_buffer(dev, kw["sizes"]), dev.background)
    untraced = wf.trace_wavefront_batch(*args, n_rays=n_rays, **kw)
    captures = wf.GRAPH_CAPTURES
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        before = wf.SEGMENTS
        traced = wf.trace_wavefront_batch(*args, n_rays=n_rays, **kw)
        replayed = wf.SEGMENTS - before
        plain_image = wf.trace_wavefront_batch(*args, n_rays=n_rays, step=wf.step_plain, **kw)
        plain = wf.SEGMENTS - before - replayed
    assert wf.GRAPH_CAPTURES == captures
    assert replayed == plain > 0
    assert torch.equal(traced, untraced) and torch.equal(traced, plain_image)


def test_cpu_batch_replays_nothing(tmp_path):
    """On the CPU the driver captures and replays no graph, and its image is
    bitwise the plain v4's, as before there were graphs."""
    scene, dev, kw, n_rays = _scene(tmp_path, "cornell", 12, 12, 4, "cpu")
    camv = camera.make_camv(scene.camera, 12, 12, 0, 2, 1, 3)
    args = (camv, 3, mk.pack_buffer(dev, kw["sizes"]), dev.background)
    replays, captures, graphs = wf.GRAPH_REPLAYS, wf.GRAPH_CAPTURES, len(wf._GRAPHS)
    image = wf.trace_wavefront_batch(*args, n_rays=n_rays, **kw)[:144]
    assert (wf.GRAPH_REPLAYS, wf.GRAPH_CAPTURES, len(wf._GRAPHS)) == (replays, captures, graphs)
    assert torch.equal(image, mk.trace_megakernel_batch(*args, n_pix=144, **kw))
