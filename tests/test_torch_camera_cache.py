"""The host frame cache of ``camera.camera_frame`` and the kernel path's
``camv`` copy: a hit returns the frame a fresh computation gives, bitwise,
and reads nothing from the device; an in-place edit of a leaf, a leaf
replaced, or another width, height or dtype misses; a camera whose leaves
require grad bypasses the cache and keeps ``camv`` in autograd's graph; a
warm batch renders the image a cold one does."""

import dataclasses

import pytest
import torch

from raytrace2_tpu_torch import tracing
from raytrace2_tpu_torch.ops import camera, integrator
from raytrace2_tpu_torch.render import Renderer
from raytrace2_tpu_torch.scene import loader, schema
from test_torch_scenes import write_scene

ARGS = (24, 16, 3, 4, 2, 7)  # width, height, sample0, n_samples, sqrt_spp, seed


@pytest.fixture
def cam(tmp_path):
    host, _ = loader.load_scene(write_scene(tmp_path, "feature"))  # a defocused camera
    return schema.to_device(host, "cpu").camera


def _fresh_camv(cam, *args):
    camera.clear_frame_cache()
    return camera.make_camv(cam, *args)


def _counts():
    return camera.FRAME_HITS, camera.FRAME_MISSES, tracing.HOST_SYNCS


def test_a_hit_is_bitwise_a_fresh_frame_and_reads_nothing(cam):
    fresh = _fresh_camv(cam, *ARGS)
    hits, misses, syncs = _counts()
    hit = camera.make_camv(cam, *ARGS)
    assert _counts() == (hits + 1, misses, syncs)
    assert torch.equal(hit, fresh)
    frame = camera.camera_frame(cam, 24, 16, torch.float32)
    camera.clear_frame_cache()
    cold = camera.camera_frame(cam, 24, 16, torch.float32)
    assert frame.keys() == cold.keys()
    assert all(torch.equal(frame[k], cold[k]) for k in frame)


def test_one_miss_then_hits(cam):
    camera.clear_frame_cache()
    hits, misses, syncs = _counts()
    for s0 in range(5):
        camera.make_camv(cam, 24, 16, s0, 1, 2, 7)
    # The miss reads the six leaves; the four hits read nothing.
    assert _counts() == (hits + 4, misses + 1, syncs + 6)


@pytest.mark.parametrize("edit", ["in_place", "in_place_same_values", "replaced"])
def test_a_changed_leaf_misses(cam, edit):
    camv = _fresh_camv(cam, *ARGS)
    if edit == "in_place":
        cam.center.add_(torch.tensor([0.25, 0.0, 0.0]))
    elif edit == "in_place_same_values":
        cam.look_at.mul_(1.0)  # bumps the version, keeps the values
    else:
        cam = dataclasses.replace(cam, vup=cam.vup.clone())
    hits, misses, syncs = _counts()
    got = camera.make_camv(cam, *ARGS)
    assert _counts() == (hits, misses + 1, syncs + 6)
    assert torch.equal(got, _fresh_camv(cam, *ARGS))
    assert torch.equal(got, camv) == (edit != "in_place")


@pytest.mark.parametrize("change", [{"width": 20}, {"height": 12}, {"dtype": torch.float64}])
def test_another_size_or_dtype_misses(cam, change):
    kw = dict(width=24, height=16, dtype=torch.float32)
    camera.clear_frame_cache()
    camera.camera_frame(cam, **kw)
    hits, misses, _ = _counts()
    frame = camera.camera_frame(cam, **dict(kw, **change))
    assert _counts()[:2] == (hits, misses + 1)
    assert frame["pixel00"].dtype == dict(kw, **change)["dtype"]
    camera.clear_frame_cache()
    cold = camera.camera_frame(cam, **dict(kw, **change))
    assert all(torch.equal(frame[k], cold[k]) for k in frame)


def test_leaves_that_require_grad_bypass_the_cache(cam):
    camv = _fresh_camv(cam, *ARGS)  # a cached frame of the same values
    leaves = []

    def as_leaf(x):
        leaves.append(x.detach().requires_grad_(True))
        return leaves[-1]

    params = schema.map_leaves(cam, as_leaf)
    hits, misses, syncs = _counts()
    got = [camera.make_camv(params, *ARGS) for _ in range(2)]
    assert _counts() == (hits, misses, syncs + 12)
    assert all(g.requires_grad and torch.equal(g.detach(), camv) for g in got)
    grads = [torch.autograd.grad((g * torch.arange(28.0)).sum(), leaves) for g in got]
    camera.clear_frame_cache()
    cold = torch.autograd.grad(
        (camera.make_camv(params, *ARGS) * torch.arange(28.0)).sum(), leaves)
    for g in grads:
        assert all(torch.equal(a, b) for a, b in zip(g, cold))


def test_camv_copy_on_the_cpu(cam):
    camv = _fresh_camv(cam, *ARGS)
    syncs = tracing.HOST_SYNCS
    assert integrator._camv_to(camv, torch.device("cpu")) is camv
    assert tracing.HOST_SYNCS == syncs
    leaf = camv.clone().requires_grad_(True)
    copied = integrator._camv_to(leaf, torch.device("cpu"))
    assert tracing.HOST_SYNCS == syncs + 1 and copied.requires_grad


@pytest.mark.parametrize("backend", ["auto", "wavefront"])
def test_warm_batches_render_the_cold_image(tmp_path, backend):
    """Batches that hit the cache against batches that each compute the
    frame anew, on v4 and on the wavefront: the same accumulator, bitwise."""
    scene, _ = loader.load_scene(write_scene(tmp_path, "cornell"))
    accums = []
    for cold in (False, True):
        r = Renderer(scene, 16, 16, num_samples=4, max_depth=5, device="cpu",
                     backend=backend)
        hits = camera.FRAME_HITS
        for _ in range(3):
            if cold:
                camera.clear_frame_cache()
            r.update(1)
        assert camera.FRAME_HITS - hits == (0 if cold else 2)
        accums.append(r.state.accum)
    assert torch.equal(*accums)
