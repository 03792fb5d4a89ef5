"""The Hopper kernels (v4, the wavefront step) against their plain PyTorch
versions and each other, on the card. Skipped where
torch.cuda.is_available() is false. Run on a machine with the card:
python -m pytest tests/test_torch_cuda.py -q --noconftest"""

import json

import numpy as np
import pytest
import torch

from raytrace2_tpu_torch.io import compare
from raytrace2_tpu_torch.ops import camera
from raytrace2_tpu_torch.ops.kernels import megakernel as mk
from raytrace2_tpu_torch.ops.kernels import wavefront as wf
from raytrace2_tpu_torch.render import Renderer
from raytrace2_tpu_torch.scene import loader, schema
from test_torch_scenes import write_scene

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _both(path, w, h, spp, depth, device):
    scene, _ = loader.load_scene(path)
    feats = scene.features()
    sizes = tuple(feats["mega_sizes"])
    dev = schema.to_device(scene, device)
    packed = mk.pack_buffer(dev, sizes)
    camv = camera.make_camv(scene.camera, w, h, 0, spp, max(int(spp ** 0.5), 1), 0).to(device)
    kw = dict(n_pix=w * h, max_depth=depth, sizes=sizes,
              has_checker=feats["has_checker"], has_noise=feats["has_noise"])
    before = mk.LAUNCHES
    kern = mk.trace_megakernel_batch(camv, 0, packed, dev.background, **kw)
    torch.cuda.synchronize()
    assert mk.LAUNCHES == before + 1
    plain = mk.trace_plain(camv, 0, packed, dev.background, **kw)
    return kern.cpu().numpy() / spp, plain.cpu().numpy() / spp


@pytest.mark.parametrize("name,size", [("cornell", 64), ("cornell_volume", 48), ("feature", 48)])
def test_kernel_matches_plain(tmp_path, cuda, name, size):
    kern, plain = _both(write_scene(tmp_path, name), size, size, 4, 8, cuda)
    assert np.isfinite(kern).all()
    assert abs(kern.mean() - plain.mean()) < 1e-3
    assert compare.psnr(kern, plain) >= 45.0


def test_closed_form_on_card(tmp_path, cuda):
    p = tmp_path / "enclosure.json"
    p.write_text(json.dumps({
        "background_color": [0, 0, 0],
        "camera": {"fov": 90, "center": [0, 0, 0], "look_at": [0, 0, -1]},
        "materials": [{"type": "diffuse_light", "albedo": [2.0, 3.0, 4.0]}],
        "primitives": [{"type": "sphere", "center": [0, 0, 0], "radius": 10.0,
                        "material": 0}]}))
    scene, _ = loader.load_scene(str(p))
    img = Renderer(scene, 8, 8, num_samples=3, max_depth=4, device=cuda).render(batch=3)
    np.testing.assert_allclose(img, np.broadcast_to([2, 3, 4], img.shape), rtol=1e-5)


def test_wrapper_rejects_bad_inputs(tmp_path, cuda):
    scene, _ = loader.load_scene(write_scene(tmp_path, "cornell"))
    sizes = tuple(scene.features()["mega_sizes"])
    dev = schema.to_device(scene, cuda)
    packed = mk.pack_buffer(dev, sizes)
    camv = camera.make_camv(scene.camera, 8, 8, 0, 1, 1, 0).to(cuda)
    kw = dict(n_pix=64, max_depth=4, sizes=sizes, has_checker=0, has_noise=False)
    with pytest.raises(ValueError):
        mk.trace_megakernel_batch(camv.cpu(), 0, packed, dev.background, **kw)
    with pytest.raises(ValueError):
        mk.trace_megakernel_batch(camv, 0, packed[:-1].contiguous(), dev.background, **kw)


def _wavefront_args(path, w, h, spp, depth, device):
    scene, _ = loader.load_scene(path)
    feats = scene.features()
    sizes = tuple(feats["mega_sizes"])
    dev = schema.to_device(scene, device)
    camv = camera.make_camv(scene.camera, w, h, 0, spp, max(int(spp ** 0.5), 1), 0).to(device)
    kw = dict(max_depth=depth, sizes=sizes, has_checker=feats["has_checker"],
              has_noise=feats["has_noise"])
    return (camv, 0, mk.pack_buffer(dev, sizes), dev.background), kw


@pytest.mark.parametrize("name,size", [("cornell", 48), ("feature", 32), ("book2", 16)])
def test_wavefront_kernel_matches_plain_and_v4(tmp_path, cuda, name, size):
    """The wavefront kernel against the wavefront driven by its plain step
    (matched-RNG gate), and bitwise against the v4 kernel: both kernels share
    path_common.cuh."""
    args, kw = _wavefront_args(write_scene(tmp_path, name), size, size, 4, 8, cuda)
    n_pix = size * size
    n_rays = -(-n_pix // wf.SLOT_TILE) * wf.SLOT_TILE
    launches = wf.LAUNCHES
    kern = wf.trace_wavefront_batch(*args, n_rays=n_rays, **kw)[:n_pix]
    torch.cuda.synchronize()
    assert wf.LAUNCHES > launches
    plain = wf.trace_wavefront_batch(*args, n_rays=n_rays, step=wf.step_plain, **kw)[:n_pix]
    v4 = mk.trace_megakernel_batch(*args, n_pix=n_pix, **kw)
    kern, plain, v4 = (x.cpu().numpy() / 4 for x in (kern, plain, v4))
    assert np.isfinite(kern).all()
    assert abs(kern.mean() - plain.mean()) < 1e-3
    assert compare.psnr(kern, plain) >= 45.0
    np.testing.assert_array_equal(kern, v4)


def test_wavefront_step_rejects_bad_state(tmp_path, cuda):
    args, kw = _wavefront_args(write_scene(tmp_path, "cornell"), 8, 8, 1, 4, cuda)
    state = wf.init_wavefront_state(128, args[0].tolist(), cuda)
    with pytest.raises(ValueError):
        wf.wavefront_step(state[:16].contiguous(), *args, k_bounces=2, **kw)
    with pytest.raises(ValueError):
        wf.wavefront_step(state.cpu(), *args, k_bounces=2, **kw)


def test_record_ceiling_scene_on_card(tmp_path, cuda):
    """4,096 spheres, the most records the kernel path takes: its tables
    (147 KB of shared memory) launch through the wavefront kernel."""
    p = tmp_path / "spheres.json"
    p.write_text(json.dumps({
        "camera": {"fov": 40, "center": [0, 0, 30], "look_at": [0, 0, 0]},
        "materials": [{"type": "diffuse_light", "albedo": [1.0, 2.0, 3.0]}],
        "primitives": [{"type": "sphere", "center": [0.01 * (i % 64) - 0.3,
                                                     0.01 * (i // 64) - 0.3, 0],
                        "radius": 0.5, "material": 0} for i in range(4096)]}))
    scene, _ = loader.load_scene(str(p))
    launches = wf.LAUNCHES
    r = Renderer(scene, 16, 16, num_samples=1, max_depth=2, device=cuda)
    assert r.kernel == "wavefront_step"
    img = r.render()
    assert wf.LAUNCHES > launches
    assert np.isfinite(img).all() and img.max() == 3.0
