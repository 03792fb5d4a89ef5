"""The Hopper v4 kernel against its plain PyTorch version, on the card.
Skipped where torch.cuda.is_available() is false. Run on a machine with the
card: python -m pytest tests/test_torch_cuda.py -q"""

import json

import numpy as np
import pytest
import torch

from raytrace2_tpu_torch.io import compare
from raytrace2_tpu_torch.ops import camera
from raytrace2_tpu_torch.ops.kernels import megakernel as mk
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
