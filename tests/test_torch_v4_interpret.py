"""The v4 kernel's plain version vs the JAX v4 kernel run in Pallas interpret
mode, on matched RNG streams: the repo's matched-RNG gate (|Δmean| < 1e-3,
PSNR ≥ 45 dB; tests/test_golden.py::test_cross_backend_matched_rng_psnr)."""

import jax.numpy as jnp
import numpy as np
import pytest

from raytrace2_tpu.ops import integrator as jax_integrator
from raytrace2_tpu.scene import loader as jax_loader
from raytrace2_tpu.scene import schema as jax_schema
from raytrace2_tpu_torch.io import compare
from raytrace2_tpu_torch.ops import camera
from raytrace2_tpu_torch.ops.kernels import megakernel as mk
from raytrace2_tpu_torch.scene import loader, schema
from test_torch_scenes import write_scene

pytestmark = pytest.mark.kernel  # Pallas interpret mode, as the JAX kernel tests


@pytest.mark.parametrize("name,size,spp,depth", [
    ("cornell", 16, 2, 4),
    ("feature", 16, 2, 6),
])
def test_plain_v4_matches_jax_kernel(tmp_path, name, size, spp, depth):
    path = write_scene(tmp_path, name)
    w = h = size
    sqrt_spp = max(int(np.sqrt(spp)), 1)
    jhost, _ = jax_loader.load_scene(path)
    feat = dict(jhost.features(), use_megakernel=True, mega_interpret=True)
    ref = np.asarray(jax_integrator.render_progressive(
        jax_schema.to_device(jhost), feat, w, h, jnp.int32(0), jnp.int32(spp), 0,
        depth, sqrt_spp)) / spp

    scene, _ = loader.load_scene(path)
    feats = scene.features()
    sizes = tuple(feats["mega_sizes"])
    dev = schema.to_device(scene, "cpu")
    packed = mk.pack_buffer(dev, sizes)
    camv = camera.make_camv(scene.camera, w, h, 0, spp, sqrt_spp, 0)
    launches = mk.LAUNCHES
    ours = mk.trace_megakernel_batch(
        camv, 0, packed, dev.background, n_pix=w * h, max_depth=depth, sizes=sizes,
        has_checker=feats["has_checker"], has_noise=feats["has_noise"])
    assert mk.LAUNCHES == launches  # a CPU tensor runs the plain version
    ours = ours.numpy().reshape(h, w, 3) / spp
    assert np.isfinite(ours).all()
    assert abs(ours.mean() - ref.mean()) < 1e-3
    assert compare.psnr(ours, ref) >= 45.0
