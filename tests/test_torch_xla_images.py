"""Whole images of the non-kernel path against the JAX package's XLA path
(``integrator.render_progressive`` with ``use_megakernel`` off, under
``jax.jit``), with the image gate (test_torch_xla_path._gate). The JAX side
compiles each scene's loop once, which is most of this file's time."""

import jax.numpy as jnp
import numpy as np
import pytest

from raytrace2_tpu.ops import integrator as jax_integrator
from raytrace2_tpu.scene import loader as jax_loader
from raytrace2_tpu.scene import schema as jax_schema
from raytrace2_tpu_torch import interop
from raytrace2_tpu_torch.io import compare
from raytrace2_tpu_torch.ops import integrator
from raytrace2_tpu_torch.scene import schema
from test_torch_scenes import write_scene
from test_torch_xla_path import _gate


def _jax_image(jhost_path, w, h, spp, depth, **feat_kw):
    jhost, _ = jax_loader.load_scene(jhost_path)
    feat = dict(jhost.features(), use_megakernel=False, **feat_kw)
    acc = jax_integrator.render_progressive(jax_schema.to_device(jhost), feat, w, h,
                                            jnp.int32(0), jnp.int32(spp), 0, depth,
                                            max(int(np.sqrt(spp)), 1))
    return np.asarray(acc) / spp, jhost, feat


@pytest.mark.parametrize("name,rng_impl", [("cornell", None), ("cornell_volume", None),
                                           ("feature", None), ("ellipsoid", None),
                                           ("cornell", "murmur")])
def test_image_matches_jax_xla_path(tmp_path, name, rng_impl):
    """32², 4 spp (2×2 strata), depth 8 through integrator.render_progressive
    on the non-kernel path: threefry streams, or the kernels' murmur
    streams."""
    kw = {"rng_impl": rng_impl} if rng_impl else {}
    ref, jhost, feat = _jax_image(write_scene(tmp_path, name), 32, 32, 4, 8, **kw)
    scene = schema.to_device(interop.from_jax_scene(jhost), "cpu")
    ours = integrator.render_progressive(scene, feat, 32, 32, 0, 4, 0, 8, 2).numpy() / 4
    _gate(ours, ref)


def test_book2_image_matches_jax_xla_path(tmp_path):
    """Book 2 (1,005 spheres, 2,401 quads, two media) at 8², 4 spp, depth 8.
    At this size one pixel is 1.6 % of the image, so the gate's 0.5 % allows
    none. XLA's fused compile of the media free path flips one of the 256
    paths here (the port equals JAX's op-by-op run of it), so the gate
    allows one flipped pixel and holds the others to the mean and 60 dB."""
    ref, jhost, feat = _jax_image(write_scene(tmp_path, "book2"), 8, 8, 4, 8)
    scene = schema.to_device(interop.from_jax_scene(jhost), "cpu")
    ours = integrator.render_progressive(scene, feat, 8, 8, 0, 4, 0, 8, 2).numpy() / 4
    assert np.isfinite(ours).all()
    flipped = np.abs(ours - ref).max(-1) > 1e-4
    assert flipped.sum() <= 1
    assert abs(float(ours[~flipped].mean()) - float(ref[~flipped].mean())) < 1e-3
    assert compare.psnr(ours[~flipped], ref[~flipped]) >= 60.0
