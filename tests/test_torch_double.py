"""``RAYTRACE2_DOUBLE=1`` in the port against the JAX package's x64 mode:
the threefry uniforms (float64 from 64-bit draws) bit for bit, the float64
render of the non-kernel path against JAX's float64 XLA render, the port's
float32 render against its float64 one (JAX's tests/test_double.py gate),
and the kernel route, whose image the toggle does not change. The dtype is
bound at import, so each side runs in a subprocess of its own."""

import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_scenes import write_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, SPP, DEPTH = 16, 12, 2, 4

_PORT = f"""
import sys, numpy as np, torch
from raytrace2_tpu_torch import defs
from raytrace2_tpu_torch.ops import integrator, rng
from raytrace2_tpu_torch.render import Renderer
from raytrace2_tpu_torch.scene import loader, schema

host, _ = loader.load_scene(sys.argv[1])
scene = schema.to_device(host, "cpu")
feat = dict(host.features(), use_megakernel=False)
xla = integrator.render_progressive(scene, feat, {W}, {H}, 0, {SPP}, 0, {DEPTH}, 1)
keys = rng.pixel_sample_key(3, torch.arange(64), 5)
u = rng.uniform(rng.fold_in(keys, 2), 7)
kern = Renderer(host, {W}, {H}, num_samples={SPP}, max_depth={DEPTH}, device="cpu")
assert kern.route == "kernel"
kern.update({SPP})
pallas = Renderer(host, {W}, {H}, num_samples=1, max_depth={DEPTH}, device="cpu",
                  backend="pallas")
pallas.update(1)
np.savez(sys.argv[2], xla=xla.numpy(), u=u.numpy(), kernel=kern.state.accum.numpy(),
         kernel_image=kern.linear_pixels(), pallas=pallas.state.accum.numpy())
print("REAL", defs.REAL.__name__, xla.dtype, u.dtype, kern.state.accum.dtype)
"""

_JAX = f"""
import sys, numpy as np, jax, jax.numpy as jnp
from raytrace2_tpu import defs
from raytrace2_tpu.ops import integrator, rng
from raytrace2_tpu.scene import loader, schema

host, _ = loader.load_scene(sys.argv[1])
scene = schema.to_device(host)
r = integrator.render_progressive(scene, host.features(), {W}, {H}, jnp.int32(0),
                                  jnp.int32({SPP}), 0, {DEPTH}, 1)
keys = jax.vmap(lambda p: rng.pixel_sample_key(3, p, 5))(jnp.arange(64, dtype=jnp.int32))
u = jax.vmap(lambda k: jax.random.uniform(jax.random.fold_in(k, 2), (7,)))(keys)
np.savez(sys.argv[2], xla=np.asarray(r), u=np.asarray(u))
print("REAL", defs.REAL.__name__, r.dtype, u.dtype)
"""


def _run(code, scene, out, double):
    env = dict(os.environ, RAYTRACE2_DOUBLE=double, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    p = subprocess.run([sys.executable, "-c", code, scene, str(out)], capture_output=True,
                       text=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    real = "float64" if double == "1" else "float32"
    assert p.stdout.split()[:2] == ["REAL", real], p.stdout
    assert p.stdout.count(real) == len(p.stdout.split()) - 1, p.stdout
    return dict(np.load(out))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The corpus Cornell (``make_scene.cornell_box_corpus``, the scene of
    the JAX package's tests/test_double.py) through the port in both modes
    and through JAX under x64."""
    tmp = tmp_path_factory.mktemp("double")
    scene = write_scene(tmp, "cornell_corpus")
    return {"port64": _run(_PORT, scene, tmp / "p64.npz", "1"),
            "port32": _run(_PORT, scene, tmp / "p32.npz", "0"),
            "jax64": _run(_JAX, scene, tmp / "j64.npz", "1")}


def test_x64_uniforms_bitwise(runs):
    """Threefry uniforms under the toggle: float64 from 64-bit draws (52
    mantissa bits), JAX's bit for bit, and not the float32 stream."""
    u64, ref = runs["port64"]["u"], runs["jax64"]["u"]
    assert u64.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(u64.view(np.int64), ref.view(np.int64))
    assert np.abs(u64 - runs["port32"]["u"]).max() > 0.1


def test_f64_render_matches_jax_f64(runs):
    """The float64 non-kernel render (16x12, 2 spp, depth 4) against JAX's
    float64 XLA render: the same streams in float64, so the images agree to
    float64 rounding; the median |diff| at most 1e-12 of the scale, which an
    intermediate rounded to float32 (1e-7 relative) would miss, and at most
    1 % of values apart by more than 1e-9 of it (a path flipped at a
    discrete decision)."""
    ours, ref = runs["port64"]["xla"], runs["jax64"]["xla"]
    assert ours.dtype == ref.dtype == np.float64 and ours.shape == (H, W, 3)
    scale = float(np.abs(ref).max())
    diff = np.abs(ours - ref)
    assert scale > 0 and float(np.median(diff)) <= 1e-12 * scale
    assert float((diff > 1e-9 * scale).mean()) <= 0.01


def test_f32_matches_f64_oracle(runs):
    """The port's float32 render against its float64 one (the gate of the
    JAX package's tests/test_double.py): flipped < 15 %, the others' p99
    below 2e-4 of the scale, the median below 1e-6 of it."""
    f32, f64 = runs["port32"]["xla"], runs["port64"]["xla"]
    assert f32.dtype == np.float32
    diff = np.abs(f32.astype(np.float64) - f64)
    scale = float(np.abs(f64).max())
    flipped = diff > 1e-3 * scale
    assert float(flipped.mean()) < 0.15
    assert float(np.quantile(diff[~flipped], 0.99)) / scale < 2e-4
    assert float(np.median(diff)) < 1e-6 * scale


def test_kernel_routes_unchanged_by_toggle(runs):
    """The v4 route under the toggle (one launch of 2 samples): its
    radiance bit for bit in a float64 accumulator, and its image equal once
    rounded to float32. B5 keeps float32 tables and takes the pallas
    route's float64 rays rounded to float32: that route runs, and its image
    meets the float32-against-float64 gate."""
    p64, p32 = runs["port64"], runs["port32"]
    assert p64["kernel"].dtype == np.float64
    np.testing.assert_array_equal(p64["kernel"], p32["kernel"].astype(np.float64))
    np.testing.assert_array_equal(p64["kernel_image"].astype(np.float32), p32["kernel_image"])
    diff = np.abs(p64["pallas"] - p32["pallas"])
    scale = float(np.abs(p64["pallas"]).max())
    assert p64["pallas"].dtype == np.float64 and scale > 0
    assert float((diff > 1e-3 * scale).mean()) < 0.15
    assert float(np.median(diff)) < 1e-6 * scale
