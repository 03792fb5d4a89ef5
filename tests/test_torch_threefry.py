"""The threefry family of the non-kernel path against ``jax.random``: keys
and uniforms bitwise on a grid of seeds, samples, pixels and bounce ids, and
the camera rays of both RNG branches of ``generate_rays``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace2_tpu.ops import camera as jax_camera
from raytrace2_tpu.ops import rng as jax_rng
from raytrace2_tpu.scene import loader as jax_loader
from raytrace2_tpu.scene import schema as jax_schema
from raytrace2_tpu_torch.ops import camera, integrator, rng
from raytrace2_tpu_torch.scene import loader
from test_torch_scenes import write_scene

SEEDS = (0, 1, 7, 12345, 2**31 - 1)
SAMPLES = (0, 1, 63)
PIXELS = np.array([0, 1, 359999, 2**24 + 3], dtype=np.int32)
BOUNCES = (0, 5, 0x7FFFFFFF)


def _jax_keys(seed, sample):
    return jax.vmap(lambda p: jax.random.key_data(jax_rng.pixel_sample_key(seed, p, sample)))(
        jnp.asarray(PIXELS))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_uniforms_bitwise(seed):
    """pixel_sample_key, bounce_key (fold_in) and uniform(k, n) for n in
    {3, 5, 7}: every word and every float's bits equal jax.random's."""
    for sample in SAMPLES:
        want = np.asarray(_jax_keys(seed, sample)).astype(np.int64)
        keys = rng.pixel_sample_key(seed, torch.from_numpy(PIXELS), sample)
        np.testing.assert_array_equal(keys.numpy(), want)
        for b in BOUNCES:
            jk = jax.vmap(lambda k: jax.random.key_data(
                jax_rng.bounce_key(jax.random.wrap_key_data(k), b)))(jnp.asarray(want, jnp.uint32))
            np.testing.assert_array_equal(rng.bounce_key(keys, b).numpy(),
                                          np.asarray(jk).astype(np.int64))
            for n in (3, 5, 7):
                ju = np.asarray(jax.vmap(lambda k: jax_rng.bounce_uniforms(
                    jax.random.wrap_key_data(k)[None], b, n)[0])(jnp.asarray(want, jnp.uint32)))
                tu = rng.bounce_uniforms(keys, b, n).numpy()
                np.testing.assert_array_equal(tu.view(np.int32), ju.view(np.int32))


def test_samplers_match_jax():
    """unit_vec3_from_uniforms and disk_from_uniforms on seeded uniforms."""
    u = np.random.RandomState(0).uniform(0, 1, (2, 4096)).astype(np.float32)
    for jf, tf in ((jax_rng.unit_vec3_from_uniforms, rng.unit_vec3_from_uniforms),
                   (jax_rng.disk_from_uniforms, rng.disk_from_uniforms)):
        want = np.asarray(jf(jnp.asarray(u[0]), jnp.asarray(u[1])))
        got = tf(torch.from_numpy(u[0]), torch.from_numpy(u[1])).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=4e-7)


@pytest.mark.parametrize("branch", ["threefry", "murmur"])
def test_generate_rays_matches_jax(tmp_path, branch):
    """Rays of both branches (threefry keys; the murmur camera draws as
    ``uniforms=``) on the feature scene's defocused camera at sample 5 of a
    3×3 stratification: origins and directions to a few ulps at the scene's
    scale (XLA contracts the camera's multiply-adds, torch does not), the
    shutter times bitwise."""
    path = write_scene(tmp_path, "feature")
    w, h, sample, sqrt_spp = 24, 16, 5, 3
    jcam = jax_schema.to_device(jax_loader.load_scene(path)[0]).camera
    cam = loader.load_scene(path)[0].camera
    pix = np.arange(w * h, dtype=np.int32)
    if branch == "threefry":
        jkeys = jax.vmap(lambda p: jax_rng.pixel_sample_key(9, p, sample))(jnp.asarray(pix))
        want = jax_camera.generate_rays(jcam, w, h, sample, sqrt_spp, jkeys)
        got = camera.generate_rays(cam, w, h, sample, sqrt_spp,
                                   rng.pixel_sample_key(9, torch.from_numpy(pix), sample))
    else:
        ctrs = tuple(jax_rng.CAMERA_CTR_BASE + k for k in range(5))
        mega_seed = integrator.mega_seed_of(9, sample)
        ju = jax_rng.murmur_uniforms(jnp.int32(mega_seed), jnp.asarray(pix), ctrs)
        want = jax_camera.generate_rays(jcam, w, h, sample, sqrt_spp, None, uniforms=ju)
        tu = rng.murmur_uniforms(mega_seed, torch.from_numpy(pix), ctrs)
        np.testing.assert_array_equal(tu.numpy().view(np.int32),
                                      np.asarray(ju).view(np.int32))
        got = camera.generate_rays(cam, w, h, sample, sqrt_spp, None, uniforms=tu)
    (jo, jd, jt), (o, d, t) = (np.asarray(x) for x in want), (x.numpy() for x in got)
    np.testing.assert_allclose(o, jo, rtol=0, atol=8 * np.spacing(np.float32(8.0)))
    np.testing.assert_allclose(d, jd, rtol=0, atol=8 * np.spacing(np.float32(1.0)))
    np.testing.assert_array_equal(t.view(np.int32), jt.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_draws_match_jax(seed):
    """``split``, the uniforms of any shape (in [0, 1) and on JAX's normal
    interval (nextafter(-1, 0), 1)) bit for bit; ``normal``, ``unit_vec3``,
    ``in_unit_sphere``, ``in_unit_disk`` and ``on_hemisphere`` within
    rtol 1e-5 and atol 2e-6: torch's erfinv, pow, sin and cos are not
    XLA's, whose erf_inv is a polynomial approximation that strays by up to
    6e-6 relative in the tails (|x| near 4, measured)."""
    jkey = jax.random.fold_in(jax.random.key(seed), 11)
    key = rng.fold_in(rng.threefry_key(seed), 11)
    np.testing.assert_array_equal(key.numpy(), np.asarray(jax.random.key_data(jkey)))
    np.testing.assert_array_equal(rng.split(key).numpy(),
                                  np.asarray(jax.random.key_data(jax.random.split(jkey))))
    lo = np.nextafter(np.float32(-1), np.float32(0))
    for shape in ((), (5,), (64, 3)):
        want = np.asarray(jax.random.uniform(jkey, shape))
        np.testing.assert_array_equal(rng.uniform_shape(key, shape).numpy().view(np.int32),
                                      want.view(np.int32))
        want = np.asarray(jax.random.uniform(jkey, shape, minval=lo, maxval=1.0))
        got = rng.uniform_shape(key, shape, lo, 1.0).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    normal = np.asarray(jax.random.normal(jkey, (4096,)))
    np.testing.assert_allclose(rng.normal(key, (4096,)).numpy(), normal, rtol=1e-5, atol=2e-6)
    shape = (512,)
    nrm = np.random.RandomState(seed).normal(size=shape + (3,)).astype(np.float32)
    for jf, tf, arg in ((jax_rng.unit_vec3, rng.unit_vec3, shape),
                        (jax_rng.in_unit_sphere, rng.in_unit_sphere, shape),
                        (jax_rng.in_unit_disk, rng.in_unit_disk, shape),
                        (jax_rng.on_hemisphere, rng.on_hemisphere, nrm)):
        want = np.asarray(jf(jkey, jnp.asarray(arg) if arg is nrm else arg))
        got = tf(key, torch.from_numpy(arg) if arg is nrm else arg).numpy()
        assert got.shape == want.shape == shape + (3,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6)
    disk = rng.in_unit_disk(key, shape).numpy()
    assert (np.linalg.norm(disk, axis=-1) <= 1.0).all() and (disk[:, 2] == 0).all()
    hemi = rng.on_hemisphere(key, torch.from_numpy(nrm)).numpy()
    assert ((hemi * nrm).sum(-1) >= 0).all()
