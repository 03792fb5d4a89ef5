"""Parts of the v4 kernel's plain version vs the JAX package: the murmur
RNG (bitwise), the camera (allclose 1e-6), the packed record tables (exact)
and the hash noise (atol 1e-6). Inputs are drawn with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace2_tpu.ops import camera as jax_camera
from raytrace2_tpu.ops import rng as jax_rng
from raytrace2_tpu.ops.pallas import megakernel as jmk
from raytrace2_tpu.scene import loader as jax_loader
from raytrace2_tpu.scene import schema as jax_schema
from raytrace2_tpu_torch.ops import camera, rng
from raytrace2_tpu_torch.ops.kernels import megakernel as mk
from raytrace2_tpu_torch.scene import loader, schema
from test_torch_scenes import write_scene

SEEDS = [0, 16, 17, 42, 123, 2**28 + 7]


def _u32_words(rs, n):
    return rs.randint(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    """uint32 numpy → the port's int64 word holder."""
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_mix_and_uniform_bitwise():
    rs = np.random.RandomState(0)
    x = _u32_words(rs, 100_000)
    ref_mix = np.asarray(jax.jit(jmk._mix)(jnp.asarray(x)))
    np.testing.assert_array_equal(rng.murmur_mix(_t(x)).numpy(), ref_mix.astype(np.int64))
    ref_u = np.asarray(jax.jit(jmk._uniform_from_bits)(jnp.asarray(x)))
    ours = rng.uniform_from_bits(_t(x)).numpy()
    np.testing.assert_array_equal(ours.view(np.uint32), ref_u.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_sample_key_and_draws_bitwise(seed):
    rs = np.random.RandomState(seed % 1000)
    pix = rs.randint(0, 600 * 600, size=4096).astype(np.int32)
    samples = rs.randint(0, 5000, size=4096).astype(np.float32)
    ref_key = np.asarray(jax.jit(jmk.v4_sample_key)(
        jnp.int32(seed), jnp.asarray(pix).astype(jnp.uint32), jnp.asarray(samples)))
    key = rng.v4_sample_key(seed, torch.from_numpy(pix), torch.from_numpy(samples))
    np.testing.assert_array_equal(key.numpy(), ref_key.astype(np.int64))
    for k in range(5):
        ref = np.asarray(jax.jit(lambda kk: jmk.cam_draw(kk, k))(jnp.asarray(ref_key)))
        np.testing.assert_array_equal(rng.cam_draw(key, k).numpy(), ref)
    # Bounce-side draws at traced counters (the v4 bounce's ``draw``).
    ctr = rs.randint(0, 50 * 7, size=4096).astype(np.int32)
    ref = np.asarray(jax.jit(lambda kk, c: jmk._uniform_from_bits(jmk._mix(
        kk ^ jmk._mix(c.astype(jnp.uint32) * jnp.uint32(0x9E3779B9) + jnp.uint32(1)))))(
            jnp.asarray(ref_key), jnp.asarray(ctr)))
    np.testing.assert_array_equal(rng.draw(key, torch.from_numpy(ctr)).numpy(), ref)


@pytest.mark.parametrize("seed", SEEDS)
def test_murmur_uniforms_and_noise_hash_bitwise(seed):
    rs = np.random.RandomState(seed % 997)
    pix = rs.randint(0, 2**20, size=2048).astype(np.int32)
    mega = np.int32((seed * 1000003 + 5) % 2**31)
    ctrs = [0, 1, 2, rng.CAMERA_CTR_BASE + 3]
    ref = np.asarray(jax_rng.murmur_uniforms_at(jnp.int32(mega), jnp.asarray(pix), ctrs))
    ours = rng.murmur_uniforms_at(int(mega), torch.from_numpy(pix), ctrs).numpy()
    np.testing.assert_array_equal(ours, ref)
    ijk = rs.randint(-2**31, 2**31 - 1, size=(3, 2048), dtype=np.int64).astype(np.int32)
    sd = _u32_words(rs, 2048)
    ref_h = np.asarray(jax.jit(jmk._lattice_hash)(*(jnp.asarray(a) for a in ijk),
                                                 jnp.asarray(sd)))
    ours_h = rng.lattice_hash(*(torch.from_numpy(a) for a in ijk), _t(sd))
    np.testing.assert_array_equal(ours_h.numpy(), ref_h.astype(np.int64))


@pytest.mark.parametrize("name,dims", [("cornell", (600, 600)), ("feature", (40, 24))])
def test_camv_and_camera_ray(tmp_path, name, dims):
    path = write_scene(tmp_path, name)
    scene, _ = loader.load_scene(path)
    jscene = jax_schema.to_device(jax_loader.load_scene(path)[0])
    w, h = dims
    frame = jax_camera.camera_frame(jscene.camera, w, h)
    ref_camv = np.concatenate([np.asarray(frame[k], np.float32).reshape(-1) for k in (
        "pixel00", "pixel_delta_u", "pixel_delta_v", "center", "defocus_disk_u",
        "defocus_disk_v", "defocus_angle")])
    camv = camera.make_camv(scene.camera, w, h, sample0=3, n_samples=4, sqrt_spp=2, seed=7)
    assert camv.dtype == torch.float32 and camv.shape == (camera.CAMV_LEN,)
    np.testing.assert_allclose(camv[:19].numpy(), ref_camv, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(camv[19:].numpy(),
                                  [w, w * h, 3, 4, 2, 7, 0, -(-w // 64), h])

    rs = np.random.RandomState(1)
    n = 1024
    slot = rs.randint(0, w * h, size=n).astype(np.float32)
    s_glob = rs.randint(0, 64, size=n).astype(np.float32)
    sqrt_spp = 8.0
    key = rs.randint(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    cv = camv.tolist()
    xx, yy, _ = camera.slot_to_pixel(torch.from_numpy(slot), cv)
    jx, jy, _ = jmk.slot_to_pixel(jnp.asarray(slot), jnp.asarray(camv.numpy()),
                                  tile_r=4096, block=64, linear_slots=True)
    np.testing.assert_array_equal(xx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(yy.numpy(), np.asarray(jy))
    ours = camera.camera_ray(cv, xx, yy, sqrt_spp, torch.from_numpy(s_glob), _t(key))
    ref = jax.jit(jmk.camera_ray)(jnp.asarray(camv.numpy()), jx, jy, jnp.float32(sqrt_spp),
                                  jnp.asarray(s_glob), jnp.asarray(key))
    # The direction is (pixel center - origin) / length: both points sit at
    # world scale and XLA fuses their sums into FMAs, so one ulp of the
    # pixel center (at Cornell's 800 units) moves the unit direction by
    # ulp/|pc - o| (focus distance 1). That cancellation bound is added to
    # atol for the direction; origins and time stay at 1e-6.
    spacing = float(np.spacing(np.float32(np.abs(camv[:12].numpy()).max())))
    focus = float(scene.camera.focus_dist)
    for i, (a, b) in enumerate(zip(ours, ref)):
        atol = 1e-6 + (4 * spacing / focus if 3 <= i < 6 else 0.0)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=atol)


@pytest.mark.parametrize("name", ["cornell", "cornell_volume", "feature", "book2"])
def test_pack_tables_exact(tmp_path, name):
    path = write_scene(tmp_path, name)
    scene, _ = loader.load_scene(path)
    sizes = tuple(scene.features()["mega_sizes"])
    dev = schema.to_device(scene, "cpu")
    ours = mk.pack_tables(dev, sizes)
    ref = jmk.pack_tables(jax_schema.to_device(jax_loader.load_scene(path)[0]), sizes)
    layout = mk.table_layout(sizes)
    for (fam, keys), fam_ours, fam_ref in zip(mk.FAMILIES, ours, ref):
        rows = layout[fam][1]
        # JAX adds the cluster-skip tables, which the flat sweep does not read.
        assert sorted(fam_ours) == sorted(keys) and set(keys) <= set(fam_ref), fam
        for k in keys:
            np.testing.assert_array_equal(fam_ours[k].numpy(),
                                          np.asarray(fam_ref[k])[:rows], err_msg=k)
        # JAX pads spheres and boxes with inactive rows; the port drops them.
        if "act" in keys:
            assert not np.asarray(fam_ref["act"])[rows:].any(), fam
        else:
            assert len(fam_ref[keys[0]]) == rows, fam
    # The packed buffer holds each family's rows at its static offsets.
    packed = mk.pack_buffer(dev, sizes)
    assert packed.numel() == layout["total"][0]
    cols = mk.unpack_buffer(packed, sizes)
    for (fam, keys), fam_ref in zip(mk.FAMILIES, ref):
        for k in keys:
            np.testing.assert_array_equal(cols[fam][k].numpy(),
                                          np.asarray(fam_ref[k])[:layout[fam][1]], err_msg=k)


def test_hash_noise_matches_jax():
    rs = np.random.RandomState(2)
    p = rs.uniform(-40.0, 40.0, size=(3, 4096)).astype(np.float32)
    seed = _u32_words(rs, 4096)
    pt = [torch.from_numpy(a) for a in p]
    pj = [jnp.asarray(a) for a in p]
    np.testing.assert_allclose(
        mk.perlin_noise(*pt, _t(seed)).numpy(),
        np.asarray(jax.jit(jmk._perlin_noise)(*pj, jnp.asarray(seed))), atol=1e-6)
    np.testing.assert_allclose(
        mk.turbulence(*pt, _t(seed)).numpy(),
        np.asarray(jax.jit(jmk._turbulence)(*pj, jnp.asarray(seed))), atol=1e-6)
