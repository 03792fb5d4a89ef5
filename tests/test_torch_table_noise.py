"""Table Perlin noise on the kernel path (``noise_impl="table"``) on the CPU:
the plain noise against the JAX kernel's ``_table_perlin`` and
``_table_turbulence`` and the non-kernel path's textures, whole plain images
(v4 and the sorted wavefront) against JAX's XLA path, and the gradient's AD
against finite differences. The gradient against JAX's XLA path is in
tests/test_torch_grad.py, beside the solid scene's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace2_tpu.ops import integrator as jax_integrator
from raytrace2_tpu.ops.pallas import megakernel as jmk
from raytrace2_tpu.scene import loader as jax_loader
from raytrace2_tpu.scene import schema as jax_schema
from raytrace2_tpu_torch import grad
from raytrace2_tpu_torch.io import compare
from raytrace2_tpu_torch.ops import integrator, textures
from raytrace2_tpu_torch.ops.kernels import megakernel as mk
from raytrace2_tpu_torch.ops.kernels import wavefront as wf
from raytrace2_tpu_torch.scene import loader, schema
from raytrace2_tpu_torch.tools import optimize_scene as opt
from test_torch_scenes import write_scene

NOISE_KW = dict(width=6, height=4, n_samples=1, max_depth=3, sqrt_spp=1)


def test_table_noise_matches_jax_kernel_and_textures(tmp_path):
    """One octave and the turbulence of table Perlin at 1,024 points of the
    feature scene's two noise textures (nslot 0 and 1): the port's plain
    version against JAX's ``_table_perlin``/``_table_turbulence`` (run op by
    op) bitwise, and one octave against the non-kernel path's
    ``textures.perlin_noise`` to f32 rounding (it sums each corner's dot
    product with ``torch.sum``)."""
    path = write_scene(tmp_path, "feature")
    scene, _ = loader.load_scene(path)
    rows = tuple(scene.features()["noise_rows"])
    assert len(rows) == 2
    dev = schema.to_device(scene, "cpu")
    ntab = mk.pack_noise_tables(dev, rows)
    jscene = jax_schema.to_device(jax_loader.load_scene(path)[0])
    jntab = np.asarray(jmk.pack_noise_tables(jscene, rows))
    np.testing.assert_array_equal(ntab.numpy(), jntab[:6])

    rs = np.random.RandomState(4)
    p = rs.uniform(-30.0, 30.0, size=(3, 8, 128)).astype(np.float32)
    slot = rs.randint(0, 2, size=(8, 128)).astype(np.int32)
    base = slot * mk.NOISE_TABLE_N
    pt = [torch.from_numpy(a.reshape(-1)) for a in p]
    bt = torch.from_numpy(base.reshape(-1))
    with jax.disable_jit():
        ref_p = np.asarray(jmk._table_perlin(*map(jnp.asarray, p), jnp.asarray(base),
                                             jnp.asarray(jntab)))
        ref_t = np.asarray(jmk._table_turbulence(*map(jnp.asarray, p), jnp.asarray(base),
                                                 jnp.asarray(jntab)))
    ours_p = mk.table_perlin(*pt, bt, ntab).numpy().reshape(8, 128)
    np.testing.assert_array_equal(ours_p, ref_p)
    np.testing.assert_array_equal(mk.table_turbulence(*pt, bt, ntab).numpy().reshape(8, 128),
                                  ref_t)
    tex_rows = torch.tensor(rows)[torch.from_numpy(slot.reshape(-1)).long()]
    xla = textures.perlin_noise(dev.textures.perm, dev.textures.grad, tex_rows,
                                torch.stack(pt, -1))
    np.testing.assert_allclose(xla.numpy().reshape(8, 128), ours_p, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def noise_spheres(tmp_path_factory):
    """The scene, and JAX's XLA-path image of it (24x16, 2 spp, depth 3,
    the kernel's murmur streams; its noise is table Perlin)."""
    path = write_scene(tmp_path_factory.mktemp("noise_spheres"), "noise_spheres")
    jhost, _ = jax_loader.load_scene(path)
    jfeat = dict(jhost.features(), use_megakernel=False, rng_impl="murmur")
    ref = np.asarray(jax_integrator.render_progressive(
        jax_schema.to_device(jhost), jfeat, 24, 16, jnp.int32(0), jnp.int32(2), 0, 3, 1)) / 2
    scene, _ = loader.load_scene(path)
    return scene, ref


@pytest.mark.parametrize("route", ["v4", "wavefront"])
def test_table_noise_image_matches_jax_xla_path(noise_spheres, route):
    """The marble sphere among 70 spheres, 24x16, 2 spp, depth 3, with
    ``noise_impl="table"``: the plain v4 and the plain wavefront against
    JAX's XLA path on the same streams, by PR 2's gate (at most 0.5 % of
    pixels flipped, the others at 60 dB or more, the means within 1e-3),
    and the image differs from hash noise's."""
    scene, ref = noise_spheres
    w, h, spp, depth = 24, 16, 2, 3
    feats = dict(scene.features(), noise_impl="table", mega_wavefront=route == "wavefront")
    assert mk.hier_flags(feats["mega_sizes"])[0]
    dev = schema.to_device(scene, "cpu")
    sorts = wf.SORTS
    ours = integrator.render_progressive(dev, feats, w, h, 0, spp, 0, depth, 1).numpy() / spp
    assert (wf.SORTS > sorts) == (route == "wavefront")
    assert np.isfinite(ours).all()
    assert abs(ours.mean() - ref.mean()) < 1e-3
    flipped = np.abs(ours - ref).max(-1) > 1e-4
    assert flipped.mean() <= 0.005, flipped.sum()
    assert compare.psnr(ours[~flipped], ref[~flipped]) >= 60.0
    hashed = integrator.render_progressive(dev, dict(feats, noise_impl="hash"), w, h, 0, spp,
                                           0, depth, 1).numpy() / spp
    assert np.abs(hashed - ours).max() > 1e-3


def _load(tmp_path, name, **feat):
    scene, _ = loader.load_scene(write_scene(tmp_path, name))
    return schema.to_device(scene, "cpu"), dict(scene.features(), **feat)


def _get(tree, leaf):
    return opt._leaf(leaf)[0](tree)


@pytest.mark.parametrize("leaf,idx", [("spheres.center0", (0, 2)), ("camera.center", (0,)),
                                      ("textures.scale", (0,))],
                         ids=["sphere_z", "cam_center_x", "tex_scale"])
def test_table_noise_ad_matches_fd(tmp_path, leaf, idx):
    """Geometry, camera and noise scale through the table-noise floor of
    the gradient test's noise scene: AD (the replay under autograd, the
    tables held constant) tracks central finite differences of the port's
    forward within the JAX test's band (same sign, ratio in (0.5, 2))."""
    scene, feats = _load(tmp_path, "grad_noise", noise_impl="table")
    base = _get(scene, leaf)

    def f(delta):
        val = base.clone()
        val[idx] += delta
        return torch.mean(grad.render_image(opt._leaf(leaf)[1](scene, val), feats, 0,
                                            **NOISE_KW))

    _, g = grad.value_and_grad_scene(torch.mean, scene, feats, 0, **NOISE_KW)
    got = float(_get(g, leaf)[idx])
    with torch.no_grad():
        want = float((f(5e-3) - f(-5e-3)) / 1e-2)
    assert np.isfinite(got)
    assert abs(want) > 5e-5, want  # the table noise makes the integrand continuous
    assert np.sign(got) == np.sign(want), (got, want)
    assert 0.5 < abs(got / want) < 2.0, (got, want)


@pytest.mark.parametrize("ntab", [False, True], ids=["hash", "table"])
def test_noise_evaluations_counted(tmp_path, ntab):
    """``make_bounce``'s ``stats`` count each live lane's noise evaluation
    by kind (what chip_smoke.py's bound of a table-noise launch counts): the
    feature scene's two noise textures (one marble, one Perlin) are met on
    some of 2,048 random rays, every counted lane shades a noise texture,
    and counting changes no bounce."""
    host, _ = loader.load_scene(write_scene(tmp_path, "feature"))
    feats = host.features()
    dev = schema.to_device(host, "cpu")
    sizes = tuple(feats["mega_sizes"])
    packed = mk.pack_buffer(dev, sizes)
    tab = integrator.noise_tables(dev, dict(feats, noise_impl="table")) if ntab else None
    rs = np.random.RandomState(5)
    n = 2048
    o = torch.from_numpy(rs.uniform(-3, 3, (3, n)).astype(np.float32))
    o[1] = o[1].abs() + 0.2
    d = torch.from_numpy(rs.normal(size=(3, n)).astype(np.float32))
    carry = (torch.zeros(n), torch.ones(n), *o, *d, torch.ones(n), torch.ones(n), torch.ones(n),
             torch.zeros(n), torch.zeros(n), torch.zeros(n))
    key = torch.from_numpy(rs.randint(0, 2**31, n).astype(np.int64))
    kw = dict(max_depth=6, sizes=sizes, has_checker=feats["has_checker"], has_noise=True,
              ntab=tab)
    stats = {}
    out = mk.make_bounce(packed, dev.background, stats=stats, **kw)(key, torch.zeros(n), carry)
    ref = mk.make_bounce(packed, dev.background, **kw)(key, torch.zeros(n), carry)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert stats["noise_marble"] > 0 and stats["noise_perlin"] > 0
    assert stats["noise_marble"] + stats["noise_perlin"] <= stats["bounces"] == n
