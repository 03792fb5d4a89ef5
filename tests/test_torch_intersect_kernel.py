"""Intersection on the non-kernel path against the JAX package: each
family's dense per-(ray, record) ts and the closest hit (``ops/intersect.py``
against ``raytrace2_tpu/ops/intersect.py`` under ``jax.jit``), and the fused
sphere + quad closest hit B5: the packed record rows bitwise, and the plain
PyTorch version against the Pallas kernel ``closest_hit_pallas`` run in
interpret mode, as tests/test_pallas_kernel.py runs it on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace2_tpu.ops import camera as jax_camera
from raytrace2_tpu.ops import intersect as jax_intersect
from raytrace2_tpu.ops import rng as jax_rng
from raytrace2_tpu.ops.pallas import intersect_kernel as jpk
from raytrace2_tpu.scene import loader as jax_loader
from raytrace2_tpu.scene import schema as jax_schema
from raytrace2_tpu_torch import interop
from raytrace2_tpu_torch.ops import intersect
from raytrace2_tpu_torch.ops.kernels import intersect_kernel as pk
from raytrace2_tpu_torch.scene import schema
from test_torch_scenes import write_scene


# Ray origins for the intersection tests are drawn inside each scene.
BOUNDS = {"cornell": ([10, 10, -100], [545, 545, 545]),
          "cornell_volume": ([10, 10, -100], [545, 545, 545]),
          "feature": ([-4, 0.1, -4], [4, 4, 4]),
          "ellipsoid": ([-3, -0.4, -3], [3, 3, 3])}


def _scenes(tmp_path, name):
    jhost, _ = jax_loader.load_scene(write_scene(tmp_path, name))
    return jax_schema.to_device(jhost), schema.to_device(interop.from_jax_scene(jhost), "cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("name", ["cornell", "book2", "feature"])
def test_pack_scene_bitwise(tmp_path, name):
    """Every row of pack_scene equals the JAX package's, bit for bit, as its
    ``pallas`` route computes them inside the jitted render: XLA contracts
    the cross products and q·(v×w) into FMAs (called op by op, the dot is
    not contracted and Cornell's rows differ in the last bit)."""
    jscene, scene = _scenes(tmp_path, name)
    jsph, jqd = jax.jit(jpk.pack_scene)(jscene.spheres, jscene.quads)
    sph, qd = pk.pack_scene(scene.spheres, scene.quads)
    for rows, jrows, keys in ((sph, jsph, pk.SPH_KEYS), (qd, jqd, pk.QUAD_KEYS)):
        assert rows.dtype == torch.float32 and rows.shape[1] % pk.TILE_P == 0
        for k, row in zip(keys, rows.numpy()):
            np.testing.assert_array_equal(row.view(np.int32),
                                          np.asarray(jrows[k][0]).view(np.int32), err_msg=k)


def _camera_rays(jscene, size):
    """Camera rays of a size² image at sample 0 (threefry keys of seed 0)."""
    pix = jnp.arange(size * size, dtype=jnp.int32)
    keys = jax.vmap(lambda p: jax_rng.pixel_sample_key(0, p, 0))(pix)
    o, d, tm = jax_camera.generate_rays(jscene.camera, size, size, 0, 1, keys)
    return np.asarray(o), np.asarray(d), np.asarray(tm)


@pytest.mark.parametrize("name", ["cornell", "feature"])
def test_plain_matches_pallas_interpret(tmp_path, name):
    """1,024 camera rays (the first bounce's launch) through the plain
    version and the Pallas kernel in interpret mode. As XLA compiles it by
    default, it contracts multiply-adds: codes equal except at near-ties (at
    most 0.5 %), t within rtol 1e-5 and a few ulps of the scene's scale.
    Compiled without optimisation (no contraction), the kernel's arithmetic
    is the plain version's: codes equal and t bit for bit."""
    jscene, scene = _scenes(tmp_path, name)
    o, d, tm = _camera_rays(jscene, 32)
    n = o.shape[0]
    t_min = np.full(n, 1e-3, np.float32)
    t_max = np.full(n, 3e38, np.float32)
    t, code = pk.closest_hit(*(_t(x) for x in (o, d, tm, t_min, t_max)),
                             *pk.pack_scene(scene.spheres, scene.quads))
    t, code = t.numpy(), code.numpy()
    args = (*(jnp.asarray(x) for x in (o, d, tm, t_min, t_max)),
            *jax.jit(jpk.pack_scene)(jscene.spheres, jscene.quads))
    call = jax.jit(lambda *a: jpk.closest_hit_pallas(*a, interpret=True)).lower(*args)

    jt, jc = (np.asarray(x) for x in call.compile()(*args))
    assert (jc >= 0).sum() > n // 2
    same = code == jc
    assert same.mean() >= 0.995, (~same).sum()
    atol = 8 * float(np.spacing(np.abs(o).max()))
    np.testing.assert_allclose(t[same], jt[same], rtol=1e-5, atol=atol)

    jt, jc = (np.asarray(x) for x in call.compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args))
    np.testing.assert_array_equal(code, jc)
    np.testing.assert_array_equal(t.view(np.int32), jt.view(np.int32))


def test_wrapper_checks_inputs(tmp_path):
    """Shapes and dtypes are checked; the tail needs no padding."""
    _, scene = _scenes(tmp_path, "cornell")
    sph, qd = pk.pack_scene(scene.spheres, scene.quads)
    o = torch.zeros(5, 3)
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(5, 3).contiguous()
    t = torch.zeros(5)
    with pytest.raises(ValueError, match="t_max"):
        pk.closest_hit(o, d, t, t, t[:4], sph, qd)
    with pytest.raises(ValueError, match="float32"):
        pk.closest_hit(o.double(), d, t, t, t, sph, qd)
    best, code = pk.closest_hit(o + 278.0, d, t, t + 1e-3, t + 3e38, sph, qd)
    assert best.shape == (5,) and code.dtype == torch.int32
    assert bool((code >> pk.FAM_SHIFT == 1).all())  # inside the box: a wall


# ---------------------------------------------------------------------------
# intersection
# ---------------------------------------------------------------------------


def _rays(jscene, name, n=1024):
    """n camera rays (threefry keys, sample 0) and n seeded rays from inside
    the scene with unnormalised directions, as later bounces make them."""
    side = int(np.sqrt(n))
    keys = jax.vmap(lambda p: jax_rng.pixel_sample_key(0, p, 0))(
        jnp.arange(side * side, dtype=jnp.int32))
    o, d, tm = (np.asarray(x) for x in jax_camera.generate_rays(
        jscene.camera, side, side, 0, 1, keys))
    rs = np.random.RandomState(3)
    lo, hi = BOUNDS[name]
    o2 = rs.uniform(lo, hi, (n, 3))
    d2 = rs.normal(size=(n, 3)) * rs.uniform(0.5, 1.5, (n, 1))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (f32(np.concatenate([o, o2])), f32(np.concatenate([d, d2])),
            f32(np.concatenate([tm, rs.uniform(size=n)])))


def _assert_ts_agree(got, want, atol):
    """[N, P] accepted ts: the hit set and each ray's argmin agree on at
    least 99.5 % of rays, t within rtol 1e-5 (and ``atol``) where both hit."""
    big = float(intersect.BIG)
    hit_g, hit_w = got < big, want < big
    assert (hit_g == hit_w).all(-1).mean() >= 0.995
    both = hit_g & hit_w
    np.testing.assert_allclose(got[both], want[both], rtol=1e-5, atol=atol)
    if got.shape[1]:
        assert (got.argmin(-1) == want.argmin(-1)).mean() >= 0.995


@pytest.mark.parametrize("name", ["cornell", "cornell_volume", "feature", "ellipsoid"])
def test_closest_hit_matches_jax(tmp_path, name):
    """Each family's dense per-(ray, record) ts, then the closest hit with
    its media free paths: winners (validity and material) equal on at least
    99.5 % of rays, t within rtol 1e-5 (and a few ulps of the scene's
    scale) and hit points close on the rest."""
    jscene, scene = _scenes(tmp_path, name)
    feat = scene.features()
    o, d, tm = _rays(jscene, name)
    n = o.shape[0]
    u = np.random.RandomState(4).uniform(size=(n, int(scene.media.btype.shape[0])))
    u = u.astype(np.float32)
    t_min = np.full(n, 1e-3, np.float32)
    t_max = np.full(n, float(intersect.BIG), np.float32)
    # A plane t near its surface is a difference of two dot products at the
    # scene's scale: contraction moves it by a few ulps of that scale.
    atol = 8 * float(np.spacing(np.abs(o).max()))
    jargs = tuple(jnp.asarray(x) for x in (o, d, tm, t_min, t_max))
    args = tuple(_t(x) for x in (o, d, tm, t_min, t_max))

    fams = [("spheres", intersect._sphere_ts, jax_intersect._sphere_ts, True),
            ("quads", intersect._quad_ts, jax_intersect._quad_ts, False)]
    if feat["has_ellipsoids"]:
        fams.append(("ellipsoids", intersect._ellipsoid_ts, jax_intersect._ellipsoid_ts, True))
    for fam, ours, theirs, timed in fams:
        sel = (lambda a: a) if timed else (lambda a: (a[0], a[1], a[3], a[4]))
        want = np.asarray(jax.jit(lambda *a, f=fam: theirs(getattr(jscene, f), *a))(*sel(jargs)))
        _assert_ts_agree(ours(getattr(scene, fam), *sel(args)).numpy(), want, atol)
    if feat["has_media"]:
        want = np.asarray(jax.jit(lambda *a: jax_intersect._media_ts(jscene.media, *a))(
            *jargs, jnp.asarray(u)))
        _assert_ts_agree(intersect._media_ts(scene.media, *args, _t(u)).numpy(), want, atol)

    jh = jax.jit(lambda o, d, tm, u: jax_intersect.closest_hit(jscene, o, d, tm, u, features=feat))(
        *jargs[:3], jnp.asarray(u))
    h = intersect.closest_hit(scene, *args[:3], _t(u), features=feat)
    valid, mat = np.asarray(jh.valid), np.asarray(jh.material)
    same = (h.valid.numpy() == valid) & (h.material.numpy() == mat)
    assert same.mean() >= 0.995, (~same).sum()
    assert valid.mean() > 0.3
    both = same & valid
    np.testing.assert_allclose(h.t.numpy()[both], np.asarray(jh.t)[both], rtol=1e-5, atol=atol)
    scale = float(np.abs(np.asarray(jh.point)[both]).max())
    np.testing.assert_allclose(h.point.numpy()[both], np.asarray(jh.point)[both],
                               rtol=0, atol=1e-5 * scale)
