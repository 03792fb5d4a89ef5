"""The sphere BVH and its walk against the JAX package: the build (arrays,
depth, SAH cost), the walk (``traverse`` and the sphere walk of
``closest_hit``) against JAX's ``_sphere_best_bvh``, the ``Renderer``'s BVH
route (``--backend bvh``, and ``xla``/``auto`` from 256 active spheres)
against the dense sweep, ``interop`` and the CLI.

JAX's walk is compiled with ``xla_backend_optimization_level`` 0, which
turns off XLA's contraction of multiply-adds into FMAs: the port's walk
rounds every product on its own (as its kernel does, built with
``-fmad=false``), and then the two agree bit for bit. The test holds t to
rtol 1e-6 and the sphere index exactly; the default compile contracts and
differs by up to 5e-4 relative on the radius-1,000 ground sphere, whose
root cancels."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace2_tpu.ops import intersect as jax_intersect
from raytrace2_tpu.scene import bvh as jax_bvh
from raytrace2_tpu.scene import loader as jax_loader
from raytrace2_tpu.scene import schema as jax_schema
from raytrace2_tpu_torch import app, interop
from raytrace2_tpu_torch.ops import bvh_traverse, integrator, intersect
from raytrace2_tpu_torch.render import BVH_MIN_SPHERES, MAX_SMEM_RECORDS, Renderer
from raytrace2_tpu_torch.scene import bvh, loader, schema
from test_torch_scenes import separated_spheres_json, write_scene

NOOPT = {"xla_backend_optimization_level": 0}
_FIELDS = ("aabb_min", "aabb_max", "left", "right", "prim")


def _assert_tree_equal(a, b):
    for f in _FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), f)


@pytest.mark.parametrize("n", [1, 2, 3, 17, 256, 1001])
def test_build_matches_jax(n):
    """Both builders give JAX's arrays exactly, its depth, and its SAH cost
    to 1e-6; boxes on a grid tie on their minimums, which the stable sort
    orders as JAX's does."""
    rs = np.random.RandomState(n)
    c = np.concatenate([rs.uniform(-5, 5, (n - n // 3, 3)),
                        np.floor(rs.uniform(-3, 3, (n // 3, 3)))])
    r = rs.uniform(0.05, 1.0, (n, 1))
    ref = jax_bvh.build(c - r, c + r, use_native=False)
    for use_native in (False, True):
        tree = bvh.build(c - r, c + r, use_native=use_native)
        _assert_tree_equal(tree, ref)
        assert tree.num_nodes == 2 * n - 1
    assert bvh.depth(tree) == jax_bvh.depth(ref)
    assert abs(bvh.sah_cost(tree) - jax_bvh.sah_cost(ref)) <= 1e-6
    with pytest.raises(ValueError, match="zero primitives"):
        bvh.build(np.zeros((0, 3)), np.zeros((0, 3)))


def test_native_builder_missing_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(bvh, "NATIVE_LIB", tmp_path / "libbvh.so")
    monkeypatch.setattr(bvh, "_LIB", None)
    with pytest.raises(RuntimeError, match="not built"):
        bvh.build(np.zeros((2, 3)), np.ones((2, 3)), use_native=True)
    _assert_tree_equal(bvh.build(np.zeros((2, 3)), np.ones((2, 3))),
                       jax_bvh.build(np.zeros((2, 3)), np.ones((2, 3)), use_native=False))


@pytest.mark.parametrize("name", ["grid", "feature", "book1"])
def test_build_sphere_bvh_matches_jax(tmp_path, name):
    """The boxes cover the motion (grid: every third sphere moves) over the
    active prefix."""
    host, _ = loader.load_scene(write_scene(tmp_path, name))
    jhost, _ = jax_loader.load_scene(write_scene(tmp_path, name))
    tree, depth = bvh.build_sphere_bvh(host.spheres)
    ref, ref_depth = jax_bvh.build_sphere_bvh(jhost.spheres)
    _assert_tree_equal(tree, ref)
    assert depth == ref_depth == bvh.depth(tree)
    assert tree.num_nodes == 2 * int(np.asarray(host.spheres.active).sum()) - 1


def _rays(rs, n, lo, hi):
    """Seeded rays with unnormalised directions; every 7th has dx = 0 and
    every 11th dz = 0, and every 13th lies in the plane x = 0, so slabs give
    the NaN of 0 * inf."""
    o = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = (rs.normal(size=(n, 3)) * rs.uniform(0.5, 1.5, (n, 1))).astype(np.float32)
    d[::7, 0] = 0.0
    d[::11, 2] = 0.0
    o[::13, 0] = 0.0
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return o, d, f32(rs.uniform(size=n)), f32(np.full(n, 1e-3)), f32(np.full(n, 3e38))


def _bvh_scenes(tmp_path, name):
    """(JAX device scene with its BVH, the port's CPU scene with the same
    BVH carried across by interop, depth)."""
    jhost, _ = jax_loader.load_scene(write_scene(tmp_path, name))
    tree, depth = jax_bvh.build_sphere_bvh(jhost.spheres)
    jhost = dataclasses.replace(jhost, sphere_bvh=tree)
    return (jax_schema.to_device(jhost), schema.to_device(interop.from_jax_scene(jhost), "cpu"),
            depth)


@pytest.mark.parametrize("name,lo,hi", [("book1", (-8, 0.05, -8), (8, 2.5, 8)),
                                        ("grid", (-12, 0, -12), (12, 4, 12))])
def test_walk_matches_jax(tmp_path, name, lo, hi):
    """2,048 rays through the port's walk and JAX's ``_sphere_best_bvh``:
    the same sphere, t bit for bit (held at rtol 1e-6); with zero
    direction components and rays in slab planes."""
    jscene, scene, depth = _bvh_scenes(tmp_path, name)
    rays = _rays(np.random.RandomState(5), 2048, lo, hi)
    args = [jnp.asarray(x) for x in rays]
    call = jax.jit(lambda *a: jax_intersect._sphere_best_bvh(jscene, *a, depth)).lower(*args)
    jt, jp = (np.asarray(x) for x in call.compile(compiler_options=NOOPT)(*args))
    tables = bvh_traverse.pack(scene.sphere_bvh, scene.spheres)
    stats = {}
    t, p = bvh_traverse.closest_sphere(tables, *(torch.from_numpy(x) for x in rays), depth,
                                       stats=stats)
    t, p = t.numpy(), p.numpy()
    miss = p < 0
    assert 0.2 < miss.mean() < 0.9
    np.testing.assert_array_equal(np.where(miss, 0, p), jp)
    np.testing.assert_array_equal(miss, jt >= 3e38)
    np.testing.assert_allclose(t[~miss], jt[~miss], rtol=1e-6, atol=0)
    assert stats["leaves"] <= stats["nodes"] and stats["steps"] <= stats["nodes"]
    ops, nbytes = bvh_traverse.bound_counts(stats, 2048, scene.sphere_bvh.num_nodes,
                                            scene.spheres.radius.shape[0])
    assert ops == 25 * stats["nodes"] + 35 * stats["leaves"] and nbytes > 2048 * 44


def test_traverse_generic_leaf_and_one_ray(tmp_path):
    """``traverse_one`` against the batch; a ray parallel to a slab outside
    it misses every box, whatever the leaf function."""
    _, scene, depth = _bvh_scenes(tmp_path, "grid")
    tree = scene.sphere_bvh
    o, d, tm, lo, hi = (torch.from_numpy(x) for x in _rays(np.random.RandomState(2), 64,
                                                            (-12, 0, -12), (12, 4, 12)))
    leaf = bvh_traverse.sphere_leaf(bvh_traverse.pack(tree, scene.spheres), o, d, tm)
    t, p = bvh_traverse.traverse(tree, leaf, o, d, lo, hi, depth)
    for i in (0, 7, 13, 40):
        leaf_i = bvh_traverse.sphere_leaf(bvh_traverse.pack(tree, scene.spheres), o[i:i + 1],
                                          d[i:i + 1], tm[i:i + 1])
        ti, pi = bvh_traverse.traverse_one(tree, leaf_i, o[i], d[i], lo[i], hi[i], depth)
        assert (float(ti), int(pi)) == (float(t[i]), int(p[i]))
    far = torch.tensor([[0.0, 50.0, 0.0]])
    flat = torch.tensor([[1.0, 0.0, 0.0]])
    t, p = bvh_traverse.traverse(tree, lambda *a: torch.zeros(1), far, flat,
                                 torch.tensor([1e-3]), torch.tensor([3e38]), depth)
    assert int(p) == -1 and float(t) == float(np.float32(3e38))


@pytest.mark.parametrize("name,lo,hi", [("grid", (-12, 0, -12), (12, 4, 12)),
                                        ("book1", (-8, 0.05, -8), (8, 2.5, 8))])
def test_closest_hit_bvh_matches_jax_and_dense(tmp_path, name, lo, hi):
    """``closest_hit`` with ``use_bvh_spheres`` against JAX's (the BVH for
    spheres, the dense quads; no FMA contraction) and against the port's
    dense sweep: the same hits and materials; t within rtol 1e-6 of JAX's,
    and within 2e-3 of the dense sweep's, whose expanded quadratic (c0·c0 −
    2 o·c0 + o·o − r²) cancels at the scale of book 1's radius-1,000
    ground (1.25e-3 measured; 9e-5 on the grid)."""
    jscene, scene, depth = _bvh_scenes(tmp_path, name)
    feats = dict(scene.features(), use_bvh_spheres=True, bvh_depth=depth)
    rays = _rays(np.random.RandomState(9), 1024, lo, hi)
    o, d, tm, t_min, t_max = (torch.from_numpy(x) for x in rays)
    hit = intersect.closest_hit(scene, o, d, tm, features=feats)
    jfeats = dict(jscene.features(), use_bvh_spheres=True, bvh_depth=depth, has_media=False)
    args = [jnp.asarray(x) for x in rays[:3]]
    call = jax.jit(lambda *a: jax_intersect.closest_hit(jscene, *a, features=jfeats)).lower(*args)
    jhit = call.compile(compiler_options=NOOPT)(*args)
    np.testing.assert_array_equal(hit.valid.numpy(), np.asarray(jhit.valid))
    v = hit.valid.numpy()
    np.testing.assert_allclose(hit.t.numpy()[v], np.asarray(jhit.t)[v], rtol=1e-6)
    np.testing.assert_array_equal(hit.material.numpy(), np.asarray(jhit.material))
    dense = intersect.closest_hit(scene, o, d, tm, features=scene.features())
    np.testing.assert_array_equal(hit.valid.numpy(), dense.valid.numpy())
    np.testing.assert_allclose(hit.t.numpy()[v], dense.t.numpy()[v], rtol=1e-5, atol=2e-3)
    np.testing.assert_array_equal(hit.material.numpy(), dense.material.numpy())
    # use_pallas takes precedence over the BVH.
    both = intersect.closest_hit(scene, o, d, tm, features=dict(
        feats, use_pallas=True, pallas_extents=(scene.spheres.radius.shape[0],
                                                scene.quads.d.shape[0])))
    assert intersect.route_tables(scene, dict(feats, use_pallas=True,
                                              pallas_extents=(1, 1)))[2:] == (1, 1)
    np.testing.assert_array_equal(both.valid.numpy(), v)


def _separated_spheres(tmp_path, n: int) -> str:
    p = tmp_path / f"separated{n}.json"
    p.write_text(json.dumps(separated_spheres_json(n)))
    return str(p)


def test_renderer_bvh_image_matches_dense(tmp_path):
    """``backend="bvh"`` against the dense sweep (``xla`` below 256
    spheres) on separated spheres, 24x18, 2 spp, depth 6: JAX's BVH gate
    (tests/test_bvh.py), rtol 1e-4, atol 1e-5."""
    host, _ = loader.load_scene(_separated_spheres(tmp_path, 64))
    kw = dict(num_samples=2, max_depth=6, device="cpu")
    walk = Renderer(host, 24, 18, backend="bvh", **kw)
    dense = Renderer(host, 24, 18, backend="xla", **kw)
    assert (walk.route, walk.kernel) == ("bvh", "bvh_traverse")
    assert (dense.route, dense.kernel) == ("xla", None)
    assert walk._features["bvh_depth"] == bvh.depth(walk.scene.sphere_bvh)
    assert isinstance(walk.scene.sphere_bvh.left, torch.Tensor)
    img = walk.render()
    assert img.mean() > 0.05
    np.testing.assert_allclose(img, dense.render(), rtol=1e-4, atol=1e-5)
    # The differentiable scan drops the BVH: the dense estimator's image.
    feats = walk._features
    scan = integrator.render_sample(walk.scene, feats, 8, 6, 0, 0, 3, 1, differentiable=True)
    ref = integrator.render_sample(dense.scene, dense._features, 8, 6, 0, 0, 3, 1,
                                   differentiable=True)
    torch.testing.assert_close(scan, ref, rtol=0, atol=0)


def test_automatic_bvh_from_256_spheres(tmp_path):
    """``xla`` walks the BVH from 256 active spheres; ``auto`` does off the
    kernel path (above 4,096 records); the kernel and pallas routes never;
    a scene without spheres never."""
    for n, route in ((BVH_MIN_SPHERES - 1, "xla"), (BVH_MIN_SPHERES, "bvh")):
        host, _ = loader.load_scene(_separated_spheres(tmp_path, n))
        r = Renderer(host, 4, 4, backend="xla", device="cpu")
        assert r.route == route and ("bvh_depth" in r._features) == (route == "bvh")
        assert Renderer(host, 4, 4, device="cpu").route == "kernel"
        assert Renderer(host, 4, 4, backend="pallas", device="cpu").route == "pallas"
    huge, _ = loader.load_scene(_separated_spheres(tmp_path, MAX_SMEM_RECORDS + 1))
    r = Renderer(huge, 4, 4, device="cpu", num_samples=1, max_depth=2)
    assert (r.route, r.kernel) == ("bvh", "bvh_traverse")
    assert np.isfinite(r.render()).all()
    cornell, _ = loader.load_scene(write_scene(tmp_path, "cornell"))
    empty = dataclasses.replace(cornell, spheres=schema.make_spheres(
        np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0), np.zeros(0, np.int32)))
    assert Renderer(empty, 4, 4, backend="bvh", device="cpu").route == "xla"


def test_interop_carries_sphere_bvh(tmp_path):
    jhost, _ = jax_loader.load_scene(write_scene(tmp_path, "book1"))
    tree, _ = jax_bvh.build_sphere_bvh(jhost.spheres)
    host = interop.from_jax_scene(dataclasses.replace(jhost, sphere_bvh=tree))
    assert isinstance(host.sphere_bvh, bvh.BVHArrays)
    _assert_tree_equal(host.sphere_bvh, tree)
    dev = schema.to_device(host, "cpu")
    assert dev.sphere_bvh.prim.dtype == torch.int32
    assert dev.sphere_bvh.aabb_min.dtype == torch.float32
    assert interop.from_jax_scene(jhost).sphere_bvh is None


def test_wrapper_checks_inputs(tmp_path):
    _, scene, depth = _bvh_scenes(tmp_path, "grid")
    tables = bvh_traverse.pack(scene.sphere_bvh, scene.spheres)
    o, d, tm, lo, hi = (torch.from_numpy(x) for x in _rays(np.random.RandomState(1), 8,
                                                            (-1, 0, -1), (1, 1, 1)))
    with pytest.raises(ValueError, match="stack"):
        bvh_traverse.closest_sphere(tables, o, d, tm, lo, hi, bvh_traverse.MAX_STACK)
    with pytest.raises(ValueError, match="t_max"):
        bvh_traverse.closest_sphere(tables, o, d, tm, lo, hi[:4], depth)
    t, p = bvh_traverse.closest_sphere(tables, o.double(), d, tm, lo, hi, depth)
    assert t.dtype == torch.float32 and p.dtype == torch.int32


def test_cli_backend_bvh(tmp_path):
    """``--backend bvh`` renders on the CPU; the done record names the route
    and the kernel, with no launches (the plain walk ran)."""
    out, metrics = tmp_path / "b.png", tmp_path / "m.jsonl"
    assert app.main([write_scene(tmp_path, "book1"), str(out), "--device", "cpu", "--quiet",
                     "--width", "8", "--height", "8", "--samples", "1", "--depth", "3",
                     "--backend", "bvh", "--metrics", str(metrics)]) == 0
    done = json.loads(metrics.read_text().splitlines()[-1])
    assert (done["route"], done["kernel"], done["launches"]) == ("bvh", "bvh_traverse", 0)
    assert out.exists()
