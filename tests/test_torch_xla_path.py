"""The non-kernel path against the JAX package's XLA path: table Perlin
textures and shading; then, within the port, chunking and compaction (bitwise), the ``pallas``
route against the dense one, routing, refusals and the CLI. The dense
closest hit is held against the JAX package in
test_torch_intersect_kernel.py, whole images in test_torch_xla_images.py.

The JAX functions run under ``jax.jit`` as the JAX package runs them. XLA on
the CPU contracts multiply-adds into FMAs and torch does not, so values
agree to a few ulps and a path can flip where it meets a surface at a
near-tie; images are held to the image gate (``_gate``): the mean within
1e-3, at most 0.5 % of pixels differing by more than 1e-4, and at least
60 dB over the others."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace2_tpu.ops import camera as jax_camera
from raytrace2_tpu.ops import intersect as jax_intersect
from raytrace2_tpu.ops import materials as jax_materials
from raytrace2_tpu.ops import rng as jax_rng
from raytrace2_tpu.ops import textures as jax_textures
from raytrace2_tpu.scene import loader as jax_loader
from raytrace2_tpu.scene import schema as jax_schema
from raytrace2_tpu_torch import app, interop
from raytrace2_tpu_torch.io import compare, image
from raytrace2_tpu_torch.ops import camera, integrator, intersect, materials, rng, textures
from raytrace2_tpu_torch.ops.kernels import intersect_kernel as pk
from raytrace2_tpu_torch.render import CHUNK_SIZE_LARGE, Renderer, display_image
from raytrace2_tpu_torch.scene import loader, schema
from test_torch_scenes import write_scene

def _load(tmp_path, name):
    """(JAX device scene, port CPU scene, features) of one test scene."""
    jhost, _ = jax_loader.load_scene(write_scene(tmp_path, name))
    return (jax_schema.to_device(jhost), schema.to_device(interop.from_jax_scene(jhost), "cpu"),
            jhost.features())


def _gate(ours, ref):
    """The image gate: the mean within 1e-3, at most 0.5 % of pixels
    differing by more than 1e-4, at least 60 dB over the others."""
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    assert abs(float(ours.mean()) - float(ref.mean())) < 1e-3, (ours.mean(), ref.mean())
    flipped = np.abs(ours - ref).max(-1) > 1e-4
    assert flipped.mean() <= 0.005, flipped.sum()
    assert compare.psnr(ours[~flipped], ref[~flipped]) >= 60.0


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# textures and shading
# ---------------------------------------------------------------------------


def test_texture_value_matches_jax(tmp_path):
    """Every texture of the feature scene (solid, depth-2 nested checkers,
    Perlin and marble table noise) at seeded points: rtol 1e-5, and the
    checkers, which resolve to solid colours, bit for bit."""
    jscene, scene, feat = _load(tmp_path, "feature")
    rs = np.random.RandomState(1)
    n = 4096
    p = rs.uniform(-5, 5, (n, 3)).astype(np.float32)
    idx = rs.randint(0, int(scene.textures.ttype.shape[0]), n).astype(np.int32)
    want = np.asarray(jax.jit(lambda p, i: jax_textures.texture_value(
        jscene.textures, i, None, p, feat))(jnp.asarray(p), jnp.asarray(idx)))
    got = textures.texture_value(scene.textures, _t(idx), None, _t(p), feat).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    checker = np.isin(idx, [2, 3])  # checkers of solid colours
    assert checker.sum() > n // 8
    np.testing.assert_array_equal(got[checker], want[checker])


def test_shade_matches_jax(tmp_path):
    """shade on seeded hit records over every material of the feature scene
    (textured and plain Lambertian, metal, dielectric, light, isotropic)."""
    jscene, scene, feat = _load(tmp_path, "feature")
    rs = np.random.RandomState(2)
    n = 4096
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    normal = rs.normal(size=(n, 3))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    d_in = rs.normal(size=(n, 3)) * rs.uniform(0.5, 1.5, (n, 1))
    z = 1.0 - 2.0 * rs.uniform(size=n)
    phi = 2.0 * np.pi * rs.uniform(size=n)
    r = np.sqrt(1.0 - z * z)
    arrays = dict(valid=np.ones(n, bool), t=f32(rs.uniform(0.1, 5, n)),
                  point=f32(rs.uniform(-3, 3, (n, 3))), normal=f32(normal),
                  front_face=rs.uniform(size=n) < 0.7, uv=np.zeros((n, 2), np.float32),
                  material=rs.randint(0, int(scene.materials.mtype.shape[0]), n).astype(np.int32))
    u_vec = f32(np.stack([r * np.cos(phi), r * np.sin(phi), z], -1))
    u_frsn = f32(rs.uniform(size=n))
    jhit = jax_intersect.Hit(**{k: jnp.asarray(v) for k, v in arrays.items()})
    want = jax.jit(lambda h, d, u, uf: jax_materials.shade(jscene, feat, h, d, u, uf))(
        jhit, jnp.asarray(f32(d_in)), jnp.asarray(u_vec), jnp.asarray(u_frsn))
    hit = intersect.Hit(**{k: _t(v) for k, v in arrays.items()})
    got = materials.shade(scene, feat, hit, _t(f32(d_in)), _t(u_vec), _t(u_frsn))
    np.testing.assert_array_equal(got.did_scatter.numpy(), np.asarray(want.did_scatter))
    for name in ("emitted", "direction", "attenuation"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rng_impl", [None, "murmur"])
def test_chunks_and_phases_are_bitwise(tmp_path, rng_impl):
    """48² rays of Cornell volume, depth 8: unchunked with 3 compaction
    phases (one compaction happens: 2,304 // 8 ≥ 256), one phase, and chunks
    of 1,000 (the last padded with the first rays again) give the same
    image bit for bit, since every stream is keyed by pixel and bounce."""
    _, scene, feat = _load(tmp_path, "cornell_volume")
    feat = dict(feat, use_megakernel=False)
    if rng_impl:
        feat["rng_impl"] = rng_impl
    base = integrator.render_sample(scene, feat, 48, 48, 1, 0, 8, 2)
    one = integrator.render_sample(scene, dict(feat, compaction_phases=1), 48, 48, 1, 0, 8, 2)
    chunked = integrator.render_sample(scene, feat, 48, 48, 1, 0, 8, 2, chunk_size=1000)
    assert float(base.mean()) > 0.05
    assert torch.equal(base, one)
    assert torch.equal(base, chunked)


def test_pallas_route_matches_xla_route(tmp_path):
    """Renderer(backend="pallas") (B5's plain version on the CPU) against the
    dense route on Cornell, 24², 4 spp, depth 8, with the image gate; the route
    and kernel names."""
    host, _ = loader.load_scene(write_scene(tmp_path, "cornell"))
    pal = Renderer(host, 24, 24, num_samples=4, max_depth=8, backend="pallas", device="cpu")
    dense = Renderer(host, 24, 24, num_samples=4, max_depth=8, backend="xla", device="cpu")
    assert (pal.route, pal.kernel) == ("pallas", "intersect_kernel")
    assert (dense.route, dense.kernel) == ("xla", None)
    launches = pk.LAUNCHES
    _gate(pal.render(batch=4), dense.render(batch=4))
    assert pk.LAUNCHES == launches  # the CPU runs the plain version


def test_renderer_routes_to_non_kernel_path(tmp_path):
    """auto sends an ellipsoid scene and a scene above max_records to the
    non-kernel path (book 2 with its smaller chunk); mega does the same for
    the ellipsoid scene, which only that path renders."""
    ell, _ = loader.load_scene(write_scene(tmp_path, "ellipsoid"))
    for backend in ("auto", "mega"):
        r = Renderer(ell, 8, 6, num_samples=1, max_depth=4, backend=backend, device="cpu")
        assert (r.route, r.kernel) == ("xla", None)
        assert np.isfinite(r.render()).all() and r.render().mean() > 0
    book2, _ = loader.load_scene(write_scene(tmp_path, "book2"))
    r = Renderer(book2, 8, 8, device="cpu", max_records=1000)
    assert r.route == "xla" and r.chunk_size == CHUNK_SIZE_LARGE
    assert Renderer(book2, 8, 8, device="cpu").kernel == "wavefront_step"


def test_bvh_and_differentiable_scan_raise(tmp_path):
    host, _ = loader.load_scene(write_scene(tmp_path, "cornell"))
    with pytest.raises(NotImplementedError, match="queue A item 12, the sphere BVH"):
        Renderer(host, 8, 8, backend="bvh", device="cpu")
    scene = schema.to_device(host, "cpu")
    with pytest.raises(NotImplementedError, match="queue A item 12, the sphere BVH"):
        intersect.closest_hit(scene, torch.zeros(2, 3), torch.ones(2, 3), torch.zeros(2),
                              features={"use_bvh_spheres": True})
    # The differentiable scan, refused until it was ported, runs exactly
    # max_depth steps over every ray: its radiance equals the compacting
    # loop's, and it is differentiable in the scene's leaves.
    o, d, tm = camera.generate_rays(scene.camera, 4, 4, 0, 1,
                                    rng.pixel_sample_key(0, torch.arange(16), 0))
    keys = rng.pixel_sample_key(0, torch.arange(16), 0)
    fast = integrator.trace_rays(scene, host.features(), o, d, tm, keys, 4)
    albedo = scene.materials.albedo.clone().requires_grad_(True)
    moved = dataclasses.replace(scene, materials=dataclasses.replace(scene.materials,
                                                                     albedo=albedo))
    scan = integrator.trace_rays(moved, host.features(), o, d, tm, keys, 4,
                                 differentiable=True)
    torch.testing.assert_close(scan.detach(), fast, rtol=0, atol=0)
    (d_albedo,) = torch.autograd.grad(scan.sum(), albedo)
    assert torch.isfinite(d_albedo).all() and float(d_albedo.abs().max()) > 0.0


def test_cli_pallas_and_chunk_size(tmp_path):
    """The CLI on the non-kernel path: --backend pallas names its route and
    kernel in the done record (0 launches: the CPU runs the plain version),
    and --chunk-size gives the same PNG as one chunk."""
    path = write_scene(tmp_path, "cornell_volume")
    out, metrics = tmp_path / "p.png", tmp_path / "m.jsonl"
    args = [path, "--device", "cpu", "--width", "24", "--height", "16", "--samples", "2",
            "--depth", "4", "--quiet"]
    assert app.main([*args[:1], str(out), *args[1:], "--backend", "pallas",
                     "--metrics", str(metrics)]) == 0
    done = [json.loads(line) for line in metrics.read_text().splitlines()][-1]
    assert (done["route"], done["kernel"], done["launches"]) == ("pallas", "intersect_kernel", 0)
    assert image.decode_png(out.read_bytes()).shape == (16, 24, 3)
    chunked = tmp_path / "c.png"
    assert app.main([*args[:1], str(chunked), *args[1:], "--backend", "xla",
                     "--chunk-size", "100"]) == 0
    host, _ = loader.load_scene(path)
    r = Renderer(host, 24, 16, num_samples=2, max_depth=4, backend="xla", device="cpu",
                 chunk_size=None)
    r.update(2)
    np.testing.assert_array_equal(image.decode_png(chunked.read_bytes()),
                                  display_image(r.state).numpy()[::-1])
