"""The differentiable scan of the non-kernel path (``integrator.trace_rays(...,
differentiable=True)``, the fallback of ``grad.render_image``) against the
JAX package's ``jax.value_and_grad`` of ``grad.render_image``, which takes
its own ``lax.scan`` for the same scenes: ellipsoids, depth above 64, and
more than 4,096 records. Both draw threefry streams, bitwise the same keys.

A path whose discrete events differ between the two (which record wins, at
an ulp) is a detached choice of the estimator, not a fault: such pixels are
found from the forward images, under the scene's background and under a
white one (which shows an escape on a black background), and left out of
the loss on both sides.

Also: AD against central differences of the port's own scan (an ellipsoid's
scale, a quad's corner through ``schema.derive_quad_plane``), finite
cotangents at a tangent ray and under total internal reflection, and
``chunk_size``."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace2_tpu import grad as jax_grad
from raytrace2_tpu.scene import loader as jax_loader
from raytrace2_tpu.scene import schema as jax_schema
from raytrace2_tpu_torch import grad, interop
from raytrace2_tpu_torch.ops import integrator, rng
from raytrace2_tpu_torch.scene import loader, schema
from test_torch_render import _many_spheres
from test_torch_scenes import ellipsoid_scene_json, write_scene

GROUPS = ("spheres", "quads", "boxes", "media", "materials", "textures", "camera",
          "ellipsoids", "background")
# Per leaf group: within this share of the group's largest JAX cotangent.
GRAD_REL = 1e-3
# Forward images (JAX's own test_sharding tolerance).
RTOL, ATOL = 2e-4, 2e-5


def _flipped(a, b):
    return np.any(np.abs(a - b) > ATOL + RTOL * np.abs(b), axis=-1)


def _group(tree, name):
    """The float leaves of one group of a gradient FlatScene (numpy)."""
    node = getattr(tree, name)
    if node is None:
        return []
    if not dataclasses.is_dataclass(node):
        return [np.asarray(node)]
    out = []
    for f in dataclasses.fields(node):
        x = getattr(node, f.name)
        if x is None or not np.issubdtype(np.asarray(x).dtype, np.floating):
            continue
        out.append(np.asarray(x.detach() if torch.is_tensor(x) else x))
    return out


def _assert_grads_close(ours, ref):
    for name in GROUPS:
        a, b = _group(ours, name), _group(ref, name)
        assert len(a) == len(b), name
        if not b:
            continue
        scale = max(float(np.abs(x).max(initial=0.0)) for x in b)
        for x, y in zip(a, b):
            assert np.isfinite(x).all(), name
            err = float(np.abs(x - y).max(initial=0.0))
            assert err <= GRAD_REL * scale + 1e-6, (name, err, scale)


def _compare(path, feats, kw):
    """The scan's forward and gradient against JAX's, with flipped pixels
    out of the loss."""
    jhost, _ = jax_loader.load_scene(path)
    jscene = jax_schema.to_device(jhost)
    jfeats = tuple(sorted(dict(jhost.features(), **feats).items()))
    h, w = kw["height"], kw["width"]
    target = np.random.RandomState(0).uniform(size=(h, w, 3)).astype(np.float32)

    def jloss(scene, weight):
        img = jax_grad.render_image(scene, jfeats, 0, **kw)
        return jnp.sum(weight * (img - target) ** 2), img

    jvg = jax.jit(jax.value_and_grad(jloss, has_aux=True, allow_int=True))
    ones = jnp.ones((h, w, 1), jnp.float32)
    white = dataclasses.replace(jscene, background=jnp.ones(3, jnp.float32))
    (_, jimg), _ = jvg(jscene, ones)
    (_, jimg_w), _ = jvg(white, ones)

    scene = schema.to_device(interop.from_jax_scene(jhost), "cpu")
    tfeats = dict(jfeats)
    with torch.no_grad():
        img = grad.render_image(scene, tfeats, 0, **kw).numpy()
        img_w = grad.render_image(dataclasses.replace(scene, background=torch.ones(3)),
                                  tfeats, 0, **kw).numpy()
    jimg, jimg_w = np.asarray(jimg), np.asarray(jimg_w)
    flipped = _flipped(img, jimg) | _flipped(img_w, jimg_w)
    assert flipped.sum() <= max(1, flipped.size // 100), flipped.sum()
    np.testing.assert_allclose(img[~flipped], jimg[~flipped], rtol=RTOL, atol=ATOL)
    assert np.isfinite(img).all() and img.mean() > 0.0

    weight = (~flipped).astype(np.float32)[..., None]
    (jl, _), jg = jvg(jscene, jnp.asarray(weight))
    tw, tt = torch.from_numpy(weight), torch.from_numpy(target)
    loss, g = grad.value_and_grad_scene(lambda im: torch.sum(tw * (im - tt) ** 2), scene,
                                        tfeats, 0, **kw)
    assert float(loss) == pytest.approx(float(jl), rel=1e-4)
    _assert_grads_close(g, jg)
    return g


def test_scan_gradient_ellipsoid(tmp_path):
    """The ellipsoid scene (no kernel sizes), 16², 2 samples, depth 4."""
    g = _compare(write_scene(tmp_path, "ellipsoid"), {},
                 dict(width=16, height=16, n_samples=2, max_depth=4, sqrt_spp=1))
    # Paths hit the ellipsoid: its material's albedo takes a cotangent (its
    # geometry takes none here, as in JAX: a path of constant lambertian
    # albedos does not vary with where it hits).
    assert float(np.abs(g.materials.albedo.numpy()[0]).max()) > 0.0


def test_scan_gradient_depth65(tmp_path, monkeypatch):
    """Cornell at depth 65, above the gradient kernel's 64: both packages
    take the scan with ``use_megakernel`` set; the replay kernel's wrapper
    is never reached."""
    from raytrace2_tpu_torch.ops.kernels import megakernel_grad as mkg

    def no_kernel(*a, **k):
        raise AssertionError("depth 65 reached the replay kernel")

    monkeypatch.setattr(mkg, "grad_call", no_kernel)
    _compare(write_scene(tmp_path, "cornell"), {"use_megakernel": True},
             dict(width=16, height=16, n_samples=1, max_depth=65, sqrt_spp=1))


def test_scan_gradient_above_4096_records(tmp_path):
    """A row of 4,097 spheres, above the kernel path's 4,096 records."""
    path = _many_spheres(tmp_path, 4097)
    host, _ = loader.load_scene(path)
    assert not grad.takes_kernel(dict(host.features(), use_megakernel=True), 4)
    _compare(path, {"use_megakernel": True},
             dict(width=16, height=16, n_samples=1, max_depth=3, sqrt_spp=1))


# ---------------------------------------------------------------------------
# AD against central differences of the scan (JAX tests/test_grad.py's
# _masked_fd_check: pixels whose second difference shows a discrete flip are
# left out, and AD of the masked mean is held to FD of it)
# ---------------------------------------------------------------------------

FD_KW = dict(width=10, height=10, n_samples=2, max_depth=4, sqrt_spp=1)


def _fd_scene(tmp_path):
    """Hash-free noise on the ground and on an ellipsoid (a sphere under a
    non-uniform scale and a rotation), under a sky: a continuous integrand
    in the geometry."""
    obj = ellipsoid_scene_json()
    obj["textures"] = [{"type": "noise", "albedo": [0.85, 0.8, 0.75], "scale": 0.6,
                        "noise_type": 0}]
    obj["materials"][0] = {"type": "texture", "tex_idx": 0}
    obj["materials"][2] = {"type": "texture", "tex_idx": 0}
    p = tmp_path / "fd.json"
    p.write_text(json.dumps(obj))
    host, _ = loader.load_scene(str(p))
    return schema.to_device(host, "cpu"), host.features()


def _masked_fd(f_img, eps, rel=2e-2, min_keep=0.6):
    with torch.no_grad():
        img_p, img_m, img_0 = f_img(eps), f_img(-eps), f_img(0.0)
    mask = ((img_p + img_m - 2.0 * img_0).abs() < 1e-3).float()
    assert float(mask.mean()) >= min_keep, float(mask.mean())
    denom = float(mask.sum())
    want = float(((img_p - img_m) * mask).sum() / (2 * eps) / denom)
    delta = torch.zeros((), requires_grad=True)
    got = float(torch.autograd.grad((f_img(delta) * mask).sum() / denom, delta)[0])
    assert np.isfinite(got)
    assert abs(want) > 1e-4, want  # the leaf reaches the image
    assert got == pytest.approx(want, rel=rel, abs=5e-5), (got, want)


def test_ad_matches_fd_ellipsoid_scale(tmp_path):
    """The ellipsoid's scale along its first model axis: row 0 of
    ``inv_model`` and column 0 of ``inv_t`` times 1 + delta."""
    scene, feats = _fd_scene(tmp_path)
    ell = scene.ellipsoids

    def f_img(delta):
        k = torch.ones(3) + torch.nn.functional.one_hot(torch.tensor(0), 3) * delta
        moved = dataclasses.replace(ell, inv_model=ell.inv_model * k[None, :, None],
                                    inv_t=ell.inv_t * k[None, None, :])
        return grad.render_image(dataclasses.replace(scene, ellipsoids=moved), feats, 0,
                                 **FD_KW)

    _masked_fd(f_img, 2e-3)


def test_ad_matches_fd_quad_corner(tmp_path):
    """The ground quad's corner height q[1] through ``derive_quad_plane``
    (JAX tests/test_grad.py:316), on the scan: the scene has an ellipsoid."""
    scene, feats = _fd_scene(tmp_path)
    ground = 1  # quads: the light, then the ground

    def f_img(delta):
        q = scene.quads.q + torch.nn.functional.one_hot(
            torch.tensor(ground * 3 + 1), scene.quads.q.numel()).reshape(
            scene.quads.q.shape) * delta
        moved = schema.derive_quad_plane(dataclasses.replace(scene.quads, q=q))
        return grad.render_image(dataclasses.replace(scene, quads=moved), feats, 0, **FD_KW)

    _masked_fd(f_img, 2e-3)


def test_derive_quad_plane_matches_loader_and_jax(tmp_path):
    """``derive_quad_plane`` rebuilds the loader's rows, as JAX's does."""
    path = write_scene(tmp_path, "cornell")
    host, _ = loader.load_scene(path)
    q = schema.to_device(host, "cpu").quads
    ours = schema.derive_quad_plane(dataclasses.replace(q, normal=None, d=None, w=None))
    jq = jax_schema.derive_quad_plane(jax_schema.to_device(jax_loader.load_scene(path)[0]).quads)
    for k in ("normal", "d", "w"):
        torch.testing.assert_close(getattr(ours, k), getattr(q, k), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(getattr(ours, k).numpy(), np.asarray(getattr(jq, k)),
                                   rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# Boundaries of the backward, and chunk_size
# ---------------------------------------------------------------------------

GLASS = {
    "background_color": [0.6, 0.7, 0.9],
    "camera": {"fov": 40, "center": [0, 0, 6], "look_at": [0, 0, 0]},
    "materials": [{"type": "dielectric", "refraction_index": 1.5},
                  {"type": "lambertian", "albedo": [0.6, 0.5, 0.4]}],
    "primitives": [
        {"type": "sphere", "center": [0, 0, 0], "radius": 1.0, "material": 0},
        {"type": "quad", "q": [-10, -1.5, -10], "u": [20, 0, 0], "v": [0, 0, 20],
         "material": 1},
    ],
}


def test_scan_cotangents_finite_tangent_and_tir(tmp_path):
    """A ray tangent to the glass sphere (discriminant exactly 0), rays
    inside it that meet its surface beyond the critical angle (total
    internal reflection), grazing rays and camera rays: every cotangent of
    the scan is finite, and so is the image gradient of the whole scene."""
    p = tmp_path / "glass.json"
    p.write_text(json.dumps(GLASS))
    host, _ = loader.load_scene(str(p))
    feats = host.features()
    params, leaves = grad.scene_params(schema.to_device(host, "cpu"))
    o = torch.tensor([[1.0, 0.0, -5.0], [0.9, 0.0, 0.0], [-0.95, 0.1, 0.0],
                      [0.0, 0.999, -5.0], [0.3, 0.2, 5.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0],
                      [0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    keys = rng.pixel_sample_key(0, torch.arange(5, dtype=torch.int32), 0)
    rad = integrator.trace_rays(params, feats, o, d, torch.zeros(5), keys, 6,
                                differentiable=True)
    grads = torch.autograd.grad(rad.sum(), leaves, allow_unused=True)
    assert all(x is None or torch.isfinite(x).all() for x in grads)
    assert any(x is not None and float(x.abs().max()) > 0.0 for x in grads)
    _, g = grad.value_and_grad_scene(torch.mean, schema.to_device(host, "cpu"),
                                     dict(feats, use_megakernel=False), 0,
                                     width=12, height=12, n_samples=2, max_depth=8, sqrt_spp=1)
    floats = []
    schema.map_leaves(g, lambda x: floats.append(x))
    assert all(torch.isfinite(x).all() for x in floats)
    assert float(g.materials.albedo[1].abs().max()) > 0.0  # the floor, through the glass
    assert float(g.background.abs().max()) > 0.0


def test_chunk_size_keeps_the_gradient(tmp_path):
    """``render_image(chunk_size=...)`` on the scan: chunks of 48 rays (the
    last one padded) give the one-chunk gradient."""
    scene, feats = _fd_scene(tmp_path)
    kw = dict(width=12, height=10, n_samples=1, max_depth=3, sqrt_spp=1)
    l1, g1 = grad.value_and_grad_scene(torch.mean, scene, feats, 0, **kw)
    l2, g2 = grad.value_and_grad_scene(torch.mean, scene, feats, 0, chunk_size=48, **kw)
    assert float(l1) == pytest.approx(float(l2), rel=1e-6)
    for name in GROUPS:
        for a, b in zip(_group(g1, name), _group(g2, name)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
