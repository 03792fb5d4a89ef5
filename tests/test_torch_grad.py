"""The gradient path of the port (``grad.py``, ``ops/kernels/megakernel_grad.py``)
against the JAX package, on the CPU, where the backward runs its plain
PyTorch version (the replay under ``torch.autograd``):

* one replayed bounce's vector-Jacobian product against JAX's
  ``_make_winner_search`` + ``_make_resolve_shade`` under ``jax.vjp``;
* the noise factor's gradient against ``jax.vjp`` of ``_noise_factor_impl``;
* the whole path against JAX's ``value_and_grad_scene`` on its XLA path with
  the kernel's RNG streams (``rng_impl="murmur"``);
* AD against central finite differences of the port's own forward;
* the differentiable forward bitwise equal to the render, finite gradients,
  a book-scale scene through the wavefront, the refusals, and the
  inverse-rendering tool.

JAX runs eagerly here (``jax.disable_jit``): one evaluation of the noise
scenes' replay is seconds op by op, where compiling it takes most of a
minute."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace2_tpu import grad as jax_grad
from raytrace2_tpu.ops.pallas import megakernel as jmk
from raytrace2_tpu.ops.pallas import megakernel_grad as jmkg
from raytrace2_tpu.scene import loader as jax_loader
from raytrace2_tpu.scene import schema as jax_schema
from raytrace2_tpu_torch import grad
from raytrace2_tpu_torch.ops import camera, integrator
from raytrace2_tpu_torch.ops.kernels import megakernel as mk
from raytrace2_tpu_torch.ops.kernels import megakernel_grad as mkg
from raytrace2_tpu_torch.ops.kernels import wavefront as wf
from raytrace2_tpu_torch.scene import loader, schema
from raytrace2_tpu_torch.tools import optimize_scene as opt
from test_torch_scenes import write_scene

# The JAX gradient tests' settings (tests/test_megakernel_grad.py).
KW = dict(width=8, height=6, n_samples=2, max_depth=3, sqrt_spp=1)
NOISE_KW = dict(width=6, height=4, n_samples=1, max_depth=3, sqrt_spp=1)


def _load(tmp_path, name, **feat):
    scene, _ = loader.load_scene(write_scene(tmp_path, name))
    return schema.to_device(scene, "cpu"), dict(scene.features(), **feat)


def _get(tree, leaf):
    return opt._leaf(leaf)[0](tree)


# ---------------------------------------------------------------------------
# (a) one replayed bounce vs JAX
# ---------------------------------------------------------------------------

N_LANES = 128
BOUNCE_DEPTH = 6
# Ray origins inside each scene's extent.
BOUNDS = {"grad_solid": ([-2, 0.1, -2], [2, 3, 2]), "grad_noise": ([-2, 0.1, -2], [2, 3, 3]),
          "grad_media": ([-3, 0.1, -2], [3, 2.5, 2]), "feature": ([-4, 0.1, -4], [4, 4, 4])}


def _bounce_inputs(name):
    rs = np.random.RandomState(3)
    lo, hi = BOUNDS[name]
    o = rs.uniform(lo, hi, size=(N_LANES, 3))
    d = rs.normal(size=(N_LANES, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d *= rs.uniform(0.5, 1.5, size=(N_LANES, 1))  # scatter directions are not unit
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    carry = [f32(rs.randint(0, BOUNCE_DEPTH - 1, N_LANES)), f32(rs.uniform(size=N_LANES) < 0.9),
             *f32(o.T), *f32(d.T), *f32(rs.uniform(0.1, 1.0, (3, N_LANES))),
             *f32(rs.uniform(0.0, 2.0, (3, N_LANES)))]
    key = rs.randint(0, 2**32, size=N_LANES, dtype=np.uint64).astype(np.uint32)
    tm = f32(rs.uniform(size=N_LANES))
    # bn and alive are discrete: no cotangent.
    cot = [np.zeros(N_LANES, np.float32)] * 2 + [f32(rs.normal(size=N_LANES))
                                                  for _ in range(12)]
    return carry, key, tm, cot


@pytest.mark.parametrize("name", ["grad_solid", "grad_noise", "grad_media", "feature"])
def test_one_bounce_vjp_matches_jax(tmp_path, name):
    """Winners exactly equal; the replayed bounce's primal and its cotangents
    of the tables (GRAD keys), the background and the carry within rtol
    1e-4, atol 1e-5 of the family's (or the carry column's) largest
    cotangent, on lanes whose primal agrees (no discrete flip)."""
    path = write_scene(tmp_path, name)
    host, _ = loader.load_scene(path)
    feats = host.features()
    sizes = tuple(feats["mega_sizes"])
    n_sph, n_quad, n_mat, n_tex, n_med, n_box = sizes
    carry, key, tm, cot = _bounce_inputs(name)
    shade_kw = dict(has_checker=feats["has_checker"], has_noise=feats["has_noise"],
                    max_depth=BOUNCE_DEPTH)

    # JAX: the winner search and the resolve-and-shade, outside any kernel.
    jscene = jax_schema.to_device(jax_loader.load_scene(path)[0])
    tables = jmk.pack_tables(jscene, sizes)
    shape = (1, N_LANES)
    kw = dict(n_sph=n_sph, n_quad=n_quad, n_med=n_med, n_box=n_box, shape=shape)
    lanes = lambda a: jnp.asarray(a).reshape(shape)  # noqa: E731
    jkey, jtm, jcarry = lanes(key), lanes(tm), tuple(lanes(c) for c in carry)
    with jax.disable_jit():
        jw = jmkg._make_winner_search(*tables[:4], **kw)(jkey, jtm, jcarry)
        jbounce = jmkg._make_resolve_shade(n_mat=n_mat, n_tex=n_tex, **shade_kw, **kw)
        jout, jvjp = jax.vjp(lambda dv, bg, c: jbounce(jkey, jtm, c, jw, dv, bg),
                             jmkg.pack_diff_tables(tables),
                             [jscene.background[i] for i in range(3)], jcarry)
    jout = [np.asarray(x).reshape(-1) for x in jout]

    # The port: the forward's tracked sweep, then the replay under autograd.
    dev = schema.to_device(host, "cpu")
    packed = mk.pack_buffer(dev, sizes)
    tkey, ttm = torch.from_numpy(key.astype(np.int64)), torch.from_numpy(tm)
    bounce = mk.make_bounce(packed, dev.background, sizes=sizes, **shade_kw)
    _, w = bounce(tkey, ttm, tuple(torch.from_numpy(c) for c in carry), track=True)
    for ours, ref in zip(w, jw):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref).reshape(-1))
    packed_l = packed.clone().requires_grad_(True)
    bg_l = dev.background.clone().requires_grad_(True)
    carry_l = [torch.from_numpy(c).requires_grad_(True) for c in carry]
    out = mkg.resolve_shade(tkey, ttm, tuple(carry_l), w, mk.unpack_buffer(packed_l, sizes),
                            bg_l, sizes=sizes, **shade_kw)
    same = np.ones(N_LANES, bool)
    for ours, ref in zip(out, jout):
        same &= np.isclose(ours.detach().numpy(), ref, rtol=1e-5, atol=1e-5)
    flips = np.nonzero(~same)[0]
    if name == "grad_media":
        # Its ground lies on the checker's boundary plane y = 0: XLA fuses
        # o + t·d into one FMA and torch does not, so the hit point's y
        # rounds to either side and picks the other square's albedo.
        assert (w[2].numpy()[flips] == mk.FAMID["quad"]).all() and (w[1].numpy()[flips] == 0).all()
        assert len(flips) < N_LANES // 4
    else:
        assert len(flips) == 0, flips
    cot = [c * same for c in cot]
    jd_dv, jd_bg, jd_carry = jvjp(tuple(lanes(c) for c in cot))
    total = sum((o_ * torch.from_numpy(c)).sum() for o_, c in zip(out, cot))
    d_packed, d_bg, *d_carry = torch.autograd.grad(total, [packed_l, bg_l, *carry_l],
                                                   allow_unused=True)

    def close(ours, ref, scale, what):
        ours = np.zeros_like(ref) if ours is None else ours
        np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5 * scale, err_msg=what)

    ref_bg = np.asarray(jd_bg, np.float32)
    close(d_bg.numpy(), ref_bg, np.abs(ref_bg).max(), "background")
    for i in range(2, 14):
        ref = np.asarray(jd_carry[i]).reshape(-1)
        close(None if d_carry[i] is None else d_carry[i].numpy(), ref, np.abs(ref).max(),
              f"carry {i}")
    ours_cols = mk.unpack_buffer(d_packed, sizes)
    layout = mk.table_layout(sizes)
    for (fam, _), ref_fam in zip(mk.FAMILIES, jmkg._unpack_diff_cotangent(jd_dv, tables)):
        rows = layout[fam][1]
        refs = {k: np.asarray(ref_fam[k])[:rows] for k in mkg.GRAD_KEYS[fam]}
        scale = max(float(np.abs(r).max()) for r in refs.values())
        for k, ref in refs.items():
            close(ours_cols[fam][k].numpy(), ref, scale, f"{fam}.{k}")


# ---------------------------------------------------------------------------
# (b) the noise factor's gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ntype", [0, 1], ids=["perlin", "marble"])
def test_noise_factor_grad_matches_jax(ntype):
    rs = np.random.RandomState(11)
    n = 4096
    p = rs.uniform(-20.0, 20.0, size=(3, n)).astype(np.float32)
    scale = rs.uniform(0.3, 4.0, size=n).astype(np.float32)
    seed = rs.randint(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    cot = rs.normal(size=n).astype(np.float32)
    kind = np.full(n, ntype, np.float32)
    with jax.disable_jit():
        _, vjp = jax.vjp(lambda x, y, z, s: jmk._noise_factor_impl(
            x, y, z, s, jnp.asarray(kind), jnp.asarray(seed)), *map(jnp.asarray, p),
            jnp.asarray(scale))
        refs = [np.asarray(r) for r in vjp(jnp.asarray(cot))]
    xs = [torch.from_numpy(a).requires_grad_(True) for a in (*p, scale)]
    val = mk.noise_factor(*xs, torch.from_numpy(kind), torch.from_numpy(seed.astype(np.int64)))
    ours = torch.autograd.grad((val * torch.from_numpy(cot)).sum(), xs)
    for what, a, b in zip(("px", "py", "pz", "scale"), ours, refs):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4 * np.abs(b).max(),
                                   err_msg=what)


# ---------------------------------------------------------------------------
# (c) the whole path vs JAX's XLA path on the kernel's RNG streams
# ---------------------------------------------------------------------------


def test_value_and_grad_matches_jax_murmur_path(tmp_path):
    """SOLID at 8×6, 2 spp, depth 3: the loss and the gradients of the albedo,
    material parameter, texture and background leaves agree with the JAX
    package's XLA path (rng_impl="murmur", the same draws) to rtol 1e-4
    (measured: 3e-8 absolute, on values around 0.2)."""
    path = write_scene(tmp_path, "grad_solid")
    jhost, _ = jax_loader.load_scene(path)
    jfeat = dict(jhost.features(), use_megakernel=False, rng_impl="murmur")
    jloss, jg = jax_grad.value_and_grad_scene(
        jnp.mean, jax_schema.to_device(jhost), tuple(sorted(jfeat.items())), 0, **KW)
    scene, feats = _load(tmp_path, "grad_solid")
    loss, g = grad.value_and_grad_scene(torch.mean, scene, feats, 0, **KW)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    for leaf in ("materials.albedo", "materials.param", "textures.albedo", "background"):
        np.testing.assert_allclose(_get(g, leaf).numpy(), np.asarray(_get(jg, leaf)),
                                   rtol=1e-4, atol=1e-7, err_msg=leaf)
    assert float(torch.abs(g.materials.albedo).max()) > 0.0
    # Geometry and camera gradients vanish on an all-solid scene (detached
    # estimator), on both sides.
    for leaf in ("spheres.center0", "camera.vfov"):
        assert not _get(g, leaf).any() and not np.asarray(_get(jg, leaf)).any()


# ---------------------------------------------------------------------------
# (d) AD vs finite differences of the port's own forward
# ---------------------------------------------------------------------------


def _ad_and_fd(scene, feats, leaf, idx, eps, kw):
    base = _get(scene, leaf)

    def f(delta):
        val = base.clone()
        val[idx] += delta
        return torch.mean(grad.render_image(opt._leaf(leaf)[1](scene, val), feats, 0, **kw))

    _, g = grad.value_and_grad_scene(torch.mean, scene, feats, 0, **kw)
    got = float(_get(g, leaf)[idx])
    with torch.no_grad():
        want = float((f(eps) - f(-eps)) / (2 * eps))
    return got, want


@pytest.mark.parametrize("leaf,idx,eps,tol", [
    ("materials.albedo", (0, 0), 1e-3, 1e-2),
    ("materials.param", (1,), 1e-3, 5e-2),
    ("background", (1,), 1e-3, 1e-2),
    # The light's emission: texture row 0, the scene's only texture (the JAX
    # test's index (2, 0) falls outside that [1, 3] table, where JAX drops
    # the update and compares two zeros).
    ("textures.albedo", (0, 0), 1e-3, 1e-2),
])
def test_ad_matches_fd_continuous(tmp_path, leaf, idx, eps, tol):
    scene, feats = _load(tmp_path, "grad_solid")
    got, want = _ad_and_fd(scene, feats, leaf, idx, eps, KW)
    assert np.isfinite(got)
    if abs(want) < 1e-5 and abs(got) < 1e-5:
        return
    assert got == pytest.approx(want, rel=tol, abs=1e-5), (leaf, got, want)


@pytest.mark.parametrize("leaf,idx", [("spheres.center0", (0, 2)), ("camera.center", (0,)),
                                      ("textures.scale", (0,))],
                         ids=["sphere_z", "cam_center_x", "tex_scale"])
def test_ad_matches_fd_geometry_noise(tmp_path, leaf, idx):
    """Geometry, camera and noise scale through the hash-noise floor: a
    continuous integrand, so AD tracks FD within the JAX test's band (same
    sign, ratio in (0.5, 2)), tolerant of a discrete flip inside ±eps."""
    scene, feats = _load(tmp_path, "grad_noise")
    got, want = _ad_and_fd(scene, feats, leaf, idx, 5e-3, NOISE_KW)
    assert np.isfinite(got)
    if abs(want) < 5e-5 and abs(got) < 5e-5:
        return
    assert np.sign(got) == np.sign(want), (got, want)
    assert 0.5 < abs(got / want) < 2.0, (got, want)


# ---------------------------------------------------------------------------
# (e)-(h) forward, finiteness, book scale, refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wavefront", [False, True], ids=["v4", "wavefront"])
def test_diff_forward_equals_render(tmp_path, wavefront):
    """DiffRender's forward is the render's own route, bit for bit."""
    scene, feats = _load(tmp_path, "grad_solid", mega_wavefront=wavefront)
    assert integrator.mega_schedule(feats)[3] == wavefront
    before = wf.SORTS
    params = schema.map_leaves(scene, lambda x: x.detach().requires_grad_(True)
                               if x.is_floating_point() else x)
    diff = grad.render_image(params, feats, 0, **KW)
    assert diff.requires_grad
    plain = integrator.render_progressive(scene, feats, KW["width"], KW["height"], 0,
                                          KW["n_samples"], 0, KW["max_depth"],
                                          KW["sqrt_spp"]) / KW["n_samples"]
    np.testing.assert_array_equal(diff.detach().numpy(), plain.numpy())
    assert (wf.SORTS > before) == wavefront


def test_differentiable_packing_keeps_values(tmp_path, monkeypatch):
    """camv and the packed tables built from grad-carrying leaves hold the
    same bits as the forward's; the packed cotangent is zero outside the
    GRAD keys."""
    scene, feats = _load(tmp_path, "feature")
    sizes = tuple(feats["mega_sizes"])
    params = schema.map_leaves(scene, lambda x: x.detach().requires_grad_(True)
                               if x.is_floating_point() else x)
    packed = mk.pack_buffer(params, sizes)
    camv = camera.make_camv(params.camera, 40, 24, 0, 2, 1, 0)
    assert packed.requires_grad and camv.requires_grad
    np.testing.assert_array_equal(packed.detach().numpy(), mk.pack_buffer(scene, sizes).numpy())
    np.testing.assert_array_equal(camv.detach().numpy(),
                                  camera.make_camv(scene.camera, 40, 24, 0, 2, 1, 0).numpy())
    g = torch.ones(40 * 24, 3)
    kw = dict(n_pix=40 * 24, max_depth=4, sizes=sizes, has_checker=feats["has_checker"],
              has_noise=feats["has_noise"])
    d_camv, _, d_packed = mkg.grad_call(camera.make_camv(scene.camera, 40, 24, 0, 2, 1, 0), 0,
                                        mk.pack_buffer(scene, sizes), scene.background, g, **kw)
    mask = mkg.grad_mask(sizes)
    assert not d_packed[~mask].any() and d_packed[mask].any()
    assert not d_camv[mkg.N_CAMV_DIFF:].any() and d_camv[:18].any()
    # Lane chunks only bound memory: the same cotangents, up to summation order.
    monkeypatch.setattr(mkg, "LANE_CHUNK", 256)
    chunked = mkg.grad_plain(camera.make_camv(scene.camera, 40, 24, 0, 2, 1, 0), 0,
                             mk.pack_buffer(scene, sizes), scene.background, g, **kw)
    np.testing.assert_allclose(chunked[2].numpy(), d_packed.numpy(), rtol=1e-4,
                               atol=1e-5 * float(d_packed.abs().max()))


def test_grads_finite_media_scene(tmp_path):
    scene, feats = _load(tmp_path, "grad_media")
    _, g = grad.value_and_grad_scene(torch.mean, scene, feats, 0, width=8, height=6,
                                     n_samples=1, max_depth=4, sqrt_spp=1)
    floats = []
    schema.map_leaves(g, lambda x: floats.append(x) if x is not None else None)
    assert floats and all(torch.isfinite(x).all() for x in floats)
    assert float(torch.abs(g.materials.albedo).max()) > 0.0
    assert g.materials.mtype is None


def test_book1_gradient_through_wavefront(tmp_path):
    """Book 1 (≈485 records) at 8×8, 1 spp, depth 4: its forward takes the
    sorted wavefront; every gradient leaf is finite and AD tracks FD on the
    ground's albedo (rel 2e-2, as the JAX test of a swept scene)."""
    scene, feats = _load(tmp_path, "book1")
    assert integrator.mega_schedule(feats)[3]
    kw = dict(width=8, height=8, n_samples=1, max_depth=4, sqrt_spp=1)
    before = wf.SORTS
    got, want = _ad_and_fd(scene, feats, "materials.albedo", (0, 1), 1e-3, kw)
    assert wf.SORTS > before
    _, g = grad.value_and_grad_scene(torch.mean, scene, feats, 0, **kw)
    floats = []
    schema.map_leaves(g, lambda x: floats.append(x) if x is not None else None)
    assert all(torch.isfinite(x).all() for x in floats)
    assert got == pytest.approx(want, rel=2e-2, abs=1e-5), (got, want)


@pytest.mark.parametrize("case", ["ellipsoid", "depth65", "table_noise"])
def test_unsupported_gradients_raise(tmp_path, case):
    """The JAX package falls back to its XLA scan here; the port refuses,
    naming the ROADMAP item that brings each."""
    if case == "ellipsoid":
        p = tmp_path / "ell.json"
        p.write_text(json.dumps({
            "materials": [{"type": "lambertian", "albedo": [0.5, 0.5, 0.5]}],
            "primitives": [{"type": "sphere", "radius": 1, "material": 0}],
            "scene": [{"transform": {"scale": [1, 2, 1]}, "primitive": 0}]}))
        host, _ = loader.load_scene(str(p))
        scene, feats, kw, item = schema.to_device(host, "cpu"), host.features(), KW, "A item 12"
    elif case == "depth65":
        scene, feats = _load(tmp_path, "grad_solid")
        kw, item = dict(KW, max_depth=65), "A item 12"
    else:
        scene, feats = _load(tmp_path, "grad_noise", noise_impl="table")
        kw, item = KW, "B item 5"
    with pytest.raises(NotImplementedError, match=item):
        grad.value_and_grad_scene(torch.mean, scene, feats, 0, **kw)


# ---------------------------------------------------------------------------
# (i) inverse rendering (tests/test_optimize.py, on the port)
# ---------------------------------------------------------------------------

OPT_SCENE = {
    "background_color": [0.7, 0.8, 1.0],
    "camera": {"fov": 40, "center": [0, 2, 6], "look_at": [0, 1, 0]},
    "materials": [{"type": "lambertian", "albedo": [0.8, 0.3, 0.3]},
                  {"type": "lambertian", "albedo": [0.3, 0.8, 0.3]}],
    "primitives": [
        {"type": "quad", "q": [-10, 0, -10], "u": [20, 0, 0], "v": [0, 0, 20], "material": 0},
        {"type": "sphere", "center": [0, 1, 0], "radius": 1.0, "material": 1},
    ],
}


def _opt_scene(tmp_path):
    p = tmp_path / "opt_scene.json"
    p.write_text(json.dumps(OPT_SCENE))
    host, _ = loader.load_scene(str(p))
    return str(p), schema.to_device(host, "cpu"), host.features()


def test_albedo_recovery(tmp_path):
    _, scene, feats = _opt_scene(tmp_path)
    kw = dict(width=32, height=32, n_samples=2, max_depth=4, sqrt_spp=1)
    _, recs = opt.optimize(scene, feats, ["materials.albedo"], steps=15, lr=5e-2,
                           render_kw=kw, log=lambda s: None)
    first, last = recs[0], recs[-1]
    assert last["loss"] < first["loss"] / 4, (first, last)
    assert last["rel_err[materials.albedo]"] < first["rel_err[materials.albedo]"] / 2


def test_optimize_cli(tmp_path, capsys):
    path, _, _ = _opt_scene(tmp_path)
    rc = opt.main([path, "--leaves", "background", "--steps", "8", "--width", "24",
                   "--height", "24", "--samples", "1", "--depth", "3", "--lr", "0.05",
                   "--device", "cpu"])
    assert rc == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert lines[-1]["event"] == "done"
    assert lines[-1]["improvement"] > 1.5
