"""B1's last option on the CPU: the threaded-BVH sweep (``RT2_SWEEP_MODE=bvh``,
``megakernel.SWEEP_MODE``). The port's ``threaded_bvh`` against JAX's
``_build_threaded_bvh`` (exactly); the plain BVH walk against the flat
sweep (bitwise on separated records, winners up to exact t ties on the
random scene); the plain v4 image in "bvh" mode against JAX's XLA path;
the plain gradient under "bvh" against "hier"; the default buffer's layout
unchanged; the switch, the build targets and the shared-memory check."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace2_tpu.ops import integrator as jax_integrator
from raytrace2_tpu.ops.pallas import megakernel as jmk
from raytrace2_tpu.scene import loader as jax_loader
from raytrace2_tpu.scene import schema as jax_schema
from raytrace2_tpu_torch.io import compare
from raytrace2_tpu_torch.ops import camera, integrator
from raytrace2_tpu_torch.ops.kernels import build
from raytrace2_tpu_torch.ops.kernels import megakernel as mk
from raytrace2_tpu_torch.ops.kernels import megakernel_grad as mkg
from raytrace2_tpu_torch.ops.kernels import megakernel_v3 as mk3
from raytrace2_tpu_torch.scene import loader, schema
from test_torch_cluster_sweep import _rays, _v4
from test_torch_scenes import write_scene

BVH_FAMILIES = {f + part for f in "sb" for part in ("bv", "bleaf", "bhit", "bmiss")}


@pytest.fixture
def bvh(monkeypatch):
    monkeypatch.setattr(mk, "SWEEP_MODE", "bvh")


def _scene(tmp_path_factory, name):
    path = write_scene(tmp_path_factory.mktemp(name), name)
    scene, _ = loader.load_scene(path)
    feats = scene.features()
    return path, scene, feats, tuple(feats["mega_sizes"]), schema.to_device(scene, "cpu")


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    return _scene(tmp_path_factory, "grid")


@pytest.fixture(scope="module")
def clustered(tmp_path_factory):
    return _scene(tmp_path_factory, "clustered")


@pytest.mark.parametrize("n_cl,n_pad", [(16, 3), (18, 5), (64, 10)])
def test_threaded_bvh_matches_jax(n_cl, n_pad):
    """Node AABBs, leaves and both links of all six threadings equal JAX's
    ``_build_threaded_bvh`` (run eagerly) exactly, on random cluster bounds
    whose last ``n_pad`` clusters are padding (inverted: lo = +BIG, hi =
    -BIG), with coordinates repeated so that the stable sort meets ties."""
    rs = np.random.RandomState(n_cl)
    lo = rs.randint(-8, 8, (n_cl, 3)).astype(np.float32) * 1.25
    hi = lo + rs.uniform(0.5, 3.0, (n_cl, 3)).astype(np.float32)
    lo[-n_pad:], hi[-n_pad:] = mk.BIG, -mk.BIG
    ref = {}
    jmk._build_threaded_bvh(ref, jnp.asarray(lo), jnp.asarray(hi))
    ours = mk.threaded_bvh(torch.from_numpy(lo), torch.from_numpy(hi))
    m = 2 * n_cl - 1
    assert ours["bv"].shape == (6, m) and ours["bhit"].shape == (6 * m,)
    for i, k in enumerate(mk.AABB_KEYS):
        np.testing.assert_array_equal(ours["bv"][i].numpy(), np.asarray(ref["bv" + k]),
                                      err_msg=k)
    for k in ("bleaf", "bhit", "bmiss"):
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert (ours["bleaf"] >= 0).sum() == n_cl  # every cluster is one leaf


def _bounce(dev, sizes, feats, key, tm, carry, monkeypatch, mode):
    """One bounce of the ray states in sweep ``mode`` ("hier", "bvh" or
    "flat"): (next states, winners, the tests counted)."""
    stats = {}
    with monkeypatch.context() as mp:
        mp.setattr(mk, "SWEEP_MODE", "bvh" if mode == "bvh" else "hier")
        if mode == "flat":
            mp.setattr(mk, "hier_flags", lambda s: (False, False))
        b = mk.make_bounce(mk.pack_buffer(dev, sizes), dev.background, stats=stats,
                           max_depth=8, sizes=sizes, has_checker=feats["has_checker"],
                           has_noise=feats["has_noise"])
        out, win = b(key, tm, carry, track=True)
    return out, win, stats


def test_bvh_sweep_equals_flat_on_separated_records(grid, monkeypatch):
    """One bounce of 1,024 ray states on the grid scene (separated records:
    no exact ties): the BVH walk's winners and next ray states equal the
    flat sweep's bitwise, with fewer record tests than the flat sweep."""
    _, _, feats, sizes, dev = grid
    key, tm, carry = _rays()
    out_b, win_b, st_b = _bounce(dev, sizes, feats, key, tm, carry, monkeypatch, "bvh")
    out_f, win_f, st_f = _bounce(dev, sizes, feats, key, tm, carry, monkeypatch, "flat")
    alive = carry[1] > 0
    for a, b in zip(win_b, win_f):
        np.testing.assert_array_equal(a[alive].numpy(), b[alive].numpy())
    for i, (a, b) in enumerate(zip(out_b, out_f)):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f"carry {i}")
    assert st_b["bounces"] == st_f["bounces"] == int(alive.sum())
    assert st_b["aabb"] > 0 and st_b["sph"] < 0.2 * st_f["sph"]


def _winner_t(dev, sizes, win, tm, carry):
    """The t of each lane's winning record (spheres and boxes; BIG where
    the winner is of another family or a miss), from the family bodies."""
    cols = mk.unpack_buffer(mk.pack_buffer(dev, sizes), sizes)
    _, idx, famid = win
    ox, oy, oz, dx, dy, dz = carry[2:8]
    a = dx * dx + dy * dy + dz * dz
    ray = dict(tm=tm, ox=ox, oy=oy, oz=oz, dx=dx, dy=dy, dz=dz, a=a, inv_a=1.0 / a,
               best_t=mk.BIG, aux=1.0)
    t = torch.full_like(ox, mk.BIG)
    inv_d = tuple(mk._safe_inv(x) for x in (dx, dy, dz))
    for fam, keys, body, extra in (
            ("sph", mk.SPH_KEYS, mk.sph_body, {}),
            ("box", mk.BOX_KEYS, mk.box_body,
             dict(inv_d=inv_d, sgn_d=tuple(torch.sign(x) for x in (dx, dy, dz))))):
        sel = famid == float(mk.FAMID[fam])
        g = {k: cols[fam][k][torch.where(sel, idx, 0.0).long()] for k in keys}
        _, vals = body(g, **ray, **extra)
        t = torch.where(sel, vals[0], t)
    return t


def test_bvh_sweep_winners_on_random_scene(clustered, monkeypatch):
    """One bounce of 4,096 ray states on the random ~840-record scene
    (overlapping primitives): the BVH walk's winners are the flat sweep's
    except at exact t ties, where the two sweeps may keep different
    records of equal t (JAX megakernel.py:512-514). Tolerance: a lane whose
    winner differs must have its two winners at the same t, and at most
    0.5 % of the live lanes may differ (none does here); every other lane's
    next ray state is bitwise the flat sweep's."""
    _, _, feats, sizes, dev = clustered
    key, tm, carry = _rays(4096, seed=7)
    out_b, win_b, st_b = _bounce(dev, sizes, feats, key, tm, carry, monkeypatch, "bvh")
    out_f, win_f, st_f = _bounce(dev, sizes, feats, key, tm, carry, monkeypatch, "flat")
    t_b, t_f = (_winner_t(dev, sizes, w, tm, carry) for w in (win_b, win_f))
    alive = carry[1] > 0
    differ = alive & torch.stack([a != b for a, b in zip(win_b, win_f)]).any(0)
    assert int(differ.sum()) <= 0.005 * int(alive.sum()), int(differ.sum())
    np.testing.assert_array_equal(t_b[differ].numpy(), t_f[differ].numpy())
    same = ~differ
    for i, (a, b) in enumerate(zip(out_b, out_f)):
        np.testing.assert_array_equal(a[same].numpy(), b[same].numpy(), err_msg=f"carry {i}")
    assert st_b["sph"] < 0.2 * st_f["sph"] and st_b["box"] < 0.2 * st_f["box"]


def test_bvh_v4_image_matches_jax_xla_path(grid, bvh):
    """The plain v4 image through the BVH walk, on the block layout with
    wave regeneration at 0.5, 24x24, 2 spp, depth 4, against JAX's XLA path
    on the kernel's murmur streams, by the gate the cluster skip is held to
    (test_torch_cluster_sweep.py): at most 0.5 % of pixels flipped (more
    than 1e-4), the others at 60 dB or more, the means within 1e-3. The
    block layout is bitwise the linear one in "bvh" mode too."""
    path, scene, feats, sizes, dev = grid
    w = h = 24
    spp, depth = 2, 4
    jhost, _ = jax_loader.load_scene(path)
    jfeat = dict(jhost.features(), use_megakernel=False, rng_impl="murmur")
    ref = np.asarray(jax_integrator.render_progressive(
        jax_schema.to_device(jhost), jfeat, w, h, jnp.int32(0), jnp.int32(spp), 0, depth,
        1)) / spp
    feats = dict(feats, mega_wavefront=False, mega_linear=False, mega_wave_frac=0.5)
    ours = integrator.render_progressive(dev, feats, w, h, 0, spp, 0, depth, 1).numpy() / spp
    assert np.isfinite(ours).all() and ref.max() > 0
    assert abs(ours.mean() - ref.mean()) < 1e-3
    flipped = np.abs(ours - ref).max(-1) > 1e-4
    assert flipped.mean() <= 0.005, flipped.sum()
    assert compare.psnr(ours[~flipped], ref[~flipped]) >= 60.0
    linear = _v4(scene, feats, sizes, dev, 20, 12, 3, 3)
    np.testing.assert_array_equal(_v4(scene, feats, sizes, dev, 20, 12, 3, 3, block=True,
                                      wave_frac=0.5), linear)


def test_bvh_gradient_matches_hier(grid, monkeypatch):
    """The plain gradient (pre-pass and replay) at 16x16, 2 spp, depth 4:
    under "bvh" its forward image is bitwise the "hier" one (the same
    winners), it replays the same bounces, and every leaf group's
    cotangents (camv, background, each record family) are within 1e-3 of
    the group's largest, the gate B3 is held to."""
    _, scene, feats, sizes, dev = grid
    camv = camera.make_camv(scene.camera, 16, 16, 0, 2, 1, 0)
    g = torch.from_numpy(np.random.RandomState(5).uniform(0, 1, (256, 3)).astype(np.float32))
    kw = dict(n_pix=256, max_depth=4, sizes=sizes, has_checker=feats["has_checker"],
              has_noise=feats["has_noise"])
    res = {}
    for mode in ("hier", "bvh"):
        monkeypatch.setattr(mk, "SWEEP_MODE", mode)
        packed = mk.pack_buffer(dev, sizes)
        img = mk.trace_plain(camv, 0, packed, dev.background, **kw)
        count = torch.zeros(1, dtype=torch.int64)
        d = mkg.grad_plain(camv, 0, packed, dev.background, g, bounces=count, **kw)
        res[mode] = (img, int(count), d, mk.unpack_buffer(d[2], sizes))
    (img_h, n_h, d_h, c_h), (img_b, n_b, d_b, c_b) = res["hier"], res["bvh"]
    assert torch.equal(img_h, img_b) and float(img_h.max()) > 0
    assert n_h == n_b > 256
    groups = [("camv", d_h[0], d_b[0]), ("background", d_h[1], d_b[1])] + [
        (fam, torch.cat([c_h[fam][k] for k in keys]), torch.cat([c_b[fam][k] for k in keys]))
        for fam, keys in mk.FAMILIES]
    for name, a, b in groups:
        assert bool(torch.isfinite(b).all()), name
        scale = float(a.abs().max())
        assert float((a - b).abs().max()) <= 1e-3 * scale + 1e-6, name
    assert float(c_b["mat"]["alr"].abs().max()) > 0  # solid scene: no geometry gradient


def test_bvh_v3_pass_equals_flat(grid, monkeypatch):
    """B4's plain pass walks the BVH too, and gives the flat sweep's
    radiance and state on 256 rays of the grid scene, bitwise."""
    _, _, feats, sizes, dev = grid
    _, tm, carry = _rays(256, seed=9)
    state, rid = mk3.init_state(torch.stack(carry[2:5], -1), torch.stack(carry[5:8], -1), tm)
    kw = dict(max_depth=6, sizes=sizes, has_checker=feats["has_checker"],
              has_noise=feats["has_noise"])
    monkeypatch.setattr(mk, "SWEEP_MODE", "bvh")
    walk = mk3.pass_plain(state, rid, 12345, 0, mk.pack_buffer(dev, sizes), dev.background,
                          **kw)
    monkeypatch.setattr(mk, "SWEEP_MODE", "hier")
    monkeypatch.setattr(mk, "hier_flags", lambda s: (False, False))
    flat = mk3.pass_plain(state, rid, 12345, 0, mk.pack_buffer(dev, sizes), dev.background,
                          **kw)
    for a, b in zip(walk, flat):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# (sizes, the table_layout total of the parent commit's packed buffer).
PARENT_TOTALS = [
    ((1005, 1, 9, 4, 2, 400), 14344),   # book 2
    ((144, 2, 3, 1, 0, 144), 3174),     # the grid scene
    ((520, 1, 3, 1, 0, 320), 8601),     # the random clustered scene
    ((4096, 0, 1, 0, 0, 0), 42099),     # the record ceiling, all spheres
    ((31, 18, 5, 1, 0, 32), 995),
    ((40, 0, 1, 0, 2400, 0), 57987),    # clusters would not fit: flat
    ((0, 18, 4, 1, 0, 0), 309),         # Cornell-like: no clustered family
]


@pytest.mark.parametrize("sizes,total", PARENT_TOTALS)
def test_hier_layout_is_the_parents(sizes, total, monkeypatch):
    """In "hier" mode the packed layout's total is the parent's and no BVH
    table has rows; in "bvh" mode each clustered family adds 19 m floats
    (m = 2 n_cl - 1 nodes), the tables still fit shared memory with the
    same cluster flags, and every other family keeps its rows."""
    assert mk.SWEEP_MODE == "hier"
    hier = mk.table_layout(sizes)
    assert hier["total"][0] == total
    assert all(hier[f][1] == 0 for f in BVH_FAMILIES)
    flags = mk.hier_flags(sizes)
    monkeypatch.setattr(mk, "SWEEP_MODE", "bvh")
    assert mk.hier_flags(sizes) == flags
    layout = mk.table_layout(sizes)
    extra = sum(19 * mk.bvh_nodes(n) for n, on in zip((sizes[0], sizes[5]), flags) if on)
    assert layout["total"][0] == total + extra
    assert 4 * (layout["total"][0] + camera.CAMV_LEN + 4 + 24) <= build.MAX_SMEM_BYTES
    assert all(layout[f][1] == hier[f][1] for f, _ in mk.ALL_FAMILIES if f not in BVH_FAMILIES)


def test_bvh_buffer_adds_only_the_bvh_tables(grid, monkeypatch):
    """The "bvh" buffer of the grid scene, without its BVH tables, is the
    "hier" buffer byte for byte, and its BVH tables are ``threaded_bvh`` of
    the raw cluster bounds (spheres: 144 records, 16 clusters, 31 nodes)."""
    _, _, _, sizes, dev = grid
    hier = mk.pack_buffer(dev, sizes)
    monkeypatch.setattr(mk, "SWEEP_MODE", "bvh")
    packed = mk.pack_buffer(dev, sizes)
    layout = mk.table_layout(sizes)
    kept = torch.cat([packed[layout[f][0]: layout[f][0] + len(keys) * layout[f][1]]
                      for f, keys in mk.ALL_FAMILIES if f not in BVH_FAMILIES])
    assert torch.equal(kept.view(torch.int32), hier.view(torch.int32))
    cols = mk.unpack_buffer(packed, sizes)
    assert layout["sbv"][1] == mk.bvh_nodes(sizes[0]) == 31
    lo = torch.stack([cols["sph"][k] for k in ("c0x", "c0y", "c0z")], -1)
    hi_ = lo + torch.stack([cols["sph"][k] for k in ("dpx", "dpy", "dpz")], -1)
    rad = cols["sph"]["rad"][:, None]
    pad = -sizes[0] % mk.SUPER
    raw = mk.cluster_tables(torch.nn.functional.pad(torch.minimum(lo, hi_) - rad, (0, 0, 0, pad)),
                            torch.nn.functional.pad(torch.maximum(lo, hi_) + rad,
                                                    (0, 0, 0, pad)),
                            torch.arange(sizes[0] + pad) < sizes[0])["raw"]
    want = mk.threaded_bvh(*raw)
    for i, k in enumerate(mk.AABB_KEYS):
        assert torch.equal(cols["sbv"][k], want["bv"][i])
    for k in ("bleaf", "bhit", "bmiss"):
        assert torch.equal(cols["s" + k][k], want[k])


def test_sweep_mode_switch_and_targets(grid, monkeypatch):
    """RT2_SWEEP_MODE is read at import (default "hier") and any value but
    "hier" or "bvh" raises; in "bvh" mode every cluster-walking kernel's
    build target carries the bvh define (a library of its own), B4 refuses
    a buffer packed in the other mode, and "hier" targets are the parent's."""
    env = dict(os.environ, RT2_SWEEP_MODE="fast")
    r = subprocess.run([sys.executable, "-c",
                        "import raytrace2_tpu_torch.ops.kernels.megakernel"],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "RT2_SWEEP_MODE='fast'" in r.stderr
    assert mk.SWEEP_MODE == "hier" and mk.SWEEP_MODES == ("hier", "bvh")
    assert build.step_target() == "wavefront_step"
    assert build.feature_target("megakernel_v4", 7) == ("megakernel_v4", ("V4_FEATURES=7",))
    hier_lib = build.library_path(build.grad_target(7))
    _, _, feats, sizes, dev = grid
    hier_packed = mk.pack_buffer(dev, sizes)
    monkeypatch.setattr(mk, "SWEEP_MODE", "bvh")
    assert build.step_target() == ("wavefront_step", (build.SWEEP_DEFINE,))
    assert build.step_target("wavefront_profile") == ("wavefront_profile",
                                                      (build.SWEEP_DEFINE,))
    for name in build.FEATURE_DEFINES:
        assert build.feature_target(name, 7)[1] == (f"{build.FEATURE_DEFINES[name]}=7",
                                                    build.SWEEP_DEFINE)
    assert build.grad_target(7) == build.feature_target("megakernel_grad", 7)
    assert build.profile_target(3, 5)[1] == ("V4_FEATURES=3", "V3_FEATURES=5",
                                             build.SWEEP_DEFINE)
    assert build.library_path(build.grad_target(7)) != hier_lib
    state, rid = mk3.init_state(torch.zeros(128, 3), torch.ones(128, 3), torch.zeros(128))
    with pytest.raises(ValueError, match="table layout"):
        mk3.megakernel_pass(state, rid, 1, 0, hier_packed, dev.background, max_depth=2,
                            sizes=sizes, has_checker=feats["has_checker"],
                            has_noise=feats["has_noise"])
