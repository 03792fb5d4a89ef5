"""The cluster-skip sweep and v4's block-tiled, wave-regenerated layout on the
CPU: the port's compact cluster tables against JAX's ``pack_tables``, the
ordered sweep against the flat one, the whole plain v4 image against JAX's
XLA path, and the block layout against the linear one (bitwise)."""

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
from raytrace2_tpu_torch.ops.kernels import megakernel_v3 as mk3
from raytrace2_tpu_torch.scene import loader, schema
from test_torch_scenes import write_scene


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    path = write_scene(tmp_path_factory.mktemp("grid"), "grid")
    scene, _ = loader.load_scene(path)
    feats = scene.features()
    sizes = tuple(feats["mega_sizes"])
    assert sizes[0] == sizes[5] == 144 and mk.hier_flags(sizes) == (True, True)
    return path, scene, feats, sizes, schema.to_device(scene, "cpu")


@pytest.fixture(scope="module")
def clustered(tmp_path_factory):
    path = write_scene(tmp_path_factory.mktemp("clustered"), "clustered")
    scene, _ = loader.load_scene(path)
    feats = scene.features()
    sizes = tuple(feats["mega_sizes"])
    assert sizes[0] == 520 and sizes[5] == 320 and mk.hier_flags(sizes) == (True, True)
    return path, scene, feats, sizes, schema.to_device(scene, "cpu")


def test_cluster_tables_match_jax(clustered):
    """The compact tables hold JAX's values: AABBs bitwise (motion-inclusive
    sphere bounds, padded clusters collapsed to BIG), ``ord`` and ``lord``
    exactly."""
    path, _, _, sizes, dev = clustered
    cols = mk.unpack_buffer(mk.pack_buffer(dev, sizes), sizes)
    ref = jmk.pack_tables(jax_schema.to_device(jax_loader.load_scene(path)[0]), sizes)
    for f, n, jt in (("s", sizes[0], ref[0]), ("b", sizes[5], ref[2])):
        n_cl, n_l2 = mk.cluster_counts(n)
        assert n_l2 >= 3, f
        for k in mk.AABB_KEYS:
            np.testing.assert_array_equal(cols[f + "cb"][k].numpy(),
                                          np.asarray(jt["cb" + k])[:n_cl], err_msg=f + k)
            np.testing.assert_array_equal(cols[f + "sb"][k].numpy(),
                                          np.asarray(jt["sb" + k])[:n_l2], err_msg=f + k)
        np.testing.assert_array_equal(cols[f + "ord"]["ord"].numpy(),
                                      np.asarray(jt["ord"])[:6 * n_l2])
        np.testing.assert_array_equal(cols[f + "lord"]["lord"].numpy(),
                                      np.asarray(jt["lord"])[:6 * n_cl])


def _rays(n=1024, seed=3):
    """Ray states inside and around the scene: origins in its box, unit and
    non-unit directions, 85 % of them alive."""
    rs = np.random.RandomState(seed)
    o = rs.uniform(-12, 12, size=(n, 3))
    o[: n // 4] = [0, 3, 26]  # camera-like rays from outside
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d *= rs.uniform(0.5, 1.5, size=(n, 1))
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    carry = (f32(rs.randint(0, 4, n)), f32(rs.uniform(size=n) < 0.85), *f32(o.T), *f32(d.T),
             *f32(rs.uniform(0.1, 1.0, (3, n))), *f32(np.zeros((3, n))))
    key = torch.from_numpy(rs.randint(0, 2**32, size=n, dtype=np.uint64).astype(np.int64))
    return key, f32(rs.uniform(size=n)), carry


def test_ordered_sweep_equals_flat_sweep(clustered, monkeypatch):
    """One bounce of 1,024 ray states through the cluster-skip sweep and
    through the flat one: the same winners, t and next rays except on exact
    t ties (counted: none on this scene), while the skip tests a small part
    of the records."""
    _, _, feats, sizes, dev = clustered
    kw = dict(max_depth=8, sizes=sizes, has_checker=feats["has_checker"],
              has_noise=feats["has_noise"])
    key, tm, carry = _rays()
    stats = {}
    hier = mk.make_bounce(mk.pack_buffer(dev, sizes), dev.background, stats=stats, **kw)
    out_h, win_h = hier(key, tm, carry, track=True)
    monkeypatch.setattr(mk, "hier_flags", lambda s: (False, False))
    flat_stats = {}
    flat = mk.make_bounce(mk.pack_buffer(dev, sizes), dev.background, stats=flat_stats, **kw)
    out_f, win_f = flat(key, tm, carry, track=True)
    alive = carry[1] > 0
    differ = alive & torch.stack([a != b for a, b in zip(win_h, win_f)]).any(0)
    ties = int(differ.sum())
    assert ties == 0, ties
    for i, (a, b) in enumerate(zip(out_h, out_f)):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f"carry {i}")
    live = stats["bounces"]
    assert live == flat_stats["bounces"] == int(alive.sum())
    assert flat_stats["sph"] == 520 * live and flat_stats["box"] == 320 * live
    assert stats["sph"] < 0.5 * flat_stats["sph"] and stats["box"] < 0.5 * flat_stats["box"]
    assert stats["aabb"] > 0 and flat_stats["aabb"] == 0


def _v4(scene, feats, sizes, dev, w, h, spp, depth, **kw):
    block = kw.get("block", False)
    camv = camera.make_camv(scene.camera, w, h, 0, spp, max(int(spp ** 0.5), 1), 0,
                            **({"block": mk.BLOCK} if block else {}))
    n_slots, slot_of_pixel = mk.pixel_slots(w, h, block)
    out = mk.trace_megakernel_batch(camv, 0, mk.pack_buffer(dev, sizes), dev.background,
                                    n_pix=n_slots, max_depth=depth, sizes=sizes,
                                    has_checker=feats["has_checker"],
                                    has_noise=feats["has_noise"], **kw)
    return out[slot_of_pixel.reshape(-1)].reshape(h, w, 3).numpy()


def test_block_wave_layout_equals_linear(grid):
    """Plain v4 at 20x12 (edge blocks with idle lanes), 3 spp, depth 3: the
    block-tiled layout with wave regeneration at 0.5 is bitwise the linear
    layout with instant regeneration, and so is the linear layout with wave
    regeneration."""
    _, scene, feats, sizes, dev = grid
    ref = _v4(scene, feats, sizes, dev, 20, 12, 3, 3)
    assert np.isfinite(ref).all() and ref.max() > 0
    np.testing.assert_array_equal(_v4(scene, feats, sizes, dev, 20, 12, 3, 3, block=True,
                                      wave_frac=0.5), ref)
    np.testing.assert_array_equal(_v4(scene, feats, sizes, dev, 20, 12, 3, 3, wave_frac=0.5),
                                  ref)


def test_mega_schedule_takes_block_layout_above_512_records(clustered):
    """JAX's mega_schedule: v4 forced on a scene above 512 records gets
    the block layout with wave_frac 0.5; the overrides apply."""
    _, _, feats, _, _ = clustered
    assert integrator.mega_schedule(feats)[3]  # 841 records: the wavefront
    assert integrator.mega_schedule(dict(feats, mega_wavefront=False)) == (8, 0.5, False, False)
    assert integrator.mega_schedule(dict(feats, mega_wavefront=False, mega_wave_frac=0.25,
                                         mega_linear=True)) == (8, 0.25, True, False)
    small = dict(feats, mega_sizes=(100, 18, 2, 1, 0, 0))
    assert integrator.mega_schedule(small) == (32, 1.0, True, False)


def test_v4_image_matches_jax_xla_path(grid):
    """The plain v4 image with the cluster skip, on the block layout with
    wave regeneration at 0.5, 24x24, 2 spp, depth 4, against JAX's XLA path
    on the kernel's murmur streams, by PR 2's gate: at most 0.5 % of pixels
    flipped (more than 1e-4), the others at 60 dB or more, the means within
    1e-3. (The random scene above, whose primitives overlap, flips 5 of 256
    pixels against JAX's XLA path at 16x16 even on the port's own non-kernel
    route, which has no cluster sweep, so it cannot tell sweeps apart; its
    sweep is held bitwise to the flat one instead.)"""
    path, scene, feats, _, dev = grid
    w = h = 24
    spp, depth = 2, 4
    jhost, _ = jax_loader.load_scene(path)
    jfeat = dict(jhost.features(), use_megakernel=False, rng_impl="murmur")
    ref = np.asarray(jax_integrator.render_progressive(
        jax_schema.to_device(jhost), jfeat, w, h, jnp.int32(0), jnp.int32(spp), 0, depth,
        1)) / spp
    launches = mk.LAUNCHES
    feats = dict(feats, mega_wavefront=False, mega_linear=False, mega_wave_frac=0.5)
    assert integrator.mega_schedule(feats)[1:] == (0.5, False, False)
    ours = integrator.render_progressive(dev, feats, w, h, 0, spp, 0, depth, 1).numpy() / spp
    assert mk.LAUNCHES == launches  # the CPU runs the plain version
    assert np.isfinite(ours).all() and ref.max() > 0
    assert abs(ours.mean() - ref.mean()) < 1e-3
    flipped = np.abs(ours - ref).max(-1) > 1e-4
    assert flipped.mean() <= 0.005, flipped.sum()
    assert compare.psnr(ours[~flipped], ref[~flipped]) >= 60.0


def test_v3_pass_takes_the_ordered_sweep(grid, monkeypatch):
    """B4's plain pass sweeps through the clusters too, and its result is
    the flat sweep's on 256 rays of the grid scene."""
    _, scene, feats, sizes, dev = grid
    key, tm, carry = _rays(256, seed=9)
    o = torch.stack(carry[2:5], -1)
    d = torch.stack(carry[5:8], -1)
    state, rid = mk3.init_state(o, d, tm)
    kw = dict(max_depth=6, sizes=sizes, has_checker=feats["has_checker"],
              has_noise=feats["has_noise"])
    hier = mk3.pass_plain(state, rid, 12345, 0, mk.pack_buffer(dev, sizes), dev.background,
                          **kw)
    monkeypatch.setattr(mk, "hier_flags", lambda s: (False, False))
    flat = mk3.pass_plain(state, rid, 12345, 0, mk.pack_buffer(dev, sizes), dev.background,
                          **kw)
    for a, b in zip(hier, flat):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("sizes,want", [
    ((1005, 1, 9, 4, 2, 400), (True, True)),    # book 2
    ((4096, 0, 1, 0, 0, 0), (True, False)),     # the record ceiling, all spheres
    ((31, 18, 5, 1, 0, 32), (False, True)),     # below 32 records a family stays flat
    ((40, 0, 1, 0, 2400, 0), (False, False)),   # clusters would not fit beside the media
])
def test_cluster_tables_fit_or_stay_flat(sizes, want):
    """A family takes the cluster skip from 32 records if the tables with
    the cluster tables fit one block's shared memory (the gradient kernel's
    block sums included); otherwise the sweep stays flat, so every scene
    whose flat tables fit is still taken."""
    assert mk.hier_flags(sizes) == want
    layout = mk.table_layout(sizes)
    floats = layout["total"][0] + camera.CAMV_LEN + 4 + 24
    assert 4 * floats <= build.MAX_SMEM_BYTES
    n_cluster = sum(len(keys) * layout[fam][1] for fam, keys in mk.CLUSTER_FAMILIES)
    assert (n_cluster > 0) == any(want)
    assert mk.counts(sizes) == (*sizes, *map(int, want), 0)
