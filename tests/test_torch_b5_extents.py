"""The fused closest hit B5 over its live records, on the CPU: the plain
version swept over the live extents (one past each family's last active
record) equals it over the padded rows bit for bit; on a scene of exact-t
ties it picks the Pallas kernel's code (JAX's ``closest_hit_pallas`` in
interpret mode, as tests/test_torch_intersect_kernel.py runs it) and the
lowest code among the tied records; the launch rule (lane group, threads,
staging); the bound's operation count; and the extents reach the wrapper
from the host scene, read once per scene by the ``Renderer``, with B5's
tables (the pallas route refuses features without them). The kernel itself is held against the plain
version on the card in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace2_tpu.ops.pallas import intersect_kernel as jpk
from raytrace2_tpu.scene import loader as jax_loader
from raytrace2_tpu.scene import schema as jax_schema
from raytrace2_tpu_torch.ops import intersect
from raytrace2_tpu_torch.ops.kernels import intersect_kernel as pk
from raytrace2_tpu_torch.render import Renderer
from raytrace2_tpu_torch.scene import loader, schema
from test_torch_cuda import _b5_rays
from test_torch_scenes import b5_tie_rays, write_scene

N_RAYS = 1024
N_TIE = 56


def _scene(tmp_path, name):
    """(host scene, CPU device scene, B5's rows, live extents)."""
    host, _ = loader.load_scene(write_scene(tmp_path, name))
    scene = schema.to_device(host, "cpu")
    return host, scene, pk.pack_scene(scene.spheres, scene.quads), pk.live_extents(host)


def _same(a, b):
    """t bit for bit (int32 views) and codes equal."""
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
    assert torch.equal(a[1], b[1])


@pytest.mark.parametrize("name,extents", [("cornell", (0, 18)), ("feature", (4, 8)),
                                          ("book2", (1005, 2401))])
def test_live_extents_are_the_padded_sweep(tmp_path, name, extents):
    """The plain version over [0, ns) and [0, nq) is the padded sweep, bit
    for bit, on 1,024 rays (camera rays and seeded rays inside the scene);
    so is the wrapper on a CPU tensor, which takes the extents."""
    host, scene, tables, ext = _scene(tmp_path, name)
    assert ext == extents
    assert tables[0].shape[1] % pk.TILE_P == 0 and tables[0].shape[1] >= max(ext[0], 1)
    rays = _b5_rays(scene, int(np.sqrt(N_RAYS // 2)), "cpu")
    padded = pk.closest_hit_plain(*rays, *tables)
    assert int((padded[1] >= 0).sum()) > N_RAYS // 4
    _same(pk.closest_hit_plain(*rays, *tables, *ext), padded)
    _same(pk.closest_hit(*rays, *tables, n_sph=ext[0], n_quad=ext[1]), padded)


def test_ties_pick_the_pallas_kernels_lowest_code(tmp_path):
    """Two identical spheres, a quad touching them and two identical quads
    (``b5_tie_scene_json``): rays down the z axis meet them at exactly equal
    t. The plain version, with live extents and without, picks the Pallas
    kernel's code in interpret mode (compiled without FMA contraction, whose
    arithmetic is the plain version's) and the lowest code among the records
    at the least t."""
    jhost, _ = jax_loader.load_scene(write_scene(tmp_path, "b5_ties"))
    host, scene, tables, ext = _scene(tmp_path, "b5_ties")
    tie = b5_tie_rays(N_TIE)  # and 2 x 22² others: the Pallas kernel's 1,024-ray tile
    cam = tuple(x.numpy() for x in _b5_rays(scene, 22, "cpu"))
    rays = tuple(np.concatenate([a, b]) for a, b in zip(tie, cam))
    args = tuple(torch.from_numpy(x) for x in rays)
    t, code = pk.closest_hit_plain(*args, *tables, *ext)
    _same((t, code), pk.closest_hit_plain(*args, *tables))

    jargs = (*(jnp.asarray(x) for x in rays),
             *jax.jit(jpk.pack_scene)(*(getattr(jax_schema.to_device(jhost), f)
                                        for f in ("spheres", "quads"))))
    call = jax.jit(lambda *a: jpk.closest_hit_pallas(*a, interpret=True)).lower(*jargs)
    jt, jc = (np.asarray(x) for x in call.compile(
        compiler_options={"xla_backend_optimization_level": 0})(*jargs))
    np.testing.assert_array_equal(code.numpy(), jc)
    np.testing.assert_array_equal(t.numpy().view(np.int32), jt.view(np.int32))

    # Each tie ray's winner is the lowest code among the records at its t.
    o, d, tm, t0, t1 = (a[:N_TIE, None] if a.dim() == 1 else a[:N_TIE] for a in args)
    cols = [o[:, 0:1], o[:, 1:2], o[:, 2:3], d[:, 0:1], d[:, 1:2], d[:, 2:3], tm, t0, t1]
    a = cols[3] * cols[3] + cols[4] * cols[4] + cols[5] * cols[5]
    ray = (*cols, a, 1.0 / a)
    ts = torch.cat([pk._sphere_tile(ray, tables[0][:, None, :]),
                    pk._quad_tile(ray, tables[1][:, None, :])], 1)
    codes = torch.cat([torch.arange(tables[0].shape[1]),
                       pk.CODE_QUAD + torch.arange(tables[1].shape[1])])
    tied = ts == ts.min(1, keepdim=True).values
    assert bool((tied.sum(1) >= 2).all())  # every tie ray meets two or more records at its t
    fams = {int(c) >> pk.FAM_SHIFT for row in tied for c in codes[row]}
    assert fams == {0, 1}
    want = torch.where(tied, codes, torch.iinfo(torch.int64).max).min(1).values
    assert torch.equal(code[:N_TIE].long(), want)
    assert torch.equal(t[:N_TIE], ts.min(1).values)


def test_launch_rule():
    """G: the smallest lane group that gives the grid 16 warps on each of
    132 SMs while a lane tests 2 records or more; the whole live table
    staged where a block's shared memory holds it, else tiles; 1,024
    threads a block where one block fills an SM, smaller blocks where the
    grid has fewer blocks than SMs and they still fit in one wave."""
    # Book 2's 16,384-ray chunk: G = 8, 31 warps an SM, the table (157 KB) whole.
    assert pk.launch_config(16384, 1005, 2401) == (8, 1024, 1005, 2401)
    assert pk.smem_bytes(1005, 2401) == 157012
    assert pk.blocks_per_sm(1024, 157012) == 1 and pk.blocks_per_sm(256, 1000) == 4
    # After the route's compactions (2,048 and 256 rays): G = 32, and blocks
    # of 512 (128 of them, one an SM) and of 128.
    assert pk.launch_config(2048, 1005, 2401) == (32, 512, 1005, 2401)
    assert pk.launch_config(256, 1005, 2401) == (32, 128, 1005, 2401)
    # Cornell's 65,536-ray chunk over 18 quads, and its 8,192 and 1,024
    # rays after compaction: G 2, then 8 (a lane keeps 2 or 3 records).
    assert pk.launch_config(65536, 0, 18) == (2, 256, 0, 18)
    assert pk.launch_config(8192, 0, 18) == (8, 256, 0, 18)
    assert pk.launch_config(1024, 0, 18) == (8, 128, 0, 18)
    assert pk.launch_config(65536, 600, 600)[0] == 2
    assert pk.launch_config(1, 1005, 2401)[0] == 32
    assert pk.launch_config(1, 100, 100)[0] == 32  # 200 records: 32 lanes of 6 or 7
    assert pk.launch_config(1, 3, 0)[0] == 1  # 3 records: one lane
    # The >4,096-record scene: tiles of 48 KB, several blocks an SM.
    g, threads, cap_s, cap_q = pk.launch_config(16384, 3500, 4201)
    assert (g, threads) == (8, 256) and pk.smem_bytes(cap_s, cap_q) <= pk.TILE_BYTES
    assert pk.launch_config(16384, 1005, 2401, tiles=True)[1:] == (256, 768, 472)
    assert pk.launch_config(100, 1005, 2401, group=2)[0] == 2
    with pytest.raises(ValueError, match="group"):
        pk.launch_config(100, 10, 10, group=3)


@pytest.mark.parametrize("name", ["cornell", "book2"])
def test_record_test_ops_count_the_data(tmp_path, name):
    """The bound's operations: 48 a live quad and, a live sphere, 24 up to
    its discriminant's compare and 35 where it has a real root, the roots
    counted as numpy's float32 arithmetic (the plain version's order of
    operations, no contraction) finds them."""
    _, scene, (sph, qd), (ns, nq) = _scene(tmp_path, name)
    rays = _b5_rays(scene, int(np.sqrt(N_RAYS // 2)), "cpu")
    o, d, tm = (x.numpy() for x in rays[:3])
    s = sph[:, :ns].numpy()
    cx, cy, cz = (s[k] + tm[:, None] * s[3 + k] for k in range(3))
    ocx, ocy, ocz = cx - o[:, :1], cy - o[:, 1:2], cz - o[:, 2:]
    dx, dy, dz = d[:, :1], d[:, 1:2], d[:, 2:]
    h = dx * ocx + dy * ocy + dz * ocz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - s[6]
    disc = h * h - (dx * dx + dy * dy + dz * dz) * cc
    roots = int((disc >= 0).sum())
    n = o.shape[0]
    want = n * (ns * pk.OPS_SPHERE_MISS + nq * pk.OPS_QUAD) + roots * (pk.OPS_SPHERE
                                                                     - pk.OPS_SPHERE_MISS)
    assert pk.record_test_ops(*rays, sph, ns, nq) == want
    if name == "cornell":
        assert want == n * 18 * pk.OPS_QUAD
    else:
        assert 0 < roots < n * ns // 10  # most sphere tests stop at the discriminant


def test_pallas_route_needs_the_extents(tmp_path):
    """The pallas route's tables carry the live extents: made from the
    features the Renderer fills, and refused without them (the padded sweep
    stays only the wrapper's default)."""
    host, scene, (sph, qd), ext = _scene(tmp_path, "cornell")
    rays = _b5_rays(scene, 4, "cpu")
    tables = intersect.pallas_tables(scene, {"pallas_extents": ext})
    assert len(tables) == 4 and tables[2:] == ext
    assert torch.equal(tables[0], sph) and torch.equal(tables[1], qd)
    with pytest.raises(ValueError, match="pallas_extents"):
        intersect.pallas_tables(scene, {})
    with pytest.raises(ValueError, match="pallas_extents"):
        intersect.closest_hit(scene, *rays[:3], features={"use_pallas": True})
    feats = {"use_pallas": True, "pallas_extents": ext, "has_media": False}
    hit = intersect.closest_hit(scene, *rays[:3], features=feats)
    padded = intersect.closest_hit(scene, *rays[:3], features=feats,
                                   tables=(sph, qd, sph.shape[1], qd.shape[1]))
    assert bool(hit.valid.any())
    for a, b in zip(hit, padded):
        assert torch.equal(a, b)


def test_wrapper_checks_extents(tmp_path):
    _, scene, tables, _ = _scene(tmp_path, "cornell")
    rays = _b5_rays(scene, 4, "cpu")
    with pytest.raises(ValueError, match="live extents"):
        pk.closest_hit(*rays, *tables, n_sph=0, n_quad=tables[1].shape[1] + 1)
    with pytest.raises(ValueError, match="live extents"):
        pk.closest_hit(*rays, *tables, n_sph=-1, n_quad=0)
    # A family with extent 0 is not swept: every ray misses.
    t, code = pk.closest_hit(*rays, *tables, n_sph=0, n_quad=0)
    assert bool((code == -1).all()) and bool((t == pk.BIG).all())


@pytest.mark.parametrize("name", ["cornell", "ellipsoid"])
def test_extents_reach_the_wrapper_from_the_host(tmp_path, name, monkeypatch):
    """``Renderer(backend="pallas")`` reads the extents from the host scene
    once, at construction (ellipsoid scenes too, whose ``mega_sizes`` is
    None), and every B5 launch of its renders receives them."""
    host, _ = loader.load_scene(write_scene(tmp_path, name))
    reads, seen = [], []
    live_extents, closest_hit = pk.live_extents, pk.closest_hit

    def read(scene):
        assert isinstance(scene.spheres.active, np.ndarray)  # the host scene's leaves
        reads.append(1)
        return live_extents(scene)

    def keep(*a, **k):
        seen.append((k["n_sph"], k["n_quad"]))
        return closest_hit(*a, **k)

    monkeypatch.setattr(pk, "live_extents", read)
    monkeypatch.setattr(pk, "closest_hit", keep)
    r = Renderer(host, 12, 10, num_samples=2, max_depth=3, backend="pallas", device="cpu")
    ext = live_extents(host)
    assert r._features["pallas_extents"] == ext and len(reads) == 1
    if name == "ellipsoid":
        assert r._features["mega_sizes"] is None and ext == (0, 2)
    img = r.render(batch=2)
    assert np.isfinite(img).all() and len(reads) == 1
    assert seen and set(seen) == {ext}
