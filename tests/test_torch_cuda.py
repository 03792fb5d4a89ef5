"""The Hopper kernels (v4, the wavefront step, the gradient replay, the fused
intersect kernel B5, the v3 state-passing kernel B4) against their plain
PyTorch versions and each other, on the card. Skipped where
torch.cuda.is_available() is false. Run on a machine with the card:
python -m pytest tests/test_torch_cuda.py -q --noconftest"""

import json

import numpy as np
import pytest
import torch

from raytrace2_tpu_torch import grad
from raytrace2_tpu_torch.io import compare
from raytrace2_tpu_torch.ops import camera, integrator, rng
from raytrace2_tpu_torch.ops.kernels import intersect_kernel as pk
from raytrace2_tpu_torch.ops.kernels import megakernel as mk
from raytrace2_tpu_torch.ops.kernels import megakernel_grad as mkg
from raytrace2_tpu_torch.ops.kernels import megakernel_v3 as mk3
from raytrace2_tpu_torch.ops.kernels import wavefront as wf
from raytrace2_tpu_torch.render import Renderer
from raytrace2_tpu_torch.scene import loader, schema
from test_torch_scenes import b5_tie_rays, write_scene

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _both(path, w, h, spp, depth, device):
    scene, _ = loader.load_scene(path)
    feats = scene.features()
    sizes = tuple(feats["mega_sizes"])
    dev = schema.to_device(scene, device)
    packed = mk.pack_buffer(dev, sizes)
    camv = camera.make_camv(scene.camera, w, h, 0, spp, max(int(spp ** 0.5), 1), 0).to(device)
    kw = dict(n_pix=w * h, max_depth=depth, sizes=sizes,
              has_checker=feats["has_checker"], has_noise=feats["has_noise"])
    before = mk.LAUNCHES
    kern = mk.trace_megakernel_batch(camv, 0, packed, dev.background, **kw)
    torch.cuda.synchronize()
    assert mk.LAUNCHES == before + 1
    plain = mk.trace_plain(camv, 0, packed, dev.background, **kw)
    return kern.cpu().numpy() / spp, plain.cpu().numpy() / spp


@pytest.mark.parametrize("name,size", [("cornell", 64), ("cornell_volume", 48), ("feature", 48)])
def test_kernel_matches_plain(tmp_path, cuda, name, size):
    kern, plain = _both(write_scene(tmp_path, name), size, size, 4, 8, cuda)
    assert np.isfinite(kern).all()
    assert abs(kern.mean() - plain.mean()) < 1e-3
    assert compare.psnr(kern, plain) >= 45.0


def test_closed_form_on_card(tmp_path, cuda):
    p = tmp_path / "enclosure.json"
    p.write_text(json.dumps({
        "background_color": [0, 0, 0],
        "camera": {"fov": 90, "center": [0, 0, 0], "look_at": [0, 0, -1]},
        "materials": [{"type": "diffuse_light", "albedo": [2.0, 3.0, 4.0]}],
        "primitives": [{"type": "sphere", "center": [0, 0, 0], "radius": 10.0,
                        "material": 0}]}))
    scene, _ = loader.load_scene(str(p))
    img = Renderer(scene, 8, 8, num_samples=3, max_depth=4, device=cuda).render(batch=3)
    np.testing.assert_allclose(img, np.broadcast_to([2, 3, 4], img.shape), rtol=1e-5)


def test_wrapper_rejects_bad_inputs(tmp_path, cuda):
    scene, _ = loader.load_scene(write_scene(tmp_path, "cornell"))
    sizes = tuple(scene.features()["mega_sizes"])
    dev = schema.to_device(scene, cuda)
    packed = mk.pack_buffer(dev, sizes)
    camv = camera.make_camv(scene.camera, 8, 8, 0, 1, 1, 0).to(cuda)
    kw = dict(n_pix=64, max_depth=4, sizes=sizes, has_checker=0, has_noise=False)
    with pytest.raises(ValueError):
        mk.trace_megakernel_batch(camv.cpu(), 0, packed, dev.background, **kw)
    with pytest.raises(ValueError):
        mk.trace_megakernel_batch(camv, 0, packed[:-1].contiguous(), dev.background, **kw)


def _wavefront_args(path, w, h, spp, depth, device):
    scene, _ = loader.load_scene(path)
    feats = scene.features()
    sizes = tuple(feats["mega_sizes"])
    dev = schema.to_device(scene, device)
    camv = camera.make_camv(scene.camera, w, h, 0, spp, max(int(spp ** 0.5), 1), 0).to(device)
    kw = dict(max_depth=depth, sizes=sizes, has_checker=feats["has_checker"],
              has_noise=feats["has_noise"])
    return (camv, 0, mk.pack_buffer(dev, sizes), dev.background), kw


@pytest.mark.parametrize("name,size", [("cornell", 48), ("feature", 32), ("book2", 16)])
def test_wavefront_kernel_matches_plain_and_v4(tmp_path, cuda, name, size):
    """The wavefront kernel against the wavefront driven by its plain step
    (matched-RNG gate), and bitwise against the v4 kernel: both kernels share
    path_common.cuh."""
    args, kw = _wavefront_args(write_scene(tmp_path, name), size, size, 4, 8, cuda)
    n_pix = size * size
    n_rays = -(-n_pix // wf.SLOT_TILE) * wf.SLOT_TILE
    launches = wf.LAUNCHES
    kern = wf.trace_wavefront_batch(*args, n_rays=n_rays, **kw)[:n_pix]
    torch.cuda.synchronize()
    assert wf.LAUNCHES > launches
    plain = wf.trace_wavefront_batch(*args, n_rays=n_rays, step=wf.step_plain, **kw)[:n_pix]
    v4 = mk.trace_megakernel_batch(*args, n_pix=n_pix, **kw)
    kern, plain, v4 = (x.cpu().numpy() / 4 for x in (kern, plain, v4))
    assert np.isfinite(kern).all()
    assert abs(kern.mean() - plain.mean()) < 1e-3
    assert compare.psnr(kern, plain) >= 45.0
    np.testing.assert_array_equal(kern, v4)


def test_wavefront_step_rejects_bad_state(tmp_path, cuda):
    args, kw = _wavefront_args(write_scene(tmp_path, "cornell"), 8, 8, 1, 4, cuda)
    state = wf.init_wavefront_state(128, args[0].tolist(), cuda)
    with pytest.raises(ValueError):
        wf.wavefront_step(state[:16].contiguous(), *args, k_bounces=2, **kw)
    with pytest.raises(ValueError):
        wf.wavefront_step(state.cpu(), *args, k_bounces=2, **kw)


def test_record_ceiling_scene_on_card(tmp_path, cuda):
    """4,096 spheres, the most records the kernel path takes: its tables
    (147 KB of shared memory) launch through the wavefront kernel."""
    p = tmp_path / "spheres.json"
    p.write_text(json.dumps({
        "camera": {"fov": 40, "center": [0, 0, 30], "look_at": [0, 0, 0]},
        "materials": [{"type": "diffuse_light", "albedo": [1.0, 2.0, 3.0]}],
        "primitives": [{"type": "sphere", "center": [0.01 * (i % 64) - 0.3,
                                                     0.01 * (i // 64) - 0.3, 0],
                        "radius": 0.5, "material": 0} for i in range(4096)]}))
    scene, _ = loader.load_scene(str(p))
    launches = wf.LAUNCHES
    r = Renderer(scene, 16, 16, num_samples=1, max_depth=2, device=cuda)
    assert r.kernel == "wavefront_step"
    img = r.render()
    assert wf.LAUNCHES > launches
    assert np.isfinite(img).all() and img.max() == 3.0


def _grad_groups(out, sizes):
    """(name, tensor) per leaf group of a grad_call result: camv, background,
    each table family."""
    cols = mk.unpack_buffer(out[2].cpu(), sizes)
    return [("camv", out[0].cpu()), ("background", out[1].cpu())] + [
        (fam, torch.cat([cols[fam][k] for k in keys])) for fam, keys in mk.FAMILIES]


@pytest.mark.parametrize("name", ["grad_solid", "grad_noise", "grad_media"])
def test_grad_kernel_matches_plain(tmp_path, cuda, name):
    """B3 against the replay under autograd, same inputs and cotangent, at
    32x32, 2 spp, depth 8: per leaf group within 1e-3 of the group's largest
    cotangent (float atomics sum in another order), and the same replayed
    bounces. The launch runs the scene's own instance (its feature mask)."""
    from raytrace2_tpu_torch.ops.kernels import build

    args, kw = _wavefront_args(write_scene(tmp_path, name), 32, 32, 2, 8, cuda)
    mask = mkg.grad_features(args[2], kw["sizes"], kw["has_checker"], kw["has_noise"])
    assert build.load(build.grad_target(mask)).megakernel_grad_features() == mask
    g = torch.from_numpy(np.random.RandomState(5).uniform(0, 1, (32 * 32, 3))
                         .astype(np.float32)).to(cuda)
    counts = [torch.zeros(1, dtype=torch.int64, device=cuda) for _ in range(2)]
    launches = mkg.LAUNCHES
    kern = mkg.grad_call(*args, g, n_pix=32 * 32, bounces=counts[0], **kw)
    torch.cuda.synchronize()
    assert mkg.LAUNCHES == launches + 1
    plain = mkg.grad_plain(*args, g, n_pix=32 * 32, bounces=counts[1], **kw)
    assert int(counts[0]) == int(counts[1]) > 0
    for (what, a), (_, b) in zip(_grad_groups(kern, kw["sizes"]), _grad_groups(plain, kw["sizes"])):
        assert torch.isfinite(a).all(), what
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max()) + 1e-6, what


def test_value_and_grad_on_card(tmp_path, cuda, monkeypatch):
    """The whole gradient path on the card (v4 forward, B3 backward) against
    the same call with the backward's plain version."""
    host, _ = loader.load_scene(write_scene(tmp_path, "grad_noise"))
    feats = host.features()
    scene = schema.to_device(host, cuda)
    kw = dict(width=16, height=12, n_samples=2, max_depth=4, sqrt_spp=1)
    launches = (mk.LAUNCHES, mkg.LAUNCHES)
    loss, g = grad.value_and_grad_scene(torch.mean, scene, feats, 0, **kw)
    assert (mk.LAUNCHES, mkg.LAUNCHES) == (launches[0] + 1, launches[1] + 1)
    monkeypatch.setattr(mkg, "grad_call", mkg.grad_plain)
    loss_p, g_p = grad.value_and_grad_scene(torch.mean, scene, feats, 0, **kw)
    assert float(loss) == float(loss_p)
    for a, b in ((g.materials.albedo, g_p.materials.albedo), (g.materials.param, g_p.materials.param),
                 (g.spheres.center0, g_p.spheres.center0), (g.camera.center, g_p.camera.center)):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max()) + 1e-6


def _b5_rays(scene, size, device, seed=3):
    """Camera rays of a ``size``² image, then the same number of rays from
    seeded points inside the camera's view toward seeded directions (the
    later bounces' kind)."""
    keys = rng.pixel_sample_key(0, torch.arange(size * size, device=device), 0)
    o, d, tm = camera.generate_rays(scene.camera, size, size, 0, 1, keys)
    rs = np.random.RandomState(seed)
    n = size * size
    o2 = torch.from_numpy(rs.uniform(-1, 1, (n, 3)).astype(np.float32)).to(device) * 3.0 + \
        o[:1] * 0.5
    d2 = torch.from_numpy(rs.normal(size=(n, 3)).astype(np.float32)).to(device)
    t2 = torch.from_numpy(rs.uniform(0, 1, n).astype(np.float32)).to(device)
    t_min = torch.full((2 * n,), 1e-3, device=device)
    t_max = torch.full((2 * n,), 3e38, device=device)
    return torch.cat([o, o2]), torch.cat([d, d2]), torch.cat([tm, t2]), t_min, t_max


@pytest.mark.parametrize("name,size", [("book2", 96), ("cornell", 64), ("feature", 48)])
def test_intersect_kernel_matches_plain(tmp_path, cuda, name, size):
    """B5 against its plain version on the same rays: t bitwise, codes equal
    (both run the Pallas kernel's arithmetic without contraction)."""
    scene = schema.to_device(loader.load_scene(write_scene(tmp_path, name))[0], cuda)
    tables = pk.pack_scene(scene.spheres, scene.quads)
    rays = _b5_rays(scene, size, cuda)
    launches = pk.LAUNCHES
    t, code = pk.closest_hit(*rays, *tables)
    torch.cuda.synchronize()
    assert pk.LAUNCHES == launches + 1
    t_p, code_p = pk.closest_hit_plain(*rays, *tables)
    assert int((code >= 0).sum()) > 0
    assert torch.equal(code, code_p)
    assert torch.equal(t.view(torch.int32), t_p.view(torch.int32))


@pytest.mark.parametrize("name", ["book2", "cornell", "b5_ties", "large"])
def test_intersect_kernel_every_group_bitwise(tmp_path, cuda, name):
    """B5 over the live extents against the plain version over the padded
    rows, t bitwise and codes equal: at every lane group G (forced), with
    the whole live table staged and in tiles, at N = 1, 33 and 16,385; on
    the tie scene its exact-t tie rays come first; the >4,096-record scene
    is staged in tiles either way."""
    host, _ = loader.load_scene(write_scene(tmp_path, name))
    scene = schema.to_device(host, cuda)
    tables = pk.pack_scene(scene.spheres, scene.quads)
    n_sph, n_quad = pk.live_extents(host)
    rays = _b5_rays(scene, 91, cuda)  # 16,562 rays
    if name == "b5_ties":
        tie = [torch.from_numpy(x).to(cuda) for x in b5_tie_rays(56)]
        rays = tuple(torch.cat([a, b])[:rays[0].shape[0]] for a, b in zip(tie, rays))
    t_p, code_p = pk.closest_hit_plain(*rays, *tables)
    assert int((code_p >= 0).sum()) > 1000
    for n in (1, 33, 16385):
        part = tuple(x[:n] for x in rays)
        for group in (1, 2, 4, 8, 16, 32):
            for tiles in (False, True):
                launches = pk.LAUNCHES
                t, code = pk.closest_hit(*part, *tables, n_sph=n_sph, n_quad=n_quad,
                                         group=group, tiles=tiles)
                torch.cuda.synchronize()
                assert pk.LAUNCHES == launches + 1
                assert torch.equal(code, code_p[:n]), (n, group, tiles)
                assert torch.equal(t.view(torch.int32), t_p[:n].view(torch.int32)), \
                    (n, group, tiles)


@pytest.mark.parametrize("min_alive", [0, mk3.TILE_R // 16])
def test_megakernel_v3_matches_plain(tmp_path, cuda, min_alive):
    """One B4 pass against its plain version on Cornell camera rays (64², a
    few tiles padded): radiance and every state column bitwise."""
    host, _ = loader.load_scene(write_scene(tmp_path, "cornell"))
    feats = host.features()
    scene = schema.to_device(host, cuda)
    sizes = tuple(feats["mega_sizes"])
    u = rng.murmur_uniforms(integrator.mega_seed_of(0, 0),
                            torch.arange(64 * 64, device=cuda), tuple(range(5)))
    o, d, tm = camera.generate_rays(scene.camera, 64, 64, 0, 1, None, uniforms=u)
    state, rid = mk3.init_state(o, d, tm)
    args = (state, rid, integrator.mega_seed_of(0, 0), min_alive, mk.pack_buffer(scene, sizes),
            scene.background.float())
    kw = dict(max_depth=50, sizes=sizes, has_checker=feats["has_checker"],
              has_noise=feats["has_noise"])
    launches = mk3.LAUNCHES
    rad, new = mk3.megakernel_pass(*args, **kw)
    torch.cuda.synchronize()
    assert mk3.LAUNCHES == launches + 1
    rad_p, new_p = mk3.pass_plain(*args, **kw)
    assert torch.equal(rad, rad_p) and torch.equal(new, new_p)
    live = (new[mk3.COL["alive"]] > 0).view(-1, mk3.TILE_R).sum(1)
    assert int(live.max()) <= min_alive


def test_pallas_and_v3_routes_on_card(tmp_path, cuda):
    """Renderer(backend="pallas") launches B5 on the card and matches the
    dense route; render_sample with use_megakernel launches B4 and matches
    the same call driven by B4's plain pass."""
    host, _ = loader.load_scene(write_scene(tmp_path, "cornell"))
    launches = pk.LAUNCHES
    pallas = Renderer(host, 32, 24, num_samples=2, max_depth=6, backend="pallas",
                      device=cuda).render(batch=2)
    assert pk.LAUNCHES > launches
    dense = Renderer(host, 32, 24, num_samples=2, max_depth=6, backend="xla",
                     device=cuda).render(batch=2)
    flipped = np.abs(pallas - dense).max(-1) > 1e-4
    assert flipped.mean() <= 0.005 and abs(pallas.mean() - dense.mean()) < 1e-3

    feats = dict(host.features(), use_megakernel=True)
    scene = schema.to_device(host, cuda)
    launches = mk3.LAUNCHES
    img = integrator.render_sample(scene, feats, 40, 30, 0, 0, 8, 1)
    assert mk3.LAUNCHES > launches
    orig = mk3.megakernel_pass
    try:
        mk3.megakernel_pass = mk3.pass_plain
        plain = integrator.render_sample(scene, feats, 40, 30, 0, 0, 8, 1)
    finally:
        mk3.megakernel_pass = orig
    assert torch.equal(img, plain)


# ---- B1's options: the cluster skip, the block layout with wave
# regeneration, table Perlin --------------------------------------------------


def _v4_args(path, w, h, spp, depth, device, block=False, **feat):
    scene, _ = loader.load_scene(path)
    feats = dict(scene.features(), **feat)
    sizes = tuple(feats["mega_sizes"])
    dev = schema.to_device(scene, device)
    camv = camera.make_camv(scene.camera, w, h, 0, spp, max(int(spp ** 0.5), 1), 0,
                            **({"block": mk.BLOCK} if block else {})).to(device)
    kw = dict(max_depth=depth, sizes=sizes, has_checker=feats["has_checker"],
              has_noise=feats["has_noise"], ntab=integrator.noise_tables(dev, feats))
    return (camv, 0, mk.pack_buffer(dev, sizes), dev.background), kw


@pytest.mark.parametrize("block,wave_frac", [(False, 1.0), (True, 0.5), (False, 0.5)])
def test_v4_with_the_sweep_matches_plain(tmp_path, cuda, block, wave_frac):
    """v4 on the grid scene (both families clustered) at 40x24, 2 spp,
    depth 8, on each lane layout: bitwise equal to its plain version."""
    args, kw = _v4_args(write_scene(tmp_path, "grid"), 40, 24, 2, 8, cuda, block=block)
    assert mk.hier_flags(kw["sizes"]) == (True, True)
    n_slots, _ = mk.pixel_slots(40, 24, block)
    launches = mk.LAUNCHES
    kern = mk.trace_megakernel_batch(*args, n_pix=n_slots, block=block, wave_frac=wave_frac,
                                     **kw)
    torch.cuda.synchronize()
    assert mk.LAUNCHES == launches + 1
    plain = mk.trace_plain(*args, n_pix=n_slots, block=block, wave_frac=wave_frac, **kw)
    assert torch.isfinite(kern).all() and float(kern.max()) > 0
    assert torch.equal(kern, plain)


@pytest.mark.parametrize("name", ["grid", "noise_spheres"])
def test_wavefront_step_with_the_sweep_matches_plain(tmp_path, cuda, name):
    """Two wavefront launches (K=2, then K=16 on the sorted state) on a
    clustered scene, table noise on the noise scene: bitwise equal to the
    plain step on the same state."""
    args, kw = _v4_args(write_scene(tmp_path, name), 32, 32, 2, 8, cuda,
                        noise_impl="table")
    state = wf.init_wavefront_state(1024, args[0].tolist(), cuda)
    bb = wf.scene_bounds(args[2], kw["sizes"])
    for k in (wf.K_BOUNCES, wf.TAIL_K):
        state = wf.sort_state(state, 2.0, *bb)
        kern = wf.wavefront_step(state.clone(), *args, k_bounces=k, **kw)
        plain = wf.step_plain(state.clone(), *args, k_bounces=k, **kw)
        torch.cuda.synchronize()
        assert torch.equal(kern, plain), k
        state = kern


@pytest.mark.parametrize("name", ["noise_spheres", "feature"])
def test_table_noise_v4_matches_plain(tmp_path, cuda, name):
    """v4 with table noise (one and two noise textures), 32x32, 2 spp,
    depth 8: bitwise equal to its plain version, and unlike hash noise."""
    path = write_scene(tmp_path, name)
    args, kw = _v4_args(path, 32, 32, 2, 8, cuda, noise_impl="table")
    assert kw["ntab"] is not None
    kern = mk.trace_megakernel_batch(*args, n_pix=1024, **kw)
    plain = mk.trace_plain(*args, n_pix=1024, **kw)
    torch.cuda.synchronize()
    assert torch.equal(kern, plain)
    hashed = mk.trace_megakernel_batch(*args, n_pix=1024, **dict(kw, ntab=None))
    assert not torch.equal(kern, hashed)


def test_megakernel_v3_with_the_sweep_matches_plain(tmp_path, cuda):
    """One B4 pass of 1,024 camera rays of the grid scene: bitwise equal to
    its plain pass (both through the cluster skip)."""
    scene, _ = loader.load_scene(write_scene(tmp_path, "grid"))
    feats = scene.features()
    sizes = tuple(feats["mega_sizes"])
    dev = schema.to_device(scene, cuda)
    pix = torch.arange(1024, dtype=torch.int32, device=cuda)
    u = rng.murmur_uniforms(77, pix, tuple(rng.CAMERA_CTR_BASE + k for k in range(5)))
    o, d, tm = camera.generate_rays(dev.camera, 32, 32, 0, 1, None, uniforms=u)
    state, rid = mk3.init_state(o, d, tm)
    kw = dict(max_depth=8, sizes=sizes, has_checker=feats["has_checker"],
              has_noise=feats["has_noise"])
    packed, bg = mk.pack_buffer(dev, sizes), dev.background.to(torch.float32)
    rad_k, new_k = mk3.megakernel_pass(state, rid, 77, 0, packed, bg, **kw)
    rad_p, new_p = mk3.pass_plain(state, rid, 77, 0, packed, bg, **kw)
    torch.cuda.synchronize()
    assert torch.equal(rad_k, rad_p) and torch.equal(new_k, new_p)


@pytest.mark.parametrize("name,feat", [("grid", {}), ("noise_spheres", {"noise_impl": "table"}),
                                       ("grad_noise", {"noise_impl": "table"})])
def test_grad_kernel_with_the_sweep_and_table_noise(tmp_path, cuda, name, feat):
    """B3 against its plain version at 32x32, 2 spp, depth 8: the winner
    search through the cluster skip (grid), table noise's adjoint
    (noise_spheres, grad_noise): per leaf group within 1e-3 of the group's
    largest cotangent, the same replayed bounces."""
    args, kw = _v4_args(write_scene(tmp_path, name), 32, 32, 2, 8, cuda, **feat)
    g = torch.from_numpy(np.random.RandomState(5).uniform(0, 1, (32 * 32, 3))
                         .astype(np.float32)).to(cuda)
    counts = [torch.zeros(1, dtype=torch.int64, device=cuda) for _ in range(2)]
    bg = args[3].to(torch.float32).contiguous()
    kern = mkg.grad_call(*args[:3], bg, g, n_pix=32 * 32, bounces=counts[0], **kw)
    plain = mkg.grad_plain(*args[:3], bg, g, n_pix=32 * 32, bounces=counts[1], **kw)
    torch.cuda.synchronize()
    assert int(counts[0]) == int(counts[1]) > 0
    for (what, a), (_, b) in zip(_grad_groups(kern, kw["sizes"]),
                                 _grad_groups(plain, kw["sizes"])):
        assert torch.isfinite(a).all(), what
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max()) + 1e-6, what


@pytest.mark.parametrize("k", [2, 16])
def test_warp_walk_with_six_orders_and_ties_matches_plain(tmp_path, cuda, k):
    """The step's warp-ordered cluster walk on a state whose warps hold all
    six visit orders (lane j of a warp takes order j % 6), aimed at the tie
    scene's groups of identical records that span clusters: bitwise equal to
    the plain step, which walks each lane's own order."""
    args, kw = _v4_args(write_scene(tmp_path, "ties"), 32, 32, 2, 8, cuda)
    n = 1024
    rs = np.random.RandomState(9)
    targets = np.array([[1.5, 0.5, -1.0], [-4.0, 2.0, 3.0], [-1.5, -0.5, 3.0]])
    t = targets[np.arange(n) % 3] + rs.uniform(-1.2, 1.2, (n, 3))
    order = np.arange(n) % 6
    u = rs.uniform(-0.4, 0.4, (n, 3))
    u[np.arange(n), order // 2] = np.where(order % 2 == 0, 1.0, -1.0)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    state = wf.init_wavefront_state(n, args[0].tolist(), cuda)
    cols = {"ox": t[:, 0] - 18 * u[:, 0], "oy": t[:, 1] - 18 * u[:, 1],
            "oz": t[:, 2] - 18 * u[:, 2], "dx": u[:, 0], "dy": u[:, 1], "dz": u[:, 2],
            "tm": rs.uniform(0, 1, n), "al": np.ones(n), "s_lane": np.zeros(n),
            "tpr": np.ones(n), "tpg": np.ones(n), "tpb": np.ones(n)}
    for name, v in cols.items():
        state[wf.COL[name]] = torch.from_numpy(v.astype(np.float32)).to(cuda)
    d = state[wf.COL["dx"]:wf.COL["dz"] + 1]
    assert torch.equal(mk.sweep_dir(*d).cpu(), torch.from_numpy(order))
    kern = wf.wavefront_step(state.clone(), *args, k_bounces=k, **kw)
    plain = wf.step_plain(state.clone(), *args, k_bounces=k, **kw)
    torch.cuda.synchronize()
    assert torch.equal(kern, plain)


# ---- B1 and B4 redesigned: per-scene instances, persistent v4 -------------


@pytest.mark.parametrize("name,w,h,block", [("cornell", 37, 23, False),
                                            ("feature", 37, 23, False),
                                            ("grid", 41, 19, False),
                                            ("cornell", 37, 23, True)])
def test_persistent_v4_bitwise_at_odd_sizes(tmp_path, cuda, name, w, h, block):
    """The persistent v4 kernel (instant regeneration, each lane fetching
    its next pixel) at odd sizes whose slot count is no multiple of the
    128-thread block, on the linear and the block-tiled layout: bitwise
    equal to its plain version, launched from the scene's own instance."""
    from raytrace2_tpu_torch.ops.kernels import build

    args, kw = _v4_args(write_scene(tmp_path, name), w, h, 3, 8, cuda, block=block)
    n_slots, _ = mk.pixel_slots(w, h, block)
    assert block or n_slots % mk.TILE
    mask = mk.scene_features(args[2], kw["sizes"], kw["has_checker"], kw["has_noise"],
                             kw["ntab"])
    assert build.load(build.feature_target("megakernel_v4", mask)).megakernel_v4_features() \
        == mask
    kern = mk.trace_megakernel_batch(*args, n_pix=n_slots, block=block, **kw)
    plain = mk.trace_plain(*args, n_pix=n_slots, block=block, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(kern).all() and float(kern.max()) > 0
    assert torch.equal(kern, plain)


def test_persistent_v4_counter_is_reset_per_launch(tmp_path, cuda):
    """Two launches in a row on one stream, and two at once on two streams,
    give the plain version's image: each launch zeroes its own pixel
    counter on its own stream."""
    args, kw = _v4_args(write_scene(tmp_path, "cornell"), 96, 80, 2, 8, cuda)
    kw["n_pix"] = 96 * 80
    plain = mk.trace_plain(*args, **kw)
    first = mk.trace_megakernel_batch(*args, **kw)
    second = mk.trace_megakernel_batch(*args, **kw)
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    outs = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(s):
            outs.append(mk.trace_megakernel_batch(*args, **kw))
    torch.cuda.synchronize()
    for img in (first, second, *outs):
        assert torch.equal(img, plain)


@pytest.mark.parametrize("name", ["cornell", "cornell_volume", "feature", "noise_spheres",
                                  "grid"])
def test_megakernel_v3_instances_match_plain(tmp_path, cuda, name):
    """Each scene's B4 instance (its feature mask with hash noise and the
    in-block compaction on flat sweeps; every feature and no compaction on
    a clustered scene, grid) on one pass of 32x32 camera rays, min_alive 8
    and 0: radiance and state bitwise equal to the plain pass; every tile
    leaves with at most min_alive live rays."""
    from raytrace2_tpu_torch.ops.kernels import build

    host, _ = loader.load_scene(write_scene(tmp_path, name))
    feats = host.features()
    sizes = tuple(feats["mega_sizes"])
    dev = schema.to_device(host, cuda)
    pix = torch.arange(1024, dtype=torch.int32, device=cuda)
    u = rng.murmur_uniforms(77, pix, tuple(rng.CAMERA_CTR_BASE + k for k in range(5)))
    o, d, tm = camera.generate_rays(dev.camera, 32, 32, 0, 1, None, uniforms=u)
    state, rid = mk3.init_state(o, d, tm)
    packed, bg = mk.pack_buffer(dev, sizes), dev.background.to(torch.float32)
    types = mk.scene_material_types(dev.materials.mtype)
    mask = mk3.instance_features(packed, sizes, feats["has_checker"], feats["has_noise"], types)
    assert build.load(build.feature_target("megakernel_v3", mask)).megakernel_v3_features() \
        == mask
    kw = dict(max_depth=50, sizes=sizes, has_checker=feats["has_checker"],
              has_noise=feats["has_noise"])
    for min_alive in (mk3.TILE_R // 16, 0):
        rad_k, new_k = mk3.megakernel_pass(state, rid, 77, min_alive, packed, bg,
                                           mat_types=types, **kw)
        rad_p, new_p = mk3.pass_plain(state, rid, 77, min_alive, packed, bg, **kw)
        torch.cuda.synchronize()
        assert torch.equal(rad_k, rad_p) and torch.equal(new_k, new_p), min_alive
        live = (new_k[mk3.COL["alive"]] > 0).view(-1, mk3.TILE_R).sum(1)
        assert int(live.max()) <= min_alive


@pytest.mark.parametrize("kernel", ["v4", "v4_block", "wavefront", "v3", "grad"])
def test_bvh_instances_match_plain(tmp_path, cuda, monkeypatch, kernel):
    """The bvh instances (RT2_SWEEP_MODE=bvh: the threaded-BVH walk) on the
    grid scene against their plain versions in "bvh" mode: v4 on both
    layouts, the wavefront step's K=2 then K=16 launch and one B4 pass
    bitwise, B3 within 1e-3 of the largest cotangent with the same replayed
    bounces."""
    monkeypatch.setattr(mk, "SWEEP_MODE", "bvh")
    block = kernel == "v4_block"
    args, kw = _v4_args(write_scene(tmp_path, "grid"), 40, 24, 2, 8, cuda, block=block)
    kw.pop("ntab")
    assert mk.hier_flags(kw["sizes"]) == (True, True)
    assert mk.table_layout(kw["sizes"])["sbv"][1] == mk.bvh_nodes(kw["sizes"][0])
    n_slots, _ = mk.pixel_slots(40, 24, block)
    if kernel.startswith("v4"):
        kern = mk.trace_megakernel_batch(*args, n_pix=n_slots, block=block,
                                         wave_frac=0.5 if block else 1.0, **kw)
        plain = mk.trace_plain(*args, n_pix=n_slots, block=block,
                               wave_frac=0.5 if block else 1.0, **kw)
        assert float(kern.max()) > 0 and torch.equal(kern, plain)
    elif kernel == "wavefront":
        state = wf.init_wavefront_state(1024, args[0].tolist(), cuda)
        bb = wf.scene_bounds(args[2], kw["sizes"])
        for k in (wf.K_BOUNCES, wf.TAIL_K):
            state = wf.sort_state(state, 2.0, *bb)
            st_k = wf.wavefront_step(state.clone(), *args, k_bounces=k, **kw)
            st_p = wf.step_plain(state.clone(), *args, k_bounces=k, **kw)
            assert torch.equal(st_k, st_p)
            state = st_k
    elif kernel == "v3":
        rs = np.random.RandomState(9)
        o = torch.from_numpy(rs.uniform(-12, 12, (256, 3)).astype(np.float32)).to(cuda)
        d = torch.from_numpy(rs.normal(size=(256, 3)).astype(np.float32)).to(cuda)
        state, rid = mk3.init_state(o, d, torch.zeros(256, device=cuda))
        kern = mk3.megakernel_pass(state, rid, 12345, 0, *args[2:], **kw)
        plain = mk3.pass_plain(state, rid, 12345, 0, *args[2:], **kw)
        assert all(torch.equal(a, b) for a, b in zip(kern, plain))
    else:
        g = torch.from_numpy(np.random.RandomState(5).uniform(0, 1, (40 * 24, 3))
                             .astype(np.float32)).to(cuda)
        counts = [torch.zeros(1, dtype=torch.int64, device=cuda) for _ in range(2)]
        kern = mkg.grad_call(*args, g, n_pix=960, bounces=counts[0], **kw)
        plain = mkg.grad_plain(*args, g, n_pix=960, bounces=counts[1], **kw)
        assert int(counts[0]) == int(counts[1]) > 0
        for a, b in zip(kern, plain):
            assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max()) + 1e-6


def _walk_inputs(tmp_path, name, n, device):
    """The BVH walk's tables of a scene and ``n`` seeded rays on ``device``,
    every 7th with dx = 0, every 11th with dz = 0 and every 13th in the plane
    x = 0 (the slab NaN), with the tree's depth."""
    from raytrace2_tpu_torch.ops import bvh_traverse
    from raytrace2_tpu_torch.scene import bvh

    host, _ = loader.load_scene(write_scene(tmp_path, name))
    tree, depth = bvh.build_sphere_bvh(host.spheres)
    dev = schema.to_device(host, device)
    tables = bvh_traverse.pack(schema.to_device(tree, device), dev.spheres)
    rs = np.random.RandomState(7)
    o = rs.uniform(-8, 8, (n, 3)).astype(np.float32)
    o[:, 1] = rs.uniform(0.05, 3.0, n)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d[::7, 0] = 0.0
    d[::11, 2] = 0.0
    o[::13, 0] = 0.0
    cols = [torch.from_numpy(x).to(device) for x in
            (o, d, rs.uniform(size=n).astype(np.float32), np.full(n, 1e-3, np.float32),
             np.full(n, 3e38, np.float32))]
    return tables, cols, depth


@pytest.mark.parametrize("name,n", [("book1", 65536), ("book2", 16384), ("grid", 1000)])
def test_bvh_walk_matches_plain(tmp_path, cuda, name, n):
    """The walk kernel against its plain version on the card, bitwise, with
    rays parallel to slabs and in slab planes; one launch counted."""
    from raytrace2_tpu_torch.ops import bvh_traverse

    tables, cols, depth = _walk_inputs(tmp_path, name, n, cuda)
    before = bvh_traverse.LAUNCHES
    t, p = bvh_traverse.closest_sphere(tables, *cols, depth)
    torch.cuda.synchronize()
    assert bvh_traverse.LAUNCHES == before + 1
    pt, pp = bvh_traverse.closest_sphere_plain(tables, *cols, depth)
    assert bool((p >= 0).any()) and bool((p < 0).any())
    assert torch.equal(p, pp)
    assert torch.equal(t.view(torch.int32), pt.view(torch.int32))
    with pytest.raises(ValueError, match="stack"):
        bvh_traverse.closest_sphere(tables, *cols, bvh_traverse.MAX_STACK)


def test_bvh_route_launches_the_walk(tmp_path, cuda):
    """``backend="bvh"`` on the card launches the walk; its image against
    the same route on the CPU (the plain walk), by the card-against-CPU gate
    of the non-kernel path: the means within 1e-3, at most 0.5 % of pixels
    apart by more than 1e-4 (a path parted at a transcendental's ulp), at
    least 60 dB over the others."""
    from raytrace2_tpu_torch.ops import bvh_traverse

    scene, _ = loader.load_scene(write_scene(tmp_path, "separated"))
    kw = dict(num_samples=2, max_depth=6, backend="bvh")
    before = bvh_traverse.LAUNCHES
    walk = Renderer(scene, 32, 24, device=cuda, **kw)
    img = walk.render()
    assert (walk.route, walk.kernel) == ("bvh", "bvh_traverse")
    assert bvh_traverse.LAUNCHES > before
    ref = Renderer(scene, 32, 24, device="cpu", **kw).render()
    assert abs(float(img.mean() - ref.mean())) < 1e-3
    flipped = np.abs(img - ref).max(-1) > 1e-4
    assert flipped.mean() <= 0.005
    assert compare.psnr(img[~flipped], ref[~flipped]) >= 60.0
