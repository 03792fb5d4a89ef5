"""The kernels' scene feature masks and the material types their main paths
read for them, the instance each wrapper picks, the plain B4 pass's stop,
the inverse visit-order tables of the wavefront step's warp-ordered walk,
and the profiling tools' refusal without a card.

A scene's v4, B4 and gradient kernels are each built for its feature mask
(``megakernel.scene_features``, re-exported as
``megakernel_grad.grad_features``), so the mask must hold every record
family, material type, texture kind and noise kind the scene holds: checked
here against the JAX loader's ``FlatScene`` of the same JSON, for every
scene of ``test_torch_scenes`` (Cornell and book 2 from
``tools/make_scene.py`` among them)."""

import numpy as np
import pytest
import torch

from raytrace2_tpu_torch import defs
from raytrace2_tpu_torch.ops import camera, integrator, rng
from raytrace2_tpu_torch.ops.kernels import build
from raytrace2_tpu_torch.ops.kernels import megakernel as mk
from raytrace2_tpu_torch.ops.kernels import megakernel_grad as mkg
from raytrace2_tpu_torch.ops.kernels import megakernel_v3 as mk3
from raytrace2_tpu_torch.render import Renderer
from raytrace2_tpu_torch.scene import loader, schema
from raytrace2_tpu_torch.tools import profile_grad, profile_wavefront, roofline
from test_torch_scenes import SCENES, write_scene

# Scenes on the kernel path (an ellipsoid scene and one of more than 4,096
# records take the non-kernel path).
KERNEL_SCENES = sorted(n for n in SCENES if n not in ("ellipsoid", "large"))


def _port(path):
    host, _ = loader.load_scene(path)
    feats = host.features()
    sizes = tuple(feats["mega_sizes"])
    packed = mk.pack_buffer(schema.to_device(host, "cpu"), sizes)
    return feats, sizes, packed


@pytest.mark.parametrize("name", KERNEL_SCENES)
def test_feature_mask_covers_the_scene(tmp_path, name):
    from raytrace2_tpu.scene import loader as jax_loader

    path = write_scene(tmp_path, name)
    feats, sizes, packed = _port(path)
    ref, _ = jax_loader.load_scene(path)
    ttypes = np.asarray(ref.textures.ttype)
    mtypes = np.asarray(ref.materials.mtype)
    need = {
        mkg.F_SPH: np.asarray(ref.spheres.active).any(),
        mkg.F_QUAD: np.asarray(ref.quads.active).any(),
        mkg.F_BOX: np.asarray(ref.boxes.active).any(),
        mkg.F_MED: np.asarray(ref.media.active).any(),
        mkg.F_CHECKER: (ttypes == defs.TEX_CHECKER).any(),
        mkg.F_METAL: (mtypes == defs.MAT_METAL).any(),
        mkg.F_DIEL: (mtypes == defs.MAT_DIELECTRIC).any(),
    }
    noisy = bool((ttypes == defs.TEX_NOISE).any())
    for table in (False, True):
        ntab = mk.pack_noise_tables(schema.to_device(loader.load_scene(path)[0], "cpu"),
                                    tuple(feats["noise_rows"])) if table and noisy else None
        mask = mkg.grad_features(packed, sizes, feats["has_checker"], feats["has_noise"], ntab)
        for bit, needed in need.items():
            assert not needed or mask & bit, (name, bit)
        noise_bit = mkg.F_TABLE_NOISE if ntab is not None else mkg.F_HASH_NOISE
        assert not noisy or mask & noise_bit, name
        # The types the kernel always holds: Lambertian, textured, light, isotropic.
        assert set(mtypes.tolist()) <= {defs.MAT_LAMBERTIAN, defs.MAT_TEXTURE,
                                        defs.MAT_DIFFUSE_LIGHT, defs.MAT_ISOTROPIC,
                                        *((defs.MAT_METAL,) if mask & mkg.F_METAL else ()),
                                        *((defs.MAT_DIELECTRIC,) if mask & mkg.F_DIEL else ())}
    if name == "cornell":
        assert mask == mkg.F_QUAD  # the quad test, its materials and the background only


@pytest.mark.parametrize("name", KERNEL_SCENES)
def test_scene_material_types_give_the_packed_mask(tmp_path, name):
    """The gradient's main path takes the material types from the scene's
    ``mtype`` leaf, read once per tensor: the mask equals the one read from
    the packed tables, and a second read of the same leaf is cached."""
    feats, sizes, packed = _port(write_scene(tmp_path, name))
    scene = schema.to_device(loader.load_scene(write_scene(tmp_path, name))[0], "cpu")
    types = mkg.scene_material_types(scene.materials.mtype)
    assert types == mkg.material_types(packed, sizes)
    assert mkg.scene_material_types(scene.materials.mtype) is types
    assert mkg.grad_features(packed, sizes, feats["has_checker"], feats["has_noise"],
                             mat_types=types) == mkg.grad_features(
        packed, sizes, feats["has_checker"], feats["has_noise"])


@pytest.mark.parametrize("name", ["book2", "clustered", "grid", "ties"])
def test_inverse_visit_orders(tmp_path, name):
    """``iord``/``ilord``, packed after every table the other kernels stage,
    are the inverse permutations of ``ord`` (superclusters) and ``lord``
    (clusters inside their supercluster) of ``megakernel.cluster_tables``,
    per direction."""
    _, sizes, packed = _port(write_scene(tmp_path, name))
    cols = mk.unpack_buffer(packed, sizes)
    layout = mk.table_layout(sizes)
    inverse = {fam for fam, _ in mk.INVERSE_FAMILIES}
    staged = sum(len(keys) * layout[fam][1] for fam, keys in mk.ALL_FAMILIES
                 if fam not in inverse)
    assert min(layout[fam][0] for fam in inverse) == staged
    ratio = mk.SUPER // mk.CLUSTER
    checked = 0
    for f, on in zip("sb", mk.hier_flags(sizes)):
        if not on:
            continue
        n_cl, n_l2 = mk.cluster_counts(sizes[0] if f == "s" else sizes[5])
        ords = cols[f + "ord"]["ord"].view(6, n_l2).long()
        lords = cols[f + "lord"]["lord"].view(6, n_cl).long()
        iord = cols[f + "iord"]["iord"].view(6, n_l2).long()
        ilord = cols[f + "ilord"]["ilord"].view(6, n_cl).long()
        for d in range(6):
            assert torch.equal(iord[d][ords[d]], torch.arange(n_l2))
            assert torch.equal(ilord[d][lords[d]], torch.arange(n_cl) % ratio)
            # lord keeps each supercluster's clusters in its own slice.
            assert torch.equal(lords[d] // ratio, torch.arange(n_cl) // ratio)
        checked += 1
    assert checked


@pytest.mark.parametrize("name", KERNEL_SCENES)
def test_forward_instances_share_the_gradient_mask(tmp_path, name):
    """v4's instance for a scene is B3's (the same function, the same ntab:
    table noise where the scene takes it), and B4's is B3's without table
    noise (B4 always takes hash noise) on a scene whose families all sweep
    flat, the all-features one on a clustered scene; each covers the JAX
    loader's FlatScene of the scene."""
    from raytrace2_tpu.scene import loader as jax_loader

    path = write_scene(tmp_path, name)
    feats, sizes, packed = _port(path)
    ref, _ = jax_loader.load_scene(path)
    scene = schema.to_device(loader.load_scene(path)[0], "cpu")
    noisy = bool(feats["has_noise"])
    ntab = integrator.noise_tables(scene, dict(feats, noise_impl="table")) if noisy else None
    args = (packed, sizes, feats["has_checker"], feats["has_noise"])
    for tables in (None, ntab):
        v4 = mk.scene_features(*args, tables)
        assert v4 == mkg.grad_features(*args, tables)
        assert v4 & mk.F_QUAD or not np.asarray(ref.quads.active).any()
    v3 = mk.scene_features(*args, None)
    assert v3 == mkg.grad_features(*args)
    # B4's instance: this mask where the pass compacts (flat sweeps), every
    # feature on a clustered scene.
    assert mk3.instance_features(*args) == (mk.F_ALL if any(mk.hier_flags(sizes)) else v3)
    assert not v3 & mk.F_TABLE_NOISE
    assert bool(v3 & mk.F_HASH_NOISE) == noisy
    assert bool(v3 & mk.F_SPH) == bool(np.asarray(ref.spheres.active).any())
    assert bool(v3 & mk.F_BOX) == bool(np.asarray(ref.boxes.active).any())
    assert bool(v3 & mk.F_MED) == bool(np.asarray(ref.media.active).any())
    if name == "cornell":
        assert v3 == v4 == mk.F_QUAD


def test_wrappers_pick_the_instance_without_a_host_read(tmp_path, monkeypatch):
    """Each per-scene kernel's build target is (name, ("<DEFINE>=<mask>",)),
    one library per mask; with the scene's material types cached, picking
    the instance reads nothing from the tensors (no .tolist, .unique,
    .item, .cpu or bool of a tensor); the Renderer reads the types from the
    host scene before the scene goes to its device."""
    feats, sizes, packed = _port(write_scene(tmp_path, "book2"))
    scene = schema.to_device(loader.load_scene(write_scene(tmp_path, "book2"))[0], "cpu")
    types = mk.scene_material_types(scene.materials.mtype)
    mask = mk.scene_features(packed, sizes, feats["has_checker"], feats["has_noise"])
    for name, define in (("megakernel_v4", "V4_FEATURES"), ("megakernel_v3", "V3_FEATURES"),
                         ("megakernel_grad", "GRAD_FEATURES")):
        assert build.feature_target(name, mask) == (name, (f"{define}={mask}",))
        assert build.library_path(build.feature_target(name, mask)) \
            != build.library_path(build.feature_target(name, mk.F_QUAD))
    assert build.grad_target(mask) == build.feature_target("megakernel_grad", mask)

    def refuse(*a, **k):
        raise AssertionError("host read")

    for attr in ("tolist", "unique", "item", "cpu", "__bool__", "numpy"):
        monkeypatch.setattr(torch.Tensor, attr, refuse)
    assert mk.scene_material_types(scene.materials.mtype) is types
    assert mk.scene_features(packed, sizes, feats["has_checker"], feats["has_noise"],
                             mat_types=types) == mask
    monkeypatch.undo()
    r = Renderer(loader.load_scene(write_scene(tmp_path, "cornell"))[0], 8, 8, device="cpu")
    assert r._features["mat_types"] == frozenset(
        float(t) for t in r.scene.materials.mtype.unique().tolist())


def test_v3_plain_pass_stops_per_tile(tmp_path):
    """The plain B4 pass stops each tile of TILE_R rays at min_alive, as the
    kernel's block count does: after a pass no tile has more live rays than
    min_alive, every ray has bounced, and a run dry (min_alive 0) leaves
    none alive."""
    feats, sizes, packed = _port(write_scene(tmp_path, "cornell"))
    scene = schema.to_device(loader.load_scene(write_scene(tmp_path, "cornell"))[0], "cpu")
    n = 4 * mk3.TILE_R
    u = rng.murmur_uniforms(5, torch.arange(n, dtype=torch.int32),
                            tuple(rng.CAMERA_CTR_BASE + k for k in range(5)))
    o, d, tm = camera.generate_rays(scene.camera, 32, 16, 0, 1, None, uniforms=u)
    state, rid = mk3.init_state(o, d, tm)
    kw = dict(max_depth=50, sizes=sizes, has_checker=feats["has_checker"],
              has_noise=feats["has_noise"])
    for min_alive in (mk3.TILE_R // 16, 0):
        _, new = mk3.pass_plain(state, rid, 5, min_alive, packed, scene.background.float(),
                                **kw)
        live = (new[mk3.COL["alive"]] > 0).view(-1, mk3.TILE_R).sum(1)
        assert int(live.max()) <= min_alive
        assert int((new[mk3.COL["bounce"]] > 0).sum()) == n


def test_profilers_refuse_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_wavefront.main(["--res", "8"])
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_grad.main(["--res", "8"])


@pytest.mark.parametrize("mode", ["ceilings", "split"])
def test_roofline_refuses_without_a_card(monkeypatch, mode):
    """tools/roofline.py measures the card; without one both modes raise
    (and the functions they run raise too)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        roofline.main(["--mode", mode])
    with pytest.raises(RuntimeError, match="CUDA"):
        (roofline.ceilings if mode == "ceilings" else roofline.split)(1)
