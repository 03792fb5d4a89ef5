"""The gradient kernel's scene feature masks and the material types its
main path reads for them, the inverse visit-order tables of the wavefront
step's warp-ordered walk, and the profiling tools' refusal without a card.

A scene's gradient kernel is built for its feature mask
(``megakernel_grad.feature_mask``), so the mask must hold every record
family, material type, texture kind and noise kind the scene holds: checked
here against the JAX loader's ``FlatScene`` of the same JSON, for every
scene of ``test_torch_scenes`` (Cornell and book 2 from
``tools/make_scene.py`` among them)."""

import numpy as np
import pytest
import torch

from raytrace2_tpu_torch import defs
from raytrace2_tpu_torch.ops.kernels import megakernel as mk
from raytrace2_tpu_torch.ops.kernels import megakernel_grad as mkg
from raytrace2_tpu_torch.scene import loader, schema
from raytrace2_tpu_torch.tools import profile_grad, profile_wavefront
from test_torch_scenes import SCENES, write_scene

# Scenes on the kernel path (an ellipsoid scene takes the non-kernel path).
KERNEL_SCENES = sorted(n for n in SCENES if n != "ellipsoid")


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


def test_profilers_refuse_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_wavefront.main(["--res", "8"])
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_grad.main(["--res", "8"])
