"""Port scene layer vs the JAX package: loader arrays, features(),
``from_jax_scene``, and that the port imports without jax.

Also holds the scenes the other ``test_torch_*`` files share: the canned
scenes of ``tools/make_scene.py`` and one feature scene that reaches every
branch of the v4 kernel (motion blur, metal, dielectric, isotropic media in a
sphere and a box, an AA box, a depth-2 nested checker, Perlin and marble
hash noise, a DoF camera). The JAX package is imported inside the tests
that use it, so that the card-only tests can share these scenes on a
machine without jax."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
sys.path.insert(0, TOOLS)
import make_scene  # noqa: E402

from raytrace2_tpu_torch import interop  # noqa: E402
from raytrace2_tpu_torch.scene import loader, schema  # noqa: E402


def feature_scene_json() -> dict:
    return {
        "background_color": [0.5, 0.6, 0.8],
        "camera": {"fov": 50, "center": [0, 3, 7], "look_at": [0, 0.8, 0],
                   "defocus_angle": 1.5, "focus_distance": 7.0},
        "textures": [
            {"type": "solid_color", "albedo": [0.9, 0.2, 0.1]},
            {"type": "solid_color", "albedo": [0.1, 0.2, 0.9]},
            {"type": "checker", "scale": 0.7, "even_tex_idx": 0, "odd_tex_idx": 1},
            {"type": "checker", "scale": 2.9, "even_tex_idx": 2, "odd_tex_idx": 1},
            {"type": "noise", "albedo": [0.9, 0.9, 0.8], "scale": 1.5, "noise_type": 0},
            {"type": "noise", "albedo": [0.8, 0.7, 0.6], "scale": 2.0, "noise_type": 1},
        ],
        "materials": [
            {"type": "texture", "tex_idx": 3},
            {"type": "metal", "albedo": [0.8, 0.8, 0.9], "fuzz": 0.2},
            {"type": "dielectric", "refraction_index": 1.5},
            {"type": "texture", "tex_idx": 4},
            {"type": "texture", "tex_idx": 5},
            {"type": "diffuse_light", "albedo": [6, 6, 6]},
            {"type": "lambertian", "albedo": [0.6, 0.5, 0.4]},
        ],
        "primitives": [
            # The ground sits off every checker boundary plane (multiples of
            # 0.7 and 2.9): on a boundary, the checker colour of a hit would
            # follow the sign of the hit point's rounding error.
            {"type": "quad", "q": [-20, -0.37, -20], "u": [40, 0, 0], "v": [0, 0, 40],
             "material": 0},
            {"type": "sphere", "center": [-1.5, 1, 0], "displacement": [0, 0.4, 0],
             "radius": 1.0, "material": 1},
            {"type": "sphere", "center": [1.2, 1, 0.5], "radius": 0.8, "material": 2},
            {"type": "sphere", "center": [0, 0.6, 2], "radius": 0.6, "material": 3},
            {"type": "sphere", "center": [2.5, 0.7, -1.5], "radius": 0.7, "material": 4},
            {"type": "box", "a": [-3, 0, -3], "b": [-2, 1.5, -2], "material": 6},
            {"type": "sphere", "center": [0, 1.2, -2], "radius": 1.0, "material": 0,
             "constant_medium": {"density": 0.5, "albedo": [0.8, 0.8, 0.9]}},
            {"type": "box", "a": [1.5, 0, 1.5], "b": [2.5, 1, 2.5], "material": 0,
             "constant_medium": {"density": 0.8, "albedo": [0.9, 0.6, 0.3]}},
            {"type": "quad", "q": [-2, 5, -2], "u": [4, 0, 0], "v": [0, 0, 4],
             "material": 5},
        ],
    }


def book1_final_json(rng_seed: int = 0) -> dict:
    """The final scene of book 1 (Ray Tracing in One Weekend, §14.1) from a
    seeded random stream: a ground sphere, a 22×22 grid of small random
    diffuse, metal and glass spheres, and three large spheres, seen through
    a defocused camera. About 485 spheres, so above the wavefront's
    256-record threshold."""
    rnd = np.random.RandomState(rng_seed)
    scene = make_scene.SceneBuilder()
    scene.add_sphere([0, -1000, 0], 1000, scene.add_lambertian([0.5, 0.5, 0.5]))
    for a in range(-11, 11):
        for b in range(-11, 11):
            choose = rnd.uniform()
            center = [a + 0.9 * rnd.uniform(), 0.2, b + 0.9 * rnd.uniform()]
            if np.linalg.norm(np.subtract(center, [4, 0.2, 0])) <= 0.9:
                continue
            if choose < 0.8:
                mat = scene.add_lambertian((rnd.uniform(size=3) * rnd.uniform(size=3)).tolist())
            elif choose < 0.95:
                mat = scene.add_metal(rnd.uniform(0.5, 1.0, size=3).tolist(),
                                      float(rnd.uniform(0.0, 0.5)))
            else:
                mat = scene.add_dielectric(1.5)
            scene.add_sphere(center, 0.2, mat)
    scene.add_sphere([0, 1, 0], 1.0, scene.add_dielectric(1.5))
    scene.add_sphere([-4, 1, 0], 1.0, scene.add_lambertian([0.4, 0.2, 0.1]))
    scene.add_sphere([4, 1, 0], 1.0, scene.add_metal([0.7, 0.6, 0.5], 0.0))
    for i in range(len(scene.primitives)):
        scene.add_node(None, i)
    scene.background_color = [0.7, 0.8, 1.0]
    scene.camera = {"fov": 20, "center": [13, 2, 3], "look_at": [0, 0, 0],
                    "defocus_angle": 0.6, "focus_distance": 10.0,
                    "width": 600, "aspect_ratio": 1.0}
    return scene.to_json()


# The scenes of the JAX package's gradient tests (tests/test_megakernel_grad.py):
# solid colours only (geometry gradients vanish there), a hash-noise floor
# under a metal sphere, and a medium with a box and a checker.
GRAD_SCENES = {
    "solid": {
        "background_color": [0.55, 0.6, 0.7],
        "camera": {"fov": 50, "center": [0, 1.5, 4], "look_at": [0, 0.5, 0]},
        "materials": [
            {"type": "lambertian", "albedo": [0.7, 0.3, 0.3]},
            {"type": "metal", "albedo": [0.8, 0.8, 0.8], "fuzz": 0.2},
            {"type": "diffuse_light", "albedo": [3, 3, 3]},
        ],
        "primitives": [
            {"type": "sphere", "center": [0, 0.5, 0], "radius": 0.8, "material": 0},
            {"type": "sphere", "center": [1.3, 0.4, 0.5], "radius": 0.4, "material": 1},
            {"type": "quad", "q": [-20, 0, -20], "u": [40, 0, 0], "v": [0, 0, 40],
             "material": 0},
            {"type": "quad", "q": [-1, 3, -1], "u": [2, 0, 0], "v": [0, 0, 2], "material": 2},
        ],
    },
    "noise": {
        "background_color": [0.7, 0.75, 0.8],
        "camera": {"fov": 42, "center": [0, 2, 5], "look_at": [0, 0.5, 0]},
        "textures": [{"type": "noise", "albedo": [0.85, 0.8, 0.75], "scale": 0.6,
                      "noise_type": 0}],
        "materials": [
            {"type": "texture", "tex_idx": 0},
            {"type": "metal", "albedo": [0.9, 0.9, 0.9], "fuzz": 0.0},
        ],
        "primitives": [
            {"type": "quad", "q": [-30, 0, -30], "u": [60, 0, 0], "v": [0, 0, 60],
             "material": 0},
            {"type": "sphere", "center": [0, 1.0, 0], "radius": 0.9, "material": 1},
        ],
    },
    "media": {
        "background_color": [0.4, 0.45, 0.55],
        "camera": {"fov": 50, "center": [0, 2, 6], "look_at": [0, 0.8, 0]},
        "textures": [
            {"type": "solid_color", "albedo": [0.9, 0.2, 0.2]},
            {"type": "solid_color", "albedo": [0.2, 0.9, 0.2]},
            {"type": "checker", "scale": 2.0, "even_tex_idx": 0, "odd_tex_idx": 1},
        ],
        "materials": [
            {"type": "texture", "tex_idx": 2},
            {"type": "lambertian", "albedo": [0.6, 0.6, 0.7]},
        ],
        "primitives": [
            {"type": "quad", "q": [-20, 0, -20], "u": [40, 0, 0], "v": [0, 0, 40],
             "material": 0},
            {"type": "box", "a": [-2.5, 0, -1], "b": [-1.0, 1.2, 0.2], "material": 1},
            {"type": "sphere", "center": [1.2, 0.9, 0], "radius": 0.9, "material": 0,
             "constant_medium": {"density": 0.8, "albedo": [0.3, 0.5, 0.9]}},
        ],
    },
}

SCENES = {
    "cornell": lambda: make_scene.cornell_box_original().to_json(),
    "cornell_volume": lambda: make_scene.cornell_box_volume().to_json(),
    "book1": book1_final_json,
    "book2": lambda: make_scene.book2_final(rng_seed=0).to_json(),
    "feature": feature_scene_json,
    **{f"grad_{k}": (lambda v=v: v) for k, v in GRAD_SCENES.items()},
}


def write_scene(tmp_path, name: str) -> str:
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(SCENES[name]()))
    return str(path)


def _assert_tree_equal(a, b, where="scene"):
    """Every leaf of two scene dataclasses equal, array for array."""
    import dataclasses

    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _assert_tree_equal(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
        return
    if a is None or b is None:
        assert a is None and b is None, where
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=where)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_loader_matches_jax(tmp_path, name):
    from raytrace2_tpu.scene import loader as jax_loader

    path = write_scene(tmp_path, name)
    ours, dims = loader.load_scene(path, seed=3)
    ref, ref_dims = jax_loader.load_scene(path, seed=3)
    assert dims == ref_dims
    _assert_tree_equal(ours, ref)
    assert ours.features() == ref.features()


def test_cornell_sizes_and_feature_gates(tmp_path):
    scene, dims = loader.load_scene(write_scene(tmp_path, "cornell"))
    assert dims == (600, 600)
    assert scene.features()["mega_sizes"] == (0, 18, 5, 1, 0, 0)
    feat = loader.load_scene(write_scene(tmp_path, "feature"))[0].features()
    assert feat["mega_sizes"] == (4, 2, 9, 9, 2, 1)
    assert feat["has_checker"] == 2 and feat["has_noise"] and feat["has_media"]


def test_legacy_format_and_transforms(tmp_path):
    """Legacy dict primitives with a by-name camera file, and a new-format
    graph with nested TRS transforms and an ellipsoid (non-uniform scale)."""
    from raytrace2_tpu.scene import loader as jax_loader

    (tmp_path / "cam1.json").write_text(json.dumps(
        {"fov": 30, "center": [1, 2, 3], "look_at": [0, 0, 0]}))
    legacy = {
        "camera": "cam1",
        "materials": [{"type": "lambertian", "albedo": [0.5, 0.5, 0.5]}],
        "primitives": {"spheres": [{"center": [0, 0, 0], "radius": 1, "material_id": 0}],
                       "quads": [{"q": [0, 0, 0], "u": [1, 0, 0], "v": [0, 1, 0],
                                  "material_id": 0}],
                       "boxes": [{"a": [0, 0, 0], "b": [1, 2, 3], "material_id": 0}]},
    }
    graph = {
        "materials": [{"type": "lambertian", "albedo": [0.5, 0.5, 0.5]}],
        "primitives": [{"type": "sphere", "radius": 1, "material": 0},
                       {"type": "box", "a": [0, 0, 0], "b": [1, 1, 1], "material": 0}],
        "scene": [{"transform": {"translation": [1, 2, 3], "rotation": [30, 0, 1, 0]},
                   "children": [{"primitive": 1},
                                {"transform": {"scale": [1, 2, 1]}, "primitive": 0}]}],
    }
    for i, obj in enumerate((legacy, graph)):
        p = tmp_path / f"s{i}.json"
        p.write_text(json.dumps(obj))
        ours, _ = loader.load_scene(str(p))
        ref, _ = jax_loader.load_scene(str(p))
        _assert_tree_equal(ours, ref)
        assert ours.features() == ref.features()
    assert ours.features()["mega_sizes"] is None  # the ellipsoid


def test_bad_scene_raises(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"materials": [{"type": "plastic"}], "primitives": []}))
    with pytest.raises(loader.SceneError):
        loader.load_scene(str(p))


@pytest.mark.parametrize("name", ["cornell", "feature"])
def test_from_jax_scene_equals_port_load(tmp_path, name):
    from raytrace2_tpu.scene import loader as jax_loader
    from raytrace2_tpu.scene import schema as jax_schema

    path = write_scene(tmp_path, name)
    ref, _ = jax_loader.load_scene(path)
    ours, _ = loader.load_scene(path)
    _assert_tree_equal(interop.from_jax_scene(jax_schema.to_device(ref)), ours)


def test_camera_file_roundtrip(tmp_path):
    scene, _ = loader.load_scene(write_scene(tmp_path, "feature"))
    p = tmp_path / "cam.json"
    loader.write_camera(scene.camera, str(p))
    _assert_tree_equal(loader.load_camera_file(str(p)), scene.camera)


def test_to_device_keeps_dtypes(tmp_path):
    import torch

    scene, _ = loader.load_scene(write_scene(tmp_path, "feature"))
    dev = schema.to_device(scene, "cpu")
    assert dev.spheres.center0.dtype == torch.float32
    assert dev.spheres.material.dtype == torch.int32
    assert dev.spheres.active.dtype == torch.bool
    assert dev.camera.vfov.shape == ()
    assert dev.features() == scene.features()


def test_port_imports_without_jax():
    """Every port module, the CLI included, imports with jax blocked."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import raytrace2_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert 'raytrace2_tpu_torch.app' in names, names\n"
        "assert not any(m == 'raytrace2_tpu' or m.startswith('raytrace2_tpu.') for m in sys.modules)\n"
        "print(len(names))\n"
    )
    root = os.path.dirname(TOOLS)
    env = dict(os.environ, PYTHONPATH=root)
    r = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 14
