"""The v4 kernel's plain version vs the JAX package: one bounce on seeded
ray states against ``megakernel._make_bounce`` (called outside any kernel,
as tools/roofline.py does), and the closed-form images of
tests/test_megakernel_v4.py, exact."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace2_tpu.ops.pallas import megakernel as jmk
from raytrace2_tpu.scene import loader as jax_loader
from raytrace2_tpu.scene import schema as jax_schema
from raytrace2_tpu_torch.ops.kernels import megakernel as mk
from raytrace2_tpu_torch.render import Renderer
from raytrace2_tpu_torch.scene import loader, schema
from test_torch_scenes import write_scene

N = 64
MAX_DEPTH = 6
# Ray origins are drawn inside each scene's extent.
BOUNDS = {"cornell": ([10, 10, -100], [545, 545, 545]),
          "feature": ([-4, 0.1, -4], [4, 4, 4])}


def _ray_states(name):
    rs = np.random.RandomState(7)
    lo, hi = BOUNDS[name]
    o = rs.uniform(lo, hi, size=(N, 3))
    d = rs.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d *= rs.uniform(0.5, 1.5, size=(N, 1))  # scatter directions are not unit
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    carry = [f32(rs.randint(0, MAX_DEPTH, N)), f32(rs.uniform(size=N) < 0.85),
             *f32(o.T), *f32(d.T), *f32(rs.uniform(0.1, 1.0, (3, N))),
             *f32(rs.uniform(0.0, 2.0, (3, N)))]
    key = rs.randint(0, 2**32, size=N, dtype=np.uint64).astype(np.uint32)
    tm = f32(rs.uniform(size=N))
    return carry, key, tm


@pytest.mark.parametrize("name", ["cornell", "feature"])
def test_one_bounce_matches_jax(tmp_path, name):
    path = write_scene(tmp_path, name)
    scene, _ = loader.load_scene(path)
    feats = scene.features()
    sizes = tuple(feats["mega_sizes"])
    n_sph, n_quad, n_mat, n_tex, n_med, n_box = sizes
    jscene = jax_schema.to_device(jax_loader.load_scene(path)[0])
    jbounce = jax.jit(jmk._make_bounce(
        *jmk.pack_tables(jscene, sizes), jscene.background, max_depth=MAX_DEPTH,
        n_sph=n_sph, n_quad=n_quad, n_med=n_med, n_mat=n_mat, n_tex=n_tex,
        n_box=n_box, has_checker=feats["has_checker"], has_noise=feats["has_noise"],
        shape=(N,), unroll_py=True))
    dev = schema.to_device(scene, "cpu")
    bounce = mk.make_bounce(
        mk.pack_buffer(dev, sizes), dev.background,
        max_depth=MAX_DEPTH, sizes=sizes, has_checker=feats["has_checker"],
        has_noise=feats["has_noise"])

    carry, key, tm = _ray_states(name)
    pos_ulp = float(np.spacing(np.float32(np.abs(BOUNDS[name]).max())))
    for step in range(3):
        ref = [np.array(x) for x in jbounce(jnp.asarray(key), jnp.asarray(tm),
                                              tuple(jnp.asarray(c) for c in carry))]
        ours = [x.numpy() for x in bounce(torch.from_numpy(key.astype(np.int64)),
                                          torch.from_numpy(tm),
                                          tuple(torch.from_numpy(c) for c in carry))]
        np.testing.assert_array_equal(ours[0], ref[0], err_msg=f"bn, bounce {step}")
        np.testing.assert_array_equal(ours[1], ref[1], err_msg=f"alive, bounce {step}")
        for i, what in enumerate(("o", "o", "o", "d", "d", "d", "tp", "tp", "tp",
                                  "L", "L", "L"), start=2):
            # A hit point o + t·d on a wall through 0 cancels terms at the
            # scene's scale, and XLA fuses it into one FMA: its absolute
            # error is a few ulps of that scale, not of the result.
            atol = 4 * pos_ulp if what == "o" else 1e-6
            np.testing.assert_allclose(ours[i], ref[i], rtol=1e-5, atol=atol,
                                       err_msg=f"{what}, bounce {step}")
        carry = ref  # continue both from the same state


def _render(tmp_path, scene_json, w, h, spp, depth):
    p = tmp_path / "closed.json"
    p.write_text(json.dumps(scene_json))
    scene, _ = loader.load_scene(str(p))
    r = Renderer(scene, w, h, num_samples=spp, max_depth=depth, device="cpu")
    return r.render(batch=spp)


def test_emissive_enclosure_exact(tmp_path):
    img = _render(tmp_path, {
        "background_color": [0, 0, 0],
        "camera": {"fov": 90, "center": [0, 0, 0], "look_at": [0, 0, -1]},
        "materials": [{"type": "diffuse_light", "albedo": [2.0, 3.0, 4.0]}],
        "primitives": [{"type": "sphere", "center": [0, 0, 0], "radius": 10.0,
                        "material": 0}],
    }, 8, 8, 3, 4)
    np.testing.assert_allclose(img, np.broadcast_to([2, 3, 4], img.shape), rtol=1e-5)


def test_lambertian_plane_exact(tmp_path):
    img = _render(tmp_path, {
        "background_color": [1.0, 0.8, 0.6],
        "camera": {"fov": 40, "center": [0, 5, 0], "look_at": [0, 0, -10]},
        "materials": [{"type": "lambertian", "albedo": [0.3, 0.5, 0.7]}],
        "primitives": [{"type": "quad", "q": [-1000, 0, -1000], "u": [2000, 0, 0],
                        "v": [0, 0, 2000], "material": 0}],
    }, 8, 8, 3, 4)
    np.testing.assert_allclose(
        img, np.broadcast_to(np.array([0.3, 0.5, 0.7]) * [1.0, 0.8, 0.6], img.shape),
        rtol=1e-5)


def test_aa_box_family_exact(tmp_path):
    img = _render(tmp_path, {
        "background_color": [0, 0, 0],
        "camera": {"fov": 90, "center": [0, 0, 0], "look_at": [0, 0, -1]},
        "materials": [{"type": "diffuse_light", "albedo": [1.5, 2.5, 3.5]}],
        "primitives": [{"type": "box", "a": [-5, -5, -5], "b": [5, 5, 5], "material": 0}],
    }, 8, 8, 2, 4)
    np.testing.assert_allclose(img, np.broadcast_to([1.5, 2.5, 3.5], img.shape), rtol=1e-5)
