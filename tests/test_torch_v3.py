"""The v3 state-passing kernel B4 on the CPU: its driver with the plain
pass against the JAX package's ``trace_megakernel`` run in interpret mode,
phased against a single pass, the closed-form images of
tests/test_megakernel.py through ``render_sample`` with ``use_megakernel``,
and that route against the port's v4 kernel path, whose streams it shares."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace2_tpu.ops import camera as jax_camera
from raytrace2_tpu.ops import rng as jax_rng
from raytrace2_tpu.ops.pallas import megakernel as jmk
from raytrace2_tpu.scene import loader as jax_loader
from raytrace2_tpu.scene import schema as jax_schema
from raytrace2_tpu_torch import interop
from raytrace2_tpu_torch.ops import integrator
from raytrace2_tpu_torch.ops.kernels import megakernel as mk
from raytrace2_tpu_torch.ops.kernels import megakernel_v3 as mk3
from raytrace2_tpu_torch.render import Renderer
from raytrace2_tpu_torch.scene import loader, schema
from test_torch_scenes import write_scene
from test_torch_xla_path import _gate

SEED, SAMPLE = 3, 1


def _cornell_tile(tmp_path, side=64):
    """One 4,096-ray tile of Cornell camera rays on the murmur camera
    streams of (SEED, SAMPLE), as render_sample draws them for B4."""
    jhost, _ = jax_loader.load_scene(write_scene(tmp_path, "cornell"))
    jscene = jax_schema.to_device(jhost)
    seed_lane = integrator.mega_seed_of(SEED, SAMPLE)
    u = jax_rng.murmur_uniforms(jnp.int32(seed_lane), jnp.arange(side * side, dtype=jnp.int32),
                                tuple(jax_rng.CAMERA_CTR_BASE + k for k in range(5)))
    rays = jax_camera.generate_rays(jscene.camera, side, side, SAMPLE, 1, None, uniforms=u)
    scene = schema.to_device(interop.from_jax_scene(jhost), "cpu")
    return jscene, scene, jhost.features(), seed_lane, [np.asarray(x) for x in rays]


def _trace(scene, feats, rays, seed_lane, depth, **kw):
    sizes = tuple(feats["mega_sizes"])
    return mk3.trace_megakernel(
        *(torch.from_numpy(x.copy()) for x in rays), seed_lane, mk.pack_buffer(scene, sizes),
        scene.background, max_depth=depth, sizes=sizes, has_checker=feats["has_checker"],
        has_noise=feats["has_noise"], **kw)


@pytest.mark.kernel
def test_plain_matches_jax_trace_megakernel(tmp_path):
    """4,096 Cornell rays at depth 8 through the port's driver (phases 2,
    ratio 16, the integrator's settings) with the plain pass, against the
    JAX package's driver and Pallas kernel in interpret mode: the image gate on
    the 64² image (the two share every stream; XLA contracts multiply-adds,
    torch does not)."""
    jscene, scene, feats, seed_lane, rays = _cornell_tile(tmp_path)
    sizes = tuple(feats["mega_sizes"])
    ref = jmk.trace_megakernel(
        *(jnp.asarray(x) for x in rays), seed_lane, jmk.pack_tables(jscene, sizes),
        jscene.background, max_depth=8, has_checker=feats["has_checker"],
        has_noise=feats["has_noise"], sizes=sizes, interpret=True, phases=2,
        compaction_ratio=16)
    ours = _trace(scene, feats, rays, seed_lane, 8, phases=2, compaction_ratio=16)
    _gate(ours.numpy().reshape(64, 64, 3), np.asarray(ref).reshape(64, 64, 3))


def test_phased_equals_single_pass(tmp_path):
    """Compaction between passes (32 tiles leave at most 8 live rays each, so
    the second pass runs on 256 slots) changes no ray's path: bitwise equal
    to one pass run dry, and to three phases of ratio 4."""
    _, scene, feats, seed_lane, rays = _cornell_tile(tmp_path)
    one = _trace(scene, feats, rays, seed_lane, 12, phases=1)
    two = _trace(scene, feats, rays, seed_lane, 12, phases=2, compaction_ratio=16)
    three = _trace(scene, feats, rays, seed_lane, 12, phases=3, compaction_ratio=4)
    assert float(one.mean()) > 0.1
    assert torch.equal(one, two) and torch.equal(one, three)


def _closed_form_scene(tmp_path, obj):
    p = tmp_path / "m.json"
    p.write_text(json.dumps(obj))
    host, _ = loader.load_scene(str(p))
    return schema.to_device(host, "cpu"), dict(host.features(), use_megakernel=True)


def _render_b4(scene, feats, w, h, spp, depth):
    acc = sum(integrator.render_sample(scene, feats, w, h, s, 0, depth, max(int(np.sqrt(spp)), 1))
              for s in range(spp))
    return (acc / spp).numpy()


def test_emissive_enclosure_exact(tmp_path):
    """Inside an emissive sphere every camera ray sees the light."""
    scene, feats = _closed_form_scene(tmp_path, {
        "background_color": [0, 0, 0],
        "camera": {"fov": 90, "center": [0, 0, 0], "look_at": [0, 0, -1]},
        "materials": [{"type": "diffuse_light", "albedo": [2.0, 3.0, 4.0]}],
        "primitives": [{"type": "sphere", "center": [0, 0, 0], "radius": 10.0, "material": 0}],
    })
    img = _render_b4(scene, feats, 8, 8, 2, 4)
    np.testing.assert_allclose(img, np.broadcast_to([2, 3, 4], img.shape), rtol=1e-5)


def test_lambertian_plane_exact(tmp_path):
    """A floor under the sky: albedo × background whatever the scatter."""
    scene, feats = _closed_form_scene(tmp_path, {
        "background_color": [1.0, 0.8, 0.6],
        "camera": {"fov": 40, "center": [0, 5, 0], "look_at": [0, 0, -10]},
        "materials": [{"type": "lambertian", "albedo": [0.3, 0.5, 0.7]}],
        "primitives": [{"type": "quad", "q": [-1000, 0, -1000], "u": [2000, 0, 0],
                        "v": [0, 0, 2000], "material": 0}],
    })
    img = _render_b4(scene, feats, 8, 8, 2, 4)
    np.testing.assert_allclose(
        img, np.broadcast_to(np.array([0.3, 0.5, 0.7]) * [1.0, 0.8, 0.6], img.shape), rtol=1e-4)


def test_b4_route_matches_v4(tmp_path):
    """render_sample with use_megakernel (B4) and the v4 kernel path render
    Cornell on the same streams: rid and seed_lane make v4's sample key. The
    camera rays differ in rounding only (torch vs the kernel's camv
    arithmetic), so the image gate, at 32², 4 spp, depth 8."""
    host, _ = loader.load_scene(write_scene(tmp_path, "cornell"))
    v4 = Renderer(host, 32, 32, num_samples=4, max_depth=8, seed=SEED, device="cpu")
    assert v4.kernel == "megakernel_v4"
    feats = dict(host.features(), use_megakernel=True)
    scene = schema.to_device(host, "cpu")
    acc = sum(integrator.render_sample(scene, feats, 32, 32, s, SEED, 8, 2) for s in range(4))
    _gate((acc / 4).numpy(), v4.render(batch=4))
