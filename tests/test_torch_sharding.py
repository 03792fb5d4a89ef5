"""The sharded entry points (``parallel/sharding.py``) on gloo ranks on the CPU,
2 and 4 processes, against the JAX package's ``render_samples_sharded`` on
the same mesh of host devices (``tests/conftest.py`` forces 8), against
JAX's single-device ``jax.value_and_grad`` of ``grad.render_image`` (which
JAX's own test holds its ``render_grad_sharded`` to), and against the port's
own single-device renders and gradients:

* the non-kernel render at meshes (2, 2) and (1, 4), 16² and 9×7 (a pad),
  at rtol 2e-4, atol 2e-5, and with ``use_pallas`` (B5) at (1, 2) against
  the single-device ``pallas`` route;
* the kernel path (the plain v4, on the linear and the block-tiled layout,
  and the plain wavefront): dp meshes bitwise the single-device image, sp
  meshes within 1e-6 relative (the order of the sum);
* the scan's sharded gradient within 1e-3 of each leaf group's largest
  cotangent, and the kernel route's (the plain v4 forward, the plain B3
  backward) under B3's gate against ``grad.value_and_grad_scene``;
* every rank holds the whole image, the same loss and the same gradient.

Each group of ranks is spawned once (``parallel.dryrun.run_ranks``, a
``file://`` rendezvous in a temporary directory, a timeout on every
collective) and runs every case of its world size; the ranks run
``torch_sharding_ranks.run_cases``, which imports no jax."""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace2_tpu import grad as jax_grad
from raytrace2_tpu.parallel import sharding as jax_sharding
from raytrace2_tpu.scene import loader as jax_loader
from raytrace2_tpu.scene import schema as jax_schema
from raytrace2_tpu_torch import grad
from raytrace2_tpu_torch.ops import integrator
from raytrace2_tpu_torch.ops.kernels import intersect_kernel as pk
from raytrace2_tpu_torch.parallel import distributed, dryrun, sharding
from raytrace2_tpu_torch.scene import loader, schema
from test_torch_grad_scan import GROUPS, _assert_grads_close, _group
from test_torch_scenes import write_scene
from torch_sharding_ranks import run_cases

RTOL, ATOL = 2e-4, 2e-5
MEGA = {"use_megakernel": True}
R = dict(max_depth=4, sqrt_spp=1)


def _target(w, h):
    return np.random.RandomState(1).uniform(size=(h, w, 3)).astype(np.float32)


def _cases(paths, world):
    c, ell = paths["cornell"], paths["ellipsoid"]
    g = dict(max_depth=3, sqrt_spp=1)
    if world == 4:
        return [
            ("xla_2x2", "render_samples_sharded", c, {}, (2, 2),
             dict(width=16, height=16, samples_per_device=1, **R)),
            ("xla_1x4_pad", "render_samples_sharded", c, {}, (1, 4),
             dict(width=9, height=7, samples_per_device=2, **R)),
            ("v4_1x4", "render_samples_sharded_mega", c, MEGA, (1, 4),
             dict(width=16, height=16, samples_per_device=2, **R)),
            ("v4_2x2", "render_samples_sharded_mega", c, MEGA, (2, 2),
             dict(width=16, height=16, samples_per_device=1, **R)),
            ("wf_1x4", "render_samples_sharded_mega", c, dict(MEGA, mega_wavefront=True),
             (1, 4), dict(width=32, height=16, samples_per_device=2, **R)),
            ("block_1x4", "render_samples_sharded_mega", c, dict(MEGA, mega_linear=False),
             (1, 4), dict(width=32, height=32, samples_per_device=1, **R)),
            ("grad_2x2_pad", "render_grad_sharded", c, {}, (2, 2),
             dict(width=9, height=7, n_samples=2, target=_target(9, 7), **g)),
            ("grad_mega_2x2", "render_grad_sharded_mega", c, MEGA, (2, 2),
             dict(width=16, height=16, n_samples=2, target=_target(16, 16), **g)),
            ("grad_mega_1x4", "render_grad_sharded_mega", c, MEGA, (1, 4),
             dict(width=16, height=16, n_samples=2, target=_target(16, 16), **g)),
            ("auto_ell_2x2", "grad_sharded_auto", ell, MEGA, (2, 2),
             dict(width=9, height=7, n_samples=2, target=_target(9, 7), **g)),
            ("train_2x2", "train_step_analog", c, {}, (2, 2),
             dict(width=8, height=8, samples_per_device=1, steps=2, **R)),
        ]
    return [
        ("xla_1x2_pad", "render_samples_sharded", c, {}, (1, 2),
         dict(width=9, height=7, samples_per_device=2, **R)),
        ("pallas_1x2_pad", "render_samples_sharded", c, {"use_pallas": True}, (1, 2),
         dict(width=9, height=7, samples_per_device=2, **R)),
        ("v4_1x2_pad", "render_samples_sharded_mega", c, MEGA, (1, 2),
         dict(width=9, height=7, samples_per_device=2, **R)),
        ("v4_2x1", "render_samples_sharded_mega", c, MEGA, (2, 1),
         dict(width=16, height=16, samples_per_device=1, **R)),
        ("grad_1x2", "render_grad_sharded", c, {}, (1, 2),
         dict(width=16, height=16, n_samples=1, target=_target(16, 16), **g)),
        ("grad_mega_2x1_pad", "render_grad_sharded_mega", c, MEGA, (2, 1),
         dict(width=9, height=7, n_samples=2, target=_target(9, 7), **g)),
    ]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharding")
    return {n: write_scene(d, n) for n in ("cornell", "ellipsoid")}


@pytest.fixture(scope="module")
def runs(paths):
    """{world size: (cases by name, [each rank's results])}."""
    out = {}
    for world in (4, 2):
        cases = _cases(paths, world)
        out[world] = ({c[0]: c for c in cases},
                      dryrun.run_ranks(run_cases, world, backend="gloo", args=(cases,),
                                       timeout_s=60.0))
    return out


def _case(runs, name):
    """(case, rank 0's result) of the case called ``name``."""
    for cases, results in runs.values():
        if name in cases:
            return cases[name], results[0][name]
    raise KeyError(name)


def _port(path, feats):
    host, _ = loader.load_scene(path)
    return schema.to_device(host, "cpu"), dict(host.features(), **feats)


def _single_render(case):
    """The port's single-device radiance sum of the same samples."""
    _, _, path, feats, (sp, _), kw = case
    scene, features = _port(path, feats)
    n = kw["samples_per_device"] * sp
    return integrator.render_progressive(scene, features, kw["width"], kw["height"], 0, n, 0,
                                         kw["max_depth"], kw["sqrt_spp"])


def test_every_rank_holds_the_same_result(runs):
    for cases, results in runs.values():
        for name in cases:
            leaves = [[], []]
            for r, res in enumerate((results[0][name], results[-1][name])):
                for x in (res.accum,) if hasattr(res, "accum") else (
                        (res,) if torch.is_tensor(res) else (res[0], res[1])):
                    if dataclasses.is_dataclass(x):
                        schema.map_leaves(x, leaves[r].append)
                    else:
                        leaves[r].append(x)
            assert all(torch.equal(a, b) for a, b in zip(*leaves)), name


@pytest.mark.parametrize("name", ["xla_2x2", "xla_1x4_pad"])
def test_render_samples_sharded_matches_jax(runs, name):
    (_, _, path, _, (sp, dp), kw), ours = _case(runs, name)
    jhost, _ = jax_loader.load_scene(path)
    mesh = jax_sharding.make_mesh(sp=sp, dp=dp, devices=jax.devices()[:sp * dp])
    ref = jax_sharding.render_samples_sharded(
        jax_schema.to_device(jhost), tuple(sorted(jhost.features().items())), jnp.int32(0), 0,
        mesh=mesh, **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_render_samples_sharded_pad_matches_one_device(runs):
    """The 2-rank pad case against the same samples of
    ``integrator.render_sample`` on one device (threefry streams)."""
    (_, _, path, feats, (sp, _), kw), ours = _case(runs, "xla_1x2_pad")
    scene, features = _port(path, feats)
    ref = sum(integrator.render_sample(scene, features, kw["width"], kw["height"], s, 0,
                                       kw["max_depth"], kw["sqrt_spp"])
              for s in range(kw["samples_per_device"] * sp))
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=RTOL, atol=ATOL)


def test_render_samples_sharded_pallas_matches_one_device(runs):
    """``use_pallas`` on the sharded non-kernel render (B5's plain version
    on the CPU): ``render_samples_sharded`` reads the live extents the
    features lack, and the 2-rank pad case matches the single-device
    ``pallas`` route (the extents read from the host scene, as the
    ``Renderer`` does)."""
    (_, _, path, feats, (sp, _), kw), ours = _case(runs, "pallas_1x2_pad")
    host, _ = loader.load_scene(path)
    scene = schema.to_device(host, "cpu")
    features = dict(host.features(), **feats, pallas_extents=pk.live_extents(host))
    ref = sum(integrator.render_sample(scene, features, kw["width"], kw["height"], s, 0,
                                       kw["max_depth"], kw["sqrt_spp"])
              for s in range(kw["samples_per_device"] * sp))
    assert torch.isfinite(ours).all() and float(ours.mean()) > 0.0
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["v4_1x4", "wf_1x4", "block_1x4", "v4_1x2_pad"])
def test_mega_dp_shards_bitwise(runs, name):
    case, ours = _case(runs, name)
    assert torch.equal(ours, _single_render(case))


@pytest.mark.parametrize("name", ["v4_2x2", "v4_2x1"])
def test_mega_sp_shards_within_sum_order(runs, name):
    case, ours = _case(runs, name)
    np.testing.assert_allclose(ours.numpy(), _single_render(case).numpy(), rtol=1e-6, atol=0)


def test_render_grad_sharded_matches_jax(runs):
    """The 4-rank (2, 2) mesh on a 9×7 image against JAX's single-device
    ``value_and_grad`` of ``render_image`` with the same loss (sum of
    squares against the target)."""
    (_, _, path, _, _, kw), (loss, g) = _case(runs, "grad_2x2_pad")
    jhost, _ = jax_loader.load_scene(path)
    kw = dict(kw)
    target = kw.pop("target")
    jfeats = tuple(sorted(jhost.features().items()))
    jl, jg = jax.value_and_grad(
        lambda s: jnp.sum((jax_grad.render_image(s, jfeats, 0, **kw) - target) ** 2),
        allow_int=True)(jax_schema.to_device(jhost))
    assert float(loss) == pytest.approx(float(jl), rel=1e-4)
    _assert_grads_close(g, jg)


def test_render_grad_sharded_matches_one_device_scan(runs):
    """The 2-rank (1, 2) mesh at 16² against the port's single-device scan
    (held to JAX by tests/test_torch_grad_scan.py). JAX's fused compile
    flips one path of this image (an escape on Cornell's black background,
    invisible in the image but not in the background's cotangent), so the
    16² case is held to the port's own scan, which follows JAX op by op."""
    (_, _, path, feats, _, kw), (loss, g) = _case(runs, "grad_1x2")
    scene, features = _port(path, dict(feats, use_megakernel=False))
    kw = dict(kw)
    target = torch.from_numpy(kw.pop("target"))
    ref_loss, ref = grad.value_and_grad_scene(lambda im: torch.sum((im - target) ** 2), scene,
                                              features, 0, **kw)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    _assert_grads_close(g, ref)


@pytest.mark.parametrize("name", ["grad_mega_2x2", "grad_mega_1x4", "grad_mega_2x1_pad",
                                  "auto_ell_2x2"])
def test_grad_sharded_kernel_route_matches_one_device(runs, name):
    """``render_grad_sharded_mega`` (and ``grad_sharded_auto``, which sends
    the ellipsoid scene to the scan) against ``grad.value_and_grad_scene``
    of the same loss on one device."""
    (_, _, path, feats, _, kw), (loss, g) = _case(runs, name)
    scene, features = _port(path, feats)
    kw = dict(kw)
    target = torch.from_numpy(kw.pop("target"))
    ref_loss, ref = grad.value_and_grad_scene(lambda im: torch.sum((im - target) ** 2), scene,
                                              features, 0, **kw)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    _assert_grads_close(g, ref)
    assert any(float(np.abs(x).max(initial=0.0)) > 0.0 for n in GROUPS for x in _group(g, n))
    assert g.materials.mtype is None


def test_train_step_analog_accumulates(runs):
    (_, _, path, feats, (sp, _), kw), state = _case(runs, "train_2x2")
    assert state.frame_idx == kw["steps"] * kw["samples_per_device"] * sp
    scene, features = _port(path, feats)
    ref = sum(integrator.render_sample(scene, features, kw["width"], kw["height"], s, 0,
                                       kw["max_depth"], kw["sqrt_spp"])
              for s in range(state.frame_idx))
    np.testing.assert_allclose(state.accum.numpy(), ref.numpy(), rtol=RTOL, atol=ATOL)


def test_make_mesh_and_runtime_in_one_process():
    """Without a process group: one rank, world 1, a 1 x 1 mesh whose
    collectives are the identity; JAX's error for a grid that does not fit;
    ``initialize`` is a no-op, and refuses a backend it does not know."""
    distributed.initialize()
    assert not torch.distributed.is_initialized()
    assert distributed.is_primary() and distributed.global_device_count() == 1
    mesh = sharding.make_mesh(device="cpu")
    assert (mesh.sp, mesh.dp, mesh.sp_index, mesh.dp_index) == (1, 1, 0, 0)
    for sp, dp in ((2, None), (2, 2), (1, 3)):
        with pytest.raises(ValueError, match=r"sp\*dp = \d+ != device count 1"):
            sharding.make_mesh(sp=sp, dp=dp, device="cpu")
    with pytest.raises(ValueError, match="backend must be one of"):
        distributed.initialize(None, init_method="file:///nonexistent/rdzv", world_size=1,
                               rank=0)


def test_dryrun_four_cpu_ranks():
    r = subprocess.run([sys.executable, "-m", "raytrace2_tpu_torch.parallel.dryrun", "--nproc",
                        "4", "--device", "cpu", "--timeout", "60"],
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    rows = [line for line in r.stdout.splitlines() if line.startswith("{")]
    assert len(rows) == 2 and '"sp": 2, "dp": 2' in rows[0] and '"kernel_grad_nonzero"' in rows[0]


def test_differentiable_shard_needs_linear_layout(paths):
    """The replay walks the linear slot layout: a differentiable shard on
    the block-tiled one is refused (``render_grad_sharded_mega`` keeps v4
    linear), and a linear shard's slot tile is [n_local, 3]."""
    scene, feats = _port(paths["cornell"], MEGA)
    packed = integrator.pack_scene(scene, feats)
    args = (scene, packed, dict(feats, mega_linear=False), 32, 32, 0, 1, 0, 2, 1)
    with pytest.raises(ValueError, match="linear slot layout"):
        integrator._render_batch_megakernel(*args, differentiable=True, pix0=256, n_local=256)
    tile = integrator._render_batch_megakernel(scene, packed, feats, 32, 32, 0, 1, 0, 2, 1,
                                               pix0=512, n_local=256)
    full = integrator._render_batch_megakernel(scene, packed, feats, 32, 32, 0, 1, 0, 2, 1)
    assert torch.equal(tile, full.reshape(-1, 3)[512:768])
