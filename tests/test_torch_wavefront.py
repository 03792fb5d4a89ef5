"""The sorted wavefront of the port (ops/kernels/wavefront.py) on the CPU,
where its K-bounce step runs the plain version: against the port's own v4
plain version (bitwise, any schedule), its parts against the JAX package's
wavefront_sorted.py (bitwise), and whole renders against the JAX package's
XLA path and its interpret-mode wavefront kernel (the repo's matched-RNG
flip gate)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace2_tpu.ops import integrator as jax_integrator
from raytrace2_tpu.ops.pallas import megakernel as jmk
from raytrace2_tpu.ops.pallas import wavefront_sorted as jwf
from raytrace2_tpu.scene import loader as jax_loader
from raytrace2_tpu.scene import schema as jax_schema
from raytrace2_tpu_torch.io import compare
from raytrace2_tpu_torch.ops import camera, integrator
from raytrace2_tpu_torch.ops.kernels import megakernel as mk
from raytrace2_tpu_torch.ops.kernels import wavefront as wf
from raytrace2_tpu_torch.render import Renderer
from raytrace2_tpu_torch.scene import loader, schema
from test_torch_scenes import write_scene


def _render(scene, w, h, spp, depth, **knobs):
    """Radiance sum [H, W, 3] of the port's kernel path on the CPU."""
    feats = dict(scene.features(), **knobs)
    dev = schema.to_device(scene, "cpu")
    return integrator.render_progressive(
        dev, feats, w, h, 0, spp, 0, depth, max(int(spp ** 0.5), 1)).numpy()


def _flip_gate(ours, ref, max_flipped=0.005):
    """PR 2's matched-RNG gate at small sizes: mean within 1e-3, at most
    ``max_flipped`` (0.5 %) of pixels differing by more than 1e-4 (paths
    flipped at near-ties by f32 rounding), PSNR ≥ 60 dB over the other
    pixels."""
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    assert abs(ours.mean() - ref.mean()) < 1e-3
    flipped = np.abs(ours - ref).max(-1) > 1e-4
    assert flipped.mean() <= max_flipped, flipped.sum()
    assert compare.psnr(ours[~flipped], ref[~flipped]) >= 60.0


# The schedules of tests/test_wavefront.py's knob sets (the port has one
# sort, so their sort knobs are gone), one phase (tail_k 0), the switch to
# the tail after the first pass (tail_frac 1), and the defaults.
KNOBS = [
    dict(mega_k_bounces=1),
    dict(mega_k_bounces=4),
    dict(mega_k_bounces=16),
    dict(mega_k_bounces=1, mega_tail_k=4, mega_tail_frac=0.5),
    dict(mega_k_bounces=1, mega_tail_k=16, mega_tail_frac=0.9),
    dict(mega_k_bounces=1, mega_tail_k=16, mega_tail_frac=0.5),
    dict(mega_tail_k=0),
    dict(mega_tail_frac=1.0),
    dict(),
]


@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: ",".join(
    f"{n[5:]}={v}" for n, v in k.items()) or "defaults")
def test_plain_wavefront_bitwise_equals_plain_v4_cornell(tmp_path, knobs):
    """Cornell 24×16, 2 spp, depth 6: the wavefront is scheduling only, so
    its image is bitwise equal to v4's for every knob set; the sort ran."""
    scene, _ = loader.load_scene(write_scene(tmp_path, "cornell"))
    v4 = _render(scene, 24, 16, 2, 6, mega_wavefront=False)
    sorts = wf.SORTS
    ours = _render(scene, 24, 16, 2, 6, mega_wavefront=True, **knobs)
    assert wf.SORTS > sorts
    np.testing.assert_array_equal(ours, v4)


def test_plain_wavefront_bitwise_equals_plain_v4_book2(tmp_path):
    """Book 2 (1,408 records: boxes, media, moving and noise spheres, a
    light) at 8×8, 2 spp, depth 4 takes the wavefront by default; bitwise
    equal to v4 forced on the same scene."""
    scene, _ = loader.load_scene(write_scene(tmp_path, "book2"))
    feats = scene.features()
    assert integrator.mega_schedule(feats)[3]
    v4 = _render(scene, 8, 8, 2, 4, mega_wavefront=False)
    ours = _render(scene, 8, 8, 2, 4)
    assert np.isfinite(ours).all() and ours.max() > 0
    np.testing.assert_array_equal(ours, v4)


# A mirror (metal, fuzz 0) on the ground under the left half of a camera
# that looks down at 59 degrees: every ray of the left half takes exactly two
# bounces (the mirror, then the sky), every ray of the right half one.
MIRROR_HALF = {
    "background_color": [0.5, 0.7, 1.0],
    "camera": {"fov": 40, "center": [0, 5, 3], "look_at": [0, 0, 0]},
    "textures": [],
    "materials": [{"type": "metal", "albedo": [0.9, 0.8, 0.7], "fuzz": 0.0}],
    "primitives": [{"type": "quad", "q": [-100, 0, -100], "u": [100, 0, 0],
                    "v": [0, 0, 200], "material": 0}],
}


@pytest.mark.parametrize("tail_frac,old,new", [
    (wf.TAIL_FRAC, [2, 2, 16], [2, 2, 2, 16, 16]),
    (0.0, [2] * 4, [2] * 5),
], ids=["two_phases", "one_phase"])
def test_lagged_passes_counted_by_hand(tmp_path, tail_frac, old, new):
    """MIRROR_HALF at 16x8, 4 spp, in 128 slots: after m single steps the
    runnable count is 64 [m < 4] + 64 [m < 8]. A schedule that read the
    count before each launch would run ``old``'s steps a launch: K=2 at
    m = 0, 2 (128 > 83 = int(0.65 * 128)), then K=16 at m = 4 (64 > 0); with
    one phase, K=2 at m = 0, 2, 4, 6. Reading the count after each pass's
    step is queued adds one launch and one sort a phase that ran (the
    overrun: K=2 at m = 4, K=16 at m = 22), and gives v4's image bit for
    bit."""
    path = tmp_path / "mirror_half.json"
    path.write_text(json.dumps(MIRROR_HALF))
    scene, _ = loader.load_scene(str(path))
    feats = scene.features()
    sizes = tuple(feats["mega_sizes"])
    dev = schema.to_device(scene, "cpu")
    args = (camera.make_camv(scene.camera, 16, 8, 0, 4, 2, 0), 0, mk.pack_buffer(dev, sizes),
            dev.background)
    kw = dict(max_depth=4, sizes=sizes, has_checker=feats["has_checker"],
              has_noise=feats["has_noise"])
    steps = []

    def step(state, *a, k_bounces, **k):
        steps.append(k_bounces)
        return wf.wavefront_step(state, *a, k_bounces=k_bounces, **k)

    sorts, overruns = wf.SORTS, wf.OVERRUN_LAUNCHES
    image = wf.trace_wavefront_batch(*args, n_rays=128, tail_frac=tail_frac, step=step, **kw)
    phases = 1 + (tail_frac > 0)
    assert steps == new and len(new) == len(old) + phases
    assert wf.SORTS - sorts == len(old) + phases
    assert wf.OVERRUN_LAUNCHES - overruns == phases
    np.testing.assert_array_equal(
        image.numpy(), mk.trace_megakernel_batch(*args, n_pix=128, **kw).numpy())


# ---- parts vs the JAX package, bitwise ------------------------------------


def _random_state(rs, n, n_samples, lo, hi):
    """A seeded slot state: live, regenerating, finished and padding slots,
    origins inside and outside the scene box, directions of every sign."""
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    span = hi - lo
    st = {k: np.zeros(n, np.float32) for k in wf.STATE_KEYS}
    st["al"] = (rs.uniform(size=n) < 0.6).astype(np.float32)
    st["s_lane"] = rs.randint(-1, n_samples + 1, size=n).astype(np.float32)
    st["pid"] = np.where(rs.uniform(size=n) < 0.9, rs.randint(0, 600 * 600, size=n), -1
                         ).astype(np.float32)
    st["bn"] = rs.randint(0, 50, size=n).astype(np.float32)
    for i, k in enumerate(("ox", "oy", "oz")):
        st[k] = rs.uniform(lo[i] - 0.1 * span[i], hi[i] + 0.1 * span[i], size=n
                           ).astype(np.float32)
    for k in ("dx", "dy", "dz"):
        st[k] = rs.normal(size=n).astype(np.float32)
    return st


@pytest.mark.parametrize("name", ["cornell", "feature", "book2"])
def test_scene_bounds_and_sort_keys_bitwise(tmp_path, name):
    path = write_scene(tmp_path, name)
    scene, _ = loader.load_scene(path)
    sizes = tuple(scene.features()["mega_sizes"])
    jscene = jax_schema.to_device(jax_loader.load_scene(path)[0])
    ref_lo, ref_hi = jax.jit(jwf.scene_bounds, static_argnums=1)(
        jmk.pack_tables(jscene, sizes), sizes)
    lo, hi = wf.scene_bounds(mk.pack_buffer(schema.to_device(scene, "cpu"), sizes), sizes)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(ref_lo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(ref_hi))

    rs = np.random.RandomState(sum(map(ord, name)))
    n_samples = 6.0
    st = _random_state(rs, 4096, int(n_samples), lo.numpy(), hi.numpy())
    state = torch.from_numpy(np.stack([st[k] for k in wf.STATE_KEYS]))
    ref = jax.jit(jwf.sort_keys, static_argnums=4)(
        {k: jnp.asarray(v) for k, v in st.items()}, jnp.float32(n_samples),
        ref_lo, ref_hi, "pos")
    ours = wf.sort_keys(state, n_samples, lo, hi)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_interleave3_bitwise():
    rs = np.random.RandomState(3)
    x = rs.randint(0, 2**32, size=65536, dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(jax.jit(jwf._interleave3)(jnp.asarray(x)))
    ours = wf.interleave3(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(ours.numpy(), ref.astype(np.int64))


def test_init_wavefront_state_bitwise(tmp_path):
    scene, _ = loader.load_scene(write_scene(tmp_path, "cornell"))
    camv = camera.make_camv(scene.camera, 20, 12, 3, 4, 2, 0)  # 240 pixels
    ref = jwf.init_wavefront_state(256, jnp.asarray(camv.numpy()))
    ours = wf.init_wavefront_state(256, camv)
    assert ours.shape == (17, 256)
    for i, k in enumerate(wf.STATE_KEYS):
        np.testing.assert_array_equal(ours[i].numpy(), np.asarray(ref[k]), err_msg=k)


# ---- whole renders against the JAX package ---------------------------------


def test_book1_renderer_takes_wavefront_and_matches_jax(tmp_path):
    """Book 1's final scene (≈485 spheres) at 16×16, 2 spp, depth 6 through
    Renderer(device="cpu"), which routes it to the wavefront, against the
    JAX XLA path on the kernel's murmur streams, under PR 2's flip gate with
    a flip budget of 2 %: glass and mirror spheres make this scene flip more
    paths at near-ties than Cornell, and the JAX package's own wavefront
    kernel flips 4 of these 256 pixels (1.6 %) against its XLA path. The port
    flips 3, the same 3; against the JAX kernel it flips 1 (the test below
    holds it to 0.5 % there). The other pixels are bitwise equal."""
    path = write_scene(tmp_path, "book1")
    scene, _ = loader.load_scene(path)
    assert integrator.n_records(scene.features()) > integrator.WAVEFRONT_MIN_RECORDS
    r = Renderer(scene, 16, 16, num_samples=2, max_depth=6, device="cpu")
    assert r.kernel == "wavefront_step"
    sorts = wf.SORTS
    ours = r.render(batch=2)
    assert wf.SORTS > sorts

    jhost, _ = jax_loader.load_scene(path)
    feat = dict(jhost.features(), use_megakernel=False, rng_impl="murmur")
    ref = np.asarray(jax_integrator.render_progressive(
        jax_schema.to_device(jhost), feat, 16, 16, jnp.int32(0), jnp.int32(2), 0,
        6, 1)) / 2
    _flip_gate(ours, ref, max_flipped=0.02)


@pytest.mark.kernel  # Pallas interpret mode, as the JAX kernel tests
@pytest.mark.parametrize("name,w,h,depth", [("cornell", 16, 8, 4), ("book1", 16, 16, 6)])
def test_plain_wavefront_matches_jax_interpret_wavefront(tmp_path, name, w, h, depth):
    """JAX trace_wavefront_batch in interpret mode (mega_wavefront=True,
    2 spp) against the port's plain wavefront, under PR 2's flip gate."""
    path = write_scene(tmp_path, name)
    jhost, _ = jax_loader.load_scene(path)
    feat = dict(jhost.features(), use_megakernel=True, mega_interpret=True,
                mega_wavefront=True)
    ref = np.asarray(jax_integrator.render_progressive(
        jax_schema.to_device(jhost), feat, w, h, jnp.int32(0), jnp.int32(2), 0,
        depth, 1)) / 2
    scene, _ = loader.load_scene(path)
    ours = _render(scene, w, h, 2, depth, mega_wavefront=True) / 2
    _flip_gate(ours, ref)


@pytest.mark.parametrize("sizes", [
    (1005, 1, 9, 4, 2, 400),   # book 2
    (4096, 0, 1, 0, 0, 0),     # the kernel path's record ceiling, all spheres
])
def test_tables_fit_shared_memory(sizes):
    """The packed tables, camv and background of one block (block_smem_bytes
    in csrc/path_common.cuh) fit the 227 KB a Hopper block can opt into."""
    from raytrace2_tpu_torch.ops.kernels import build

    smem = (mk.table_layout(sizes)["total"][0] + camera.CAMV_LEN + 4) * 4
    assert 48 * 1024 < smem <= build.MAX_SMEM_BYTES
