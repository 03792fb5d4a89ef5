"""The wavefront driver's keys and count (``wavefront.count_and_keys``):
on a CPU state the plain ``sort_keys`` and ``runnable``, on the card one
launch of csrc/wavefront_keys.cu a pass, held bit for bit against them;
the pass order both devices share (keys and count, the sort by those keys,
the step, then the count's read); the refusals; and the driver's batch,
which reads each pass's count after queueing its step, against v4's image.
The card tests skip where torch.cuda.is_available() is false. Run on a
machine with the card:
python -m pytest tests/test_torch_wavefront_keys.py -q --noconftest"""

import numpy as np
import pytest
import torch

from raytrace2_tpu_torch import tracing
from raytrace2_tpu_torch.ops import camera, integrator
from raytrace2_tpu_torch.ops.kernels import build
from raytrace2_tpu_torch.ops.kernels import megakernel as mk
from raytrace2_tpu_torch.ops.kernels import wavefront as wf
from raytrace2_tpu_torch.scene import loader, schema
from test_torch_scenes import write_scene


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _args(path, w, h, spp, depth, device):
    scene, _ = loader.load_scene(path)
    feats = scene.features()
    sizes = tuple(feats["mega_sizes"])
    dev = schema.to_device(scene, device)
    camv = camera.make_camv(scene.camera, w, h, 0, spp, max(int(spp ** 0.5), 1), 0).to(device)
    kw = dict(max_depth=depth, sizes=sizes, has_checker=feats["has_checker"],
              has_noise=feats["has_noise"])
    return (camv, 0, mk.pack_buffer(dev, sizes), dev.background), kw


def _random_state(seed, n, n_samples, lo, hi):
    """A seeded [17, n] slot state with every slot class: live, regenerating
    (s_lane up to n_samples - 1, where it can no longer regenerate),
    finished, padding (pid -1); origins inside and outside the box, some
    infinite or NaN; directions of every sign and zero; bn up to 50."""
    rs = np.random.RandomState(seed)
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    span = np.maximum(hi - lo, 1.0)
    st = np.zeros((len(wf.STATE_KEYS), n), np.float32)
    col = {k: st[i] for i, k in enumerate(wf.STATE_KEYS)}
    col["al"][:] = rs.uniform(size=n) < 0.6
    col["s_lane"][:] = rs.randint(-1, n_samples + 1, size=n)
    col["pid"][:] = np.where(rs.uniform(size=n) < 0.9, rs.randint(0, 600 * 600, size=n), -1)
    col["bn"][:] = rs.randint(0, 51, size=n)
    for i, k in enumerate(("ox", "oy", "oz")):
        col[k][:] = rs.uniform(lo[i] - 0.2 * span[i], hi[i] + 0.2 * span[i], size=n)
        odd = rs.uniform(size=n)
        col[k][odd < 0.01] = np.inf
        col[k][(odd >= 0.01) & (odd < 0.02)] = -np.inf
        col[k][(odd >= 0.02) & (odd < 0.025)] = np.nan
    for k in ("dx", "dy", "dz"):
        col[k][:] = np.where(rs.uniform(size=n) < 0.05, 0.0, rs.normal(size=n))
    return torch.from_numpy(st)


def _kernel(state, n_samples, lo, hi):
    keys = torch.full((state.shape[1],), -7, dtype=torch.int32, device=state.device)
    count = torch.full((1,), -7, dtype=torch.int32, device=state.device)
    wf.count_and_keys(state, n_samples, lo, hi, keys, count)
    return keys, int(count)


def _assert_matches_plain(state, n_samples, lo, hi):
    keys, n = _kernel(state, n_samples, lo, hi)
    want = wf.sort_keys(state, n_samples, lo, hi)
    assert n == int(wf.runnable(state, n_samples).sum())
    assert torch.equal(keys, want), int((keys != want).sum())


# ---- the CPU route --------------------------------------------------------


def test_cpu_batch_takes_the_plain_keys(tmp_path, monkeypatch):
    """A CPU batch keys and counts through ``count_and_keys``' plain
    version, once a pass, launches no keys kernel, and its image is bitwise
    the v4 plain version's."""
    args, kw = _args(write_scene(tmp_path, "cornell"), 8, 8, 1, 3, "cpu")
    calls = {"count_and_keys": 0, "sort_keys": 0}
    for name in calls:
        def spy(*a, _fn=getattr(wf, name), _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(wf, name, spy)

    def no_launch(*a, **k):
        raise AssertionError("a CPU batch launched the keys kernel")

    monkeypatch.setattr(build, "launch_wavefront_keys", no_launch)
    key_launches, sorts = wf.KEY_LAUNCHES, wf.SORTS
    image = wf.trace_wavefront_batch(*args, n_rays=128, **kw)[:64]
    assert wf.KEY_LAUNCHES == key_launches
    assert calls["count_and_keys"] == calls["sort_keys"] == wf.SORTS - sorts > 0
    np.testing.assert_array_equal(image.numpy(),
                                  mk.trace_megakernel_batch(*args, n_pix=64, **kw).numpy())


@pytest.mark.parametrize("name", ["cornell", "feature", "book2"])
def test_count_and_keys_on_a_cpu_state(tmp_path, name):
    """On a CPU state ``count_and_keys`` writes ``sort_keys``' keys and
    ``runnable``'s count into its outputs, and counts no kernel launch: a
    seeded state of 4,096 slots against each scene's box."""
    scene, _ = loader.load_scene(write_scene(tmp_path, name))
    sizes = tuple(scene.features()["mega_sizes"])
    lo, hi = wf.scene_bounds(mk.pack_buffer(schema.to_device(scene, "cpu"), sizes), sizes)
    state = _random_state(sum(map(ord, name)), 4096, 6, lo.tolist(), hi.tolist())
    launches = wf.KEY_LAUNCHES
    keys, n = _kernel(state, 6.0, lo, hi)
    assert wf.KEY_LAUNCHES == launches
    assert keys.dtype == torch.int32
    assert torch.equal(keys, wf.sort_keys(state, 6.0, lo, hi))
    assert 0 < n == int(wf.runnable(state, 6.0).sum()) < 4096


def test_each_pass_keys_sorts_steps_then_reads(tmp_path, monkeypatch):
    """The pass order both devices run: ``count_and_keys`` on the pass's
    state, ``sort_state`` by the keys it wrote, the step, then the count's
    read on the host; the batch's only other read is ``camv``'s values."""
    args, kw = _args(write_scene(tmp_path, "cornell"), 8, 8, 2, 4, "cpu")
    calls = []
    count_and_keys, sort_state, sync = wf.count_and_keys, wf.sort_state, tracing.sync

    def keys_spy(state, n_samples, lo, hi, keys, count):
        count_and_keys(state, n_samples, lo, hi, keys, count)
        calls.append(("keys", keys, count))

    def sort_spy(state, *a, keys=None, **k):
        calls.append(("sort", keys))
        return sort_state(state, *a, keys=keys, **k)

    def step(state, *a, **k):
        calls.append(("step",))
        return wf.wavefront_step(state, *a, **k)

    def sync_spy(t, site, *a, **k):
        calls.append(("read", site, t))
        return sync(t, site, *a, **k)

    monkeypatch.setattr(wf, "count_and_keys", keys_spy)
    monkeypatch.setattr(wf, "sort_state", sort_spy)
    monkeypatch.setattr(tracing, "sync", sync_spy)
    wf.trace_wavefront_batch(*args, n_rays=128, step=step, **kw)
    assert calls[0][:2] == ("read", "camv_values")
    passes = calls[1:]
    assert len(passes) % 4 == 0 and len(passes) >= 8
    for i in range(0, len(passes), 4):
        (k, keys, count), (s, sorted_by), (st,), (r, site, read) = passes[i:i + 4]
        assert (k, s, st, r, site) == ("keys", "sort", "step", "read", "runnable")
        assert sorted_by is keys and read is count


@pytest.mark.parametrize("case", ["strided_state", "too_few_rows", "short_keys",
                                  "float_keys", "int64_count"])
def test_count_and_keys_refuses_bad_inputs_on_the_cpu(case):
    state = wf.init_wavefront_state(256, [0.0] * 20 + [200.0, 0.0, 4.0, 0.0, 0.0, 0.0])
    keys = torch.full((256,), -7, dtype=torch.int32)
    count = torch.full((1,), -7, dtype=torch.int32)
    a = dict(state=state, keys=keys, count=count) | {
        "strided_state": dict(state=state[:, ::2]), "too_few_rows": dict(state=state[:16]),
        "short_keys": dict(keys=keys[:128]), "float_keys": dict(keys=keys.float()),
        "int64_count": dict(count=count.long())}[case]
    launches = wf.KEY_LAUNCHES
    with pytest.raises(ValueError):
        wf.count_and_keys(a["state"], 4.0, -torch.ones(3), torch.ones(3), a["keys"], a["count"])
    assert wf.KEY_LAUNCHES == launches
    assert (keys == -7).all() and int(count) == -7


# ---- on the card ----------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("bounds", ["book2", "flat"])
def test_keys_kernel_matches_sort_keys_on_random_states(tmp_path, cuda, bounds):
    """Random states of 4,133 slots (not a multiple of a block) against the
    scene box of book 2, and against a box flat on one axis (the extent's
    clamp to 1e-20)."""
    if bounds == "book2":
        args, kw = _args(write_scene(tmp_path, "book2"), 8, 8, 1, 4, cuda)
        lo, hi = wf.scene_bounds(args[2], kw["sizes"])
    else:
        lo = torch.tensor([-1.0, 0.5, -3.0], device=cuda)
        hi = torch.tensor([2.0, 0.5, 4.0], device=cuda)
    for seed, n_samples in ((1, 6.0), (2, 64.0), (3, 1.0)):
        state = _random_state(seed, 4133, int(n_samples), lo.tolist(), hi.tolist()).to(cuda)
        _assert_matches_plain(state, n_samples, lo, hi)


@pytest.mark.cuda
def test_keys_kernel_matches_sort_keys_mid_batch(tmp_path, cuda):
    """Every state that book 2's batch (96x96, 8 spp, depth 50) hands to a
    launch, keyed by the kernel and by the plain version."""
    args, kw = _args(write_scene(tmp_path, "book2"), 96, 96, 8, 50, cuda)
    lo, hi = wf.scene_bounds(args[2], kw["sizes"])
    states = []

    def step(state, *a, **k):
        states.append(state.clone())
        return wf.wavefront_step(state, *a, **k)

    wf.trace_wavefront_batch(*args, n_rays=96 * 96, step=step, **kw)
    assert len(states) > 4
    for state in states:
        _assert_matches_plain(state, 8.0, lo, hi)


def _plain_count_and_keys(state, n_samples, bb_lo, bb_hi, keys, count):
    """``sort_keys`` and ``runnable(...).sum()`` in torch ops on the card,
    into the kernel's outputs."""
    keys.copy_(wf.sort_keys(state, n_samples, bb_lo, bb_hi))
    count.copy_(wf.runnable(state, n_samples).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [dict()], ids=["defaults"])
def test_batch_is_the_plain_keys_batch(tmp_path, cuda, monkeypatch, knobs):
    """Book 2 at 128x128, 6 spp, depth 50: the same states before every
    launch, the same image bit for bit and the same sorts and launches as
    the batch keyed by torch ops; one keys launch a launch."""
    args, kw = _args(write_scene(tmp_path, "book2"), 128, 128, 6, 50, cuda)
    kw.update(knobs)
    runs = []
    for plain in (False, True):
        states = []

        def step(state, *a, **k):
            states.append(state.clone())
            return wf.wavefront_step(state, *a, **k)

        if plain:
            monkeypatch.setattr(wf, "count_and_keys", _plain_count_and_keys)
        counters = (wf.LAUNCHES, wf.SORTS, wf.KEY_LAUNCHES)
        image = wf.trace_wavefront_batch(*args, n_rays=128 * 128, step=step, **kw)
        runs.append((image, states, [b - a for a, b in zip(
            counters, (wf.LAUNCHES, wf.SORTS, wf.KEY_LAUNCHES))]))
    (image, states, (launches, sorts, key_launches)), (p_image, p_states, p_counts) = runs
    assert torch.equal(image, p_image)
    assert len(states) == len(p_states) == launches
    assert all(torch.equal(a, b) for a, b in zip(states, p_states))
    assert [launches, sorts] == p_counts[:2] and p_counts[2] == 0
    assert key_launches == launches


@pytest.mark.cuda
def test_book2_batch_is_v4s_image(tmp_path, cuda):
    """Book 2 at 96x96, 4 spp, depth 50: the wavefront's image, each count
    read after its pass's step is queued, a step more in each of the two
    phases, is bitwise v4's on the block layout."""
    scene, _ = loader.load_scene(write_scene(tmp_path, "book2"))
    dev, feats = schema.to_device(scene, cuda), scene.features()
    assert integrator.mega_schedule(feats)[3]

    def render(**knobs):
        return integrator.render_progressive(dev, dict(feats, **knobs), 96, 96, 0, 4, 0, 50, 2)

    overruns = wf.OVERRUN_LAUNCHES
    image = render()
    assert wf.OVERRUN_LAUNCHES - overruns == 2
    assert image.max() > 0 and torch.equal(image, render(mega_wavefront=False))


@pytest.mark.cuda
def test_keys_wrapper_refuses_bad_inputs(cuda):
    state = wf.init_wavefront_state(256, [0.0] * 20 + [200.0, 0.0, 4.0, 0.0, 0.0, 0.0], cuda)
    lo, hi = -torch.ones(3, device=cuda), torch.ones(3, device=cuda)
    keys = torch.empty(256, dtype=torch.int32, device=cuda)
    count = torch.empty(1, dtype=torch.int32, device=cuda)
    launches = wf.KEY_LAUNCHES
    bad = [dict(state=state.cpu()), dict(state=state[:, ::2]), dict(state=state[:16]),
           dict(keys=keys[:128]), dict(keys=keys.float()), dict(count=count.long())]
    for case in bad:
        a = dict(state=state, keys=keys, count=count) | case
        with pytest.raises(ValueError):
            wf.count_and_keys(a["state"], 4.0, lo, hi, a["keys"], a["count"])
    assert wf.KEY_LAUNCHES == launches
