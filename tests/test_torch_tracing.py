"""The port's spans and host-sync counter (``raytrace2_tpu_torch.tracing``):
idle without a profiler, the documented names and nesting in an exported
trace, the host syncs each route makes per batch, images and gradients
unchanged by tracing, and the benchmark's readers of them. The ``cuda``
test holds ``HOST_SYNCS`` against the synchronising calls torch's sync debug
mode reports on the card: python -m pytest tests/test_torch_tracing.py -q
--noconftest -m cuda"""

import collections
import json
import warnings

import numpy as np
import pytest
import torch

from raytrace2_tpu_torch import app, grad, tracing
from raytrace2_tpu_torch.ops.kernels import wavefront as wf
from raytrace2_tpu_torch.render import Renderer
from raytrace2_tpu_torch.scene import loader, schema
from rtbench import harness
from rtbench.metrics import _spans
from test_torch_scenes import write_scene

# Host syncs of one batch on the v4 route: six camera leaves read for the
# frame, and camv copied to the device.
V4_SYNCS = 7
# The gradient step: the forward's seven, and the copies back of camv's and
# the six leaves' gradients in the backward.
GRAD_SYNCS = 14
NEW_READERS = ("render.syncs_per_batch", "render.host_busy_ms_per_batch",
               "render.syncs_per_frame", "render.host_busy_ms_per_frame",
               "wavefront.syncs_per_spp", "wavefront.host_busy_ms_per_pass",
               "wavefront.sync_wait_ms_per_pass", "grad.syncs_per_step",
               "grad.host_busy_ms_per_step")
# Route -> (scene, size, spp, the spans expected in one batch's trace, each
# with its parent).
ROUTES = {
    "v4": ("cornell", 16, 2, {"render.update": None, "integrator.camv": "render.update",
                              "sync.camera": "integrator.camv", "sync.camv": "integrator.camv",
                              "integrator.launch": "render.update",
                              "render.accumulate": "render.update"}),
    "wavefront": ("book2", 12, 2, {
        "render.update": None, "integrator.camv": "render.update",
        "integrator.launch": "render.update", "wavefront.setup": "integrator.launch",
        "sync.camv_values": "wavefront.setup", "wavefront.runnable": "integrator.launch",
        "sync.runnable": "wavefront.runnable", "wavefront.sort": "integrator.launch",
        "wavefront.launch": "integrator.launch", "wavefront.unpermute": "integrator.launch",
        "render.accumulate": "render.update"}),
}


def _renderer(tmp_path, route):
    name, size, spp, _ = ROUTES[route]
    scene, _ = loader.load_scene(write_scene(tmp_path, name))
    return Renderer(scene, size, size, num_samples=spp, max_depth=6, device="cpu"), spp


def _profile(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof, out


def _annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"]


def _span(ev):
    """The span an annotation records: its name less the unit a top span carries."""
    return ev["name"].split("#")[0]


def _parent(ev, events):
    """The span of the shortest other annotation of ``ev``'s thread that encloses it."""
    s, e = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
    outer = [o for o in events if o is not ev and o["tid"] == ev["tid"]
             and float(o["ts"]) <= s and e <= float(o["ts"]) + float(o["dur"])]
    return _span(min(outer, key=lambda o: float(o["dur"]))) if outer else None


def _totals():
    """Every documented span's totals, read by dotted path as the benchmark reads them."""
    keys = [tracing.key(n) for n in tracing.SPANS + tuple("sync." + s for s in tracing.SITES)]
    return {k: (getattr(tracing, "NS_" + k), getattr(tracing, "SYNC_NS_" + k)) for k in keys}


def _grad_step(tmp_path):
    host, _ = loader.load_scene(write_scene(tmp_path, "cornell"))
    scene = schema.to_device(host, "cpu")
    kw = dict(width=8, height=8, n_samples=2, max_depth=4, sqrt_spp=1)
    return lambda: grad.value_and_grad_scene(lambda img: (img ** 2).mean(), scene,
                                             host.features(), 3, **kw)


def test_spans_record_nothing_without_a_profiler(tmp_path):
    r, spp = _renderer(tmp_path, "v4")
    before, syncs = _totals(), tracing.HOST_SYNCS
    r.update(spp)
    r.display_pixels()
    assert _totals() == before
    assert tracing.HOST_SYNCS - syncs == V4_SYNCS + 1
    assert tracing.span("render.update") is tracing.span("grad.forward")


@pytest.fixture(scope="module", params=sorted(ROUTES))
def batches(request, tmp_path_factory):
    """Two batches of a route, the second untraced on one renderer and
    traced on another: the trace's annotations, the syncs of each second
    batch, the spans its trace holds, and both images."""
    route, tmp = request.param, tmp_path_factory.mktemp("tracing")
    out = {"route": route}
    for traced in (False, True):
        r, spp = _renderer(tmp, route)
        r.update(spp)  # the shapes and the scene's reads
        before, syncs = _totals(), tracing.HOST_SYNCS
        if traced:
            prof, _ = _profile(lambda: r.update(spp))
            out["events"] = _annotations(prof, tmp)
            out["calls"] = collections.Counter(_span(e) for e in out["events"])
        else:
            r.update(spp)
            assert _totals() == before
        out[traced] = {"syncs": tracing.HOST_SYNCS - syncs, "accum": r.state.accum.clone(),
                       "display": r.display_pixels()}
    out["spp"] = spp
    return out


def test_trace_holds_the_spans_with_their_nesting(batches):
    events, spp = batches["events"], batches["spp"]
    names = {_span(e) for e in events}
    parents = ROUTES[batches["route"]][3]
    assert set(parents) <= names
    for ev in events:
        if _span(ev) in parents:
            assert _parent(ev, events) == parents[_span(ev)], ev["name"]
    # The top span of the batch carries its identifier in its name.
    assert [e["name"] for e in events if _span(e) == "render.update"] \
        == [f"render.update#seed=0,s0={spp}"]
    assert names <= set(tracing.SPANS) | {"sync." + s for s in tracing.SITES}


def test_host_syncs_per_batch(batches):
    got, calls = batches[True]["syncs"], batches["calls"]
    assert batches[False]["syncs"] == got  # the same reads with tracing off
    if batches["route"] == "v4":
        assert got == V4_SYNCS
        assert calls["sync.camera"] == 6 and calls["sync.camv"] == 1
    else:
        # camv's values, and one runnable read before each launch and at
        # the end of each of the two phases.
        assert calls["sync.runnable"] == calls["wavefront.launch"] + 2
        assert got == V4_SYNCS + 1 + calls["sync.runnable"]
        assert calls["wavefront.sort"] == calls["wavefront.launch"]
    assert calls["render.update"] == 1


def test_images_are_bitwise_with_tracing_on_and_off(batches):
    off, on = batches[False], batches[True]
    assert torch.equal(off["accum"], on["accum"])
    np.testing.assert_array_equal(off["display"], on["display"])


def test_gradient_step_syncs_and_spans(tmp_path):
    step = _grad_step(tmp_path)
    step()  # the material types, read once per scene tensor
    syncs = tracing.HOST_SYNCS
    prof, _ = _profile(step)
    assert tracing.HOST_SYNCS - syncs == GRAD_SYNCS
    events = _annotations(prof, tmp_path)
    names = {_span(e) for e in events}
    assert {"grad.value_and_grad", "grad.params", "grad.forward", "grad.backward",
            "grad.replay", "grad.tree", "sync.camera_grad", "sync.camv_grad",
            "integrator.pack"} <= names
    assert "grad.value_and_grad#seed=3" in {e["name"] for e in events}
    for ev in events:
        if ev["name"] in ("grad.params", "grad.forward", "grad.backward", "grad.tree"):
            assert _parent(ev, events) == "grad.value_and_grad"
        if ev["name"] == "grad.replay":
            assert _parent(ev, events) == "grad.backward"


def test_gradients_are_bitwise_with_tracing_on_and_off(tmp_path):
    step = _grad_step(tmp_path)
    loss0, g0 = step()
    _, (loss1, g1) = _profile(step)
    assert torch.equal(loss0, loss1)
    leaves0, leaves1 = [], []
    schema.map_leaves(g0, leaves0.append)
    schema.map_leaves(g1, leaves1.append)
    assert leaves0 and len(leaves0) == len(leaves1)
    for x, y in zip(leaves0, leaves1):
        assert torch.equal(x, y)


def test_totals_read_by_dotted_path():
    read = harness.counter_reader(["raytrace2_tpu_torch.tracing.HOST_SYNCS",
                                   "raytrace2_tpu_torch.tracing.NS_render_update",
                                   "raytrace2_tpu_torch.tracing.SYNC_NS_wavefront_runnable",
                                   "raytrace2_tpu_torch.tracing.NS_sync_runnable"])
    assert all(isinstance(v, int) for v in read().values())
    with pytest.raises(AttributeError):
        tracing.NS_no_such_span  # noqa: B018


def test_every_reader_counter_resolves_to_an_int():
    bench = harness.load_benchmark()
    names = []
    for metric in bench["per_layer"]:
        reader = harness.load_file_module(harness.PKG / "metrics" / f"{metric['name']}.py")
        if metric["name"] in NEW_READERS:
            assert reader.COUNTERS and metric["source"] == "program_counter"
        names += list(getattr(reader, "COUNTERS", ()))
    values = harness.counter_reader(names)()
    assert set(values) == set(names)
    assert all(type(v) is int for v in values.values())
    assert {m["name"] for m in bench["per_layer"]} >= set(NEW_READERS)


def test_readers_read_nothing_from_a_program_without_spans(monkeypatch):
    monkeypatch.setattr(_spans, "_has_spans", lambda: False)
    assert _spans.counters("render.update", syncs=True, launches=True) == ()
    run = harness.Run(cell={}, cfg={}, traffic={}, seed=1, seconds=1.0, trace=True,
                      device=torch.device("cpu"),
                      trace_summary={"counters": {}, "busy_s": 0.0, "window_s": 1.0},
                      traced_work={"units": 3, "spp": 3})
    assert _spans.syncs_per(run, (), "units") is None
    assert _spans.busy_ms(run, (), ("render.update",)) is None
    assert _spans.wait_ms_per_launch(run, (), "wavefront.runnable") is None


def test_readers_divide_the_window_deltas():
    counters = _spans.counters("wavefront.runnable", syncs=True, launches=True)
    m = _spans.MODULE
    run = harness.Run(cell={}, cfg={}, traffic={}, seed=1, seconds=1.0, trace=True,
                      device=torch.device("cpu"),
                      trace_summary={"counters": {f"{m}.HOST_SYNCS": 40,
                                                  f"{m}.NS_wavefront_runnable": 9_000_000,
                                                  f"{m}.SYNC_NS_wavefront_runnable": 6_000_000,
                                                  _spans.LAUNCHES: 30}},
                      traced_work={"units": 2, "spp": 8})
    assert _spans.syncs_per(run, counters, "units") == 20
    assert _spans.syncs_per(run, counters, "spp") == 5
    assert _spans.busy_ms(run, counters, ("wavefront.runnable",), per="launches") == 0.1
    assert _spans.wait_ms_per_launch(run, counters, "wavefront.runnable") == 0.2


def test_cli_done_line_reports_host_syncs(tmp_path):
    metrics = tmp_path / "m.jsonl"
    rc = app.main([write_scene(tmp_path, "cornell"), str(tmp_path / "o.png"), "--device", "cpu",
                   "--samples", "4", "--batch", "2", "--depth", "3", "--width", "12",
                   "--height", "12", "--quiet", "--metrics", str(metrics)])
    assert rc == 0
    done = [json.loads(line) for line in metrics.read_text().splitlines()][-1]
    # Two batches, then the linear image read back for the PNG.
    assert done["event"] == "done" and done["host_syncs"] == 2 * V4_SYNCS + 1


@pytest.mark.cuda
@pytest.mark.parametrize("unit", ["v4", "wavefront", "grad"])
def test_host_syncs_match_torch_sync_debug_mode(tmp_path, unit):
    """Every synchronising call torch reports in a batch of each route and a
    gradient step went through ``tracing.sync``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda = torch.device("cuda")
    if unit == "grad":
        host, _ = loader.load_scene(write_scene(tmp_path, "cornell"))
        scene = schema.to_device(host, cuda)
        kw = dict(width=64, height=64, n_samples=4, max_depth=8, sqrt_spp=2)

        def run():
            grad.value_and_grad_scene(lambda img: (img ** 2).mean(), scene, host.features(), 3,
                                      **kw)
    else:
        name = ROUTES[unit][0]
        scene, _ = loader.load_scene(write_scene(tmp_path, name))
        r = Renderer(scene, 64, 64, num_samples=4, max_depth=8, device=cuda)
        assert r.kernel == ("wavefront_step" if unit == "wavefront" else "megakernel_v4")

        def run():
            r.update(2)
    run()  # builds, and the reads made once per scene
    torch.cuda.synchronize()
    syncs, launches = tracing.HOST_SYNCS, wf.LAUNCHES
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    # torch also warns once, when the mode is first set, that it is a prototype.
    reported = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    counted = tracing.HOST_SYNCS - syncs
    print(f"{unit}: {counted} host syncs counted, {len(reported)} reported, "
          f"{wf.LAUNCHES - launches} wavefront launches; reported at",
          sorted(f"{w.filename}:{w.lineno}" for w in reported))
    assert counted == len(reported)
    if unit == "v4":
        assert counted == V4_SYNCS
    if unit == "grad":
        assert counted == GRAD_SYNCS
