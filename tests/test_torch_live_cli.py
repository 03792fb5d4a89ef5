"""The live CLI of the port (``io/term.py``; ``app.py``'s ``--live``,
``--live-cols``, ``--watch``, the keys and ``--profile``) on the CPU: the
terminal frames against the JAX package's ``io/term.py``, and the loop
driven as JAX's tests/test_app.py drives its own (``Renderer.update``
hooked to edit the scene mid-render; ``_KeyControls`` replaced by a fake)."""

import contextlib
import io
import json
import os

import numpy as np
import pytest

from raytrace2_tpu.io import term as jax_term
from raytrace2_tpu_torch import app
from raytrace2_tpu_torch.io import image, term
from raytrace2_tpu_torch.render import Renderer


def _scene_json():
    """JAX tests/test_app.py's scene: a sphere under a sky, 32 x 16."""
    return {
        "background_color": [0.7, 0.8, 1.0],
        "camera": {"fov": 60, "center": [0, 1, 3], "look_at": [0, 0, 0],
                   "width": 32, "aspect_ratio": 2.0},
        "materials": [{"type": "lambertian", "albedo": [0.5, 0.5, 0.5]}],
        "primitives": [{"type": "sphere", "center": [0, 0, 0], "radius": 1.0, "material": 0}],
    }


def _write(tmp_path, obj=None):
    p = tmp_path / "scene.json"
    p.write_text(json.dumps(obj or _scene_json()))
    return str(p)


@pytest.mark.parametrize("shape,cols", [((9, 7), 100), ((33, 250), 80), ((16, 32), 7),
                                        ((1, 1), 10)])
def test_frames_match_jax(shape, cols, capsys):
    """``ansi_frame`` and ``redraw`` (first and later frames, with a status
    line) print the JAX package's strings for the same linear image, out of
    range values included."""
    lin = np.random.RandomState(sum(shape)).uniform(-0.2, 1.4, size=(*shape, 3))
    lin = lin.astype(np.float32)
    assert term.ansi_frame(lin, cols) == jax_term.ansi_frame(lin, cols)
    printed = []
    for mod in (term, jax_term):
        mod.redraw(lin, cols, first=True)
        mod.redraw(lin, cols, first=False, status="sample 2/4  1.00 Mpaths/s")
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1]


def test_live_frames_and_same_png(tmp_path):
    """--live --live-cols 16 prints one ANSI frame per batch (cursor moved
    back over each earlier one) and writes the PNG of the run without it."""
    path = _write(tmp_path)
    base = ["--device", "cpu", "--samples", "3", "--depth", "3", "--batch", "1"]
    assert app.main([path, str(tmp_path / "plain.png"), "--quiet", *base]) == 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = app.main([path, str(tmp_path / "live.png"), "--live", "--live-cols", "16", *base])
    out = buf.getvalue()
    assert rc == 0
    assert out.count("\x1b[38;2;") == 3 * 16 * 4  # 3 frames, 16 columns, 4 text rows
    assert out.count("\x1b[5A") == 2 and "sample 3/3" in out
    assert (tmp_path / "live.png").read_bytes() == (tmp_path / "plain.png").read_bytes()


def test_watch_reloads_scene(tmp_path, monkeypatch):
    """--watch: the scene file is rewritten from inside the render loop
    (after the 4th batch, as JAX's test does) with a bright sky; the reload
    is logged, the accumulation restarts and the image shows the new sky."""
    obj = _scene_json()
    obj["background_color"] = [0.01, 0.01, 0.01]
    path = _write(tmp_path, obj)
    out = tmp_path / "out.png"
    calls = {"n": 0}
    orig_update = Renderer.update

    def update_and_rewrite(self, n):
        calls["n"] += 1
        if calls["n"] == 4:
            obj["background_color"] = [0.9, 0.9, 0.9]
            with open(path, "w") as f:
                json.dump(obj, f)
            os.utime(path, (1e9, 2e9))  # a new mtime, whatever the clock's grain
        return orig_update(self, n)

    monkeypatch.setattr(Renderer, "update", update_and_rewrite)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = app.main([path, str(out), "--device", "cpu", "--samples", "8", "--depth", "3",
                       "--batch", "1", "--watch"])
    assert rc == 0
    assert calls["n"] >= 5 + 8 - 4, calls  # the reload restarted the 8 samples
    assert "Scene reloaded" in buf.getvalue()
    assert image.decode_png(out.read_bytes()).mean() > 60


def test_key_controls_inactive_off_tty():
    """Piped stdin (as under pytest): the key poller stays inert."""
    kc = app._KeyControls(enabled=True)
    assert not kc.active and kc.poll() == ""
    kc.close()  # a no-op
    assert not app._KeyControls(enabled=False).active


def test_keys_quit_snapshot_camera_reset(tmp_path, monkeypatch):
    """'w' writes a snapshot, 'c' the camera JSON, 'r' restarts the
    accumulation and 'q' ends the run early, still writing the image (JAX
    tests/test_app.py:198)."""
    path = _write(tmp_path)
    out = tmp_path / "out.png"
    presses = iter(["", "wc", "r", "q"])

    class FakeKeys:
        def __init__(self, enabled):
            self.active = True

        def poll(self):
            return next(presses, "q")

        def close(self):
            pass

    monkeypatch.setattr(app, "_KeyControls", FakeKeys)
    metrics = tmp_path / "m.jsonl"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = app.main([path, str(out), "--device", "cpu", "--samples", "64", "--depth", "3",
                       "--batch", "1", "--watch", "--metrics", str(metrics)])
    assert rc == 0 and out.exists()
    log = buf.getvalue()
    assert "Snapshot written" in log and "Accumulation reset" in log
    assert "Quit requested" in log
    cam = json.loads((tmp_path / "out.png.camera.json").read_text())
    assert cam["center"] == [0, 1, 3]
    done = json.loads(metrics.read_text().splitlines()[-1])
    assert done["event"] == "done" and done["samples"] == 1  # one batch after the reset


def test_profile_writes_trace(tmp_path):
    """--profile DIR writes a Chrome trace of the render loop (the CPU's
    ops here; on a card the kernels' launches too)."""
    prof = tmp_path / "prof"
    rc = app.main([_write(tmp_path), str(tmp_path / "out.png"), "--device", "cpu", "--quiet",
                   "--samples", "2", "--depth", "2", "--profile", str(prof)])
    assert rc == 0
    trace = json.loads((prof / "trace.json").read_text())
    assert len(trace["traceEvents"]) > 0
