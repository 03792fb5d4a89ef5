"""Resume on the CPU: the CLI's ``--checkpoint`` (a render of 4 samples, then
4 more, is bitwise a one-shot render of 8), ``--checkpoint-every`` and
``--preview-every``; checkpoints moving between the JAX package and the
port in both directions; the Renderer's ``resize``, ``set_state`` and
``display_pixels``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace2_tpu import render as jax_render
from raytrace2_tpu.io import checkpoint as jax_ckpt
from raytrace2_tpu_torch import app
from raytrace2_tpu_torch.io import checkpoint, image
from raytrace2_tpu_torch.render import Renderer, RenderState, display_image
from raytrace2_tpu_torch.scene import loader
from test_torch_scenes import write_scene

W, H, DEPTH = 12, 10, 4


def _cli(scene, out, samples, *argv):
    return app.main([scene, str(out), "--device", "cpu", "--quiet", "--width", str(W),
                     "--height", str(H), "--depth", str(DEPTH), "--samples", str(samples),
                     *argv])


def test_checkpointed_render_equals_one_shot(tmp_path):
    """4 samples with --checkpoint, then the same command at 8 samples
    resumes at sample 4: its accumulator, frame count and PNG are bitwise
    the one-shot 8-sample render's (both take sqrt_spp 2, and a sample's
    keys depend only on seed, pixel and sample index)."""
    scene = write_scene(tmp_path, "cornell")
    ck = tmp_path / "resume.npz"
    assert _cli(scene, tmp_path / "a.png", 4, "--checkpoint", str(ck)) == 0
    first = checkpoint.load_state(str(ck))
    assert first.frame_idx == 4 and first.accum.shape == (H, W, 3)
    assert _cli(scene, tmp_path / "b.png", 8, "--checkpoint", str(ck)) == 0
    resumed = checkpoint.load_state(str(ck))
    one = tmp_path / "one.npz"
    assert _cli(scene, tmp_path / "c.png", 8, "--checkpoint", str(one)) == 0
    once = checkpoint.load_state(str(one))
    assert resumed.frame_idx == once.frame_idx == 8
    assert float(resumed.accum.max()) > 0.0
    assert torch.equal(resumed.accum, once.accum)
    assert not torch.equal(first.accum, once.accum)
    assert (tmp_path / "b.png").read_bytes() == (tmp_path / "c.png").read_bytes()
    # A checkpoint of another image size is refused.
    assert app.main([scene, str(tmp_path / "d.png"), "--device", "cpu", "--quiet",
                     "--width", "6", "--height", "5", "--samples", "8",
                     "--checkpoint", str(ck)]) == 1


def test_checkpoint_every_and_preview_every(tmp_path, monkeypatch):
    """--checkpoint-every 2 saves at samples 2, 4 and 6 and at the end;
    --preview-every 2 rewrites the output PNG at samples 2 and 4 (not at
    the last, which the final write covers); the batch follows both."""
    scene = write_scene(tmp_path, "cornell")
    saved, written = [], []
    save, write = checkpoint.save_state, image.write_image
    monkeypatch.setattr(checkpoint, "save_state",
                        lambda p, s: (saved.append(s.frame_idx), save(p, s)))
    monkeypatch.setattr(image, "write_image",
                        lambda lin, p: (written.append(p), write(lin, p)))
    ck, out = tmp_path / "every.npz", tmp_path / "every.png"
    assert _cli(scene, out, 6, "--checkpoint", str(ck), "--checkpoint-every", "2",
                "--preview-every", "2", "--batch", "4") == 0
    assert saved == [2, 4, 6, 6]
    assert written == [str(out)] * 3
    png = image.decode_png(out.read_bytes())
    assert png.shape == (H, W, 3) and png.max() > 0
    assert checkpoint.load_state(str(ck)).frame_idx == 6


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_moves_between_packages(tmp_path, direction):
    """One .npz format: a checkpoint written by the JAX package's
    save_state loads in the port, and the port's loads in the JAX package,
    with the same values and types (accum f32 [H, W, 3], frame_idx int32)."""
    accum = np.random.RandomState(3).uniform(0, 2, (H, W, 3)).astype(np.float32)
    path = str(tmp_path / "state.npz")
    if direction == "jax_to_port":
        jax_ckpt.save_state(path, jax_render.RenderState(jnp.asarray(accum), jnp.int32(7)))
        state = checkpoint.load_state(path)
        assert state.accum.dtype == torch.float32 and state.frame_idx == 7
        np.testing.assert_array_equal(state.accum.numpy(), accum)
    else:
        checkpoint.save_state(path, RenderState(torch.from_numpy(accum), 7))
        state = jax_ckpt.load_state(path)
        assert state.frame_idx.dtype == jnp.int32 and int(state.frame_idx) == 7
        np.testing.assert_array_equal(np.asarray(state.accum), accum)
    with np.load(path) as z:
        assert sorted(z.files) == ["accum", "frame_idx"]
        assert z["accum"].dtype == np.float32 and z["frame_idx"].dtype == np.int32
        assert z["frame_idx"].shape == ()


def test_renderer_resize_set_state_display(tmp_path):
    """set_state restores a state (checked against the image size) and the
    next samples continue from it; resize restarts the accumulation;
    display_pixels is display_image of the state."""
    scene, _ = loader.load_scene(write_scene(tmp_path, "cornell"))
    r = Renderer(scene, W, H, num_samples=4, max_depth=DEPTH, device="cpu")
    r.update(2)
    saved = RenderState(r.state.accum.clone(), r.frame_idx)
    r.update(2)
    full = r.state.accum.clone()
    np.testing.assert_array_equal(r.display_pixels(), display_image(r.state).numpy())
    r2 = Renderer(scene, W, H, num_samples=4, max_depth=DEPTH, device="cpu")
    r2.set_state(saved)
    assert r2.frame_idx == 2
    r2.update(2)
    assert torch.equal(r2.state.accum, full)
    with pytest.raises(ValueError, match="does not match"):
        r2.set_state(RenderState(torch.zeros(H + 1, W, 3), 1))
    r2.resize(5, 4)
    assert (r2.width, r2.height, r2.frame_idx) == (5, 4, 0)
    assert r2.state.accum.shape == (4, 5, 3) and float(r2.state.accum.abs().max()) == 0.0
    assert r2.render(2, batch=2).shape == (4, 5, 3)
