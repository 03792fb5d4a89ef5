"""Checkpoint and resume of the progressive accumulator (port of
``raytrace2_tpu/io/checkpoint.py``).

The render state is the (accum, frame_idx) pair (``render.RenderState``).
It is saved as one ``.npz`` with the JAX package's keys and types:
``accum`` [H, W, 3] float32 and ``frame_idx`` a 0-d int32, so a checkpoint
written by either package resumes in the other.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from raytrace2_tpu_torch import render as render_mod


def save_state(path: str, state: "render_mod.RenderState") -> None:
    """Write ``state`` to ``path`` through a temporary file and a rename, so
    that an interrupted save leaves the previous checkpoint whole."""
    tmp = path + ".tmp.npz"  # np.savez appends .npz to a name without it
    np.savez(tmp, accum=state.accum.detach().cpu().numpy().astype(np.float32),
             frame_idx=np.asarray(state.frame_idx, dtype=np.int32))
    os.replace(tmp, path)


def load_state(path: str, device="cpu") -> "render_mod.RenderState":
    """The state saved at ``path``, its accumulator on ``device``."""
    with np.load(path) as z:
        return render_mod.RenderState(
            accum=torch.from_numpy(np.asarray(z["accum"], dtype=np.float32)).to(device),
            frame_idx=int(z["frame_idx"]))
