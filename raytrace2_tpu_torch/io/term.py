"""Terminal live preview (port of ``raytrace2_tpu/io/term.py``): the
headless stand-in for the reference's SDL2/OpenGL live view
(src/Window.cpp, src/App.cpp:176-242).

The progressive accumulator is drawn as 24-bit ANSI half blocks: "▀" takes
an upper (foreground) and a lower (background) pixel, so one text row shows
two image rows. The CLI's ``--live`` redraws the frame in place after each
batch of samples.
"""

from __future__ import annotations

import numpy as np

from raytrace2_tpu_torch.io import image as image_io

_HALF = "▀"  # upper half block


def ansi_frame(linear: np.ndarray, max_cols: int = 100) -> str:
    """One ANSI frame of a linear [H, W, 3] image, at most ``max_cols``
    wide (row 0 is the bottom row, as in the renderer's buffer)."""
    rgb = image_io.to_color(linear)[::-1]  # top row first for printing
    step = max(1, (rgb.shape[1] + max_cols - 1) // max_cols)
    rgb = rgb[::step, ::step]
    if rgb.shape[0] % 2:
        rgb = np.concatenate([rgb, np.zeros((1, rgb.shape[1], 3), np.uint8)], axis=0)
    lines = []
    for top, bot in zip(rgb[0::2], rgb[1::2]):
        lines.append("".join(
            f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[48;2;{b[0]};{b[1]};{b[2]}m{_HALF}"
            for t, b in zip(top.tolist(), bot.tolist())) + "\x1b[0m")
    return "\n".join(lines)


def redraw(linear: np.ndarray, max_cols: int = 100, first: bool = False,
           status: str = "") -> None:
    """Print a frame, with an optional status line under it (the reference's
    frame-count panel, App.cpp:212-213), moving the cursor back over the
    previous frame unless this is the ``first``."""
    frame = ansi_frame(linear, max_cols)
    if status:
        frame += "\n\x1b[2K" + status
    if not first:
        print(f"\x1b[{frame.count(chr(10)) + 1}A", end="")
    print(frame)
