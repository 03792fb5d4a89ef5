"""Image output: PNG and PPM writers with the reference's exact conversion.

``util::WriteImage`` (src/Util.cpp:39-79) applies sqrt (gamma-2.0), scales by
255.999, clamps to [0,255], and writes vertically flipped (the renderer's row
0 is the bottom scanline; stbi_flip_vertically_on_write(true)). The PNG
encoder here is a dependency-free implementation over zlib (stdlib) — no
image library needed.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_color(linear: np.ndarray) -> np.ndarray:
    """Linear [H,W,3] float → u8 with sqrt gamma (Util.cpp:41-48)."""
    g = np.sqrt(np.maximum(np.asarray(linear, np.float64), 0.0))
    return np.clip(g * 255.999, 0.0, 255.0).astype(np.uint8)


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def encode_png(rgb: np.ndarray) -> bytes:
    """Encode an [H,W,3] u8 array as an 8-bit RGB PNG."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    # Filter type 0 per scanline.
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return b"".join(
        [
            b"\x89PNG\r\n\x1a\n",
            _png_chunk(b"IHDR", ihdr),
            _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)),
            _png_chunk(b"IEND", b""),
        ]
    )


def decode_png(data: bytes) -> np.ndarray:
    """Minimal decoder for PNGs produced by encode_png (and any 8-bit RGB/RGBA
    non-interlaced PNG with filters 0-4) — used by tests and golden compares."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    idat = b""
    w = h = channels = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", payload)
            assert depth == 8 and interlace == 0, "unsupported PNG"
            channels = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    raw = zlib.decompress(idat)
    stride = w * channels
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        row = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int32)
        pos += 1 + stride
        if ftype == 0:
            cur = row
        elif ftype == 1:  # Sub
            cur = row.copy()
            for x in range(channels, stride):
                cur[x] = (cur[x] + cur[x - channels]) & 0xFF
        elif ftype == 2:  # Up
            cur = (row + prev) & 0xFF
        elif ftype == 3:  # Average
            cur = row.copy()
            for x in range(stride):
                left = cur[x - channels] if x >= channels else 0
                cur[x] = (cur[x] + ((left + prev[x]) >> 1)) & 0xFF
        else:  # Paeth
            cur = row.copy()
            for x in range(stride):
                a = cur[x - channels] if x >= channels else 0
                b = prev[x]
                c = prev[x - channels] if x >= channels else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[x] = (cur[x] + pr) & 0xFF
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out.reshape(h, w, channels)


def write_image(linear: np.ndarray, path: str, png: bool | None = None) -> None:
    """Write a linear [H,W,3] image with the reference's conversion + vertical
    flip (Util.cpp:39-79). Format from extension unless ``png`` is forced."""
    if png is None:
        png = not path.endswith(".ppm")
    rgb = to_color(linear)[::-1]  # bottom row first → flip for display
    if png:
        with open(path, "wb") as f:
            f.write(encode_png(rgb))
    else:
        h, w, _ = rgb.shape
        with open(path, "w") as f:
            f.write(f"P3\n{w} {h}\n255\n")
            for row in rgb.reshape(h * w, 3):
                f.write(f"{row[0]} {row[1]} {row[2]}\n")
