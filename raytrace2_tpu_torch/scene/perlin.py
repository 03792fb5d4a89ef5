"""Perlin noise table generation (port of ``raytrace2_tpu/scene/perlin.py``).

Per Noise texture: 256 unit gradients from normalized uniform cube samples
and three shuffled permutation tables (src/cpu_raytrace/PerlinNoiseGen.cpp:
40-50), seeded deterministically from (seed, texture index) so renders are
reproducible. Same numpy calls in the same order as the JAX package, so the
tables are identical.
"""

from __future__ import annotations

import numpy as np

from raytrace2_tpu_torch import defs

POINT_COUNT = 256


def make_tables(seed: int, tex_idx: int, point_count: int = POINT_COUNT):
    """Return (perm [3,256] int32, grad [256,3] float32)."""
    rs = np.random.RandomState(np.uint32((0x9E3779B9 * (tex_idx + 1) + seed) & 0xFFFFFFFF))
    v = rs.uniform(-1.0, 1.0, size=(point_count, 3))
    norms = np.linalg.norm(v, axis=-1, keepdims=True)
    norms = np.where(norms > 0, norms, 1.0)
    grad = (v / norms).astype(defs.REAL)
    perm = np.stack([rs.permutation(point_count) for _ in range(3)]).astype(defs.INDEX)
    return perm, grad


def identity_tables(point_count: int = POINT_COUNT):
    """Placeholder tables for non-noise texture rows."""
    perm = np.tile(np.arange(point_count, dtype=defs.INDEX), (3, 1))
    grad = np.zeros((point_count, 3), defs.REAL)
    return perm, grad
