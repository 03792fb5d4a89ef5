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


def noise_ref(perm: np.ndarray, grad: np.ndarray, p: np.ndarray) -> float:
    """NumPy float64 oracle of the reference Perlin evaluation
    (src/cpu_raytrace/PerlinNoiseGen.cpp:66-88 and PerlinInterp :10-26), as
    the JAX package's ``noise_ref``."""
    p = np.asarray(p, np.float64)
    u, v, w = p - np.floor(p)
    i, j, k = (int(np.floor(c)) for c in p)
    uu = u * u * (3 - 2 * u)
    vv = v * v * (3 - 2 * v)
    ww = w * w * (3 - 2 * w)
    accum = 0.0
    for di in range(2):
        for dj in range(2):
            for dk in range(2):
                g = grad[perm[0][(i + di) & 255] ^ perm[1][(j + dj) & 255]
                         ^ perm[2][(k + dk) & 255]]
                weight = np.array([u - di, v - dj, w - dk])
                accum += (
                    (di * uu + (1 - di) * (1 - uu))
                    * (dj * vv + (1 - dj) * (1 - vv))
                    * (dk * ww + (1 - dk) * (1 - ww))
                    * float(np.dot(g, weight))
                )
    return accum


def turb_ref(perm: np.ndarray, grad: np.ndarray, p: np.ndarray, depth: int = 7) -> float:
    """NumPy oracle of turbulence (src/cpu_raytrace/PerlinNoiseGen.cpp:52-64)."""
    accum = 0.0
    temp_p = np.asarray(p, np.float64).copy()
    weight = 1.0
    for _ in range(depth):
        accum += weight * noise_ref(perm, grad, temp_p)
        weight *= 0.5
        temp_p = temp_p * 2
    return abs(accum)
