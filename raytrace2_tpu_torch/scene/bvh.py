"""Flattened sphere BVH (port of ``raytrace2_tpu/scene/bvh.py``).

The reference builds a binary tree of nodes: sort the span by the minimum of
each child's AABB along the longest axis of the span's bounds, split at the
median, recurse (src/cpu_raytrace/BVH.cpp:10-48). Here the same algorithm
emits index arrays, node 0 the root, ids in pre-order (left subtree before
right), 2N - 1 nodes for N primitives:

* ``left``/``right`` [M] int32: child node ids (-1 at leaves)
* ``prim`` [M] int32: the primitive of a leaf, -1 at internal nodes
* ``aabb_min``/``aabb_max`` [M, 3] float32

Two builders with identical output: NumPy, and the repository's C++ builder
(``native/libbvh.so``, built by ``make -C native``), loaded read-only through
ctypes. The walk is ``ops/bvh_traverse.py``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import Any

import numpy as np

NATIVE_LIB = Path(__file__).resolve().parents[2] / "native" / "libbvh.so"


@dataclasses.dataclass(frozen=True)
class BVHArrays:
    aabb_min: Any  # [M, 3] f32
    aabb_max: Any  # [M, 3] f32
    left: Any      # [M] i32
    right: Any     # [M] i32
    prim: Any      # [M] i32

    @property
    def num_nodes(self) -> int:
        return self.left.shape[0]


_LIB = None


def _native_lib():
    """The C++ builder, bound at first use; None where it is not built."""
    global _LIB
    if _LIB is None and NATIVE_LIB.exists():
        lib = ctypes.CDLL(str(NATIVE_LIB))
        lib.bvh_build.restype = ctypes.c_int
        lib.bvh_build.argtypes = [ctypes.c_int] + [
            np.ctypeslib.ndpointer(t, flags="C")
            for t in (np.float32,) * 4 + (np.int32,) * 3]
        _LIB = lib
    return _LIB


def build(aabb_min: np.ndarray, aabb_max: np.ndarray, use_native: bool | None = None) -> BVHArrays:
    """The flattened BVH over N primitive AABBs. ``use_native``: the C++
    builder (True; raises where the library is not built), the NumPy one
    (False), or the C++ one where it is built (None)."""
    aabb_min = np.ascontiguousarray(aabb_min, np.float32).reshape(-1, 3)
    aabb_max = np.ascontiguousarray(aabb_max, np.float32).reshape(-1, 3)
    n = aabb_min.shape[0]
    if n == 0:
        raise ValueError("cannot build a BVH over zero primitives")
    lib = _native_lib() if use_native in (None, True) else None
    if use_native is True and lib is None:
        raise RuntimeError(f"native BVH library {NATIVE_LIB} not built (make -C native)")
    if lib is None:
        return _build_numpy(aabb_min, aabb_max)
    m = 2 * n - 1
    out_min, out_max = np.empty((m, 3), np.float32), np.empty((m, 3), np.float32)
    left, right, prim = (np.empty(m, np.int32) for _ in range(3))
    used = lib.bvh_build(n, aabb_min, aabb_max, out_min, out_max, left, right, prim)
    if used != m:
        raise RuntimeError(f"native builder emitted {used} nodes, expected {m}")
    return BVHArrays(out_min, out_max, left, right, prim)


def _build_numpy(aabb_min: np.ndarray, aabb_max: np.ndarray) -> BVHArrays:
    """Median split with an explicit stack, in the reference's pre-order: a
    node over c primitives holds ids [id, id + 2c - 1), its left child is
    id + 1 (over the first half) and its right child id + 2·half."""
    n = aabb_min.shape[0]
    m = 2 * n - 1
    out_min = np.empty((m, 3), np.float32)
    out_max = np.empty((m, 3), np.float32)
    left = np.full(m, -1, np.int32)
    right = np.full(m, -1, np.int32)
    prim = np.full(m, -1, np.int32)
    order = np.arange(n)
    stack = [(0, n, 0)]
    while stack:
        start, end, node = stack.pop()
        span = order[start:end]
        mn = aabb_min[span].min(0)
        mx = aabb_max[span].max(0)
        out_min[node], out_max[node] = mn, mx
        if end - start == 1:
            prim[node] = span[0]
            continue
        # Longest axis of the span's bounds (AABB.hpp:49-54); a stable sort
        # of the children's minimums on it (BVH.cpp:33-48).
        axis = int(np.argmax(mx - mn))
        order[start:end] = span[np.argsort(aabb_min[span, axis], kind="stable")]
        mid = (end - start) // 2
        left[node], right[node] = node + 1, node + 2 * mid
        stack.append((start + mid, end, node + 2 * mid))
        stack.append((start, start + mid, node + 1))
    return BVHArrays(out_min, out_max, left, right, prim)


def build_sphere_bvh(spheres) -> tuple[BVHArrays, int]:
    """The BVH over a host scene's active spheres (the loader packs them as a
    prefix, so a leaf's prim is the sphere's row) and its depth. The boxes
    cover the centre's whole path over the shutter, as the reference's
    moving sphere unions its t = 0 and t = 1 boxes (Sphere.hpp:24-27)."""
    c0 = np.asarray(spheres.center0)
    disp = np.asarray(spheres.displacement)
    rad = np.asarray(spheres.radius)[:, None]
    act = np.asarray(spheres.active)
    n = int(act.sum())
    if not np.all(act[:n]):
        raise ValueError("active spheres must form a prefix")
    lo = np.minimum(c0, c0 + disp)[:n] - rad[:n]
    hi = np.maximum(c0, c0 + disp)[:n] + rad[:n]
    tree = build(lo, hi)
    return tree, depth(tree)


def depth(bvh: BVHArrays) -> int:
    """The tree's largest depth (the root at 0), which sizes the walk's stack."""
    left, right = np.asarray(bvh.left), np.asarray(bvh.right)
    maxd = 0
    stack = [(0, 0)]
    while stack:
        node, dd = stack.pop()
        maxd = max(maxd, dd)
        if left[node] >= 0:
            stack.append((left[node], dd + 1))
            stack.append((right[node], dd + 1))
    return maxd


def sah_cost(bvh: BVHArrays) -> float:
    """Surface-area-heuristic cost, relative to the root's area (diagnostics)."""
    mn, mx = np.asarray(bvh.aabb_min), np.asarray(bvh.aabb_max)
    ext = np.maximum(mx - mn, 0)
    area = 2 * (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 0] * ext[:, 2])
    root = max(area[0], 1e-30)
    internal = np.asarray(bvh.prim) < 0
    return float((area[internal].sum() * 1.2 + area[~internal].sum()) / root)
