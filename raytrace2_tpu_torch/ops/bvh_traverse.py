"""The BVH walk: closest sphere hit through the flattened sphere BVH (port of
``raytrace2_tpu/ops/bvh_traverse.py`` and the walk of
``raytrace2_tpu/ops/intersect.py::_sphere_best_bvh``).

Each ray walks the tree with an explicit stack, as the reference's recursion
does (src/cpu_raytrace/BVH.cpp:50-55): pop a node, test its box against
(t_min, best_t); at a hit leaf test the sphere, which shrinks best_t; at a
hit internal node push the right child, then the left, so the left pops
first. A leaf is kept only when strictly closer, so the first leaf visited
wins a tie.

The JAX package runs the walk as one ``lax.while_loop`` per ray under
``vmap``: a device loop with no host in it. Here it has two forms:

* ``traverse``, the plain PyTorch version: all rays step together, a stack
  tensor ``[N, max_depth + 2]``, until every stack is empty (one host read a
  step). It takes any leaf function and counts the nodes and leaves visited
  (``stats``), which the bound of the kernel is computed from.
* ``csrc/bvh_traverse.cu``, the kernel: one thread a ray, the stack in local
  memory, sphere leaves only (``closest_sphere`` launches it for CUDA
  tensors and runs the plain walk for CPU ones).

NaN: ``1/d`` is ±inf where a direction component is 0, and ``(mn - o) *
inf`` is NaN where the ray lies in a slab's plane. ``torch.minimum``,
``torch.maximum`` and the reductions propagate that NaN, as ``jnp`` does,
so the box is a miss; the kernel tests for it explicitly (``fminf`` would
drop it).

Both forms compute in float32 whatever ``defs.REAL`` is, as the JAX
package's kernels do: ``pack`` casts the tree and the spheres and
``closest_sphere`` the rays.
"""

from __future__ import annotations

import torch

from raytrace2_tpu_torch.ops.kernels import build
from raytrace2_tpu_torch.scene.bvh import BVHArrays

BIG = 3.0e38
# The kernel's stack (csrc/bvh_traverse.cu kMaxStack): max_depth + 2 must fit.
MAX_STACK = 64
# f32 operations of a node's box test and of a sphere leaf's test (the
# kernel's arithmetic, compares counted, selects not), and the bytes a
# visited node and a tested sphere read.
OPS_NODE, OPS_LEAF = 25, 35
NODE_BYTES, SPHERE_BYTES = 36, 28

# Launches of the CUDA kernel (the plain version does not count).
LAUNCHES = 0


def aabb_hit(mn, mx, o, inv_d, t0, t1):
    """Slab test (AABB.hpp:34-47) of rays against boxes, [K, 3] each and
    [K] intervals: shrink (t0, t1) per axis, a hit iff t1 > t0; NaN is a
    miss."""
    ta = (mn - o) * inv_d
    tb = (mx - o) * inv_d
    t0 = torch.maximum(t0, torch.amax(torch.minimum(ta, tb), -1))
    t1 = torch.minimum(t1, torch.amin(torch.maximum(ta, tb), -1))
    return t1 > t0


def traverse(bvh, leaf_fn, o, d, t_min, t_max, max_depth: int, stats=None):
    """Batched closest hit through the BVH: ``o``, ``d`` [N, 3], ``t_min``,
    ``t_max`` [N]; ``bvh`` a ``BVHArrays`` of tensors on the rays' device;
    ``leaf_fn(prim, lo, hi)`` → t of each ray's primitive ``prim`` [N] in
    (lo, hi), BIG where none (its rows outside the visited leaves are
    ignored). Returns (t, prim) [N], prim -1 and t = t_max on a miss.
    ``stats`` (a dict) gets ``nodes``, ``leaves`` and ``steps``: the nodes
    popped, the leaves tested and the longest ray's nodes."""
    n = o.shape[0]
    inv_d = 1.0 / d
    lo_box, hi_box = bvh.aabb_min, bvh.aabb_max
    left, right, prim = (x.long() for x in (bvh.left, bvh.right, bvh.prim))
    stack = torch.zeros((n, max_depth + 2), dtype=torch.long, device=o.device)
    sp = torch.ones(n, dtype=torch.long, device=o.device)
    best_t = t_max.clone()
    best_p = torch.full((n,), -1, dtype=torch.long, device=o.device)
    nodes = leaves = steps = 0
    rows = torch.arange(n, device=o.device)
    while True:
        act = sp > 0
        n_act = int(act.sum())
        if not n_act:
            break
        nodes, steps = nodes + n_act, steps + 1
        sp = sp - act.long()
        node = stack[rows, sp]
        hit = act & aabb_hit(lo_box[node], hi_box[node], o, inv_d, t_min, best_t)
        p = prim[node]
        is_leaf = p >= 0
        leaf = hit & is_leaf
        leaves += int(leaf.sum())
        t_leaf = torch.where(leaf, leaf_fn(p.clamp(min=0), t_min, best_t), BIG)
        closer = t_leaf < best_t
        best_t = torch.where(closer, t_leaf, best_t)
        best_p = torch.where(closer, p, best_p)
        push = (hit & ~is_leaf).nonzero()[:, 0]
        stack[push, sp[push]] = right[node[push]]
        stack[push, sp[push] + 1] = left[node[push]]
        sp[push] += 2
    if stats is not None:
        stats["nodes"] = stats.get("nodes", 0) + nodes
        stats["leaves"] = stats.get("leaves", 0) + leaves
        stats["steps"] = max(stats.get("steps", 0), steps)
    return best_t, best_p.to(torch.int32)


def traverse_one(bvh, leaf_fn, o, d, t_min, t_max, max_depth: int):
    """``traverse`` of one ray: ``o``, ``d`` [3], ``t_min``, ``t_max`` 0-dim."""
    t, p = traverse(bvh, leaf_fn, o[None], d[None], t_min.reshape(1), t_max.reshape(1),
                    max_depth)
    return t[0], p[0]


def pack(bvh, spheres):
    """The walk's tables on the scene's device, float32 and int32, contiguous:
    (aabb_min [M, 3], aabb_max [M, 3], left, right, prim [M], center0 [S, 3],
    displacement [S, 3], radius [S])."""
    f32 = [x.to(torch.float32).contiguous() for x in
           (bvh.aabb_min, bvh.aabb_max, spheres.center0, spheres.displacement, spheres.radius)]
    i32 = [x.to(torch.int32).contiguous() for x in (bvh.left, bvh.right, bvh.prim)]
    return (f32[0], f32[1], *i32, *f32[2:])


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def sphere_leaf(tables, o, d, time):
    """The leaf function of ``_sphere_best_bvh`` (JAX intersect.py:397-411)
    over ``pack``'s spheres: c = center0 + t·disp, oc = c − o, a = d·d,
    h = d·oc, cc = oc·oc − r², the nearest root strictly inside (lo, hi).
    Products and sums in the kernel's order."""
    c0, disp, rad = tables[5:]
    o, d = o.unbind(-1), d.unbind(-1)

    def leaf(p, lo, hi):
        c = [c0[p, k] + time * disp[p, k] for k in range(3)]
        oc = [c[k] - o[k] for k in range(3)]
        r = rad[p]
        a = _dot(*d, *d)
        h = _dot(*d, *oc)
        cc = _dot(*oc, *oc) - r * r
        disc = h * h - a * cc
        has = disc >= 0.0
        # Correctly rounded, as sqrtf and XLA's sqrt are: torch's float32
        # sqrt on the CPU is off by an ulp for some inputs, which the
        # cancellation in h - sq magnifies.
        sq = torch.sqrt(torch.where(has, disc, 0.0).double()).float()
        r0 = (h - sq) / a
        r1 = (h + sq) / a
        ok0 = (r0 > lo) & (r0 < hi)
        ok1 = (r1 > lo) & (r1 < hi)
        return torch.where(has & (ok0 | ok1), torch.where(ok0, r0, r1), BIG)

    return leaf


def closest_sphere_plain(tables, o, d, time, t_min, t_max, max_depth: int, stats=None):
    """Plain PyTorch version of the kernel (float32 inputs)."""
    return traverse(BVHArrays(*tables[:5]), sphere_leaf(tables, o, d, time), o, d, t_min,
                    t_max, max_depth, stats)


def closest_sphere(tables, o, d, time, t_min, t_max, max_depth: int, stats=None):
    """Nearest sphere hit of each ray through the BVH: (t [N] f32, prim [N]
    int32), prim -1 and t = t_max on a miss. ``tables`` from ``pack``;
    ``max_depth`` the tree's depth (``scene.bvh.depth``). The rays are cast
    to float32. On a CPU tensor this runs the plain walk (``stats`` as in
    ``traverse``); on a CUDA tensor it launches the kernel (built at first
    use) or raises."""
    global LAUNCHES
    n = o.shape[0]
    o, d, time, t_min, t_max = (x.to(torch.float32).contiguous()
                                for x in (o, d, time, t_min, t_max))
    for name, t, shape in (("o", o, (n, 3)), ("d", d, (n, 3)), ("time", time, (n,)),
                           ("t_min", t_min, (n,)), ("t_max", t_max, (n,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    for x in tables:
        if x.device != o.device:
            raise ValueError(f"the BVH tables are on {x.device}, the rays on {o.device}")
    if max_depth + 2 > MAX_STACK:
        raise ValueError(f"a BVH of depth {max_depth} needs a stack of {max_depth + 2}, "
                         f"above the kernel's {MAX_STACK}")
    if o.device.type == "cpu":
        return closest_sphere_plain(tables, o, d, time, t_min, t_max, max_depth, stats)
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    best_t = torch.empty((n,), dtype=torch.float32, device=o.device)
    best_p = torch.empty((n,), dtype=torch.int32, device=o.device)
    build.launch_bvh_traverse(o, d, time, t_min, t_max, tables, best_t, best_p)
    LAUNCHES += 1
    return best_t, best_p


def bound_counts(stats, n_rays: int, n_nodes: int, n_spheres: int) -> tuple[int, int]:
    """(f32 operations, bytes) of a walk for its bound: the visited nodes'
    box tests and the tested leaves' sphere tests from the plain walk's
    ``stats``; each input read once (rays 36 B, nodes and spheres) and each
    output written once (8 B a ray)."""
    ops = stats["nodes"] * OPS_NODE + stats["leaves"] * OPS_LEAF
    return ops, n_rays * 44 + n_nodes * NODE_BYTES + n_spheres * SPHERE_BYTES
