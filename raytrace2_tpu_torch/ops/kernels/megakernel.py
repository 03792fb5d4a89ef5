"""v4 path-regeneration megakernel: host packing, the plain PyTorch version,
and the wrapper that launches the Hopper kernel (``csrc/megakernel_v4.cu``).

Port of ``raytrace2_tpu/ops/pallas/megakernel.py`` (``_render_kernel_v4``,
launched by ``trace_megakernel_batch``): every lane owns one pixel slot and
loops over that pixel's samples; when its path ends it regenerates the
camera ray of its next sample, and it returns the radiance summed over the
batch's samples. Lanes map to pixels linearly (slot == pixel id) or, as
the JAX kernel does above 512 records, block-tiled: each tile of
``BLOCK_TILE`` lanes owns one square pixel block, and with ``wave_frac < 1``
a tile refills its dead lanes only once its live count falls to that
fraction of its in-image lanes. Keys come from the pixel id, so the image
is bitwise the same for every layout and ``wave_frac``.

The plain version below follows the JAX kernel's math operation by
operation, vectorised over all lanes at once. It is what the CPU tests and
the on-card comparison run; on a CUDA tensor the wrapper launches the kernel
and nothing else.

Sweep order and comparisons are the JAX kernel's: spheres → quads → AA
boxes → media; sphere ``root < best_t``, quad ``t <= best_t``, box
``t < best_t``, medium ``hit_dist <= e1 - e0``. Quads and media are swept
flat in record order. Spheres and AA boxes with ``HIER_MIN`` or more records
go through JAX's two-level cluster-skip sweep (``_hier_sweep``): 128-record
superclusters in a front-to-back order, then their 16-record clusters in
order, each skipped when its AABB's slab test fails for the ray's interval.
The port picks the order per lane from the ray's own direction (JAX picks
one per tile from the summed directions), so the visit order never depends
on which other lanes are live. With ``RT2_SWEEP_MODE=bvh`` (``SWEEP_MODE``)
those families walk JAX's threaded BVH over their clusters instead
(``_bvh_sweep``), each lane on its own cursor and its own threading. Noise
textures evaluate hash-gradient noise, or with an ``ntab`` operand
(``noise_impl="table"``) the reference's 256-entry Perlin tables. The
material/texture resolve is a direct index (the JAX sweep and gather both
copy exact table values, so the result is the same).
"""

from __future__ import annotations

import os
import weakref

import torch

from raytrace2_tpu_torch import defs, tracing
from raytrace2_tpu_torch.ops import camera, rng
from raytrace2_tpu_torch.ops.kernels.build import MAX_SMEM_BYTES
from raytrace2_tpu_torch.scene import schema

BIG = 3.0e38

SPH_KEYS = ("c0x", "c0y", "c0z", "dpx", "dpy", "dpz", "rad", "mat", "act")
QUAD_KEYS = ("nx", "ny", "nz", "d", "aax", "aay", "aaz", "abx", "aby",
             "abz", "qaa", "qab", "mat")
BOX_KEYS = ("x0", "y0", "z0", "x1", "y1", "z1", "mat", "act")
MED_KEYS = ("btype", "p0x", "p0y", "p0z", "p1x", "p1y", "p1z",
            "dspx", "dspy", "dspz",
            "i00", "i01", "i02", "i03", "i10", "i11", "i12", "i13",
            "i20", "i21", "i22", "i23", "nid", "mat")
MAT_KEYS = ("mtype", "alr", "alg", "alb", "param", "tex")
TEX_KEYS = ("ttype", "alr", "alg", "alb", "inv_scale", "even", "odd",
            "scale", "ntype", "nslot")
FAMILIES = (("sph", SPH_KEYS), ("quad", QUAD_KEYS), ("box", BOX_KEYS),
            ("med", MED_KEYS), ("mat", MAT_KEYS), ("tex", TEX_KEYS))

# The cluster-skip sweep's tables (JAX ``_cluster_tables``, :114-177), per
# clustered family (``s`` spheres, ``b`` AA boxes): the AABBs of the
# 16-record clusters (``cb``, one entry per cluster) and of the 128-record
# superclusters (``sb``), and the six direction-sorted visit orders of the
# superclusters (``ord``, 6 x n_l2) and of the clusters inside each
# supercluster (``lord``, 6 x n_cl), as f32 ids. JAX stores each as a row of
# the record table's width; the port stores n_cl or n_l2 entries per key.
# Their inverses, a supercluster's place in each order (``iord``) and a
# cluster's place inside its supercluster in each order (``ilord``), are
# packed last (``INVERSE_FAMILIES``): only the wavefront step stages them,
# and its warp-ordered walk ranks records in a lane's own order with them
# (csrc/path_common.cuh visit_rank).
CLUSTER = 16
SUPER = 128
# A family sweeps through its clusters from this many records (JAX
# ``hier_sph``/``hier_box``: ``n >= 2 * SPH_CLUSTER``).
HIER_MIN = 2 * CLUSTER
AABB_KEYS = ("x0", "y0", "z0", "x1", "y1", "z1")
# How a clustered family is walked (JAX ``SWEEP_MODE``, megakernel.py:83,
# read from the same variable with the same default): "hier", the
# two-level cluster skip above, or "bvh", the threaded BVH over the
# clusters (JAX ``_build_threaded_bvh``/``_bvh_sweep``, :180-270,
# :500-552), whose tables (``threaded_bvh``: node AABBs ``bv`` [6, m],
# ``bleaf`` [m], links ``bhit`` and ``bmiss`` [6 m], m = 2 n_cl - 1) follow
# each family's cluster tables and are packed in "bvh" mode only, so the
# default buffer stays what it was. The kernels take the walk from their
# ``bvh`` instances (``build.SWEEP_DEFINE``). Tests switch modes in one
# process by patching ``SWEEP_MODE``.
SWEEP_MODES = ("hier", "bvh")
SWEEP_MODE = os.environ.get("RT2_SWEEP_MODE", "hier")
if SWEEP_MODE not in SWEEP_MODES:
    raise ValueError(f"RT2_SWEEP_MODE={SWEEP_MODE!r}: expected one of {SWEEP_MODES}")
CLUSTER_FAMILIES = tuple((f + part, keys) for f in ("s", "b") for part, keys in (
    ("cb", AABB_KEYS), ("sb", AABB_KEYS), ("ord", ("ord",)), ("lord", ("lord",)),
    ("bv", AABB_KEYS), ("bleaf", ("bleaf",)), ("bhit", ("bhit",)), ("bmiss", ("bmiss",))))
INVERSE_FAMILIES = tuple((f + k, (k,)) for f in ("s", "b") for k in ("iord", "ilord"))
ALL_FAMILIES = FAMILIES + CLUSTER_FAMILIES + INVERSE_FAMILIES
# Floats of one block's staging area beside the tables: camv (28), the
# background (3, padded to 4), and the gradient kernel's block sums (24).
_STAGE_EXTRA = camera.CAMV_LEN + 4 + 24
# Entries per Perlin permutation/gradient table (PerlinNoiseGen.cpp).
NOISE_TABLE_N = 256
# v4's tiles (csrc/megakernel_v4.cu): a CUDA block of TILE lanes on the
# linear layout, of BLOCK_TILE lanes = a BLOCK x BLOCK pixel block on the
# block-tiled one.
TILE = 128
BLOCK_TILE = 256
BLOCK = camera.PIXEL_BLOCK

# Launches of the CUDA kernel (the plain version does not count).
LAUNCHES = 0
# v4's path segments (closest-hit queries: one a bounce of a lane) and
# medium scatters (segments whose closest hit was a medium) while a
# profiler records: an int64 [2] tensor per device that each batch adds
# to on the device (``tracing.device_counter``), so that counting adds no
# host sync. ``SEGMENTS`` and ``MEDIUM_SCATTERS`` read their sums, waiting
# for the devices.
_TALLY: dict = {}


def __getattr__(attr: str) -> int:
    if attr == "SEGMENTS":
        return tracing.device_count(_TALLY, 0)
    if attr == "MEDIUM_SCATTERS":
        return tracing.device_count(_TALLY, 1)
    raise AttributeError(f"module {__name__!r} has no attribute {attr!r}")

# Feature bits of the kernels' instances (csrc/path_common.cuh kF*): v4, B4
# (megakernel_v3) and B3 (megakernel_grad) are each built once per scene
# feature mask, as the JAX kernels are traced per scene with its family
# sizes, has_checker and has_noise static.
(F_SPH, F_QUAD, F_BOX, F_MED, F_CHECKER, F_HASH_NOISE, F_TABLE_NOISE, F_METAL,
 F_DIEL) = (1 << i for i in range(9))
F_ALL = (1 << 9) - 1


def feature_mask(sizes, has_checker, has_noise, ntab=None, mat_types=None) -> int:
    """The features whose code a scene's kernel instance needs: each family
    with records, the checker, hash noise or (with ``ntab``) table noise,
    and metal and dielectric where ``mat_types`` (the material type ids
    present; None: any) holds them."""
    n_sph, n_quad, _, _, n_med, n_box = sizes
    metal, diel = float(defs.MAT_METAL), float(defs.MAT_DIELECTRIC)
    mats = {metal, diel} if mat_types is None else {float(t) for t in mat_types}
    return ((F_SPH if n_sph else 0) | (F_QUAD if n_quad else 0) | (F_BOX if n_box else 0)
            | (F_MED if n_med else 0) | (F_CHECKER if has_checker else 0)
            | ((F_TABLE_NOISE if ntab is not None else F_HASH_NOISE) if has_noise else 0)
            | (F_METAL if metal in mats else 0) | (F_DIEL if diel in mats else 0))


def material_types(packed, sizes) -> set:
    """The material type ids of the packed tables (one host read)."""
    return set(tracing.sync(unpack_buffer(packed, sizes)["mat"]["mtype"].unique(), "mat_types",
                            torch.Tensor.tolist))


# Material type ids per scene mtype tensor, by id while the tensor lives.
_MAT_TYPES: dict = {}


def scene_material_types(mtype) -> frozenset:
    """The material type ids of a scene's ``materials.mtype`` leaf, read from
    the device once per tensor: an integer leaf stays the same tensor across
    batches and gradient steps, so later launches need no host read."""
    key = id(mtype)
    if key not in _MAT_TYPES:
        _MAT_TYPES[key] = frozenset(
            float(t) for t in tracing.sync(mtype.unique(), "mat_types", torch.Tensor.tolist))
        weakref.finalize(mtype, _MAT_TYPES.pop, key, None)
    return _MAT_TYPES[key]


def scene_features(packed, sizes, has_checker, has_noise, ntab=None, mat_types=None) -> int:
    """The feature mask of a scene's kernel instances: v4 and B3 take it
    with the scene's ``ntab`` (table noise); B4 with None (it always takes
    hash noise, as the JAX v3 kernel does) where its pass compacts
    (``megakernel_v3.instance_features``). ``mat_types``
    (``scene_material_types``), where given, spares reading the material
    types from ``packed``: with it no host read happens."""
    if mat_types is None:
        mat_types = material_types(packed, sizes)
    return feature_mask(sizes, has_checker, has_noise, ntab, mat_types)


# ---------------------------------------------------------------------------
# Host side: table packing
# ---------------------------------------------------------------------------


def _fms(a, b, c, d):
    """``a*b - c*d`` with the first product fused, as XLA contracts the JAX
    package's ``jnp.cross`` (fma(a, b, -(c*d))): computed in float64, where
    a*b of two f32 is exact, then rounded once to f32."""
    return (a.double() * b.double() - (c * d).double()).float()


def _cross(a, b):
    return torch.stack([
        _fms(a[:, 1], b[:, 2], a[:, 2], b[:, 1]),
        _fms(a[:, 2], b[:, 0], a[:, 0], b[:, 2]),
        _fms(a[:, 0], b[:, 1], a[:, 1], b[:, 0]),
    ], dim=-1)


def _dot3(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def pack_tables(scene, sizes):
    """Record columns of the active rows, as the JAX ``pack_tables``
    (megakernel.py:273-380) emits them, without its cluster tables.

    ``scene`` is a FlatScene of torch tensors (``schema.to_device``).
    Returns six dicts (sph, quad, box, med, mat, tex) of f32 columns of
    ``family_rows(sizes)`` rows each: the JAX package's columns without the
    ``act = 0`` rows it pads spheres and boxes with."""
    rows = family_rows(sizes)
    s, q_, m_, b_ = rows["sph"], rows["quad"], rows["med"], rows["box"]

    def f32(x):
        return x.to(torch.float32)

    sp = scene.spheres
    act = torch.full((s,), float(sizes[0] > 0), device=sp.radius.device)
    sph = dict(
        c0x=sp.center0[:s, 0], c0y=sp.center0[:s, 1], c0z=sp.center0[:s, 2],
        dpx=sp.displacement[:s, 0], dpy=sp.displacement[:s, 1],
        dpz=sp.displacement[:s, 2], rad=sp.radius[:s], mat=sp.material[:s],
        act=act,
    )
    sph = {k: f32(v) for k, v in sph.items()}

    q = scene.quads
    a_alpha = _cross(q.v, q.w)
    a_beta = _cross(q.w, q.u)
    quad = dict(
        nx=q.normal[:q_, 0], ny=q.normal[:q_, 1], nz=q.normal[:q_, 2], d=q.d[:q_],
        aax=a_alpha[:q_, 0], aay=a_alpha[:q_, 1], aaz=a_alpha[:q_, 2],
        abx=a_beta[:q_, 0], aby=a_beta[:q_, 1], abz=a_beta[:q_, 2],
        qaa=_dot3(q.q, a_alpha)[:q_], qab=_dot3(q.q, a_beta)[:q_],
        mat=q.material[:q_],
    )
    quad = {k: f32(v) for k, v in quad.items()}

    bx = scene.boxes
    box = dict(
        x0=bx.bmin[:b_, 0], y0=bx.bmin[:b_, 1], z0=bx.bmin[:b_, 2],
        x1=bx.bmax[:b_, 0], y1=bx.bmax[:b_, 1], z1=bx.bmax[:b_, 2],
        mat=bx.material[:b_],
        act=torch.full((b_,), float(sizes[5] > 0), device=bx.bmin.device),
    )
    box = {k: f32(v) for k, v in box.items()}

    md = scene.media
    med = dict(btype=md.btype[:m_])
    for i, axis in enumerate("xyz"):
        med["p0" + axis] = md.p0[:m_, i]
    for i, axis in enumerate("xyz"):
        med["p1" + axis] = md.p1[:m_, i]
    for i, axis in enumerate("xyz"):
        med["dsp" + axis] = md.displacement[:m_, i]
    for r in range(3):
        for c in range(4):
            med[f"i{r}{c}"] = md.inv_model[:m_, r, c]
    med["nid"] = md.neg_inv_density[:m_]
    med["mat"] = md.material[:m_]
    med = {k: f32(med[k]) for k in MED_KEYS}

    m = scene.materials
    mat = dict(mtype=m.mtype, alr=m.albedo[:, 0], alg=m.albedo[:, 1],
               alb=m.albedo[:, 2], param=m.param, tex=m.tex)
    mat = {k: f32(v) for k, v in mat.items()}

    t = scene.textures
    is_noise = (t.ttype == defs.TEX_NOISE).to(torch.int32)
    nslot = torch.cumsum(is_noise, 0) - is_noise
    tex = dict(ttype=t.ttype, alr=t.albedo[:, 0], alg=t.albedo[:, 1],
               alb=t.albedo[:, 2], inv_scale=t.inv_scale, even=t.even,
               odd=t.odd, scale=t.scale, ntype=t.noise_type, nslot=nslot)
    tex = {k: f32(v) for k, v in tex.items()}
    return sph, quad, box, med, mat, tex


def cluster_counts(n: int) -> tuple:
    """(n_cl, n_l2): clusters and superclusters of ``n`` records padded to a
    whole supercluster, as JAX pads them."""
    n_l2 = -(-max(n, 1) // SUPER)
    return n_l2 * (SUPER // CLUSTER), n_l2


def _record_floats(sizes) -> int:
    n_sph, n_quad, n_mat, n_tex, n_med, n_box = sizes
    return (len(SPH_KEYS) * max(n_sph, 1) + len(QUAD_KEYS) * max(n_quad, 1)
            + len(BOX_KEYS) * max(n_box, 1) + len(MED_KEYS) * max(n_med, 1)
            + len(MAT_KEYS) * n_mat + len(TEX_KEYS) * n_tex)


def bvh_nodes(n: int) -> int:
    """Nodes of the threaded BVH over the clusters of ``n`` records."""
    return 2 * cluster_counts(n)[0] - 1


def hier_flags(sizes) -> tuple:
    """(spheres, AA boxes): whether each family takes the cluster-skip sweep
    (or in "bvh" mode the BVH walk). A family does from ``HIER_MIN``
    records, as in JAX, as long as the tables with the cluster tables (and
    in "bvh" mode the BVH tables, 19 floats a node) still fit one block's
    shared memory (``build.MAX_SMEM_BYTES``, the gradient kernel's block
    sums and the wavefront step's inverse orders included: every kernel
    takes the same flags, so that their images agree bitwise). Near the
    kernel path's record ceiling they may not: then both families stay on
    the flat sweep, which finds the same hits, and no scene the flat sweep
    took is refused."""
    want = (sizes[0] >= HIER_MIN, sizes[5] >= HIER_MIN)
    bvh = SWEEP_MODE == "bvh"
    floats = _record_floats(sizes) + _STAGE_EXTRA + sum(
        18 * sum(cluster_counts(n)) + (19 * bvh_nodes(n) if bvh else 0)
        for n, on in zip((sizes[0], sizes[5]), want) if on)
    return want if 4 * floats <= MAX_SMEM_BYTES else (False, False)


def family_rows(sizes) -> dict:
    """Rows per column of each family in the packed buffer: the active
    records (at least one row, as in the JAX tables), then the cluster
    tables (with the BVH tables in "bvh" mode) and inverse orders of each
    family that ``hier_flags`` clusters (no rows otherwise)."""
    n_sph, n_quad, n_mat, n_tex, n_med, n_box = sizes
    rows = {"sph": max(n_sph, 1), "quad": max(n_quad, 1), "box": max(n_box, 1),
            "med": max(n_med, 1), "mat": n_mat, "tex": n_tex}
    for f, n, on in zip("sb", (n_sph, n_box), hier_flags(sizes)):
        n_cl, n_l2 = cluster_counts(n) if on else (0, 0)
        m = bvh_nodes(n) if on and SWEEP_MODE == "bvh" else 0
        rows.update({f + "cb": n_cl, f + "sb": n_l2, f + "ord": 6 * n_l2,
                     f + "lord": 6 * n_cl, f + "bv": m, f + "bleaf": m, f + "bhit": 6 * m,
                     f + "bmiss": 6 * m, f + "iord": 6 * n_l2, f + "ilord": 6 * n_cl})
    return rows


def table_layout(sizes) -> dict:
    """Static offsets of the packed buffer: family → (base, rows). Column
    ``k`` of a family starts at ``base + k * rows``. The CUDA kernels
    compute the same offsets from the same counts (``make_tables`` in
    csrc/path_common.cuh)."""
    rows = family_rows(sizes)
    layout, base = {}, 0
    for fam, keys in ALL_FAMILIES:
        layout[fam] = (base, rows[fam])
        base += len(keys) * rows[fam]
    layout["total"] = (base, 0)
    return layout


def counts(sizes, n_noise: int = 0) -> tuple:
    """The kernels' ``Counts`` (csrc/path_common.cuh): the six sizes, the two
    ``hier_flags`` and the number of noise textures in ``ntab`` (0: hash
    noise)."""
    return (*(int(x) for x in sizes), *(int(f) for f in hier_flags(sizes)), int(n_noise))


def cluster_tables(lo, hi, act):
    """JAX ``_cluster_tables`` in compact form. ``lo``/``hi``: [P, 3] f32
    record AABBs, P a multiple of ``SUPER``; ``act``: [P] bool. Inactive
    records get ±BIG bounds; a cluster left empty collapses to the point
    BIG, because an inverted box does not fail the slab test. Returns
    {cb: [6, n_cl], sb: [6, n_l2], ord: [6 n_l2], lord: [6 n_cl],
    iord: [6 n_l2], ilord: [6 n_cl]}, f32; ``ord`` and ``lord`` are ascending
    centroid orders along +x, then their reverse for -x, and so on for y and
    z; ``iord[d n_l2 + c2]`` is the place of supercluster c2 in order d and
    ``ilord[d n_cl + c1]`` the place of cluster c1 among its supercluster's
    clusters in order d; and ``raw``, the clusters' (lo, hi) [n_cl, 3]
    before the collapse (JAX ``cl_lo_raw``/``cl_hi_raw``, :123-129: a padded
    cluster inverted, lo = +BIG, hi = -BIG), from which ``threaded_bvh``
    builds."""
    lo = torch.where(act[:, None], lo, BIG)
    hi = torch.where(act[:, None], hi, -BIG)
    n_cl, n_l2 = lo.shape[0] // CLUSTER, lo.shape[0] // SUPER
    ratio = SUPER // CLUSTER

    def boxes(n, per):
        return lo.view(n, per, 3).amin(1), hi.view(n, per, 3).amax(1)

    def collapse(b_lo, b_hi):
        empty = b_hi[:, :1] < b_lo[:, :1]
        return torch.where(empty, BIG, b_lo), torch.where(empty, BIG, b_hi)

    raw = boxes(n_cl, CLUSTER)
    cl_lo, cl_hi = collapse(*raw)
    sb_lo, sb_hi = collapse(*boxes(n_l2, SUPER))
    cen = (sb_lo + sb_hi) * 0.5
    ccen = (cl_lo + cl_hi) * 0.5
    base = (torch.arange(n_l2, device=lo.device) * ratio)[:, None]
    orders, lorders = [], []
    for axis in range(3):
        asc = torch.argsort(cen[:, axis], stable=True)
        orders += [asc, asc.flip(0)]
        asc_local = torch.argsort(ccen[:, axis].reshape(n_l2, ratio), dim=1, stable=True)
        lorders += [(base + asc_local).reshape(-1), (base + asc_local.flip(1)).reshape(-1)]
    ords, lords = torch.stack(orders), torch.stack(lorders)
    iord = torch.empty_like(ords).scatter_(
        1, ords, torch.arange(n_l2, device=lo.device).expand(6, n_l2))
    ilord = torch.empty_like(lords).scatter_(
        1, lords, (torch.arange(n_cl, device=lo.device) % ratio).expand(6, n_cl))
    return {"cb": torch.cat([cl_lo.t(), cl_hi.t()]), "sb": torch.cat([sb_lo.t(), sb_hi.t()]),
            "ord": ords.reshape(-1).to(torch.float32),
            "lord": lords.reshape(-1).to(torch.float32),
            "iord": iord.reshape(-1).to(torch.float32),
            "ilord": ilord.reshape(-1).to(torch.float32), "raw": raw}


def threaded_bvh(cl_lo, cl_hi):
    """JAX ``_build_threaded_bvh`` (megakernel.py:180-270): a binary BVH over
    the clusters' raw bounds ``cl_lo``/``cl_hi`` [n_cl, 3] (padded clusters
    inverted, so that min/max unions ignore them), threaded six times for
    a stackless walk. Each span of the cluster list takes its bounds'
    longest axis (ties x before y before z), is stably sorted by AABB min
    along it and split at the median; nodes have pre-order ids (left child
    id + 1, right id + 2 mid). For each direction d (+x, -x, +y, -y, +z,
    -z) a hit at an internal node goes to its near child (judged by lo + hi
    on d's axis), a hit at a leaf and every miss to the node's escape.
    Nodes holding only padding collapse to the point BIG, which fails every
    slab test.

    Returns, with m = 2 n_cl - 1: {"bv": [6, m] node AABBs (x0, y0, z0, x1,
    y1, z1), "bleaf": [m] the leaf's cluster id or -1, "bhit", "bmiss":
    [6 m] the link of direction d at d m + node, -1 at the end}, f32 on
    the bounds' device."""
    n_cl = cl_lo.shape[0]
    m = 2 * n_cl - 1
    node_lo, node_hi, leaf, kids = [None] * m, [None] * m, [None] * m, [None] * m
    order = torch.arange(n_cl, device=cl_lo.device)

    def build(start, end, node):
        nonlocal order
        span = order[start:end]
        lo, hi = cl_lo[span], cl_hi[span]
        node_lo[node], node_hi[node] = lo.amin(0), hi.amax(0)
        if end - start == 1:
            leaf[node] = span[0].to(torch.float32)
            return
        leaf[node] = torch.tensor(-1.0, device=cl_lo.device)
        ext = node_hi[node] - node_lo[node]
        ax_x = (ext[0] >= ext[1]) & (ext[0] >= ext[2])
        ax_y = ~ax_x & (ext[1] >= ext[2])
        keys = torch.where(ax_x, lo[:, 0], torch.where(ax_y, lo[:, 1], lo[:, 2]))
        order = torch.cat([order[:start], span[torch.argsort(keys, stable=True)],
                           order[end:]])
        mid = (end - start) // 2
        kids[node] = (node + 1, node + 2 * mid)
        build(start, start + mid, node + 1)
        build(start + mid, end, node + 2 * mid)

    build(0, n_cl, 0)
    # The six threadings at once: direction d judges its axis d // 2,
    # ascending for even d.
    asc = torch.tensor([True, False] * 3, device=cl_lo.device)
    hit, miss = [None] * m, [None] * m

    def thread(node, escape):
        if kids[node] is None:
            hit[node] = miss[node] = escape
            return
        left, right = kids[node]
        c_l = (node_lo[left] + node_hi[left]).repeat_interleave(2)
        c_r = (node_lo[right] + node_hi[right]).repeat_interleave(2)
        near_left = torch.where(asc, c_l <= c_r, c_l >= c_r)
        hit[node] = torch.where(near_left, float(left), float(right))
        miss[node] = escape
        thread(left, torch.where(near_left, float(right), escape))
        thread(right, torch.where(near_left, escape, float(left)))

    thread(0, torch.full((6,), -1.0, device=cl_lo.device))
    lo_arr, hi_arr = torch.stack(node_lo), torch.stack(node_hi)
    empty = hi_arr[:, :1] < lo_arr[:, :1]
    lo_arr, hi_arr = torch.where(empty, BIG, lo_arr), torch.where(empty, BIG, hi_arr)
    return {"bv": torch.cat([lo_arr.t(), hi_arr.t()]), "bleaf": torch.stack(leaf),
            "bhit": torch.stack(hit, 1).reshape(-1), "bmiss": torch.stack(miss, 1).reshape(-1)}


def pack_clusters(sph, box, sizes) -> list:
    """The ``CLUSTER_FAMILIES`` and ``INVERSE_FAMILIES`` dicts for
    ``pack_tables``' sphere and box columns: the cluster tables of each
    family that ``hier_flags`` clusters (in "bvh" mode with the BVH tables,
    built on the host from the raw cluster bounds),
    from detached geometry (they only steer the sweep, and are rebuilt from
    the current geometry whenever the tables are packed), sphere bounds
    covering the motion from c0 to c0 + dp (JAX :305-320, :338-348)."""
    out, inverse = [], []
    for f, cols, n, on in zip("sb", (sph, box), (sizes[0], sizes[5]), hier_flags(sizes)):
        if on:
            pad = -n % SUPER

            def col(k):
                return torch.nn.functional.pad(cols[k][:n].detach(), (0, pad))

            if f == "s":
                c0 = torch.stack([col("c0x"), col("c0y"), col("c0z")], -1)
                c1 = torch.stack([col("c0x") + col("dpx"), col("c0y") + col("dpy"),
                                  col("c0z") + col("dpz")], -1)
                rad = col("rad")[:, None]
                lo, hi = torch.minimum(c0, c1) - rad, torch.maximum(c0, c1) + rad
            else:
                lo = torch.stack([col("x0"), col("y0"), col("z0")], -1)
                hi = torch.stack([col("x1"), col("y1"), col("z1")], -1)
            act = torch.arange(n + pad, device=lo.device) < n
            t = cluster_tables(lo, hi, act)
            if SWEEP_MODE == "bvh":
                raw = (tracing.sync(x, "bvh") for x in t["raw"])
                t.update({k: tracing.sync(v, "bvh", device=lo.device)
                          for k, v in threaded_bvh(*raw).items()})
        else:
            empty = torch.zeros(0, dtype=torch.float32, device=cols["act"].device)
            t = {"cb": empty.view(6, 0), "sb": empty.view(6, 0), "ord": empty, "lord": empty,
                 "iord": empty, "ilord": empty}
        if "bv" not in t:
            empty = torch.zeros(0, dtype=torch.float32, device=t["ord"].device)
            t.update(bv=empty.view(6, 0), bleaf=empty, bhit=empty, bmiss=empty)
        out += [dict(zip(AABB_KEYS, t["cb"])), dict(zip(AABB_KEYS, t["sb"])),
                {"ord": t["ord"]}, {"lord": t["lord"]}, dict(zip(AABB_KEYS, t["bv"])),
                {"bleaf": t["bleaf"]}, {"bhit": t["bhit"]}, {"bmiss": t["bmiss"]}]
        inverse += [{"iord": t["iord"]}, {"ilord": t["ilord"]}]
    return out + inverse


def pack_buffer(scene, sizes) -> torch.Tensor:
    """The scene's table columns (``pack_tables``) and cluster tables
    (``pack_clusters``) as one contiguous f32 buffer laid out by
    ``table_layout``, on the scene's device; float64 leaves (under
    ``RAYTRACE2_DOUBLE``) are read as float32."""
    tables = pack_tables(schema.as_float32(scene), sizes)
    with tracing.span("integrator.cluster"):
        tables = (*tables, *pack_clusters(tables[0], tables[2], sizes))
    return torch.cat([tbl[k] for (_, keys), tbl in zip(ALL_FAMILIES, tables)
                      for k in keys]).contiguous()


def unpack_buffer(packed: torch.Tensor, sizes) -> dict:
    """Inverse of ``pack_buffer``: family → {key: column view}."""
    layout = table_layout(sizes)
    out = {}
    for fam, keys in ALL_FAMILIES:
        base, n = layout[fam]
        out[fam] = {k: packed[base + i * n: base + (i + 1) * n]
                    for i, k in enumerate(keys)}
    return out


def pack_noise_tables(scene, noise_rows) -> torch.Tensor:
    """The noise textures' Perlin tables for table-Perlin noise
    (``noise_impl="table"``; JAX ``pack_noise_tables``, :383-400):
    [6, T * 256] f32 on the scene's device, rows 0-2 the three permutation
    tables (integer-valued) and rows 3-5 the gradients' x, y, z. The texture
    with ``nslot`` s owns columns s*256 .. s*256+255. ``noise_rows`` are the
    noise textures' rows (``features["noise_rows"]``). JAX pads two more
    rows for the TPU's sublanes; the port does not."""
    t = scene.textures
    rows = list(noise_rows)
    perm = torch.stack([t.perm[r] for r in rows], 1).reshape(3, -1)
    grad = torch.stack([t.grad[r] for r in rows], 0)
    gxyz = torch.movedim(grad, -1, 0).reshape(3, -1)
    return torch.cat([perm.to(torch.float32), gxyz.to(torch.float32)]).contiguous()


# ---------------------------------------------------------------------------
# Plain version of the kernel (PyTorch, vectorised over lanes)
# ---------------------------------------------------------------------------


def _safe_inv(c):
    """1/c with the sign-preserving epsilon clamp of the slab tests."""
    return 1.0 / torch.where(torch.abs(c) < 1e-12,
                             torch.where(c < 0, -1e-12, 1e-12), c)


def sph_body(g, *, tm, ox, oy, oz, dx, dy, dz, a, inv_a, best_t, aux, **_):
    """Sphere test (JAX ``make_family_bodies.sph_body``). ``g`` maps each
    ``SPH_KEYS`` column to the record's value: a float in the sweep, a
    per-lane tensor in the gradient replay. Returns (closer, record)."""
    t_min = float(defs.T_MIN)
    cx = g["c0x"] + tm * g["dpx"]
    cy = g["c0y"] + tm * g["dpy"]
    cz = g["c0z"] + tm * g["dpz"]
    ocx, ocy, ocz = cx - ox, cy - oy, cz - oz
    h = dx * ocx + dy * ocy + dz * ocz
    rad = g["rad"]
    cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
    disc = h * h - a * cc
    has = disc >= 0.0
    # Double where: the replay's backward meets no sqrt'(0), on masked lanes
    # or at a tangent (disc == 0, sq == 0), where the kernel's adjoint gives
    # the discriminant no cotangent either.
    pos = disc > 0.0
    sq = torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0)
    root0 = (h - sq) * inv_a
    root1 = (h + sq) * inv_a
    ok0 = (root0 > t_min) & (root0 < best_t)
    ok1 = (root1 > t_min) & (root1 < best_t)
    root = torch.where(ok0, root0, root1)
    closer = has & (ok0 | ok1) & (g["act"] > 0)
    return closer, (root, 0.0, g["mat"], cx, cy, cz, rad)


def quad_body(g, *, ox, oy, oz, dx, dy, dz, best_t, aux, **_):
    """Quad test (``quad_body``): plane t, then alpha/beta inside [0, 1]."""
    t_min = float(defs.T_MIN)
    nx, ny, nz = g["nx"], g["ny"], g["nz"]
    nd = dx * nx + dy * ny + dz * nz
    no = ox * nx + oy * ny + oz * nz
    not_par = torch.abs(nd) >= float(defs.QUAD_EPS)
    t = (g["d"] - no) / torch.where(not_par, nd, 1.0)
    o_aa = ox * g["aax"] + oy * g["aay"] + oz * g["aaz"]
    d_aa = dx * g["aax"] + dy * g["aay"] + dz * g["aaz"]
    o_ab = ox * g["abx"] + oy * g["aby"] + oz * g["abz"]
    d_ab = dx * g["abx"] + dy * g["aby"] + dz * g["abz"]
    alpha = o_aa + t * d_aa - g["qaa"]
    beta = o_ab + t * d_ab - g["qab"]
    closer = (not_par & (t >= t_min) & (t <= best_t)
              & (alpha >= 0.0) & (alpha <= 1.0)
              & (beta >= 0.0) & (beta <= 1.0))
    return closer, (t, 1.0, g["mat"], nx, ny, nz, aux)


def box_body(g, *, ox, oy, oz, inv_d, sgn_d, best_t, aux, **_):
    """AA box slab test (``box_body``): entry at t0 with the entering face's
    normal, exit at t1 for a ray that starts inside. ``inv_d`` and
    ``sgn_d`` are the ray's safe reciprocal and sign per axis."""
    t_min = float(defs.T_MIN)
    inv_dx, inv_dy, inv_dz = inv_d
    tax = (g["x0"] - ox) * inv_dx
    tbx = (g["x1"] - ox) * inv_dx
    tay = (g["y0"] - oy) * inv_dy
    tby = (g["y1"] - oy) * inv_dy
    taz = (g["z0"] - oz) * inv_dz
    tbz = (g["z1"] - oz) * inv_dz
    lox, hix = torch.minimum(tax, tbx), torch.maximum(tax, tbx)
    loy, hiy = torch.minimum(tay, tby), torch.maximum(tay, tby)
    loz, hiz = torch.minimum(taz, tbz), torch.maximum(taz, tbz)
    t0 = torch.maximum(lox, torch.maximum(loy, loz))
    t1 = torch.minimum(hix, torch.minimum(hiy, hiz))
    enter = t0 >= t_min
    t = torch.where(enter, t0, t1)
    closer = (t1 > t0) & (t > t_min) & (t < best_t) & (t1 > t_min)
    ax_x = (enter & (t0 == lox)) | (~enter & (t1 == hix))
    ax_y = ((enter & (t0 == loy)) | (~enter & (t1 == hiy))) & ~ax_x
    ax_z = ~ax_x & ~ax_y
    sgn = torch.where(enter, -1.0, 1.0)
    nxb = torch.where(ax_x, sgn * sgn_d[0], 0.0)
    nyb = torch.where(ax_y, sgn * sgn_d[1], 0.0)
    nzb = torch.where(ax_z, sgn * sgn_d[2], 0.0)
    closer = closer & (g["act"] > 0)
    return closer, (t, 1.0, g["mat"], nxb, nyb, nzb, aux)


def med_body(g, *, key, ctr, tm, ox, oy, oz, dx, dy, dz, d_len, best_t, aux, **_):
    """Constant medium (``med_body``): boundary entry/exit in model space,
    then an exponential free path drawn at counter ``ctr``. A float
    ``btype`` (the sweep) takes its boundary's branch only; a per-lane one
    (the replay) computes both and selects, as the JAX body does."""
    t_min = float(defs.T_MIN)
    omx = g["i00"] * ox + g["i01"] * oy + g["i02"] * oz + g["i03"]
    omy = g["i10"] * ox + g["i11"] * oy + g["i12"] * oz + g["i13"]
    omz = g["i20"] * ox + g["i21"] * oy + g["i22"] * oz + g["i23"]
    dmx_r = g["i00"] * dx + g["i01"] * dy + g["i02"] * dz
    dmy_r = g["i10"] * dx + g["i11"] * dy + g["i12"] * dz
    dmz_r = g["i20"] * dx + g["i21"] * dy + g["i22"] * dz
    dm_len = torch.sqrt(torch.clamp(dmx_r * dmx_r + dmy_r * dmy_r + dmz_r * dmz_r,
                                    min=1e-24))
    dmx, dmy, dmz = dmx_r / dm_len, dmy_r / dm_len, dmz_r / dm_len

    def box():
        # Box boundary (slabs, safe reciprocal).
        ix, iy, iz = _safe_inv(dmx), _safe_inv(dmy), _safe_inv(dmz)
        ax, bx = (g["p0x"] - omx) * ix, (g["p1x"] - omx) * ix
        ay, by = (g["p0y"] - omy) * iy, (g["p1y"] - omy) * iy
        az, bz = (g["p0z"] - omz) * iz, (g["p1z"] - omz) * iz
        t0_ = torch.maximum(torch.minimum(ax, bx),
                            torch.maximum(torch.minimum(ay, by), torch.minimum(az, bz)))
        t1_ = torch.minimum(torch.maximum(ax, bx),
                            torch.minimum(torch.maximum(ay, by), torch.maximum(az, bz)))
        return t0_, t1_, t0_ < t1_

    def sphere():
        # Sphere boundary (moving center).
        ocx = (g["p0x"] + tm * g["dspx"]) - omx
        ocy = (g["p0y"] + tm * g["dspy"]) - omy
        ocz = (g["p0z"] + tm * g["dspz"]) - omz
        h = dmx * ocx + dmy * ocy + dmz * ocz
        r = g["p1x"]
        cc = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        disc = h * h - cc
        v = disc > 0.0
        sq = torch.where(v, torch.sqrt(torch.where(v, disc, 1.0)), 0.0)
        return h - sq, h + sq, v

    if isinstance(g["btype"], float):
        t0_, t1_, v = box() if g["btype"] == float(defs.MEDIUM_BOX) else sphere()
    else:
        is_box = g["btype"] == float(defs.MEDIUM_BOX)
        (b0, b1, bv), (s0, s1, sv) = box(), sphere()
        t0_, t1_ = torch.where(is_box, b0, s0), torch.where(is_box, b1, s1)
        v = torch.where(is_box, bv, sv)
    v = v & (t1_ > t0_ + float(defs.MEDIUM_EPS))
    scale = dm_len / d_len
    e0 = torch.clamp(torch.maximum(t0_, t_min * scale), min=0.0)
    e1 = torch.minimum(t1_, best_t * scale)
    v = v & (e0 < e1)
    u_m = rng.draw(key, ctr)
    hit_dist = g["nid"] * torch.log(torch.clamp(u_m, min=1e-12))
    v = v & (hit_dist <= (e1 - e0))
    return v, ((e0 + hit_dist) / scale, 2.0, g["mat"], 1.0, 0.0, 0.0, aux)


# Family id of each sweep family as the gradient replay pins a winner
# (JAX ``track_index``): the forward record's ``fam`` cannot tell a quad
# from an AA box.
FAMID = {"sph": 0, "quad": 1, "box": 2, "med": 3}


def sweep_dir(dx, dy, dz):
    """Per-lane index of the visit order (0..5: +x, -x, +y, -y, +z, -z) by
    the dominant axis of the ray's direction (JAX ``_closest_hit``'s rule,
    :843-856, on the lane's own direction)."""
    axa, aya, aza = torch.abs(dx), torch.abs(dy), torch.abs(dz)
    is_x = (axa >= aya) & (axa >= aza)
    is_y = ~is_x & (aya >= aza)
    return torch.where(is_x, torch.where(dx >= 0, 0, 1),
                       torch.where(is_y, torch.where(dy >= 0, 2, 3),
                                   torch.where(dz >= 0, 4, 5)))


def could_hit(bb, c, ox, oy, oz, inv_d, best):
    """Slab test of AABB ``c`` (per lane) of a {x0..z1: [n]} table against
    the ray's interval: ``t1 > max(t0, t_min)`` and ``t0 < best`` (JAX
    ``_hier_sweep.could_hit``)."""
    ta = [(bb[k][c] - o) * i for k, o, i in zip(("x0", "y0", "z0"), (ox, oy, oz), inv_d)]
    tb = [(bb[k][c] - o) * i for k, o, i in zip(("x1", "y1", "z1"), (ox, oy, oz), inv_d)]
    lo = [torch.minimum(a, b) for a, b in zip(ta, tb)]
    hi = [torch.maximum(a, b) for a, b in zip(ta, tb)]
    t0 = torch.maximum(lo[0], torch.maximum(lo[1], lo[2]))
    t1 = torch.minimum(hi[0], torch.minimum(hi[1], hi[2]))
    return (t1 > torch.clamp(t0, min=float(defs.T_MIN))) & (t0 < best)


def _hier_sweep(h, body, rec, ray, extra, famid, *, dir_idx, inv_d, alive, track, stats,
                name):
    """The cluster-skip sweep of one family over all lanes (JAX
    ``_hier_sweep``, :438-497, with the visit order per lane): superclusters
    in the lane's order, then their clusters in order, each tested with the
    lane's running best_t as the kernel does. A cluster that some lane
    enters is tested for all 16 records at once and reduced by the sweep's
    tie rule (the first of equal t wins: ``root < best_t``, ``t < best_t``).
    A record's candidate t does not depend on best_t, so this equals the
    kernel's record-by-record walk. ``h``: the family's columns and cluster
    tables (``make_bounce``)."""
    n, n_cl, n_l2 = h["n"], h["n_cl"], h["n_l2"]
    ratio = SUPER // CLUSTER
    ox, oy, oz = ray["ox"], ray["oy"], ray["oz"]
    ray2 = {k: (v[:, None] if torch.is_tensor(v) else v) for k, v in ray.items()}
    extra2 = {k: (tuple(x[:, None] for x in v) if isinstance(v, tuple) else v)
              for k, v in extra.items()}
    k16 = torch.arange(CLUSTER, device=ox.device)
    supers = range(n_l2) if n_l2 >= 2 else [None]
    for i in supers:
        if i is None:
            m_sup = torch.ones_like(alive)
        else:
            c2 = h["ord"][dir_idx * n_l2 + i]
            m_sup = could_hit(h["sb"], c2, ox, oy, oz, inv_d, rec[0])
            if stats is not None:
                stats["aabb"] += int(alive.sum())
            if not bool(m_sup.any()):
                continue
        for j in range(ratio if i is not None else n_cl):
            c1 = h["lord"][dir_idx * n_cl + c2 * ratio + j] if i is not None \
                else torch.full_like(dir_idx, j)
            m = m_sup & could_hit(h["cb"], c1, ox, oy, oz, inv_d, rec[0])
            p = c1[:, None] * CLUSTER + k16
            valid = p < n
            if stats is not None:
                stats["aabb"] += int((alive & m_sup).sum())
                stats[name] += int(((alive & m)[:, None] & valid).sum())
            if not bool(m.any()):
                continue
            pi = torch.where(valid, p, 0)
            closer, vals = body({k: col[pi] for k, col in h["cols"].items()}, best_t=BIG,
                                aux=rec[6][:, None], **ray2, **extra2)
            t = torch.where(closer & valid & m[:, None], vals[0], float("inf"))
            w = torch.argmin(t, dim=1, keepdim=True)
            upd = t.gather(1, w)[:, 0] < rec[0]
            for f, v in enumerate(vals):
                v = v.expand_as(t).gather(1, w)[:, 0] if torch.is_tensor(v) else v
                rec[f] = torch.where(upd, v, rec[f])
            if track:
                rec[7] = torch.where(upd, pi.gather(1, w)[:, 0].to(torch.float32), rec[7])
                rec[8] = torch.where(upd, float(famid), rec[8])


def _bvh_sweep(h, body, rec, ray, extra, famid, *, dir_idx, inv_d, alive, track, stats,
               name):
    """The threaded-BVH walk of one family over all lanes (JAX ``_bvh_sweep``,
    :500-552, per lane): each live lane keeps its own node cursor, from node
    0 along the threading of its own direction (``dir_idx``), slab-tests
    the node's AABB with its running best_t (``could_hit``), tests the 16
    records of a leaf it enters, and follows ``bhit`` on a hit and
    ``bmiss`` on a miss until its cursor falls below 0. A record is taken
    when strictly closer (the lane's first of equal t within a leaf, and
    never one equal to a record found earlier), as in the kernel's
    record-by-record walk; a record's candidate t does not depend on best_t,
    so a leaf's 16 records are tested at once and reduced (``_hier_sweep``).
    ``stats`` counts each node test as an "aabb" slab test and each record
    of an entered leaf as a record test of ``name``."""
    n, m = h["n"], h["m"]
    ox, oy, oz = ray["ox"], ray["oy"], ray["oz"]
    k16 = torch.arange(CLUSTER, device=ox.device)
    node = torch.where(alive, 0, -1)
    while True:
        lanes = torch.nonzero(node >= 0).squeeze(1)
        if not lanes.numel():
            return
        nd = node[lanes]
        hit = could_hit(h["bv"], nd, ox[lanes], oy[lanes], oz[lanes],
                        tuple(i[lanes] for i in inv_d), rec[0][lanes])
        leaf = h["bleaf"][nd]
        enter = hit & (leaf >= 0)
        if stats is not None:
            stats["aabb"] += lanes.numel()
        li = lanes[enter]
        if li.numel():
            p = leaf[enter][:, None] * CLUSTER + k16
            valid = p < n
            if stats is not None:
                stats[name] += int(valid.sum())
            pi = torch.where(valid, p, 0)
            sub = {k: (v[li][:, None] if torch.is_tensor(v) else v) for k, v in ray.items()}
            sub_extra = {k: (tuple(x[li][:, None] for x in v) if isinstance(v, tuple) else v)
                         for k, v in extra.items()}
            closer, vals = body({k: col[pi] for k, col in h["cols"].items()}, best_t=BIG,
                                aux=rec[6][li][:, None], **sub, **sub_extra)
            t = torch.where(closer & valid, vals[0], float("inf"))
            w = torch.argmin(t, dim=1, keepdim=True)
            upd = t.gather(1, w)[:, 0] < rec[0][li]
            for f, v in enumerate(vals):
                v = v.expand_as(t).gather(1, w)[:, 0] if torch.is_tensor(v) else v
                rec[f] = rec[f].index_copy(0, li, torch.where(upd, v, rec[f][li]))
            if track:
                rec[7] = rec[7].index_copy(0, li, torch.where(
                    upd, pi.gather(1, w)[:, 0].to(torch.float32), rec[7][li]))
                rec[8] = rec[8].index_copy(0, li, torch.where(upd, float(famid), rec[8][li]))
        link = dir_idx[lanes] * m + nd
        node = node.index_copy(0, lanes, torch.where(hit, h["bhit"][link], h["bmiss"][link]))


def _closest_hit(tl, sizes, *, key, tm, ox, oy, oz, dx, dy, dz, a, inv_a, bn,
                 track=False, hier=None, alive=None, stats=None):
    """Closest-hit sweep (JAX ``make_family_bodies`` + ``_closest_hit``,
    :635-882): quads and media flat in record order, spheres and AA boxes
    flat too or, for the families in ``hier``, through ``_hier_sweep`` (or
    ``_bvh_sweep`` where ``hier`` holds the family's BVH tables).
    ``tl`` maps family → {key: list of floats}. Returns [best_t, fam, mat,
    p0, p1, p2, aux], and with ``track`` also the winner's record index and
    family id (``FAMID``; -1 on a miss) — the same values, the extra columns
    only follow them. ``stats`` (a dict, optional) gets the tests a lane in
    ``alive`` makes added: "aabb" slab tests and each family's record tests."""
    n_sph, n_quad, _, _, n_med, n_box = sizes
    hier = hier or {}
    rec = [torch.full_like(ox, BIG), torch.full_like(ox, -1.0), torch.zeros_like(ox),
           torch.zeros_like(ox), torch.zeros_like(ox), torch.zeros_like(ox),
           torch.ones_like(ox)]
    if track:
        rec += [torch.full_like(ox, -1.0), torch.full_like(ox, -1.0)]
    ray = dict(tm=tm, ox=ox, oy=oy, oz=oz, dx=dx, dy=dy, dz=dz, a=a, inv_a=inv_a)
    if alive is None:
        alive = torch.ones_like(ox, dtype=torch.bool)
    n_live = int(alive.sum()) if stats is not None else 0
    inv_d = (_safe_inv(dx), _safe_inv(dy), _safe_inv(dz))
    hkw = dict(dir_idx=sweep_dir(dx, dy, dz) if hier else None, inv_d=inv_d, alive=alive,
               track=track, stats=stats)

    def sweep(fam, keys, n, body, extra=lambda p: {}):
        if fam in hier:
            walk = _bvh_sweep if "bv" in hier[fam] else _hier_sweep
            walk(hier[fam], body, rec, ray, extra(0), FAMID[fam], name=fam, **hkw)
            return
        if stats is not None:
            stats[fam] += n * n_live
        tbl = tl[fam]
        for p in range(n):
            closer, vals = body({k: tbl[k][p] for k in keys}, best_t=rec[0],
                                aux=rec[6], **ray, **extra(p))
            for i, v in enumerate(vals):
                rec[i] = torch.where(closer, v, rec[i])
            if track:
                rec[7] = torch.where(closer, float(p), rec[7])
                rec[8] = torch.where(closer, float(FAMID[fam]), rec[8])

    sweep("sph", SPH_KEYS, n_sph, sph_body)
    sweep("quad", QUAD_KEYS, n_quad, quad_body)
    if n_box:
        box_kw = dict(inv_d=inv_d, sgn_d=(torch.sign(dx), torch.sign(dy), torch.sign(dz)))
        sweep("box", BOX_KEYS, n_box, box_body, lambda p: box_kw)
    if n_med:
        d_len = torch.sqrt(torch.clamp(a, min=1e-24))
        bctr = bn.to(torch.int32).to(torch.int64) * (3 + n_med)
        sweep("med", MED_KEYS, n_med, med_body,
              lambda p: dict(key=key, ctr=bctr + (3 + p), d_len=d_len))
    return rec


def perlin_noise(px, py, pz, seed_u):
    """One octave of hash-gradient noise in [-1, 1] (``mk._perlin_noise``)."""
    fx, fy, fz = torch.floor(px), torch.floor(py), torch.floor(pz)
    ix, iy, iz = fx.to(torch.int32), fy.to(torch.int32), fz.to(torch.int32)
    u, v, w = px - fx, py - fy, pz - fz
    uu = u * u * (3.0 - 2.0 * u)
    vv = v * v * (3.0 - 2.0 * v)
    ww = w * w * (3.0 - 2.0 * w)
    accum = torch.zeros_like(px)
    for di in (0, 1):
        wi = uu if di else (1.0 - uu)
        for dj in (0, 1):
            wj = vv if dj else (1.0 - vv)
            for dk in (0, 1):
                wk = ww if dk else (1.0 - ww)
                gx, gy, gz = rng.hash_gradient(ix + di, iy + dj, iz + dk, seed_u)
                dot = gx * (u - di) + gy * (v - dj) + gz * (w - dk)
                accum = accum + wi * wj * wk * dot
    return accum


def turbulence(px, py, pz, seed_u, depth=7):
    """|Σ 0.5^k noise(2^k p)| (``mk._turbulence``)."""
    accum = torch.zeros_like(px)
    weight = 1.0
    sx, sy, sz = px, py, pz
    for _ in range(depth):
        accum = accum + weight * perlin_noise(sx, sy, sz, seed_u)
        weight *= 0.5
        sx, sy, sz = sx * 2.0, sy * 2.0, sz * 2.0
    return torch.abs(accum)


def table_perlin(px, py, pz, base_i, ntab):
    """One octave of table Perlin noise (JAX ``_table_perlin``, :583-621;
    PerlinNoiseGen.cpp:66-88): the lattice corners' permutations and
    gradients gathered from ``ntab`` (``pack_noise_tables``) at ``base_i``
    (the texture's nslot * 256) plus the lattice coordinate & 255. The
    lattice cell is detached (integer indices), so autograd differentiates
    through the Hermite weights and the (u - di) terms only."""
    fx, fy, fz = torch.floor(px), torch.floor(py), torch.floor(pz)
    ix, iy, iz = fx.to(torch.int32), fy.to(torch.int32), fz.to(torch.int32)
    u, v, w = px - fx, py - fy, pz - fz
    uu = u * u * (3.0 - 2.0 * u)
    vv = v * v * (3.0 - 2.0 * v)
    ww = w * w * (3.0 - 2.0 * w)
    base = base_i.to(torch.int64)

    def perm(row, i, d):
        return ntab[row][base + ((i + d) & 255).to(torch.int64)].to(torch.int32)

    pxv = [perm(0, ix, d) for d in (0, 1)]
    pyv = [perm(1, iy, d) for d in (0, 1)]
    pzv = [perm(2, iz, d) for d in (0, 1)]
    accum = torch.zeros_like(px)
    for di in (0, 1):
        wi = uu if di else (1.0 - uu)
        for dj in (0, 1):
            wj = vv if dj else (1.0 - vv)
            for dk in (0, 1):
                wk = ww if dk else (1.0 - ww)
                gi = base + (pxv[di] ^ pyv[dj] ^ pzv[dk]).to(torch.int64)
                dot = ntab[3][gi] * (u - di) + ntab[4][gi] * (v - dj) + ntab[5][gi] * (w - dk)
                accum = accum + wi * wj * wk * dot
    return accum


def table_turbulence(px, py, pz, base_i, ntab, depth=7):
    """|Σ 0.5^k table_perlin(2^k p)| (JAX ``_table_turbulence``)."""
    accum = torch.zeros_like(px)
    weight = 1.0
    sx, sy, sz = px, py, pz
    for _ in range(depth):
        accum = accum + weight * table_perlin(sx, sy, sz, base_i, ntab)
        weight *= 0.5
        sx, sy, sz = sx * 2.0, sy * 2.0, sz * 2.0
    return torch.abs(accum)


def noise_factor(npx, npy, npz, t_scale, t_ntype, nseed, ntab=None, base_i=None):
    """Marble or Perlin factor of a noise texture (Texture.cpp:13-22): hash
    noise seeded by ``nseed``, or with ``ntab`` table noise at ``base_i``."""
    if ntab is None:
        turb = turbulence(npx, npy, npz, nseed)
        perl = perlin_noise(t_scale * npx, t_scale * npy, t_scale * npz, nseed)
    else:
        turb = table_turbulence(npx, npy, npz, base_i, ntab)
        perl = table_perlin(t_scale * npx, t_scale * npy, t_scale * npz, base_i, ntab)
    marble = 0.5 * (1.0 + torch.sin(t_scale * npz + 10.0 * turb))
    return torch.where(t_ntype == float(defs.NOISE_MARBLE), marble, 0.5 * (1.0 + perl))


def _shade_advance(carry, rec, mat6, tex_resolve, bg, key, *, has_checker,
                   has_noise, max_depth, n_med, ntab=None, stats=None):
    """Shade + state advance (JAX ``_shade_advance``, :1047-1265); noise
    from the tables in ``ntab`` when it is given. ``stats`` (a dict,
    optional) gets the live lanes' noise evaluations added, by kind
    ("noise_marble", "noise_perlin")."""
    (bn, alive_f, ox, oy, oz, dx, dy, dz, tpr, tpg, tpb, rr, rg, rb) = carry
    alive = alive_f > 0.0
    a = dx * dx + dy * dy + dz * dz
    best_t, fam, matf, p0, p1, p2, aux = rec
    mtype, alr, alg, alb, mparam, mtex = mat6
    valid = fam >= 0.0
    is_sph = fam == 0.0
    is_med = fam == 2.0

    px = ox + best_t * dx
    py = oy + best_t * dy
    pz = oz + best_t * dz
    rad_safe = torch.where(aux != 0.0, aux, 1.0)
    onx = torch.where(is_sph, (px - p0) / rad_safe, p0)
    ony = torch.where(is_sph, (py - p1) / rad_safe, p1)
    onz = torch.where(is_sph, (pz - p2) / rad_safe, p2)
    front_geom = (dx * onx + dy * ony + dz * onz) < 0.0
    front = front_geom | is_med
    sgn = torch.where(is_med, 1.0, torch.where(front_geom, 1.0, -1.0))
    nx_, ny_, nz_ = sgn * onx, sgn * ony, sgn * onz

    leaf = mtex
    (ttype, t_alr, t_alg, t_alb, t_inv, t_even, t_odd,
     t_scale, t_ntype, t_nslot) = tex_resolve(leaf)
    for _ in range(int(has_checker)):
        fx = torch.floor(t_inv * px)
        fy = torch.floor(t_inv * py)
        fz = torch.floor(t_inv * pz)
        parity = fx + fy + fz - 2.0 * torch.floor((fx + fy + fz) * 0.5)
        child = torch.where(parity == 0.0, t_even, t_odd)
        leaf = torch.where(ttype == float(defs.TEX_CHECKER), child, leaf)
        (ttype, t_alr, t_alg, t_alb, t_inv, t_even, t_odd,
         t_scale, t_ntype, t_nslot) = tex_resolve(leaf)
    if has_noise:
        # Noise is evaluated only on the lanes that shade a noise texture
        # (a per-lane function, so the subset gives the same values as the
        # JAX kernel's whole-tile branch); points are clamped to 0 on miss
        # lanes, where best_t = BIG would overflow.
        sel_n = (ttype == float(defs.TEX_NOISE)) & valid
        if stats is not None:
            marble = t_ntype == float(defs.NOISE_MARBLE)
            stats["noise_marble"] += int((sel_n & alive & marble).sum())
            stats["noise_perlin"] += int((sel_n & alive & ~marble).sum())
        idx = torch.nonzero(sel_n).squeeze(1)
        if idx.numel():
            npx = torch.where(valid, px, 0.0)[idx]
            npy = torch.where(valid, py, 0.0)[idx]
            npz = torch.where(valid, pz, 0.0)[idx]
            nfac = noise_factor(npx, npy, npz, t_scale[idx], t_ntype[idx],
                                rng.noise_seed(leaf[idx]), ntab,
                                t_nslot[idx].to(torch.int32) * NOISE_TABLE_N)
            t_alr, t_alg, t_alb = t_alr.clone(), t_alg.clone(), t_alb.clone()
            t_alr[idx] = t_alr[idx] * nfac
            t_alg[idx] = t_alg[idx] * nfac
            t_alb[idx] = t_alb[idx] * nfac

    bctr = bn.to(torch.int32).to(torch.int64) * (3 + n_med)
    u1 = rng.draw(key, bctr)
    u2 = rng.draw(key, bctr + 1)
    u3 = rng.draw(key, bctr + 2)
    z = 1.0 - 2.0 * u1
    phi = (2.0 * 3.14159265358979) * u2
    rxy = torch.sqrt(torch.clamp(1.0 - z * z, min=1e-12))
    uvx = rxy * torch.cos(phi)
    uvy = rxy * torch.sin(phi)
    uvz = z

    is_lamb = (mtype == float(defs.MAT_LAMBERTIAN)) | (mtype == float(defs.MAT_TEXTURE))
    is_metal = mtype == float(defs.MAT_METAL)
    is_diel = mtype == float(defs.MAT_DIELECTRIC)
    is_iso = mtype == float(defs.MAT_ISOTROPIC)
    is_light = mtype == float(defs.MAT_DIFFUSE_LIGHT)
    uses_tex = (mtype == float(defs.MAT_TEXTURE)) | is_iso

    ldx, ldy, ldz = nx_ + uvx, ny_ + uvy, nz_ + uvz
    eps = float(defs.NEAR_ZERO_EPS)
    degen = (torch.abs(ldx) < eps) & (torch.abs(ldy) < eps) & (torch.abs(ldz) < eps)
    ldx = torch.where(degen, nx_, ldx)
    ldy = torch.where(degen, ny_, ldy)
    ldz = torch.where(degen, nz_, ldz)

    dn = dx * nx_ + dy * ny_ + dz * nz_
    rfx = dx - 2.0 * dn * nx_
    rfy = dy - 2.0 * dn * ny_
    rfz = dz - 2.0 * dn * nz_
    rlen = torch.sqrt(torch.clamp(rfx * rfx + rfy * rfy + rfz * rfz, min=1e-24))
    mdx = rfx / rlen + mparam * uvx
    mdy = rfy / rlen + mparam * uvy
    mdz = rfz / rlen + mparam * uvz

    param_safe = torch.where(mparam > 0.0, mparam, 1.0)
    ri = torch.where(front, 1.0 / param_safe, param_safe)
    dlen = torch.sqrt(torch.clamp(a, min=1e-24))
    udx, udy, udz = dx / dlen, dy / dlen, dz / dlen
    cos_t = torch.clamp(-(udx * nx_ + udy * ny_ + udz * nz_), max=1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=1e-12))
    cannot = ri * sin_t > 1.0
    r0s = (1.0 - ri) / (1.0 + ri)
    r0s = r0s * r0s
    om = 1.0 - cos_t
    om2 = om * om
    schl = r0s + (1.0 - r0s) * (om * (om2 * om2))  # x**5 as JAX's integer_pow
    refl_choice = cannot | (schl > u3)
    udn = udx * nx_ + udy * ny_ + udz * nz_
    rfux = udx - 2.0 * udn * nx_
    rfuy = udy - 2.0 * udn * ny_
    rfuz = udz - 2.0 * udn * nz_
    rpx = ri * (udx + cos_t * nx_)
    rpy = ri * (udy + cos_t * ny_)
    rpz = ri * (udz + cos_t * nz_)
    k = 1.0 - (rpx * rpx + rpy * rpy + rpz * rpz)
    spar = -torch.sqrt(torch.clamp(torch.abs(k), min=1e-20))
    ddx = torch.where(refl_choice, rfux, rpx + spar * nx_)
    ddy = torch.where(refl_choice, rfuy, rpy + spar * ny_)
    ddz = torch.where(refl_choice, rfuz, rpz + spar * nz_)

    ndx = torch.where(is_lamb, ldx, torch.where(is_metal, mdx, torch.where(is_diel, ddx, uvx)))
    ndy = torch.where(is_lamb, ldy, torch.where(is_metal, mdy, torch.where(is_diel, ddy, uvy)))
    ndz = torch.where(is_lamb, ldz, torch.where(is_metal, mdz, torch.where(is_diel, ddz, uvz)))

    atr = torch.where(is_diel, 1.0, torch.where(uses_tex, t_alr, alr))
    atg = torch.where(is_diel, 1.0, torch.where(uses_tex, t_alg, alg))
    atb = torch.where(is_diel, 1.0, torch.where(uses_tex, t_alb, alb))
    emr = torch.where(is_light, t_alr, 0.0)
    emg = torch.where(is_light, t_alg, 0.0)
    emb = torch.where(is_light, t_alb, 0.0)

    miss = alive & ~valid
    hit_live = alive & valid
    scatter_live = hit_live & ~is_light

    rr = rr + torch.where(miss, tpr * bg[0], 0.0) + torch.where(hit_live, tpr * emr, 0.0)
    rg = rg + torch.where(miss, tpg * bg[1], 0.0) + torch.where(hit_live, tpg * emg, 0.0)
    rb = rb + torch.where(miss, tpb * bg[2], 0.0) + torch.where(hit_live, tpb * emb, 0.0)
    tpr = torch.where(scatter_live, tpr * atr, tpr)
    tpg = torch.where(scatter_live, tpg * atg, tpg)
    tpb = torch.where(scatter_live, tpb * atb, tpb)
    ox = torch.where(scatter_live, px, ox)
    oy = torch.where(scatter_live, py, oy)
    oz = torch.where(scatter_live, pz, oz)
    dx = torch.where(scatter_live, ndx, dx)
    dy = torch.where(scatter_live, ndy, dy)
    dz = torch.where(scatter_live, ndz, dz)
    bn = bn + torch.where(alive, 1.0, 0.0)
    next_alive = scatter_live & (bn < float(max_depth))
    return (bn, next_alive.to(torch.float32), ox, oy, oz, dx, dy, dz,
            tpr, tpg, tpb, rr, rg, rb)


def make_bounce(packed, background, *, max_depth, sizes, has_checker, has_noise,
                ntab=None, stats=None):
    """The per-bounce transition of the v4 kernel (JAX ``_make_bounce``):
    ``bounce(key, tm, carry) -> carry`` with carry = (bn, alive, ox, oy, oz,
    dx, dy, dz, tpr, tpg, tpb, rr, rg, rb), all [N] f32, and ``key`` the
    lane's uint32 sample key (int64 holder). ``track=True`` also returns
    the winner (material, record index, ``FAMID``) of each lane's sweep.
    ``ntab`` (``pack_noise_tables``) switches noise to the tables;
    ``stats`` (a dict, optional) gets each live lane's sweep tests added
    ("bounces", "aabb", and the record tests of "sph", "quad", "box",
    "med") and its noise evaluations ("noise_marble", "noise_perlin"),
    which is what the kernel's bound counts."""
    cols = unpack_buffer(packed, sizes)
    tl = {fam: {k: v.tolist() for k, v in cols[fam].items()}
          for fam in ("sph", "quad", "box", "med")}
    hier = {}
    for fam, f, keys, n, on in (("sph", "s", SPH_KEYS, sizes[0], hier_flags(sizes)[0]),
                                ("box", "b", BOX_KEYS, sizes[5], hier_flags(sizes)[1])):
        if on:
            n_cl, n_l2 = cluster_counts(n)
            hier[fam] = dict(n=n, n_cl=n_cl, n_l2=n_l2, cols={k: cols[fam][k] for k in keys},
                             cb=cols[f + "cb"], sb=cols[f + "sb"],
                             ord=cols[f + "ord"]["ord"].to(torch.int64),
                             lord=cols[f + "lord"]["lord"].to(torch.int64))
            if SWEEP_MODE == "bvh":
                hier[fam].update(m=bvh_nodes(n), bv=cols[f + "bv"],
                                 bleaf=cols[f + "bleaf"]["bleaf"].to(torch.int64),
                                 **{k: cols[f + k][k].to(torch.int64)
                                    for k in ("bhit", "bmiss")})
    mat_cols = [cols["mat"][k] for k in MAT_KEYS]
    tex_cols = [cols["tex"][k] for k in TEX_KEYS]
    bg = [float(x) for x in background.tolist()]
    n_med = sizes[4]
    if stats is not None:
        for k in ("bounces", "aabb", "sph", "quad", "box", "med", "noise_marble",
                  "noise_perlin"):
            stats.setdefault(k, 0)

    def tex_resolve(idx_f):
        idx = idx_f.to(torch.int64)
        return tuple(c[idx] for c in tex_cols)

    def bounce(key, tm, carry, track=False):
        (bn, alive_f, ox, oy, oz, dx, dy, dz) = carry[:8]
        a = dx * dx + dy * dy + dz * dz
        inv_a = 1.0 / a
        alive = alive_f > 0.0
        if stats is not None:
            stats["bounces"] += int(alive.sum())
        rec = _closest_hit(tl, sizes, key=key, tm=tm, ox=ox, oy=oy, oz=oz,
                           dx=dx, dy=dy, dz=dz, a=a, inv_a=inv_a, bn=bn, track=track,
                           hier=hier, alive=alive, stats=stats)
        midx = rec[2].to(torch.int64)
        mat6 = tuple(c[midx] for c in mat_cols)
        out = _shade_advance(carry, rec[:7], mat6, tex_resolve, bg, key,
                             has_checker=has_checker, has_noise=has_noise,
                             max_depth=max_depth, n_med=n_med, ntab=ntab, stats=stats)
        return (out, (rec[2], rec[7], rec[8])) if track else out

    return bounce


def regenerate(cv, seed, pix, s_lane, tm, carry, in_grid, allow=None):
    """Regeneration step of the kernel's loop: every dead lane with samples
    left (and, where ``allow`` is given, allowed: wave regeneration) takes
    the camera ray of its next sample. ``pix`` is (xx, yy, pid_u) of each
    lane; ``carry`` the 14 bounce columns. Returns (s_lane, key, tm, carry),
    with ``key`` the lane's sample key for the bounce."""
    xx, yy, pid_u = pix
    s0, n_samples, sqrt_spp = cv[21], cv[22], cv[23]
    (bn, al, ox, oy, oz, dx, dy, dz, tpr, tpg, tpb, rr, rg, rb) = carry
    need = (al <= 0.0) & (s_lane < n_samples - 1.0) & in_grid
    if allow is not None:
        need = need & allow
    s_lane = s_lane + torch.where(need, 1.0, 0.0)
    key = rng.v4_sample_key(seed, pid_u, s0 + s_lane)
    cox, coy, coz, cdx, cdy, cdz, ctm = camera.camera_ray(
        cv, xx, yy, sqrt_spp, s0 + s_lane, key)
    ox, oy, oz = torch.where(need, cox, ox), torch.where(need, coy, oy), torch.where(need, coz, oz)
    dx, dy, dz = torch.where(need, cdx, dx), torch.where(need, cdy, dy), torch.where(need, cdz, dz)
    tm = torch.where(need, ctm, tm)
    bn = torch.where(need, 0.0, bn)
    al = torch.where(need, 1.0, al)
    tpr, tpg, tpb = torch.where(need, 1.0, tpr), torch.where(need, 1.0, tpg), torch.where(need, 1.0, tpb)
    return s_lane, key, tm, (bn, al, ox, oy, oz, dx, dy, dz, tpr, tpg, tpb, rr, rg, rb)


def pixel_slots(width: int, height: int, block: bool = False):
    """(n_slots, slot_of_pixel [H, W] int64) of v4's lane layout (JAX
    ``pixel_slots``, :1763-1783): linear, slot == pixel id (no padding:
    the kernel masks its last block); or block-tiled, one ``BLOCK_TILE``-lane
    tile per ``BLOCK`` x ``BLOCK`` pixel block, row-major blocks, whose lanes
    past the image's edge stay idle."""
    if not block:
        return width * height, torch.arange(width * height).reshape(height, width)
    nbx, nby = -(-width // BLOCK), -(-height // BLOCK)
    xs, ys = torch.arange(width), torch.arange(height)
    tile = (ys[:, None] // BLOCK) * nbx + xs[None, :] // BLOCK
    slot = tile * BLOCK_TILE + (ys[:, None] % BLOCK) * BLOCK + xs[None, :] % BLOCK
    return nbx * nby * BLOCK_TILE, slot


def trace_plain(camv, seed, packed, background, *, n_pix, max_depth, sizes,
                has_checker, has_noise, ntab=None, block=False, wave_frac=1.0, stats=None,
                mat_types=None, tally=None):
    """Plain PyTorch version of the v4 kernel: radiance summed over
    ``camv[22]`` samples for each of ``n_pix`` slots, [n_pix, 3] (on the
    block-tiled layout, ``block``, n_pix is ``pixel_slots``' n_slots).

    Like the JAX kernel's tile loop, every iteration regenerates each dead
    lane that has samples left — with ``wave_frac < 1`` only in tiles whose
    live count has fallen to ``wave_frac`` of their in-image lanes — then
    bounces the live lanes; the loop ends when no lane can run. A tile is
    one CUDA block of the kernel: ``BLOCK_TILE`` lanes on the block layout,
    ``TILE`` on the linear one. ``mat_types``, which picks the kernel's
    instance, changes nothing here. ``tally`` (an int64 [2] tensor, optional)
    gets the bounces (path segments) and the medium scatters added, as the
    kernel's counter counts them."""
    device = packed.device
    cv = [float(x) for x in camv.tolist()]
    bounce = make_bounce(packed, background, max_depth=max_depth, sizes=sizes,
                         has_checker=has_checker, has_noise=has_noise, ntab=ntab, stats=stats)
    tile = BLOCK_TILE if block else TILE
    n_lanes = -(-n_pix // tile) * tile
    slot_i = torch.arange(n_lanes, dtype=torch.int32, device=device) + int(cv[25])
    slot_f = slot_i.to(torch.float32)
    xx, yy, in_grid = camera.slot_to_pixel(slot_f, cv, tile if block else 0)
    pix = (xx, yy, rng.as_u32(yy * cv[19] + xx))
    n_img = in_grid.view(-1, tile).sum(1).to(torch.float32)
    threshold = torch.tensor(wave_frac, dtype=torch.float32, device=device) * n_img
    zero = torch.zeros(n_lanes, dtype=torch.float32, device=device)
    s_lane = torch.full_like(zero, -1.0)
    tm = zero
    carry = (zero,) * 14
    while True:
        al = carry[1]
        runnable = (al > 0.0) | ((s_lane < cv[22] - 1.0) & in_grid)
        if not bool(runnable.any()):
            break
        allow = None
        if wave_frac < 1.0:
            live = (al > 0.0).view(-1, tile).sum(1).to(torch.float32)
            allow = (live <= threshold).repeat_interleave(tile)
        s_lane, key, tm, carry = regenerate(cv, seed, pix, s_lane, tm, carry, in_grid, allow)
        # A bounce changes nothing on a dead lane: bounce the live ones only.
        idx = torch.nonzero(carry[1] > 0.0).squeeze(1)
        lanes = (key[idx], tm[idx], tuple(c[idx] for c in carry))
        if tally is None:
            out = bounce(*lanes)
        else:
            out, (_, _, famid) = bounce(*lanes, track=True)
            tally[0] += idx.numel()
            tally[1] += (famid == FAMID["med"]).sum()
        carry = tuple(c.index_copy(0, idx, v) for c, v in zip(carry, out))
    return torch.stack(carry[11:14], dim=-1)[:n_pix]


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------


def check_inputs(camv, packed, background, n_pix, sizes):
    for name, t in (("camv", camv), ("packed", packed), ("background", background)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.dim() != 1:
            raise ValueError(f"{name} must be a contiguous 1-D float32 tensor")
        if t.device != packed.device:
            raise ValueError(f"{name} is on {t.device}, packed on {packed.device}")
    if camv.numel() != camera.CAMV_LEN or background.numel() != 3:
        raise ValueError("camv must hold 28 entries and background 3")
    if packed.numel() != table_layout(sizes)["total"][0]:
        raise ValueError("packed buffer does not match the table layout of sizes (packed "
                         "in another SWEEP_MODE?)")
    if not 0 <= n_pix < (1 << 24):
        # Pixel ids ride f32 in the kernel's slot arithmetic (JAX :1729-1731).
        raise ValueError(f"n_pix={n_pix} must be below 2^24")


def n_noise_of(ntab) -> int:
    """Noise textures in an ``ntab`` operand (0 for None: hash noise)."""
    return 0 if ntab is None else ntab.shape[1] // NOISE_TABLE_N


def check_ntab(ntab, packed) -> None:
    if ntab is None:
        return
    if (ntab.dtype != torch.float32 or not ntab.is_contiguous() or ntab.dim() != 2
            or ntab.shape[0] != 6 or ntab.shape[1] % NOISE_TABLE_N or not ntab.shape[1]
            or ntab.device != packed.device):
        raise ValueError("ntab must be a contiguous [6, T*256] float32 tensor on the "
                         "tables' device")


def trace_megakernel_batch(camv, seed, packed, background, *, n_pix, max_depth,
                           sizes, has_checker, has_noise, ntab=None, block=False,
                           wave_frac=1.0, mat_types=None):
    """Radiance summed over the batch's samples, [n_pix, 3] f32, per slot.

    ``camv``: the 28-entry control vector (``camera.make_camv``, with
    ``block=BLOCK`` for the block-tiled layout); ``seed``: the exact int
    seed; ``packed``: ``pack_buffer`` of the scene tables; ``background``:
    [3]; ``ntab``: ``pack_noise_tables`` for table noise, or None for hash
    noise. ``block`` selects the block-tiled lane layout (``n_pix`` is then
    ``pixel_slots``' n_slots, and the caller de-tiles), ``wave_frac`` the
    wave regeneration. On a CPU tensor this runs the plain version; on a
    CUDA tensor it launches the Hopper kernel's instance for the scene's
    feature mask (``scene_features``; built at first use) or raises.
    ``mat_types`` (``scene_material_types``; None: read from ``packed``)
    are the material type ids the scene holds. While a profiler records as
    the batch starts, the batch adds its segments and medium scatters to
    ``SEGMENTS`` and ``MEDIUM_SCATTERS`` on the device."""
    global LAUNCHES
    check_inputs(camv, packed, background, n_pix, sizes)
    check_ntab(ntab, packed)
    if block and n_pix % BLOCK_TILE:
        raise ValueError(f"n_pix={n_pix} must be a multiple of {BLOCK_TILE} on the "
                         "block-tiled layout")
    kw = dict(n_pix=n_pix, max_depth=max_depth, sizes=sizes, has_checker=has_checker,
              has_noise=has_noise, ntab=ntab, block=block, wave_frac=wave_frac)
    if packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {packed.device}")
    tally = tracing.device_counter(_TALLY, packed.device, 2)
    if packed.device.type == "cpu":
        return trace_plain(camv, seed, packed, background, tally=tally, **kw)
    from raytrace2_tpu_torch.ops.kernels import build

    out = torch.empty((n_pix, 3), dtype=torch.float32, device=packed.device)
    build.launch_megakernel_v4(
        camv, int(seed), background, packed, ntab, out, n_pix=n_pix,
        max_depth=max_depth, counts=counts(sizes, n_noise_of(ntab)),
        checker_depth=int(has_checker), has_noise=bool(has_noise),
        features=scene_features(packed, sizes, has_checker, has_noise, ntab, mat_types),
        block=bool(block), wave_frac=float(wave_frac), tally=tally)
    LAUNCHES += 1
    return out
