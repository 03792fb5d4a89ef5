"""Fused sphere + quad closest hit (B5): host packing, the plain PyTorch
version, and the wrapper that launches the Hopper kernel
(``csrc/intersect_kernel.cu``).

Port of ``raytrace2_tpu/ops/pallas/intersect_kernel.py`` (``_kernel``,
launched by ``closest_hit_pallas``), which serves ``Renderer(backend=
"pallas")``: the non-kernel path's bounce loop calls it once per bounce for
the sphere and quad families, and resolves media and ellipsoids densely.
For each ray it returns the nearest sphere or quad hit inside
(t_min, t_max): ``best_t`` [N] f32 (3e38 on a miss) and ``code`` [N] int32,
``family << 24 | index`` (family 0 spheres, 1 quads; -1 on a miss).

The arithmetic is the Pallas kernel's: ``inv_a = 1/a`` and ``(h ∓ sq) *
inv_a``, ``sq = sqrt(has ? disc : 0)``, the quad's ``t = (d - n·o) /
(not_par ? n·d : 1)``, closed intervals for quads and strict ones for
spheres, ``act > 0``. Records are tested in index order, spheres before
quads, and a hit replaces the best only when strictly closer, which is the
Pallas kernel's tile-wise argmin plus its strict ``<`` across tiles: the
first index wins a tie.

Live extents: the callers pass ``n_sph``, ``n_quad``, one past each
family's last active record (``live_extents``, read once per scene from the
host scene); the records past them are padding, which never hits, so the
result is the padded sweep's bit for bit. Without them the whole padded
rows are swept.

On the card (``launch_config``): each ray's sweep is split over a group of
G lanes of a warp, the smallest G that gives the grid ``MIN_WARPS_PER_SM``
warps on each SM, as long as a lane still tests ``MIN_RECORDS_PER_LANE``
records; the records sit in shared memory as float4 planes, the whole live
table once per block where it fits, else in tiles of ``TILE_BYTES``; a
grid of fewer blocks than SMs (the route's compacted launches) takes
smaller blocks, down to ``MIN_THREADS``, while it still runs in one wave.
"""

from __future__ import annotations

import numpy as np
import torch

from raytrace2_tpu_torch import defs
from raytrace2_tpu_torch.ops.kernels import build
from raytrace2_tpu_torch.ops.kernels.megakernel import _cross
from raytrace2_tpu_torch.scene import schema

BIG = 3.0e38
TILE_P = 128      # records per tile (the Pallas kernel's primitive tile)
FAM_SHIFT = 24
CODE_SPHERE = 0 << FAM_SHIFT
CODE_QUAD = 1 << FAM_SHIFT

SPH_KEYS = ("c0x", "c0y", "c0z", "dpx", "dpy", "dpz", "r2", "act")
QUAD_KEYS = ("nx", "ny", "nz", "d", "aax", "aay", "aaz", "abx", "aby", "abz",
             "qaa", "qab", "act")

# Launches of the CUDA kernel (the plain version does not count).
LAUNCHES = 0

# The launch rule (launch_config; csrc/intersect_kernel.cu).
MIN_WARPS_PER_SM = 16       # the grid's warps an SM that hide the tests' latency
MIN_RECORDS_PER_LANE = 2    # the least records a lane of a group tests
MIN_THREADS = 128           # the smallest block: fewer threads stage the table too slowly
MAX_GROUP = 32
SPH_BYTES, QUAD_BYTES = 32, 52   # a staged record: 2 float4; 3 float4 and act
SM_SMEM_BYTES = 233472      # an SM's shared memory, 1,024 B of it reserved per block
SMEM_RESERVED = 1024
# Threads an SM holds: its 65,536 registers over the 64 a thread may take at
# most (__launch_bounds__(1024)); and its blocks.
MAX_THREADS_PER_SM = 1024
MAX_BLOCKS_PER_SM = 32
TILE_BYTES = 48 * 1024      # a tile's budget where the live table does not fit
H100_SMS = 132

# f32 operations of one record test (csrc/intersect_kernel.cu, selects not
# counted): a sphere test stops at the compare of its discriminant unless
# the sphere has a real root; a quad test has no early stop.
OPS_SPHERE_MISS, OPS_SPHERE, OPS_QUAD = 24, 35, 48


def _dot3_fused(a, b):
    """``a·b`` of [P, 3] rows as XLA contracts the JAX ``jnp.sum(a * b, -1)``
    here: fma(a2, b2, fma(a1, b1, a0*b0)), each fma taken in float64 (where
    the product of two f32 is exact) and rounded once to f32."""
    a, b = a.double(), b.double()
    s = (a[:, 0] * b[:, 0]).float()
    s = (a[:, 1] * b[:, 1] + s.double()).float()
    return (a[:, 2] * b[:, 2] + s.double()).float()


def pack_scene(spheres, quads):
    """Record rows of every sphere and quad (active or not), each padded with
    zeros to a multiple of ``TILE_P``, as the JAX ``pack_scene`` (:189-223)
    emits them: ``sph`` [8, Ps] (``SPH_KEYS``) and ``qd`` [13, Pq]
    (``QUAD_KEYS``), contiguous f32 on the scene's device. The cross
    products and ``q·(v×w)`` are fused as XLA contracts them, so the rows
    equal the JAX package's bit for bit."""
    spheres, quads = schema.as_float32(spheres), schema.as_float32(quads)

    def rows(cols):
        x = torch.stack([c.to(torch.float32) for c in cols])
        return torch.nn.functional.pad(x, (0, -x.shape[1] % TILE_P)).contiguous()

    sph = rows([spheres.center0[:, 0], spheres.center0[:, 1], spheres.center0[:, 2],
                spheres.displacement[:, 0], spheres.displacement[:, 1],
                spheres.displacement[:, 2], spheres.radius * spheres.radius,
                spheres.active])
    a_alpha = _cross(quads.v, quads.w)
    a_beta = _cross(quads.w, quads.u)
    qd = rows([quads.normal[:, 0], quads.normal[:, 1], quads.normal[:, 2], quads.d,
               a_alpha[:, 0], a_alpha[:, 1], a_alpha[:, 2],
               a_beta[:, 0], a_beta[:, 1], a_beta[:, 2],
               _dot3_fused(quads.q, a_alpha), _dot3_fused(quads.q, a_beta), quads.active])
    return sph, qd


def live_extents(scene) -> tuple[int, int]:
    """(ns, nq): one past the last active sphere and the last active quad of
    a scene (numpy leaves, as the loader builds it, or tensors, read to the
    host; 0 for a family with none), read once per scene. Records past them
    are padding, which never hits (``act`` is 0)."""
    def extent(active):
        idx = np.flatnonzero(active.cpu().numpy() if torch.is_tensor(active)
                             else np.asarray(active))
        return int(idx[-1]) + 1 if idx.size else 0

    return extent(scene.spheres.active), extent(scene.quads.active)


def smem_bytes(cap_s: int, cap_q: int) -> int:
    """Shared memory of tiles of cap_s spheres and cap_q quads: what a
    launch passes to the kernel."""
    return cap_s * SPH_BYTES + cap_q * QUAD_BYTES


def blocks_per_sm(threads: int, smem: int) -> int:
    """Resident blocks an SM of a launch at ``threads`` a block and ``smem``
    bytes of shared memory: the fewest that its shared memory, its threads
    (``MAX_THREADS_PER_SM``) and the card's block limit allow."""
    return min(SM_SMEM_BYTES // (smem + SMEM_RESERVED), MAX_THREADS_PER_SM // threads,
               MAX_BLOCKS_PER_SM)


def launch_config(n: int, n_sph: int, n_quad: int, sms: int = H100_SMS, group=None,
                  tiles: bool = False) -> tuple[int, int, int, int]:
    """(G, threads a block, cap_s, cap_q) of a launch over n rays and the
    live records [0, n_sph) and [0, n_quad).

    G: the smallest power of two that gives the grid n·G/32 warps ≥
    ``MIN_WARPS_PER_SM`` on each of ``sms`` SMs, capped so that a lane still
    tests ``MIN_RECORDS_PER_LANE`` records (``group`` forces it: tests and
    tools only). Staging: the whole live table once per block where it fits
    in a block's shared memory, else tiles of ``TILE_BYTES`` split evenly
    between the families (``tiles`` forces them). Threads: the smallest
    block from 256 threads whose resident blocks (``blocks_per_sm``) fill
    an SM's ``MAX_THREADS_PER_SM``, so that a full grid keeps 32 warps on
    each SM; then, while the grid has fewer blocks than ``sms``, half that
    block, down to ``MIN_THREADS``, as long as the smaller blocks still fit
    on the card at once (one wave)."""
    live = n_sph + n_quad
    g_cap = 1
    while g_cap < MAX_GROUP and live >= 2 * g_cap * MIN_RECORDS_PER_LANE:
        g_cap *= 2
    g = 1
    while g < g_cap and n * g < MIN_WARPS_PER_SM * 32 * sms:
        g *= 2
    if group is not None:
        if group not in (1, 2, 4, 8, 16, 32):
            raise ValueError(f"group must be a power of two up to {MAX_GROUP}, got {group}")
        g = group
    if not tiles and smem_bytes(n_sph, n_quad) <= build.MAX_SMEM_BYTES:
        cap_s, cap_q = n_sph, n_quad
    else:
        cap_s = min(n_sph, TILE_BYTES // 2 // SPH_BYTES)
        cap_q = min(n_quad, TILE_BYTES // 2 // QUAD_BYTES)
    smem = smem_bytes(cap_s, cap_q)
    threads = next((t for t in (256, 512) if blocks_per_sm(t, smem) * t >= MAX_THREADS_PER_SM),
                   1024)

    def blocks(t):
        return -(-n * g // t)

    while (threads > MIN_THREADS and blocks(threads) < sms
           and blocks(threads // 2) <= sms * blocks_per_sm(threads // 2, smem)):
        threads //= 2
    return g, threads, cap_s, cap_q


# ---------------------------------------------------------------------------
# Plain version (PyTorch, [N, TILE_P] record tiles)
# ---------------------------------------------------------------------------


def _ray(o, d, time, t_min, t_max):
    """The ray columns [N, 1] of a sweep, with a = d·d and 1/a."""
    cols = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], time, t_min, t_max]
    ox, oy, oz, dx, dy, dz, tm, t0, t1 = (c[:, None] for c in cols)
    a = dx * dx + dy * dy + dz * dz
    return ox, oy, oz, dx, dy, dz, tm, t0, t1, a, 1.0 / a


def _sphere_disc(ray, s):
    """(h, disc) [N, TILE_P] of one sphere tile: the test up to its
    discriminant."""
    ox, oy, oz, dx, dy, dz, tm, _, _, a, _ = ray
    cx = s[0] + tm * s[3]
    cy = s[1] + tm * s[4]
    cz = s[2] + tm * s[5]
    ocx, ocy, ocz = cx - ox, cy - oy, cz - oz
    h = dx * ocx + dy * ocy + dz * ocz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - s[6]
    return h, h * h - a * cc


def _sphere_tile(ray, s):
    """[N, TILE_P] accepted roots of one sphere tile (``_sphere_pass``)."""
    t0, t1, inv_a = ray[7], ray[8], ray[10]
    h, disc = _sphere_disc(ray, s)
    has = disc >= 0.0
    sq = torch.sqrt(torch.where(has, disc, 0.0))
    r0 = (h - sq) * inv_a
    r1 = (h + sq) * inv_a
    ok0 = (r0 > t0) & (r0 < t1)
    ok1 = (r1 > t0) & (r1 < t1)
    root = torch.where(ok0, r0, r1)
    hit = has & (ok0 | ok1) & (s[7] > 0)
    return torch.where(hit, root, BIG)


def _quad_tile(ray, q):
    """[N, TILE_P] accepted plane ts of one quad tile (``_quad_pass``)."""
    ox, oy, oz, dx, dy, dz, _, t0, t1, _, _ = ray
    nd = dx * q[0] + dy * q[1] + dz * q[2]
    no = ox * q[0] + oy * q[1] + oz * q[2]
    not_par = torch.abs(nd) >= float(defs.QUAD_EPS)
    t = (q[3] - no) / torch.where(not_par, nd, 1.0)
    o_aa = ox * q[4] + oy * q[5] + oz * q[6]
    d_aa = dx * q[4] + dy * q[5] + dz * q[6]
    o_ab = ox * q[7] + oy * q[8] + oz * q[9]
    d_ab = dx * q[7] + dy * q[8] + dz * q[9]
    alpha = o_aa + t * d_aa - q[10]
    beta = o_ab + t * d_ab - q[11]
    hit = (not_par & (t >= t0) & (t <= t1) & (alpha >= 0.0) & (alpha <= 1.0)
           & (beta >= 0.0) & (beta <= 1.0) & (q[12] > 0))
    return torch.where(hit, t, BIG)


def closest_hit_plain(o, d, time, t_min, t_max, sph, qd, n_sph=None, n_quad=None):
    """Plain PyTorch version of the kernel, over [N, TILE_P] record tiles in
    the Pallas kernel's order of operations, of the records [0, n_sph) and
    [0, n_quad) (all of them by default). Returns (best_t, code)."""
    sph, qd = sph[:, :n_sph], qd[:, :n_quad]
    n = o.shape[0]
    ray = _ray(o, d, time, t_min, t_max)
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=o.device)
    code = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    for rows, tile_fn, fam in ((sph, _sphere_tile, CODE_SPHERE), (qd, _quad_tile, CODE_QUAD)):
        for off in range(0, rows.shape[1], TILE_P):
            ts = tile_fn(ray, rows[:, None, off:off + TILE_P])
            tile_best, tile_arg = ts.min(dim=1)
            closer = tile_best < best_t
            best_t = torch.where(closer, tile_best, best_t)
            code = torch.where(closer, (tile_arg + (fam + off)).to(torch.int32), code)
    return best_t, code


def record_test_ops(o, d, time, t_min, t_max, sph, n_sph: int, n_quad: int) -> int:
    """f32 operations of a launch's record tests on these rays: per ray,
    ``OPS_QUAD`` for each of the ``n_quad`` live quads and, for each of the
    ``n_sph`` live spheres, ``OPS_SPHERE_MISS``, or ``OPS_SPHERE`` where the
    plain version's discriminant is ≥ 0 (the kernel's, bit for bit)."""
    ray = _ray(o, d, time, t_min, t_max)
    roots = 0
    for off in range(0, n_sph, TILE_P):
        _, disc = _sphere_disc(ray, sph[:, None, off:min(off + TILE_P, n_sph)])
        roots += int((disc >= 0.0).sum())
    return (o.shape[0] * (n_sph * OPS_SPHERE_MISS + n_quad * OPS_QUAD)
            + roots * (OPS_SPHERE - OPS_SPHERE_MISS))


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------


def closest_hit(o, d, time, t_min, t_max, sph, qd, n_sph=None, n_quad=None, *,
                group=None, tiles=False):
    """Nearest sphere/quad hit of each ray: (best_t [N] f32, code [N] int32).

    ``o``, ``d`` [N, 3]; ``time``, ``t_min``, ``t_max`` [N]; ``sph``, ``qd``
    from ``pack_scene``; ``n_sph``, ``n_quad`` the live extents
    (``live_extents``; the padded widths by default). On a CPU tensor this
    runs the plain version; on a CUDA tensor it launches the Hopper kernel
    (built at first use) or raises. Any N: the kernel masks the tail.
    ``group`` and ``tiles`` force the launch's lane group and tiled staging
    (``launch_config``); only tests and tools pass them."""
    global LAUNCHES
    n = o.shape[0]
    n_sph = sph.shape[-1] if n_sph is None else int(n_sph)
    n_quad = qd.shape[-1] if n_quad is None else int(n_quad)
    if not (0 <= n_sph <= sph.shape[-1] and 0 <= n_quad <= qd.shape[-1]):
        raise ValueError(f"live extents ({n_sph}, {n_quad}) outside the rows "
                         f"({sph.shape[-1]}, {qd.shape[-1]})")
    for name, t, shape in (("o", o, (n, 3)), ("d", d, (n, 3)), ("time", time, (n,)),
                           ("t_min", t_min, (n,)), ("t_max", t_max, (n,)),
                           ("sph", sph, (len(SPH_KEYS), sph.shape[-1])),
                           ("qd", qd, (len(QUAD_KEYS), qd.shape[-1]))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != o.device:
            raise ValueError(f"{name} is on {t.device}, o on {o.device}")
    if o.device.type == "cpu":
        return closest_hit_plain(o, d, time, t_min, t_max, sph, qd, n_sph, n_quad)
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    config = launch_config(n, n_sph, n_quad, build.sm_count(o.device), group, tiles)
    best_t = torch.empty((n,), dtype=torch.float32, device=o.device)
    code = torch.empty((n,), dtype=torch.int32, device=o.device)
    build.launch_intersect_kernel(*(x.contiguous() for x in (o, d, time, t_min, t_max,
                                                             sph, qd)), best_t, code,
                                  n_sph=n_sph, n_quad=n_quad, config=config,
                                  smem=smem_bytes(*config[2:]))
    LAUNCHES += 1
    return best_t, code
