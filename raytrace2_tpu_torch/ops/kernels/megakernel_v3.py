"""v3 state-passing megakernel (B4): the driver, the plain PyTorch version of
one pass, and the wrapper that launches the Hopper kernel
(``csrc/megakernel_v3.cu``).

Port of ``raytrace2_tpu/ops/pallas/megakernel.py`` (``_render_kernel``,
``megakernel_pass``, ``init_state``, ``trace_megakernel``, :1422-1648). The
non-kernel path's ``integrator.trace_rays`` reaches it when it gets a
``mega_seed`` and ``use_megakernel`` is set (``render_sample`` passes one).
A pass runs each tile's bounce loop until the tile's live count falls to
``min_alive``; between passes the host gathers the survivors into a buffer
``ratio`` times smaller.

The state is 12 f32 columns [12, n] (``STATE_KEYS``) and an int32 ray id
[n] (the JAX kernel carries the id as an f32 bit pattern). Each ray's
stream key is ``mix(rid·0x9E3779B9 ^ mix(seed_lane))``, and the bounce is
v4's (``megakernel.make_bounce`` here, ``path_common.cuh::bounce`` in the
kernel), so a ray's path does not depend on where a pass stops.
"""

from __future__ import annotations

import torch

from raytrace2_tpu_torch.ops import rng
from raytrace2_tpu_torch.ops.kernels import megakernel as mk

# Rays per tile: one CUDA block (path_common.cuh kThreads). The JAX kernel's
# tile is 4,096 lanes; the port's only has to keep the survivor bound below.
TILE_R = 128
STATE_KEYS = ("ox", "oy", "oz", "dx", "dy", "dz", "tm", "bounce", "alive", "tpr", "tpg",
              "tpb")
COL = {k: i for i, k in enumerate(STATE_KEYS)}

# Launches of the CUDA kernel (the plain version does not count).
LAUNCHES = 0


def instance_features(packed, sizes, has_checker, has_noise, mat_types=None) -> int:
    """The feature mask of the kernel's instance for a scene: the scene's
    own (``megakernel.scene_features`` with hash noise) where every family
    sweeps flat, the pass then compacting its live rays (where the exchange
    area fits in shared memory); every feature where a family goes through
    the cluster walk (no compaction there: the mask instance measured slower
    than the all-features one)."""
    if any(mk.hier_flags(sizes)):
        return mk.F_ALL
    return mk.scene_features(packed, sizes, has_checker, has_noise, None, mat_types)


def init_state(o, d, time):
    """Fresh state of N camera rays (JAX ``init_state``): ([12, N] f32,
    rid [N] int32 = 0..N-1)."""
    n = o.shape[0]
    ones = torch.ones(n, dtype=torch.float32, device=o.device)
    zeros = torch.zeros_like(ones)
    state = torch.stack([o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], time,
                         zeros, ones, ones, ones, ones]).to(torch.float32).contiguous()
    return state, torch.arange(n, dtype=torch.int32, device=o.device)


def pass_plain(state, rid, seed_lane, min_alive, packed, background, *, max_depth, sizes,
               has_checker, has_noise, mat_types=None):
    """Plain PyTorch version of one pass: every ``TILE_R`` tile bounces its
    live rays while its live count exceeds ``min_alive``. Returns (radiance
    [n, 3] of this pass, new state [12, n]); ``state`` is not changed.
    ``mat_types``, which picks the kernel's instance, changes nothing
    here."""
    n = rid.numel()
    bounce = mk.make_bounce(packed, background, max_depth=max_depth, sizes=sizes,
                            has_checker=has_checker, has_noise=has_noise)
    key = rng.murmur_mix(rng.mul32(rng.as_u32(rid), rng.GOLDEN)
                         ^ rng.murmur_mix(rng.as_u32(int(seed_lane))))
    s = {k: state[COL[k]] for k in STATE_KEYS}
    zeros = torch.zeros_like(s["ox"])
    carry = (s["bounce"], s["alive"], s["ox"], s["oy"], s["oz"], s["dx"], s["dy"], s["dz"],
             s["tpr"], s["tpg"], s["tpb"], zeros, zeros, zeros)
    while True:
        live = carry[1] > 0.0
        run_tile = live.view(-1, TILE_R).sum(1) > min_alive
        idx = torch.nonzero(live & run_tile.repeat_interleave(TILE_R)).squeeze(1)
        if not idx.numel():
            break
        out = bounce(key[idx], s["tm"][idx], tuple(c[idx] for c in carry))
        carry = tuple(c.index_copy(0, idx, v) for c, v in zip(carry, out))
    (bn, al, ox, oy, oz, dx, dy, dz, tpr, tpg, tpb, rr, rg, rb) = carry
    new = torch.stack([ox, oy, oz, dx, dy, dz, s["tm"], bn, al, tpr, tpg, tpb])
    return torch.stack([rr, rg, rb], dim=-1), new


def megakernel_pass(state, rid, seed_lane, min_alive, packed, background, *, max_depth,
                    sizes, has_checker, has_noise, mat_types=None):
    """One pass (JAX ``megakernel_pass``): (radiance [n, 3] contributed by
    this pass, new state [12, n]). ``n`` is a multiple of ``TILE_R``. On a
    CPU tensor this runs the plain version; on a CUDA tensor it launches the
    Hopper kernel's instance for the scene (``instance_features``; built at
    first use) on a copy of the state, or raises. ``mat_types``
    (``megakernel.scene_material_types``; None: read from ``packed``) are
    the material type ids the scene holds."""
    global LAUNCHES
    n = rid.numel()
    if n % TILE_R or tuple(state.shape) != (len(STATE_KEYS), n):
        raise ValueError(f"state must be [{len(STATE_KEYS)}, n] with n a multiple of "
                         f"{TILE_R}, got {tuple(state.shape)}")
    if not -2**31 <= int(seed_lane) < 2**31:
        raise ValueError("seed_lane must be an int32")
    if packed.numel() != mk.table_layout(sizes)["total"][0]:
        raise ValueError("packed buffer does not match the table layout of sizes")
    kw = dict(max_depth=max_depth, sizes=sizes, has_checker=has_checker, has_noise=has_noise)
    if state.device.type == "cpu":
        return pass_plain(state, rid, seed_lane, min_alive, packed, background, **kw)
    if state.device.type != "cuda":
        raise ValueError(f"unsupported device {state.device}")
    from raytrace2_tpu_torch.ops.kernels import build

    new = state.to(torch.float32).clone(memory_format=torch.contiguous_format)
    radiance = torch.empty((n, 3), dtype=torch.float32, device=state.device)
    build.launch_megakernel_v3(
        background.to(torch.float32).contiguous(), packed, new, rid.contiguous(), radiance,
        seed_lane=int(seed_lane), min_alive=int(min_alive), max_depth=max_depth,
        counts=mk.counts(sizes), checker_depth=int(has_checker), has_noise=bool(has_noise),
        features=instance_features(packed, sizes, has_checker, has_noise, mat_types))
    LAUNCHES += 1
    return radiance, new


def trace_megakernel(o, d, time, seed_lane, packed, background, *, max_depth, sizes,
                     has_checker, has_noise, phases=3, compaction_ratio=8, mat_types=None):
    """Trace N rays (N a multiple of ``TILE_R``) to completion with
    cross-tile compaction between passes (JAX ``trace_megakernel``,
    :1609-1648): returns radiance [N, 3]."""
    n = o.shape[0]
    if n % TILE_R:
        raise ValueError(f"ray count {n} is not a multiple of {TILE_R}")
    state, rid = init_state(o, d, time)
    radiance_full = torch.zeros((n, 3), dtype=torch.float32, device=o.device)
    idx_map = torch.arange(n, device=o.device)
    kw = dict(max_depth=max_depth, sizes=sizes, has_checker=has_checker, has_noise=has_noise,
              mat_types=mat_types)
    width = n
    for phase in range(phases):
        # Each tile leaves with at most TILE_R // ratio live rays, so the next
        # buffer holds n_tiles * (TILE_R // ratio), rounded UP to a tile.
        survivors = (width // TILE_R) * (TILE_R // compaction_ratio)
        cap_next = -(-survivors // TILE_R) * TILE_R
        last = phase == phases - 1 or cap_next >= width or cap_next < TILE_R
        min_alive = 0 if last else TILE_R // compaction_ratio
        radiance, state = megakernel_pass(state, rid, seed_lane, min_alive, packed,
                                          background, **kw)
        radiance_full.index_add_(0, idx_map, radiance)
        if last:
            break
        live = (state[COL["alive"]] > 0.0) & (state[COL["bounce"]] < max_depth)
        order = torch.argsort((~live).to(torch.int8), stable=True)[:cap_next]
        idx_map, rid = idx_map[order], rid[order]
        state = state[:, order].contiguous()
        width = cap_next
    return radiance_full
