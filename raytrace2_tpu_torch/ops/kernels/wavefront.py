"""Sorted-wavefront renderer for big scenes: the Morton sort, the K-bounce
step's plain PyTorch version, the wrapper that launches the Hopper kernel
(``csrc/wavefront_step.cu``) and the driver that alternates them.

Port of ``raytrace2_tpu/ops/pallas/wavefront_sorted.py``. Every pixel slot
keeps its path state in device memory between launches, as 17 f32 columns
of one ``[17, n_rays]`` tensor (``STATE_KEYS``). Before a launch the driver
sorts the slots by a coherence key (Morton code of the ray origin for live
rays, pixel id for rays about to regenerate, a constant for finished slots)
and gathers the state; the launch then advances every slot by up to K steps
of "regenerate if dead and samples remain, then one bounce". Per-slot
arithmetic is v4's (the plain step reuses ``megakernel.regenerate`` and
``megakernel.make_bounce``; the kernel shares ``path_common.cuh`` with
``megakernel_v4.cu``) and each pixel owns one slot, so the image is bitwise
equal to the v4 kernel's whatever the schedule, sort or key.

The JAX package's TPU layout knobs choose nothing here: ``mega_sublanes``
(tile height) and ``mega_state_packed`` (17 state blocks or one) change no
image, and the port's state is always one ``[17, n]`` tensor advanced by one
thread per slot. Slots are padded to a multiple of ``SLOT_TILE``, which
also sets the grain of the tail compaction.

The kernel's sweep finds v4's winners: the cluster skip for spheres and AA
boxes of 32 or more records, each slot's winner that of its own visit order
(from its ray's direction), walked in one order per warp; the sort gives
neighbouring threads rays that take the same order and enter the same
clusters. ``ntab`` switches noise to the
reference's Perlin tables (``noise_impl="table"``).
"""

from __future__ import annotations

import torch

from raytrace2_tpu_torch import tracing
from raytrace2_tpu_torch.ops import camera, rng
from raytrace2_tpu_torch.ops.kernels import megakernel as mk

# State columns, each [n_rays] f32 (pixel ids stay < 2^24, exact in f32).
STATE_KEYS = ("s_lane", "pid", "bn", "al", "ox", "oy", "oz",
              "dx", "dy", "dz", "tm", "tpr", "tpg", "tpb",
              "rr", "rg", "rb")
COL = {k: i for i, k in enumerate(STATE_KEYS)}
# The 14 columns of megakernel's bounce carry, in its order.
_CARRY_KEYS = ("bn", "al", "ox", "oy", "oz", "dx", "dy", "dz",
               "tpr", "tpg", "tpb", "rr", "rg", "rb")
# Two-phase schedule defaults, as the JAX package tuned them on its chip:
# K=2 bounces per launch with a sort before each, until the runnable
# population drops below TAIL_FRAC of the slots; then TAIL_K per launch.
K_BOUNCES = 2
TAIL_K = 16
TAIL_FRAC = 0.65
SORT_EVERY = 1
SORT_IMPL = "gather"
# Slot padding grain (the kernel's blocks of 256 threads take a ragged end).
SLOT_TILE = 128
# Keys of the three slot classes (JAX sort_keys).
_REGEN_KEY = 1 << 28
_DONE_KEY = 1 << 30

# Launches of the CUDA kernel (the plain version does not count), and sorts
# of the slot state (on either device).
LAUNCHES = 0
SORTS = 0


# ---------------------------------------------------------------------------
# Sort keys
# ---------------------------------------------------------------------------


def interleave3(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of a non-negative integer tensor so that
    consecutive bits land 3 apart (3-D Morton part1by2). Every value stays
    below 2^30, so int64 and int32 shift logically here."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def sort_keys(state, n_samples, bb_lo, bb_hi, key_mode="pos") -> torch.Tensor:
    """int32 coherence key per slot (JAX ``sort_keys``): small runs first,
    similar keys share a block.

    * live rays, by ``key_mode``: "pos" Morton-7 of the origin in the scene
      box, then the direction octant (24 bits); "pos8" Morton-8 (24 bits);
      "depth" the bounce index, then Morton-7 (27 bits);
    * dead, samples left: 2^28 + pixel id, so fresh camera rays group by
      pixel;
    * finished or padding: 2^30.
    Every key is below 2^31. ``bb_lo``/``bb_hi`` are [3] f32 tensors."""
    st = state
    alive = st[COL["al"]] > 0.0
    can_regen = (st[COL["s_lane"]] < n_samples - 1.0) & (st[COL["pid"]] >= 0.0)
    bits = 8 if key_mode == "pos8" else 7
    top = float((1 << bits) - 1)
    extent = torch.clamp(bb_hi - bb_lo, min=1e-20)
    inv = torch.full_like(extent, top) / extent  # a true division, as JAX's
    qs = []
    for axis, name in enumerate(("ox", "oy", "oz")):
        q = torch.clamp((st[COL[name]] - bb_lo[axis]) * inv[axis], 0.0, top)
        qs.append(interleave3(q.to(torch.int64)))
    morton = qs[0] | (qs[1] << 1) | (qs[2] << 2)
    if key_mode == "pos8":
        akey = morton
    elif key_mode == "depth":
        akey = (st[COL["bn"]].to(torch.int32).to(torch.int64) << 21) | morton
    elif key_mode == "pos":
        octant = ((st[COL["dx"]] < 0).to(torch.int64) * 4
                  | (st[COL["dy"]] < 0).to(torch.int64) * 2
                  | (st[COL["dz"]] < 0).to(torch.int64))
        akey = (morton << 3) | octant
    else:
        raise ValueError(f"unknown sort key mode {key_mode!r}")
    # pid < 0 wraps as uint32 in JAX; those slots never take this key.
    rkey = (_REGEN_KEY + st[COL["pid"]].to(torch.int32).to(torch.int64)) & rng.MASK32
    key = torch.where(alive, akey, torch.where(can_regen, rkey, _DONE_KEY))
    return key.to(torch.int32)


def scene_bounds(packed, sizes):
    """(bb_lo, bb_hi), [3] f32 each, of the active spheres (both ends of
    their motion, ± radius) and AA boxes, from the packed table columns;
    [-1, 1]³ for a scene with neither (JAX ``scene_bounds``)."""
    n_sph, _, _, _, _, n_box = sizes
    cols = mk.unpack_buffer(packed, sizes)
    los, his = [], []
    if n_sph:
        sph = cols["sph"]
        for ax in "xyz":
            c = sph["c0" + ax][:n_sph]
            cd = c + sph["dp" + ax][:n_sph]
            r = sph["rad"][:n_sph]
            los.append(torch.min(torch.minimum(c, cd) - r))
            his.append(torch.max(torch.maximum(c, cd) + r))
    if n_box:
        box = cols["box"]
        for ax in "xyz":
            los.append(torch.min(box[ax + "0"][:n_box]))
            his.append(torch.max(box[ax + "1"][:n_box]))
    if not los:
        ones = torch.ones(3, dtype=torch.float32, device=packed.device)
        return -ones, ones
    bb_lo = torch.stack([torch.min(torch.stack(los[i::3])) for i in range(3)])
    bb_hi = torch.stack([torch.max(torch.stack(his[i::3])) for i in range(3)])
    return bb_lo, bb_hi


def init_wavefront_state(n_rays: int, cv, device="cpu") -> torch.Tensor:
    """Fresh slot state [17, n_rays]: slot i holds pixel camv[25] + i (or
    -1 past the last pixel), dead, with s_lane = -1 so that the first step
    regenerates sample 0. ``cv`` is indexable by camv entry."""
    state = torch.zeros((len(STATE_KEYS), n_rays), dtype=torch.float32, device=device)
    slot = torch.arange(n_rays, dtype=torch.float32, device=device) + float(cv[25])
    state[COL["pid"]] = torch.where(slot < float(cv[20]), slot, -1.0)
    state[COL["s_lane"]] = -1.0
    return state


def runnable(state, n_samples) -> torch.Tensor:
    """Slots that can still step: alive, or dead with samples left."""
    st = state
    return (st[COL["al"]] > 0.0) | ((st[COL["s_lane"]] < n_samples - 1.0)
                                    & (st[COL["pid"]] >= 0.0))


def runnable_count(state, n_samples) -> int:
    """Runnable slots, read on the host (one device sync)."""
    return tracing.sync(runnable(state, n_samples).sum(), "runnable", int)


def sort_state(state, n_samples, bb_lo, bb_hi, key_mode="pos", sort_impl="gather"):
    """The state permuted by ascending key: an argsort of the int32 keys
    (stable, or unstable for "gather_unstable": any order of equal keys
    gives the same image, since per-slot math is keyed by pixel id) and one
    gather of the [17, n] state. "multi" stands in for the JAX package's
    one multi-operand ``lax.sort`` of the keys and the 17 columns (stable):
    one stable sort of the keys, whose permutation is applied column by
    column, with no gather of the packed state; its image is the "gather"
    one bit for bit."""
    global SORTS
    if sort_impl not in ("gather", "gather_unstable", "multi"):
        raise ValueError(f"unknown sort_impl {sort_impl!r}")
    keys = sort_keys(state, n_samples, bb_lo, bb_hi, key_mode)
    SORTS += 1
    if sort_impl == "multi":
        perm = torch.sort(keys, stable=True).indices
        out = torch.empty_like(state)
        for i in range(state.shape[0]):
            torch.index_select(state[i], 0, perm, out=out[i])
        return out
    perm = torch.argsort(keys, stable=sort_impl == "gather")
    return state.index_select(1, perm)


# ---------------------------------------------------------------------------
# The K-bounce step: plain version and wrapper
# ---------------------------------------------------------------------------


def step_plain(state, camv, seed, packed, background, *, k_bounces, max_depth,
               sizes, has_checker, has_noise, ntab=None, stats=None):
    """Plain PyTorch version of the kernel: up to ``k_bounces`` steps of
    regeneration plus one bounce over all slots, stopping early once no slot
    can run (a step changes nothing on a slot that cannot run). Advances
    ``state`` in place and returns it. ``stats`` (a dict, optional) gets the
    sweep tests of every live bounce added (``megakernel.make_bounce``)."""
    cv = [float(x) for x in camv.tolist()]
    bounce = mk.make_bounce(packed, background, max_depth=max_depth, sizes=sizes,
                            has_checker=has_checker, has_noise=has_noise, ntab=ntab,
                            stats=stats)
    pid = state[COL["pid"]]
    xx, yy, _ = camera.slot_to_pixel(pid, cv)
    pix = (xx, yy, rng.as_u32(pid))
    in_grid = pid >= 0.0
    s_lane, tm = state[COL["s_lane"]], state[COL["tm"]]
    carry = tuple(state[COL[k]] for k in _CARRY_KEYS)
    for _ in range(k_bounces):
        if not bool(((carry[1] > 0.0) | ((s_lane < cv[22] - 1.0) & in_grid)).any()):
            break
        s_lane, key, tm, carry = mk.regenerate(cv, seed, pix, s_lane, tm, carry, in_grid)
        carry = bounce(key, tm, carry)
    state[COL["s_lane"]] = s_lane
    state[COL["tm"]] = tm
    for k, v in zip(_CARRY_KEYS, carry):
        state[COL[k]] = v
    return state


def wavefront_step(state, camv, seed, packed, background, *, k_bounces, max_depth,
                   sizes, has_checker, has_noise, ntab=None):
    """Advance the slot state [17, n] by up to ``k_bounces`` steps per slot.
    On a CPU tensor this runs the plain version; on a CUDA tensor it
    launches the Hopper kernel (built at first use), which updates ``state``
    in place, or raises. Returns the advanced state."""
    global LAUNCHES
    mk.check_inputs(camv, packed, background, state.shape[-1], sizes)
    mk.check_ntab(ntab, packed)
    if state.dtype != torch.float32 or not state.is_contiguous() or state.dim() != 2 \
            or state.shape[0] != len(STATE_KEYS) or state.device != packed.device:
        raise ValueError("state must be a contiguous [17, n] float32 tensor on the "
                         "tables' device")
    if packed.device.type == "cpu":
        return step_plain(state, camv, seed, packed, background, k_bounces=k_bounces,
                          max_depth=max_depth, sizes=sizes, has_checker=has_checker,
                          has_noise=has_noise, ntab=ntab)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    from raytrace2_tpu_torch.ops.kernels import build

    build.launch_wavefront_step(
        camv, int(seed), background, packed, ntab, state, n_slots=state.shape[1],
        k_bounces=k_bounces, max_depth=max_depth, counts=mk.counts(sizes, mk.n_noise_of(ntab)),
        checker_depth=int(has_checker), has_noise=bool(has_noise))
    LAUNCHES += 1
    return state


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def trace_wavefront_batch(camv, seed, packed, background, *, n_rays, max_depth,
                          sizes, has_checker, has_noise=False, ntab=None,
                          sort_every=SORT_EVERY, k_bounces=K_BOUNCES, key_mode="pos",
                          tail_k=TAIL_K, tail_frac=TAIL_FRAC, tail_compact=False,
                          sort_impl=SORT_IMPL, step=None):
    """Radiance summed over the batch's samples for the linear slots
    0..n_rays-1 (slot i is pixel camv[25] + i), [n_rays, 3] f32 (JAX
    ``trace_wavefront_batch``). ``n_rays`` is a multiple of ``SLOT_TILE``.

    Two-phase schedule: while more than ``tail_frac * n_rays`` slots can
    run, each launch runs ``k_bounces`` steps, with a sort before every
    ``sort_every``-th launch; then ``tail_k`` steps per launch until none
    can run. With ``tail_compact`` the tail runs on the sorted runnable
    prefix only. The host reads the runnable count before every launch.
    Scheduling only: any setting gives the same image.

    ``step`` is the K-bounce step to run, ``wavefront_step`` (the kernel's
    wrapper) by default; passing ``step_plain`` drives the plain version
    with a CUDA tensor, to hold the kernel against it on the card."""
    step = wavefront_step if step is None else step
    if n_rays % SLOT_TILE:
        raise ValueError(f"n_rays={n_rays} must be a multiple of {SLOT_TILE}")
    device = packed.device
    with tracing.span("wavefront.setup"):
        cv = [float(x) for x in tracing.sync(camv, "camv_values", torch.Tensor.tolist)]
        n_samples = cv[22]
        bb_lo, bb_hi = scene_bounds(packed, sizes)
        state = init_wavefront_state(n_rays, cv, device)
    kw = dict(max_depth=max_depth, sizes=sizes, has_checker=has_checker,
              has_noise=has_noise, ntab=ntab)

    def sort(state):
        with tracing.span("wavefront.sort"):
            return sort_state(state, n_samples, bb_lo, bb_hi, key_mode, sort_impl)

    def launches(state, k, go_on):
        i = 0
        while True:
            with tracing.span("wavefront.runnable"):
                n = runnable_count(state, n_samples)
            if not go_on(n):
                return state
            if i % sort_every == 0:
                state = sort(state)
            with tracing.span("wavefront.launch"):
                state = step(state, camv, seed, packed, background, k_bounces=k, **kw)
            i += 1

    if tail_k and tail_frac > 0.0:
        pop_switch = int(tail_frac * n_rays)
        state = launches(state, k_bounces, lambda n: n > pop_switch)
        # After a sort the runnable slots are a prefix (finished and padding
        # slots key 2^30) and at most pop_switch of them remain: the tail
        # can run on that prefix alone, the rest riding along untouched.
        n_tail = -(-max(pop_switch, 1) // SLOT_TILE) * SLOT_TILE
        if tail_compact and n_tail < n_rays:
            state = sort(state)
            head = launches(state[:, :n_tail].contiguous(), tail_k, lambda n: n > 0)
            state = torch.cat([head, state[:, n_tail:]], dim=1)
        else:
            state = launches(state, tail_k, lambda n: n > 0)
    else:
        state = launches(state, k_bounces, lambda n: n > 0)

    # Un-permute by pixel id: each pixel owns exactly one slot, so the map
    # is a bijection (padding slots go to a spare row that is dropped).
    with tracing.span("wavefront.unpermute"):
        pid = state[COL["pid"]]
        tgt = torch.where(pid >= 0.0, pid - cv[25], float(n_rays)).to(torch.int64)
        out = torch.zeros((n_rays + 1, 3), dtype=torch.float32, device=device)
        out.index_copy_(0, tgt, state[COL["rr"]:COL["rb"] + 1].t())
        return out[:n_rays]
