"""Sorted-wavefront renderer for big scenes: the Morton sort, the K-bounce
step's plain PyTorch version, the wrapper that launches the Hopper kernel
(``csrc/wavefront_step.cu``) and the driver that alternates them.

Port of ``raytrace2_tpu/ops/pallas/wavefront_sorted.py``. Every pixel slot
keeps its path state in device memory between launches, as 17 f32 columns
of one ``[17, n_rays]`` tensor (``STATE_KEYS``). Before a launch the driver
sorts the slots by a coherence key (Morton code of the ray origin for live
rays, pixel id for rays about to regenerate, a constant for finished slots)
and gathers the state; the launch then advances every slot by up to K steps
of "regenerate if dead and samples remain, then one bounce". A pass runs
the same four things on either device: ``count_and_keys`` (on the card one
launch of ``csrc/wavefront_keys.cu``, on the CPU ``sort_keys`` and
``runnable``), the sort by those keys, the step, and the host's read of the
count, made only once the pass's sort and step are queued. On the card the
sort, the gather and the step are one replay of a CUDA graph captured at
the shape's first batch (``_PassGraphs``), so a pass costs the host two
launches and a read. Per-slot
arithmetic is v4's (the plain step reuses ``megakernel.regenerate`` and
``megakernel.make_bounce``; the kernel shares ``path_common.cuh`` with
``megakernel_v4.cu``) and each pixel owns one slot, so the image is bitwise
equal to the v4 kernel's whatever the schedule.

The JAX package's TPU layout knobs choose nothing here: ``mega_sublanes``
(tile height) and ``mega_state_packed`` (17 state blocks or one) change no
image, and the port's state is always one ``[17, n]`` tensor advanced by one
thread per slot. Slots are padded to a multiple of ``SLOT_TILE``.

The kernel's sweep finds v4's winners: the cluster skip for spheres and AA
boxes of 32 or more records, each slot's winner that of its own visit order
(from its ray's direction), walked in one order per warp; the sort gives
neighbouring threads rays that take the same order and enter the same
clusters. ``ntab`` switches noise to the
reference's Perlin tables (``noise_impl="table"``).
"""

from __future__ import annotations

import collections
import contextlib

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
# K=2 bounces per launch until the runnable population drops below
# TAIL_FRAC of the slots; then TAIL_K per launch; a sort before each launch.
K_BOUNCES = 2
TAIL_K = 16
TAIL_FRAC = 0.65
# Slot padding grain (the kernel's blocks of 256 threads take a ragged end).
SLOT_TILE = 128
# Keys of the three slot classes (JAX sort_keys).
_REGEN_KEY = 1 << 28
_DONE_KEY = 1 << 30

# Launches of the CUDA step kernel (the plain version does not count), sorts
# of the slot state (on either device), launches of the keys kernel (the
# plain keys and count do not count), and steps (on either device) queued on
# a pass whose own count, read after them, ended its phase. A pass replayed
# from a CUDA graph counts its sort and its launch.
LAUNCHES = 0
SORTS = 0
KEY_LAUNCHES = 0
OVERRUN_LAUNCHES = 0
# Passes replayed from a CUDA graph, and graphs captured (``_PassGraphs``).
GRAPH_REPLAYS = 0
GRAPH_CAPTURES = 0
# The pass graphs of the shapes in use, the most recently used last, at most
# _GRAPH_SHAPES of them: a process may render many scenes and sizes.
_GRAPHS: collections.OrderedDict = collections.OrderedDict()
_GRAPH_SHAPES = 4
# The steps' closest-hit queries (path segments) while a profiler records,
# an int64 [1] tensor per device that each step adds to on the device
# (``tracing.device_counter``), so that counting adds no host sync to a pass.
# The module attribute ``SEGMENTS`` reads their sum, waiting for the devices.
_SEGMENTS: dict = {}


def __getattr__(attr: str) -> int:
    if attr == "SEGMENTS":
        return tracing.device_count(_SEGMENTS)
    raise AttributeError(f"module {__name__!r} has no attribute {attr!r}")


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


def sort_keys(state, n_samples, bb_lo, bb_hi) -> torch.Tensor:
    """int32 coherence key per slot (JAX ``sort_keys``, mode "pos"): small
    runs first, similar keys share a block.

    * live rays: Morton-7 of the origin in the scene box, then the direction
      octant (24 bits);
    * dead, samples left: 2^28 + pixel id, so fresh camera rays group by
      pixel;
    * finished or padding: 2^30.
    Every key is below 2^31. ``bb_lo``/``bb_hi`` are [3] f32 tensors."""
    st = state
    alive = st[COL["al"]] > 0.0
    can_regen = (st[COL["s_lane"]] < n_samples - 1.0) & (st[COL["pid"]] >= 0.0)
    top = 127.0
    extent = torch.clamp(bb_hi - bb_lo, min=1e-20)
    inv = torch.full_like(extent, top) / extent  # a true division, as JAX's
    qs = []
    for axis, name in enumerate(("ox", "oy", "oz")):
        q = torch.clamp((st[COL[name]] - bb_lo[axis]) * inv[axis], 0.0, top)
        qs.append(interleave3(q.to(torch.int64)))
    morton = qs[0] | (qs[1] << 1) | (qs[2] << 2)
    octant = ((st[COL["dx"]] < 0).to(torch.int64) * 4
              | (st[COL["dy"]] < 0).to(torch.int64) * 2
              | (st[COL["dz"]] < 0).to(torch.int64))
    akey = (morton << 3) | octant
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


def init_wavefront_state(n_rays: int, cv, device="cpu", out=None) -> torch.Tensor:
    """Fresh slot state [17, n_rays]: slot i holds pixel camv[25] + i (or
    -1 past the last pixel), dead, with s_lane = -1 so that the first step
    regenerates sample 0. ``cv`` is indexable by camv entry. ``out`` (a
    [17, n_rays] f32 tensor on ``device``, optional) takes the state in
    place of a new tensor."""
    if out is None:
        state = torch.zeros((len(STATE_KEYS), n_rays), dtype=torch.float32, device=device)
    else:
        state = out.zero_()
    slot = torch.arange(n_rays, dtype=torch.float32, device=device) + float(cv[25])
    state[COL["pid"]] = torch.where(slot < float(cv[20]), slot, -1.0)
    state[COL["s_lane"]] = -1.0
    return state


def runnable(state, n_samples) -> torch.Tensor:
    """Slots that can still step: alive, or dead with samples left."""
    st = state
    return (st[COL["al"]] > 0.0) | ((st[COL["s_lane"]] < n_samples - 1.0)
                                    & (st[COL["pid"]] >= 0.0))


def count_and_keys(state, n_samples, bb_lo, bb_hi, keys, count) -> None:
    """``sort_keys(state, n_samples, bb_lo, bb_hi)`` written to ``keys`` [n]
    int32 and the runnable slots of ``state`` [17, n] to ``count`` [1]
    int32, with no host read. On a CPU state this runs the plain versions;
    on a CUDA state it launches the keys kernel (``csrc/wavefront_keys.cu``,
    built at first use) on the current stream. Any other device, or
    tensors of another shape, dtype, layout or device than the state's,
    raise."""
    global KEY_LAUNCHES
    device = state.device
    if state.dtype != torch.float32 or not state.is_contiguous() or state.dim() != 2 \
            or state.shape[0] != len(STATE_KEYS):
        raise ValueError(f"state must be a contiguous [{len(STATE_KEYS)}, n] float32 tensor, "
                         f"got {tuple(state.shape)} {state.dtype}")
    n = state.shape[1]
    for name, t, dtype, size in (("bb_lo", bb_lo, torch.float32, 3),
                                 ("bb_hi", bb_hi, torch.float32, 3),
                                 ("keys", keys, torch.int32, n), ("count", count, torch.int32, 1)):
        if (t.dtype != dtype or t.device != device or not t.is_contiguous()
                or t.numel() != size):
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of {size} on {device}")
    if device.type == "cpu":
        keys.copy_(sort_keys(state, n_samples, bb_lo, bb_hi))
        count.copy_(runnable(state, n_samples).sum())
        return
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    from raytrace2_tpu_torch.ops.kernels import build

    build.launch_wavefront_keys(state, bb_lo, bb_hi, keys, count, regen_below=n_samples - 1.0)
    KEY_LAUNCHES += 1


def sort_state(state, n_samples, bb_lo, bb_hi, keys=None):
    """The state permuted by ascending key: a stable argsort of the int32
    keys and one gather of the [17, n] state. ``keys`` (int32 [n],
    optional) are the state's keys where the caller has them
    (``count_and_keys``), ``sort_keys``' otherwise."""
    global SORTS
    if keys is None:
        keys = sort_keys(state, n_samples, bb_lo, bb_hi)
    SORTS += 1
    perm = torch.argsort(keys, stable=True)
    return state.index_select(1, perm)


# ---------------------------------------------------------------------------
# The K-bounce step: plain version and wrapper
# ---------------------------------------------------------------------------


def step_plain(state, camv, seed, packed, background, *, k_bounces, max_depth,
               sizes, has_checker, has_noise, ntab=None, stats=None, segments=None):
    """Plain PyTorch version of the kernel: up to ``k_bounces`` steps of
    regeneration plus one bounce over all slots, stopping early once no slot
    can run (a step changes nothing on a slot that cannot run). Advances
    ``state`` in place and returns it. ``stats`` (a dict, optional) gets the
    sweep tests of every live bounce added (``megakernel.make_bounce``);
    ``segments`` (an int64 [1] tensor, optional) gets the live bounces
    added, each one closest-hit query, with no host read of its own."""
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
        if segments is not None:
            segments += (carry[1] > 0.0).sum()
        carry = bounce(key, tm, carry)
    state[COL["s_lane"]] = s_lane
    state[COL["tm"]] = tm
    for k, v in zip(_CARRY_KEYS, carry):
        state[COL[k]] = v
    return state


def wavefront_step(state, camv, seed, packed, background, *, k_bounces, max_depth,
                   sizes, has_checker, has_noise, ntab=None, segments=None):
    """Advance the slot state [17, n] by up to ``k_bounces`` steps per slot.
    On a CPU tensor this runs the plain version; on a CUDA tensor it
    launches the Hopper kernel (built at first use), which updates ``state``
    in place, or raises. Returns the advanced state. ``segments`` (an int64
    [1] tensor on the state's device, optional) gets the step's closest-hit
    queries added on the device."""
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
                          has_noise=has_noise, ntab=ntab, segments=segments)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    from raytrace2_tpu_torch.ops.kernels import build

    build.launch_wavefront_step(
        camv, int(seed), background, packed, ntab, state, n_slots=state.shape[1],
        k_bounces=k_bounces, max_depth=max_depth, counts=mk.counts(sizes, mk.n_noise_of(ntab)),
        checker_depth=int(has_checker), has_noise=bool(has_noise), segments=segments)
    LAUNCHES += 1
    return state


# ---------------------------------------------------------------------------
# A pass's sort, gather and step as one CUDA graph
# ---------------------------------------------------------------------------


class _PassGraphs:
    """The CUDA graphs of one shape's passes on the card, and the buffers
    they read and write. The graph of (K, parity p, counter) holds a pass's
    stable argsort of ``keys``, the gather of ``states[p]`` into
    ``states[1 - p]`` and the ``wavefront_step`` launch of K bounces on it,
    adding its closest-hit queries to ``segments`` where the counter is on.
    The four graphs of a K are captured the first time the shape runs at
    that K. ``load`` copies a batch's values (``camv``, the seed, the
    tables, the fresh slot state) into the buffers on the stream, so that a
    new batch, job, frame or set of tables replays without a capture."""

    def __init__(self, device, n_rays, camv, packed, background, ntab, launch_kw):
        self.device, self.n_rays, self.launch_kw = device, n_rays, launch_kw
        self.camv, self.packed, self.background = (torch.empty_like(t, requires_grad=False)
                                                   for t in (camv, packed, background))
        self.ntab = None if ntab is None else torch.empty_like(ntab, requires_grad=False)
        self.seed = torch.empty(1, dtype=torch.int32, device=device)
        self.segments = torch.zeros(1, dtype=torch.int64, device=device)
        self.states = [torch.empty((len(STATE_KEYS), n_rays), dtype=torch.float32,
                                   device=device) for _ in range(2)]
        self.keys = torch.empty(n_rays, dtype=torch.int32, device=device)
        self.count = torch.empty(1, dtype=torch.int32, device=device)
        self.graphs: dict = {}
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)

    def capture(self, k: int) -> None:
        """Capture the graphs of K = ``k`` bounces, once. Their launches load
        nothing: the step's library and the sort and gather have run before
        the first capture, on the capture stream."""
        global GRAPH_CAPTURES
        from raytrace2_tpu_torch.ops.kernels import build

        if (k, 0, False) in self.graphs:
            return
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            if not self.graphs:
                build.load_wavefront_step(self.launch_kw["counts"])
                torch.index_select(self.states[0], 1, torch.argsort(self.keys, stable=True),
                                   out=self.states[1])
            for parity in (0, 1):
                src, dst = self.states[parity], self.states[1 - parity]
                for counted in (False, True):
                    graph = torch.cuda.CUDAGraph()
                    graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
                    try:
                        torch.index_select(src, 1, torch.argsort(self.keys, stable=True),
                                           out=dst)
                        build.launch_wavefront_step(
                            self.camv, self.seed, self.background, self.packed, self.ntab,
                            dst, n_slots=self.n_rays, k_bounces=k,
                            segments=self.segments if counted else None, **self.launch_kw)
                    finally:
                        graph.capture_end()
                    self.graphs[k, parity, counted] = graph
                    GRAPH_CAPTURES += 1
        main.wait_stream(self.stream)

    def load(self, camv, seed, packed, background, ntab, cv) -> torch.Tensor:
        """Copy a batch's values into the buffers on the current stream and
        return the first pass's state, ``states[0]``, made fresh."""
        from raytrace2_tpu_torch.ops.kernels import build

        with torch.no_grad():
            for buf, t in ((self.camv, camv), (self.packed, packed),
                           (self.background, background), (self.ntab, ntab)):
                if buf is not None:
                    buf.copy_(t)
            build.seed_buffer(seed, self.device, out=self.seed)
            self.segments.zero_()
            return init_wavefront_state(self.n_rays, cv, self.device, out=self.states[0])

    def replay(self, state, k: int, counted: bool) -> torch.Tensor:
        """One pass of K = ``k`` bounces on ``state`` (one of ``states``)
        after its keys: replays its graph on the current stream and returns
        the state the step advanced."""
        global SORTS, LAUNCHES, GRAPH_REPLAYS
        parity = 0 if state is self.states[0] else 1
        self.graphs[k, parity, counted].replay()
        SORTS += 1
        LAUNCHES += 1
        GRAPH_REPLAYS += 1
        return self.states[1 - parity]


def _pass_graphs(camv, packed, background, ntab, *, n_rays, max_depth, sizes, has_checker,
                 has_noise) -> _PassGraphs:
    """The pass graphs of this shape: the device, ``n_rays``, the step's
    kernel instance and launch arguments, and the buffers' sizes. Made at
    the shape's first batch; the least recently used shape beyond
    ``_GRAPH_SHAPES`` is dropped with its graphs and buffers."""
    from raytrace2_tpu_torch.ops.kernels import build

    mk.check_inputs(camv, packed, background, n_rays, sizes)
    mk.check_ntab(ntab, packed)
    launch_kw = dict(max_depth=int(max_depth), counts=mk.counts(sizes, mk.n_noise_of(ntab)),
                     checker_depth=int(has_checker), has_noise=bool(has_noise))
    key = (packed.device, n_rays, build.target_key(build.step_target()),
           *launch_kw.values(), packed.numel(), None if ntab is None else tuple(ntab.shape))
    graphs = _GRAPHS.pop(key, None)
    if graphs is None:
        graphs = _PassGraphs(packed.device, n_rays, camv, packed, background, ntab, launch_kw)
    _GRAPHS[key] = graphs
    while len(_GRAPHS) > _GRAPH_SHAPES:
        _GRAPHS.popitem(last=False)
    return graphs


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def trace_wavefront_batch(camv, seed, packed, background, *, n_rays, max_depth,
                          sizes, has_checker, has_noise=False, ntab=None,
                          k_bounces=K_BOUNCES, tail_k=TAIL_K, tail_frac=TAIL_FRAC, step=None):
    """Radiance summed over the batch's samples for the linear slots
    0..n_rays-1 (slot i is pixel camv[25] + i), [n_rays, 3] f32 (JAX
    ``trace_wavefront_batch``). ``n_rays`` is a multiple of ``SLOT_TILE``.

    Two-phase schedule: while more than ``tail_frac * n_rays`` slots can
    run, each launch runs ``k_bounces`` steps; then ``tail_k`` steps per
    launch until none can run (``tail_k`` 0 or ``tail_frac`` 0: one phase
    of ``k_bounces``). Scheduling only: any setting gives the same image.

    Every pass, on either device, runs ``count_and_keys`` on its state,
    sorts the state by those keys, queues its step, and only then reads the
    count on the host, which waits while the step it just queued runs. A
    count decides the next pass, so each phase ends one pass late: its last
    pass steps a state whose count ended the phase (``OVERRUN_LAUNCHES``),
    which changes nothing at a count of 0 and otherwise runs ``k_bounces``
    steps more before the tail. On the card the count is read through a
    side stream that waits for the keys launch alone, and a pass's sort,
    gather and step are one replay of a CUDA graph (``_PassGraphs``,
    captured at a shape's first batch) inside the span ``wavefront.launch``.

    ``step`` is the K-bounce step to run, ``wavefront_step`` (the kernel's
    wrapper) by default; a step passed here runs eagerly, after
    ``sort_state``, on either device: passing ``step_plain`` drives the
    plain version with a CUDA tensor, to hold the kernel against it on the
    card. Where a profiler records as the batch starts, every step also
    gets the device's ``SEGMENTS`` tensor (``segments=``) to add its
    closest-hit queries to (a replayed pass: its graph's own counter, added
    to ``SEGMENTS`` at the batch's end)."""
    if n_rays % SLOT_TILE:
        raise ValueError(f"n_rays={n_rays} must be a multiple of {SLOT_TILE}")
    device = packed.device
    on_card = device.type == "cuda"
    kw = dict(max_depth=max_depth, sizes=sizes, has_checker=has_checker,
              has_noise=has_noise, ntab=ntab)
    graphs = None
    with tracing.span("wavefront.setup"):
        cv = [float(x) for x in tracing.sync(camv, "camv_values", torch.Tensor.tolist)]
        n_samples = cv[22]
        bb_lo, bb_hi = scene_bounds(packed, sizes)
        if on_card and step is None:
            graphs = _pass_graphs(camv, packed, background, **kw, n_rays=n_rays)
            for k in (k_bounces, tail_k) if tail_k and tail_frac > 0.0 else (k_bounces,):
                graphs.capture(k)
            state = graphs.load(camv, seed, packed, background, ntab, cv)
            # The outputs of the last count_and_keys, for the state it read.
            keys, count = graphs.keys, graphs.count
        else:
            state = init_wavefront_state(n_rays, cv, device)
            keys = torch.empty(n_rays, dtype=torch.int32, device=device)
            count = torch.empty(1, dtype=torch.int32, device=device)
        # On the card, the stream that reads the count, and the event it
        # waits on. torch's pool streams are non-blocking: not even the
        # legacy default stream orders the read behind the step.
        if on_card:
            side = torch.cuda.Stream(device)
            counted = torch.cuda.Event()
    segments = tracing.device_counter(_SEGMENTS, device)

    if graphs is not None:
        def sort_and_step(state, k):
            with tracing.span("wavefront.launch"):
                return graphs.replay(state, k, counted=segments is not None)
    else:
        step = wavefront_step if step is None else step
        if segments is not None:
            kw["segments"] = segments

        def sort_and_step(state, k):
            with tracing.span("wavefront.sort"):
                state = sort_state(state, n_samples, bb_lo, bb_hi, keys=keys)
            with tracing.span("wavefront.launch"):
                return step(state, camv, seed, packed, background, k_bounces=k, **kw)

    def launches(state, k, go_on):
        """Passes of ``k`` steps until a count fails ``go_on``: the state
        after the last pass, and the count of the state it started from."""
        global OVERRUN_LAUNCHES
        while True:
            with tracing.span("wavefront.runnable"):
                count_and_keys(state, n_samples, bb_lo, bb_hi, keys, count)
                if on_card:
                    counted.record(torch.cuda.current_stream(device))
                    side.wait_event(counted)
            state = sort_and_step(state, k)
            # The host waits here until the copy is done, so the next
            # count_and_keys, which rewrites ``count``, is queued after it.
            with tracing.span("wavefront.runnable"), (
                    torch.cuda.stream(side) if on_card else contextlib.nullcontext()):
                n = tracing.sync(count, "runnable", int)
            if not go_on(n):
                OVERRUN_LAUNCHES += 1
                return state, n

    if tail_k and tail_frac > 0.0:
        pop_switch = int(tail_frac * n_rays)
        state, n = launches(state, k_bounces, lambda n: n > pop_switch)
        if n:
            state, _ = launches(state, tail_k, lambda n: n > 0)
    else:
        state, _ = launches(state, k_bounces, lambda n: n > 0)

    # Un-permute by pixel id: each pixel owns exactly one slot, so the map
    # is a bijection (padding slots go to a spare row that is dropped).
    with tracing.span("wavefront.unpermute"):
        if graphs is not None and segments is not None:
            segments += graphs.segments
        pid = state[COL["pid"]]
        tgt = torch.where(pid >= 0.0, pid - cv[25], float(n_rays)).to(torch.int64)
        out = torch.zeros((n_rays + 1, 3), dtype=torch.float32, device=device)
        out.index_copy_(0, tgt, state[COL["rr"]:COL["rb"] + 1].t())
        return out[:n_rays]
