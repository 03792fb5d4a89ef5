"""Path integrator (port of ``raytrace2_tpu/ops/integrator.py``).

Two routes, as in the JAX package:

* **The kernel path** (``mega_schedule`` :314-343, ``_render_batch_megakernel``
  :346-465): scenes with at most 256 sweep records render through the v4
  kernel on the linear slot layout with instant regeneration; larger ones
  (books 1 and 2) through the sorted wavefront (``ops/kernels/wavefront.py``),
  whose K-bounce kernel advances the slot state between Morton sorts. v4
  forced on a scene of more than 512 records takes JAX's block-tiled lane
  layout with wave regeneration at half occupancy. With
  ``noise_impl="table"`` both kernels evaluate the reference's Perlin
  tables (``megakernel.pack_noise_tables``) instead of hash noise.
* **The non-kernel path** (``_make_step``, ``trace_rays``, ``render_sample``,
  :37-311): one progressive sample at a time, a bounce loop over ray state
  with phased compaction, the closest hit from ``ops/intersect.py`` (dense,
  or B5 with ``use_pallas``), shading from ``ops/materials.py`` and threefry
  or murmur streams. ``trace_rays`` with a ``mega_seed`` and
  ``use_megakernel`` hands the rays to the v3 kernel B4
  (``ops/kernels/megakernel_v3.py``) instead; only ``render_sample`` reaches
  it, as in the JAX package.

``render_progressive`` takes the kernel path when ``use_megakernel`` is set
and the scene has kernel sizes (no ellipsoids), and the non-kernel path
otherwise.

Feature knobs read on the kernel path, named as in the JAX package:
``mega_wavefront`` forces the route either way; ``mega_k_bounces``,
``mega_tail_k`` and ``mega_tail_frac`` set the wavefront's schedule,
``mega_wave_frac`` and ``mega_linear`` v4's (none changes the image).
``mega_sublanes`` and ``mega_state_packed`` are TPU tile and layout knobs
that choose nothing here: the port's tiles are its CUDA blocks. On the
non-kernel path:
``rng_impl`` ("murmur" for the kernels' streams), ``compaction_phases`` (3)
and ``compaction_ratio`` (8); on B4's: ``mega_phases`` (2) and
``mega_ratio`` (16).
"""

from __future__ import annotations

import torch

from raytrace2_tpu_torch import defs, tracing
from raytrace2_tpu_torch.ops import camera, intersect, materials, rng
from raytrace2_tpu_torch.ops.kernels import megakernel as mk
from raytrace2_tpu_torch.ops.kernels import megakernel_grad as mkg
from raytrace2_tpu_torch.ops.kernels import megakernel_v3 as mk3
from raytrace2_tpu_torch.ops.kernels import wavefront as wf

# JAX mega_schedule's threshold: above it, scenes go to the sorted
# wavefront kernel (wavefront_sorted.py::_bounce_step_kernel).
WAVEFRONT_MIN_RECORDS = 256
# Above this many records v4 takes the block-tiled layout and wave
# regeneration (JAX mega_schedule's ``big``).
BLOCK_MIN_RECORDS = 512


def n_records(features) -> int:
    """Sweep records of a scene: spheres + plain quads + media + AA boxes."""
    ms = features.get("mega_sizes") or (0,) * 6
    return ms[0] + ms[1] + ms[4] + ms[5]


def mega_schedule(features) -> tuple:
    """(sublanes, wave_frac, linear, wavefront) as the JAX package picks them
    (:314-343): the sorted wavefront (24×128 tiles, linear slots) above 256
    records or when ``mega_wavefront`` is set; else v4, above 512 records
    with 8×128 tiles, wave regeneration at ``wave_frac`` 0.5 and the
    block-tiled layout, below with 32×128 tiles, instant regeneration and
    linear slots; ``mega_sublanes``, ``mega_wave_frac`` and ``mega_linear``
    override them. ``sublanes`` chooses nothing in the port, whose tiles
    are its CUDA blocks."""
    big = n_records(features) > BLOCK_MIN_RECORDS
    if bool(features.get("mega_wavefront", n_records(features) > WAVEFRONT_MIN_RECORDS)):
        return int(features.get("mega_sublanes", 24)), 1.0, True, True
    return (int(features.get("mega_sublanes", 8 if big else 32)),
            float(features.get("mega_wave_frac", 0.5 if big else 1.0)),
            bool(features.get("mega_linear", not big)), False)


def _check_kernel_features(features) -> None:
    if features.get("mega_sizes") is None:
        raise NotImplementedError(
            "scene has no kernel sizes (ellipsoids): the kernel path cannot render it; "
            "use the non-kernel path (use_megakernel unset, backend 'xla' or 'auto')")


def _material_types(scene, features) -> frozenset:
    """The material type ids that pick the kernels' instances
    (``megakernel.scene_features``): the Renderer's, read from the host
    scene, or else read from the device once per scene
    (``megakernel.scene_material_types``), so no launch reads the device."""
    if features.get("mat_types") is not None:
        return features["mat_types"]
    return mk.scene_material_types(scene.materials.mtype)


def noise_tables(scene, features):
    """The ``ntab`` operand of table noise (JAX :389-397): the noise
    textures' Perlin tables when the scene has noise and ``noise_impl`` is
    "table", else None (hash noise). The tables are constants of the
    estimator: they carry no gradient."""
    if features.get("has_noise", False) and features.get("noise_impl", "hash") == "table":
        with tracing.span("integrator.pack"):
            return mk.pack_noise_tables(scene, tuple(features["noise_rows"])).detach()
    return None


def slot_tile(features) -> int:
    """Lanes of one tile of the kernel path's slot layout for ``features``:
    a shard's run of slots is a whole number of them (JAX
    ``sharding.py:137-142``). The linear v4 layout's tile is one CUDA block
    (``mk.TILE``), the block-tiled one's a 16x16 pixel block
    (``mk.BLOCK_TILE``), the wavefront's its slot padding grain
    (``wf.SLOT_TILE``)."""
    _, _, linear, wavefront = mega_schedule(features)
    if wavefront:
        return wf.SLOT_TILE
    return mk.TILE if linear else mk.BLOCK_TILE


def slot_layout(features, width: int, height: int):
    """(n_slots, slot_of_pixel [H, W] int64) of the kernel path's slot
    layout: the block-tiled one where v4 takes it, else linear."""
    _, _, linear, wavefront = mega_schedule(features)
    return mk.pixel_slots(width, height, block=not (linear or wavefront))


def _camv_to(camv: torch.Tensor, device: torch.device) -> torch.Tensor:
    """The CPU ``camv`` on the render device. One that requires grad (a
    camera leaf does) goes through ``tracing.sync``, a counted copy in
    autograd's graph; otherwise the CPU keeps it as it is, and the card gets
    it by a non-blocking copy from pinned memory, which the host does not
    wait on (the caching host allocator keeps the pinned block until the
    copy has run)."""
    if camv.requires_grad:
        return tracing.sync(camv, "camv", device=device)
    if device.type == "cpu":
        return camv
    return camv.pin_memory().to(device, non_blocking=True)


def _render_batch_megakernel(scene, packed, features, width, height, sample0,
                             n_samples, seed, max_depth, sqrt_spp, differentiable=False,
                             pix0=0, n_local=None):
    """Radiance SUM over samples [sample0, sample0 + n_samples), [H, W, 3],
    from one launch of the v4 kernel or one wavefront pass (a launch per K
    bounces). ``scene`` and ``packed`` live on the render device.

    ``pix0``/``n_local`` (JAX :346-378,460-461): a shard runs the
    ``n_local`` slots from ``pix0`` of the slot layout (``slot_layout``;
    both whole ``slot_tile``s) and gets that flat slot tile back,
    [n_local, 3], which the caller de-tiles once it holds every shard's.
    The streams are keyed by global pixel id, so any split renders each
    pixel as one device does.

    ``differentiable=True`` goes through ``megakernel_grad.DiffRender``
    (JAX :407-436): the same forward, and a backward that launches the
    replay kernel; ``camv`` and ``packed`` then carry the scene leaves'
    graph. The replay walks the linear layout, so a differentiable shard
    must not be on the block-tiled one."""
    _, wave_frac, linear, wavefront = mega_schedule(features)
    block = not (linear or wavefront)
    if differentiable and block and n_local is not None:
        raise ValueError("a differentiable shard needs the linear slot layout "
                         "(features mega_linear=True)")
    n_pix = width * height
    with tracing.span("integrator.camv"):
        camv = _camv_to(
            camera.make_camv(scene.camera, width, height, sample0, n_samples, sqrt_spp, seed,
                             **({"block": mk.BLOCK} if block else {}), slot0=pix0),
            packed.device)
    ntab = noise_tables(scene, features)
    kw = dict(max_depth=max_depth, sizes=tuple(features["mega_sizes"]),
              has_checker=int(features.get("has_checker", 1)),
              has_noise=bool(features.get("has_noise", False)), ntab=ntab)
    background = scene.background.to(torch.float32).contiguous()
    mat_types = _material_types(scene, features)
    n_slots = n_pix
    if block:
        n_slots, slot_of_pixel = mk.pixel_slots(width, height, block=True)
        slot_of_pixel = tracing.sync(slot_of_pixel.reshape(-1), "slots", device=packed.device)
    if n_local is not None:
        n_slots = n_local
    n_out = n_pix if n_local is None else n_local

    def forward(camv, seed, packed, background):
        if block:
            out = mk.trace_megakernel_batch(camv, seed, packed, background, n_pix=n_slots,
                                            block=True, wave_frac=wave_frac,
                                            mat_types=mat_types, **kw)
            # De-tile: each pixel's slot (JAX :463-465); a shard keeps its tile.
            return out if n_local is not None else out[slot_of_pixel]
        if not wavefront:
            return mk.trace_megakernel_batch(camv, seed, packed, background, n_pix=n_slots,
                                             wave_frac=wave_frac, mat_types=mat_types, **kw)
        return wf.trace_wavefront_batch(
            camv, seed, packed, background,
            n_rays=-(-n_slots // wf.SLOT_TILE) * wf.SLOT_TILE,
            k_bounces=int(features.get("mega_k_bounces", wf.K_BOUNCES)),
            tail_k=int(features.get("mega_tail_k", wf.TAIL_K)),
            tail_frac=float(features.get("mega_tail_frac", wf.TAIL_FRAC)),
            **kw)[:n_out]

    with tracing.span("integrator.launch"):
        if differentiable:
            radiance = mkg.DiffRender.apply(
                camv, packed, background, int(seed), forward,
                dict(n_pix=n_out, mat_types=mat_types, **kw))
        else:
            radiance = forward(camv, int(seed), packed, background)
    if n_local is not None:
        return radiance  # the sharded caller keeps the flat slot tile
    return radiance.reshape(height, width, 3)


def pack_scene(scene, features) -> torch.Tensor:
    """The packed f32 table buffer of a device scene (in the graph of its
    leaves when they require grad)."""
    _check_kernel_features(features)
    sizes = tuple(features["mega_sizes"])
    return mk.pack_buffer(scene, sizes)


def _int32(x: int) -> int:
    """``x`` wrapped to int32, as JAX's int32 arithmetic wraps."""
    return (int(x) + 2**31) % 2**32 - 2**31


def mega_seed_of(seed: int, sample_idx: int) -> int:
    """The kernels' per-(seed, sample) stream seed, seed·1000003 + sample in
    int32 arithmetic (JAX :245)."""
    return _int32(_int32(seed) * 1000003 + int(sample_idx))


def _make_step(scene, features, background, mega_seed=None):
    """The per-bounce transition of a (possibly compacted) ray set (JAX
    :37-108). The state carries each ray's keys and time, so compaction
    gathers them with the rays.

    ``features["rng_impl"] == "murmur"`` (with ``mega_seed``): the draws are
    the v4 kernel's counter-hash streams and ``st["keys"]`` holds pixel ids;
    the counter stride is 3 + the active media, and padded media rows get a
    dead 0.5 draw. Otherwise ``st["keys"]`` are threefry keys [N, 2]."""
    num_media = scene.media.btype.shape[0]
    has_media = features.get("has_media", True)
    use_murmur = features.get("rng_impl") == "murmur" and mega_seed is not None
    n_med_active = (features.get("mega_sizes") or (0,) * 6)[4]
    tables = intersect.route_tables(scene, features)

    def step(st):
        keys = st["keys"]
        if use_murmur:
            draws_pb = 3 + (n_med_active if has_media else 0)
            bctr = st["bounce"] * draws_pb
            ctrs = [bctr, bctr + 1, bctr + 2] + (
                [bctr + 3 + m for m in range(n_med_active)] if has_media else [])
            u = rng.murmur_uniforms_at(mega_seed, keys, ctrs).to(keys.device)
            if has_media and num_media > n_med_active:
                u = torch.cat([u, torch.full((u.shape[0], num_media - n_med_active), 0.5,
                                             device=u.device)], -1)
        else:
            n_draws = 3 + (num_media if has_media else 0)
            u = rng.bounce_uniforms(keys, st["bounce"], n_draws)
        u_media = u[:, 3:] if has_media else None
        hit = intersect.closest_hit(scene, st["o"], st["d"], st["time"], u_media,
                                    features=features, tables=tables)
        u_vec = rng.unit_vec3_from_uniforms(u[:, 0], u[:, 1])
        sc = materials.shade(scene, features, hit, st["d"], u_vec, u[:, 2])

        alive = st["alive"]
        miss = alive & ~hit.valid
        hit_live = alive & hit.valid
        scatter_live = hit_live & sc.did_scatter
        tp = st["throughput"]
        radiance = st["radiance"] + torch.where(miss[:, None], tp * background[None, :], 0.0)
        radiance = radiance + torch.where(hit_live[:, None], tp * sc.emitted, 0.0)
        return dict(
            st,
            o=torch.where(scatter_live[:, None], hit.point, st["o"]),
            d=torch.where(scatter_live[:, None], sc.direction, st["d"]),
            throughput=torch.where(scatter_live[:, None], tp * sc.attenuation, tp),
            radiance=radiance,
            alive=scatter_live,
            bounce=st["bounce"] + 1,
        )

    return step


def _trace_megakernel(scene, features, o, d, time, seed_lane, max_depth):
    """The rays through B4 (JAX :111-134): padded to the kernel's tile with
    alive ``d = 1`` rays, whose radiance is cut off. B4 evaluates hash noise
    whatever ``noise_impl`` says, as the JAX v3 kernel does."""
    n = o.shape[0]
    pad = -n % mk3.TILE_R
    if pad:
        o = torch.nn.functional.pad(o, (0, 0, 0, pad))
        d = torch.nn.functional.pad(d, (0, 0, 0, pad), value=1.0)
        time = torch.nn.functional.pad(time, (0, pad))
    sizes = tuple(features["mega_sizes"])
    radiance = mk3.trace_megakernel(
        o, d, time, seed_lane, mk.pack_buffer(scene, sizes),
        scene.background.to(torch.float32), max_depth=max_depth, sizes=sizes,
        has_checker=int(features.get("has_checker", 1)),
        has_noise=bool(features.get("has_noise", False)),
        phases=int(features.get("mega_phases", 2)),
        compaction_ratio=int(features.get("mega_ratio", 16)),
        mat_types=_material_types(scene, features))
    return radiance[:n]


def trace_rays(scene, features, o, d, time, keys, max_depth: int,
               differentiable: bool = False, mega_seed=None):
    """Trace N rays to completion; returns radiance [N, 3] (JAX :137-228).

    Phased compaction: each phase bounces the whole buffer while more rays
    are alive than the next phase's capacity (``width // ratio``), then
    gathers the survivors (stable, with their keys: the streams do not
    change) into that smaller buffer; the last phase runs dry. The alive
    count is read on the host once per bounce.

    ``differentiable=True`` is JAX's ``lax.scan`` (:210-214): exactly
    ``max_depth`` steps over every ray, with no compaction and no early
    exit, differentiable under ``torch.autograd`` (the step writes no state
    in place). It never takes B4, and it drops ``use_bvh_spheres``
    (:188-193): hit selection is detached either way, so the estimator is
    the dense sweep's."""
    if differentiable:
        features = {k: v for k, v in features.items() if k != "use_bvh_spheres"}
    elif (mega_seed is not None and features.get("use_megakernel", False)
            and features.get("mega_sizes") is not None):
        return _trace_megakernel(scene, features, o, d, time, mega_seed, max_depth)

    n = o.shape[0]
    background = scene.background.to(o.dtype)
    step = _make_step(scene, features, background, mega_seed=mega_seed)
    state = dict(o=o, d=d, time=time, keys=keys,
                 throughput=torch.ones((n, 3), dtype=o.dtype, device=o.device),
                 radiance=torch.zeros((n, 3), dtype=o.dtype, device=o.device),
                 alive=torch.ones((n,), dtype=torch.bool, device=o.device), bounce=0)
    if differentiable:
        for _ in range(max_depth):
            state = step(state)
        return state["radiance"]
    ratio = int(features.get("compaction_ratio", 8))
    num_phases = int(features.get("compaction_phases", 3))
    radiance_full = torch.zeros((n, 3), dtype=o.dtype, device=o.device)
    idx_map = torch.arange(n, device=o.device)
    width = n
    for phase in range(num_phases):
        last = phase == num_phases - 1 or width // ratio < 256
        cap_next = 0 if last else width // ratio
        while state["bounce"] < max_depth \
                and tracing.sync(state["alive"].sum(), "alive", int) > cap_next:
            state = step(state)
        radiance_full.index_add_(0, idx_map, state["radiance"])
        if last:
            break
        # Stable partition of the live rays to the front; dead rays that ride
        # along add nothing.
        order = torch.argsort((~state["alive"]).to(torch.int8), stable=True)[:cap_next]
        idx_map = idx_map[order]
        state = dict(o=state["o"][order], d=state["d"][order], time=state["time"][order],
                     keys=state["keys"][order],
                     throughput=state["throughput"][order],
                     radiance=torch.zeros((cap_next, 3), dtype=o.dtype, device=o.device),
                     alive=state["alive"][order], bounce=state["bounce"])
        width = cap_next
    return radiance_full


def render_sample(scene, features, width: int, height: int, sample_idx: int, seed: int,
                  max_depth: int, sqrt_spp: int, chunk_size: int | None = None,
                  differentiable: bool = False):
    """One progressive stratified sample of every pixel → [H, W, 3] radiance
    (JAX :231-311), on the scene's device.

    Streams: with ``use_megakernel`` (and kernel sizes) the camera draws come
    from the murmur family and the rays go to B4, unchunked; with
    ``rng_impl="murmur"`` the XLA loop draws the kernels' streams, keyed by
    pixel id; otherwise threefry keys of (seed, sample, pixel). Chunks bound
    the [chunk, records] intermediates; the last one is padded with the
    first rays again (``keys[:pad]``) and cut off."""
    n = width * height
    pixel_ids = torch.arange(n, dtype=torch.int32, device=scene.background.device)
    mega_seed = mega_seed_of(seed, sample_idx)
    mega_active = (not differentiable and features.get("use_megakernel", False)
                   and features.get("mega_sizes") is not None)
    if mega_active or features.get("rng_impl") == "murmur":
        cam_u = rng.murmur_uniforms(mega_seed, pixel_ids,
                                    tuple(rng.CAMERA_CTR_BASE + k for k in range(5)))
        keys = None if mega_active else pixel_ids
        o, d, time = camera.generate_rays(scene.camera, width, height, sample_idx, sqrt_spp,
                                          None, uniforms=cam_u)
        if mega_active:
            chunk_size = None  # B4 holds no [rays, records] intermediates
    else:
        keys = rng.pixel_sample_key(seed, pixel_ids, sample_idx)
        o, d, time = camera.generate_rays(scene.camera, width, height, sample_idx, sqrt_spp,
                                          keys)

    def tracer(o, d, time, keys):
        return trace_rays(scene, features, o, d, time, keys, max_depth,
                          differentiable=differentiable, mega_seed=mega_seed)

    if chunk_size is None or chunk_size >= n:
        radiance = tracer(o, d, time, keys)
    else:
        pad = -n % chunk_size
        if pad:
            o = torch.nn.functional.pad(o, (0, 0, 0, pad))
            d = torch.nn.functional.pad(d, (0, 0, 0, pad), value=1.0)
            time = torch.nn.functional.pad(time, (0, pad))
            keys = torch.cat([keys, keys[:pad]])
        radiance = torch.cat([
            tracer(o[i:i + chunk_size], d[i:i + chunk_size], time[i:i + chunk_size],
                   keys[i:i + chunk_size])
            for i in range(0, o.shape[0], chunk_size)])[:n]
    return radiance.reshape(height, width, 3)


def render_progressive(scene, features, width: int, height: int, sample0: int,
                       n_samples: int, seed: int, max_depth: int, sqrt_spp: int,
                       packed=None, differentiable: bool = False, chunk_size: int | None = None):
    """Accumulate ``n_samples`` consecutive progressive samples; returns the
    radiance sum [H, W, 3] on the scene's device.

    With ``use_megakernel`` (the Renderer's kernel route; absent counts as
    set) and kernel sizes: one kernel launch or wavefront pass. ``packed``
    (``pack_scene``) may be passed to reuse the table buffer;
    ``differentiable=True`` packs the scene inside the graph and returns a
    sum that autograd differentiates through the replay kernel. Otherwise
    the non-kernel path: a loop of ``render_sample``, which with
    ``differentiable=True`` traces each sample with the differentiable scan
    (``trace_rays``)."""
    if features.get("use_megakernel", True) and features.get("mega_sizes") is not None:
        _check_kernel_features(features)
        if packed is None or differentiable:
            with tracing.span("integrator.pack"):
                packed = pack_scene(scene, features)
        return _render_batch_megakernel(scene, packed, features, width, height,
                                        sample0, n_samples, seed, max_depth, sqrt_spp,
                                        differentiable=differentiable)
    acc = torch.zeros((height, width, 3), dtype=defs.TORCH_REAL,
                      device=scene.background.device)
    for i in range(int(n_samples)):
        acc += render_sample(scene, features, width, height, sample0 + i, seed, max_depth,
                             sqrt_spp, chunk_size, differentiable)
    return acc
