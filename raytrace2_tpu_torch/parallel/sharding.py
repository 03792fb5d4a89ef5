"""Multi-device rendering: pixel-dp x sample-sp over ``torch.distributed``
ranks (port of ``raytrace2_tpu/parallel/sharding.py``).

The JAX package lays its devices on an ('sp', 'dp') ``Mesh`` and writes each
entry point as a ``shard_map``. Here each rank is one process driving one device,
and a ``Mesh`` names this rank's place on the same grid (rank = i·dp + j for
sp index i, dp index j) with a process group for its sp column and one for
its dp row:

* ``dp`` shards pixels (or, on the kernel path, whole tiles of the slot
  layout): each rank traces its own;
* ``sp`` shards samples: the ranks of an sp column trace different sample
  blocks of the same pixels, summed by ``all_reduce``.

The keys are pure functions of (seed, pixel, sample), never of the rank, so
a dp split renders each pixel bitwise as one device does; an sp split
differs from it only in the order of the float sum. The image comes back
whole on every rank: each rank writes its tile into a zeroed image and the
world ``all_reduce``s it, one collective that sums the sp blocks and
gathers the dp tiles together, and that NCCL and gloo both run on CUDA
tensors.

``torch.distributed``'s collectives are outside autograd, so the sharded
gradients take each rank's local gradient and ``all_reduce`` every float
cotangent over the world, as JAX ``psum``s them. Without a process group
(a single process) a mesh is 1 x 1 and every collective is the identity.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from raytrace2_tpu_torch import grad as grad_mod
from raytrace2_tpu_torch import render as render_mod
from raytrace2_tpu_torch.ops import camera, integrator, rng
from raytrace2_tpu_torch.ops.kernels import intersect_kernel as pk
from raytrace2_tpu_torch.parallel import distributed
from raytrace2_tpu_torch.scene import schema

# Pixel and slot ids ride f32 in the kernels (megakernel.check_inputs).
MAX_SLOTS = 1 << 24


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the (sp, dp) grid and its process groups (None
    without a process group)."""

    sp: int
    dp: int
    rank: int
    device: torch.device
    sp_group: object = None  # the ranks of this rank's sp column (its dp index)
    dp_group: object = None  # the ranks of this rank's dp row (its sp index)

    @property
    def shape(self) -> dict:
        return {"sp": self.sp, "dp": self.dp}

    @property
    def sp_index(self) -> int:
        return self.rank // self.dp

    @property
    def dp_index(self) -> int:
        return self.rank % self.dp


def make_mesh(sp: int = 1, dp: int | None = None, device="cuda") -> Mesh:
    """An ('sp', 'dp') mesh over the world's ranks (JAX ``make_mesh``,
    :37-45); by default every rank on the dp axis. ``device`` is this rank's
    (``distributed.local_device``: ``cuda`` becomes its card). Every rank
    creates every group, in the same order."""
    total = distributed.global_device_count()
    if dp is None:
        dp = total // sp
    if sp * dp != total:
        raise ValueError(f"sp*dp = {sp * dp} != device count {total}")
    device = render_mod.resolve_device(distributed.local_device(device))
    rank = distributed.process_index()
    if not dist.is_initialized():
        return Mesh(sp, dp, rank, device)
    sp_groups = [dist.new_group([i * dp + j for i in range(sp)]) for j in range(dp)]
    dp_groups = [dist.new_group([i * dp + j for j in range(dp)]) for i in range(sp)]
    return Mesh(sp, dp, rank, device, sp_groups[rank % dp], dp_groups[rank // dp])


def _all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` in place over ``group`` (the world when None)."""
    if dist.is_initialized():
        dist.all_reduce(t, group=group)
    return t


def _check_slots(n: int) -> None:
    if not 0 <= n < MAX_SLOTS:
        raise ValueError(f"{n} pixel slots: ids must stay below 2^24 (they ride f32)")


def _pixel_range(n: int, parts: int, index: int) -> tuple[int, int]:
    """Shard ``index`` of ``parts`` equal runs of ceil(n / parts) pixels (the
    last one short; JAX pads it with wrapped pixels it then drops)."""
    size = -(-n // parts)
    return min(index * size, n), min((index + 1) * size, n)


def _trace_tile(scene, features, width, height, pixel_ids, sample_idx, seed, max_depth,
                sqrt_spp, differentiable=False):
    """One rank's pixels at one sample index (JAX ``_trace_tile``): threefry
    keys of (seed, pixel, sample), the non-kernel path's tracer."""
    keys = rng.pixel_sample_key(seed, pixel_ids, sample_idx)
    o, d, time = camera.generate_rays(scene.camera, width, height, sample_idx, sqrt_spp,
                                      keys, pixel_ids)
    return integrator.trace_rays(scene, features, o, d, time, keys, max_depth,
                                 differentiable=differentiable)


def _gather_image(tile: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """The [n, 3] image of every rank's ``tile`` at ``start``: written into
    zeros, summed over the world."""
    out = torch.zeros((n, 3), dtype=torch.float32, device=tile.device)
    out[start:start + tile.shape[0]] = tile
    return _all_reduce(out)


def render_samples_sharded(scene, features, sample0, seed, *, width, height, max_depth,
                           sqrt_spp, samples_per_device, mesh):
    """Radiance sum [H, W, 3] over ``samples_per_device * sp`` progressive
    samples on the non-kernel path: rank (i, j) traces samples ``sample0 +
    i·spd + [0, spd)`` of dp shard j's pixels. ``use_pallas`` in the
    features runs B5 for the closest hit, over the live extents in
    ``features["pallas_extents"]`` or, when absent, read here once from
    the scene."""
    features = dict(features)
    if features.get("use_pallas") and features.get("pallas_extents") is None:
        features["pallas_extents"] = pk.live_extents(scene)
    n = width * height
    _check_slots(n)
    start, stop = _pixel_range(n, mesh.dp, mesh.dp_index)
    pixel_ids = torch.arange(start, stop, dtype=torch.int32, device=mesh.device)
    local = torch.zeros((stop - start, 3), dtype=torch.float32, device=mesh.device)
    for s in range(samples_per_device):
        sample_idx = int(sample0) + mesh.sp_index * samples_per_device + s
        local = local + _trace_tile(scene, features, width, height, pixel_ids, sample_idx,
                                    seed, max_depth, sqrt_spp)
    return _gather_image(local, start, n).reshape(height, width, 3)


def _slot_chunk(features, width, height, dp) -> tuple[int, torch.Tensor]:
    """(chunk, slot_of_pixel): each dp rank's run of the slot layout, whole
    tiles of it (JAX :137-142), and the layout's de-tile map."""
    n_slots, slot_of_pixel = integrator.slot_layout(features, width, height)
    tile = integrator.slot_tile(features)
    chunk = -(-n_slots // (dp * tile)) * tile
    _check_slots(chunk * dp)
    return chunk, slot_of_pixel


def render_samples_sharded_mega(scene, features, sample0, seed, *, width, height, max_depth,
                                sqrt_spp, samples_per_device, mesh):
    """The kernel path sharded (JAX ``render_samples_sharded_mega``): each dp
    rank launches v4, or runs the wavefront, on its run of whole slot tiles
    from its ``pix0`` (``camv[25]``), the sp ranks on disjoint sample
    blocks; the flat slot image is summed over the world and de-tiled once.
    Returns the radiance sum [H, W, 3] over ``sp · samples_per_device``
    samples."""
    features = dict(features)
    chunk, slot_of_pixel = _slot_chunk(features, width, height, mesh.dp)
    pix0 = mesh.dp_index * chunk
    tile = integrator._render_batch_megakernel(
        scene, integrator.pack_scene(scene, features), features, width, height,
        int(sample0) + mesh.sp_index * samples_per_device, samples_per_device, seed,
        max_depth, sqrt_spp, pix0=pix0, n_local=chunk)
    flat = _gather_image(tile, pix0, chunk * mesh.dp)
    return flat[slot_of_pixel.reshape(-1).to(flat.device)].reshape(height, width, 3)


def _summed_grads(params, grads):
    """The gradient FlatScene (``grad.grad_tree``) with every float
    cotangent summed over the world; the integer leaves stay None."""
    return schema.map_leaves(grad_mod.grad_tree(params, grads),
                             lambda x: _all_reduce(x.contiguous()))


def render_grad_sharded(scene, features, target, seed, *, width, height, max_depth,
                        sqrt_spp, n_samples, mesh):
    """L2 loss against ``target`` [H, W, 3], sum of squares over the image,
    and d loss / d scene on the non-kernel path (JAX
    ``render_grad_sharded``): the pixels are sharded over every rank (both
    axes), each rank differentiates its part of the loss through the scan,
    and the loss and the float cotangents are summed over the world. B5 is
    dropped: it has no VJP. Returns (loss, gradient FlatScene) on every
    rank, the integer leaves None, as ``grad.value_and_grad_scene`` gives
    them."""
    features = dict(features)
    features.pop("use_pallas", None)
    n = width * height
    _check_slots(n)
    start, stop = _pixel_range(n, mesh.sp * mesh.dp, mesh.rank)
    pixel_ids = torch.arange(start, stop, dtype=torch.int32, device=mesh.device)
    tgt = torch.as_tensor(target, dtype=torch.float32, device=mesh.device).reshape(n, 3)
    params, leaves = grad_mod.scene_params(scene)
    with torch.enable_grad():
        acc = torch.zeros((stop - start, 3), dtype=torch.float32, device=mesh.device)
        for s in range(n_samples):
            acc = acc + _trace_tile(params, features, width, height, pixel_ids, s, seed,
                                    max_depth, sqrt_spp, differentiable=True)
        loss = torch.sum((acc / n_samples - tgt[start:stop]) ** 2)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return _all_reduce(loss.detach().reshape(1)).reshape(()), _summed_grads(params, grads)


def render_grad_sharded_mega(scene, features, target, seed, *, width, height, max_depth,
                             sqrt_spp, n_samples, mesh):
    """The same loss and gradient at kernel speed (JAX
    ``render_grad_sharded_mega``): each rank's forward launches v4 or the
    wavefront on its dp run of slots and the backward B3 there. ``sp`` ranks
    render disjoint blocks of the ``n_samples`` samples (sp must divide it).
    Each rank sums the sp blocks into its tile of the image, forms its part
    of the loss and applies the image cotangent ``2·w·(img − t)/n_samples``
    to its local render by hand (JAX :294-304); the loss is summed over the
    dp row and the cotangents over the world. The replay walks the linear
    slot layout, so v4 takes that layout here."""
    features = dict(features, mega_linear=True)
    if n_samples % mesh.sp:
        raise ValueError(f"n_samples={n_samples} (total) must divide by the mesh's "
                         f"sp={mesh.sp} (each sp rank renders a disjoint block)")
    per_rank = n_samples // mesh.sp
    n = width * height
    chunk, _ = _slot_chunk(features, width, height, mesh.dp)
    pix0 = mesh.dp_index * chunk
    tgt = torch.zeros((chunk * mesh.dp, 3), dtype=torch.float32, device=mesh.device)
    tgt[:n] = torch.as_tensor(target, dtype=torch.float32, device=mesh.device).reshape(n, 3)
    wgt = torch.zeros((chunk * mesh.dp, 1), dtype=torch.float32, device=mesh.device)
    wgt[:n] = 1.0
    tgt, wgt = tgt[pix0:pix0 + chunk], wgt[pix0:pix0 + chunk]
    params, leaves = grad_mod.scene_params(scene)
    with torch.enable_grad():
        packed = integrator.pack_scene(params, features)
        local = integrator._render_batch_megakernel(
            params, packed, features, width, height, mesh.sp_index * per_rank, per_rank, seed,
            max_depth, sqrt_spp, differentiable=True, pix0=pix0, n_local=chunk)
        img = _all_reduce(local.detach().clone(), mesh.sp_group) / n_samples
        resid = wgt * (img - tgt)
        loss = _all_reduce(torch.sum(resid * (img - tgt)).reshape(1), mesh.dp_group)
        grads = torch.autograd.grad(local, leaves, grad_outputs=2.0 * resid / n_samples,
                                    allow_unused=True)
    return loss.reshape(()), _summed_grads(params, grads)


def grad_sharded_auto(scene, features, target, seed, *, width, height, max_depth, sqrt_spp,
                      n_samples, mesh):
    """The sharded value-and-grad with the route ``grad.render_image``
    takes: the kernels (forward and B3) for scenes within the gradient
    kernel's gates, else the scan (JAX ``grad_sharded_auto``, :316-342)."""
    kw = dict(width=width, height=height, max_depth=max_depth, sqrt_spp=sqrt_spp,
              n_samples=n_samples, mesh=mesh)
    if grad_mod.takes_kernel(dict(features), max_depth):
        return render_grad_sharded_mega(scene, features, target, seed, **kw)
    return render_grad_sharded(scene, features, target, seed, **kw)


def train_step_analog(scene, features, state, seed, *, width, height, max_depth, sqrt_spp,
                      samples_per_device, mesh):
    """One distributed accumulation step (JAX ``train_step_analog``): adds
    ``sp · samples_per_device`` samples to ``state`` (a
    ``render.RenderState``) and returns the new state."""
    radiance = render_samples_sharded(
        scene, features, state.frame_idx, seed, width=width, height=height,
        max_depth=max_depth, sqrt_spp=sqrt_spp, samples_per_device=samples_per_device,
        mesh=mesh)
    return render_mod.RenderState(accum=state.accum + radiance,
                                  frame_idx=state.frame_idx + samples_per_device * mesh.sp)
