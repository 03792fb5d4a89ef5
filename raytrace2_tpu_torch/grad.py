"""Differentiable rendering (port of ``raytrace2_tpu/grad.py``).

The scene's float leaves are the parameters: ``value_and_grad_scene`` makes
them autograd leaves, renders through ``integrator.render_progressive(...,
differentiable=True)`` — the forward kernel, and a backward that launches
the indexed-replay kernel (``ops/kernels/megakernel_grad.py``) — and returns
the gradient as a FlatScene.

Estimator (as in the JAX package): geometry, camera, material, texture and
background parameters differentiate through the continuous chain (camera
ray → hit t → point → normal → scatter direction → ...) at fixed random
draws; discrete events — which primitive is hit, the dielectric branch, the
checker cell, medium scatter-or-not — carry no gradient. On an all-solid
scene the radiance is piecewise constant in geometry, so geometry and
camera gradients are exactly zero there; a noise texture makes them
continuous.

The JAX package falls back to its XLA scan for scenes outside the gradient
kernel's gates (ellipsoids, depth above 64, more than 4,096 records, table
Perlin). That path is not ported yet: such scenes raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import torch

from raytrace2_tpu_torch.ops import integrator
from raytrace2_tpu_torch.ops.kernels import megakernel_grad as mkg
from raytrace2_tpu_torch.scene import schema


def _check_supported(features, max_depth) -> None:
    sizes = features.get("mega_sizes")
    if sizes is None:
        raise NotImplementedError(
            "scene has no kernel sizes (ellipsoids): its gradient needs the non-kernel "
            "path, which is not ported yet (ROADMAP queue A item 12)")
    if features.get("noise_impl", "hash") != "hash":
        raise NotImplementedError(
            "table Perlin noise (noise_impl='table') is not ported yet (ROADMAP queue B "
            "item 5, B1's options)")
    if not mkg.grad_supported(tuple(sizes), max_depth):
        raise NotImplementedError(
            f"depth {max_depth} (gradient kernel: at most {mkg.GRAD_MAX_DEPTH}) or "
            f"{integrator.n_records(features)} records (at most {mkg.MAX_RECORDS}) "
            "need the non-kernel path, which is not ported yet (ROADMAP queue A item 12)")


def render_image(scene, features, seed, *, width, height, n_samples, max_depth,
                 sqrt_spp):
    """Differentiable ``n_samples``-sample render → mean radiance [H, W, 3] on
    the scene's device (a CUDA device runs the kernels, a CPU device their
    plain versions). ``features`` is ``scene.features()`` as a dict or as
    sorted items."""
    features = dict(features)
    _check_supported(features, max_depth)
    acc = integrator.render_progressive(scene, features, width, height, 0, n_samples,
                                        seed, max_depth, sqrt_spp, differentiable=True)
    return acc / n_samples


def value_and_grad_scene(loss_fn, scene, features, seed, **render_kw):
    """(loss, d loss / d scene) for ``loss_fn(image) -> scalar tensor``.

    ``scene`` is a FlatScene of tensors on the render device
    (``schema.to_device``). The gradient is a FlatScene of the same shape:
    a tensor for every float leaf (zeros where the loss does not reach it)
    and None for the integer and bool leaves."""
    leaves = []

    def as_leaf(x):
        if not torch.is_tensor(x):
            raise TypeError("value_and_grad_scene needs a scene of tensors "
                            "(schema.to_device)")
        if not x.is_floating_point():
            return x
        x = x.detach().requires_grad_(True)
        leaves.append(x)
        return x

    params = schema.map_leaves(scene, as_leaf)
    loss = loss_fn(render_image(params, features, seed, **render_kw))
    grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

    def grad_of(x):
        if not x.is_floating_point():
            return None
        d = next(grads)
        return torch.zeros_like(x) if d is None else d

    return loss.detach(), schema.map_leaves(params, grad_of)
