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

Noise textures differentiate through hash noise or, with
``noise_impl="table"``, the reference's Perlin tables (held constant).

Outside the gradient kernel's gates — ellipsoids, depth above 64, more than
4,096 records, or ``use_megakernel`` set to False — ``render_image`` falls
back to the non-kernel path's differentiable scan, as the JAX package does
(``grad.py:56-83``): a Python loop of ``integrator.render_sample(...,
differentiable=True)`` over the samples, threefry streams (or murmur with
``rng_impl="murmur"``), the dense closest hit, and every bounce's residuals
kept for the backward. A features dict without ``use_megakernel`` takes
the kernel path, as ``integrator.render_progressive`` reads it.
"""

from __future__ import annotations

import torch

from raytrace2_tpu_torch import defs, tracing
from raytrace2_tpu_torch.ops import integrator
from raytrace2_tpu_torch.ops.kernels import megakernel_grad as mkg
from raytrace2_tpu_torch.scene import schema


def takes_kernel(features, max_depth) -> bool:
    """Whether ``render_image`` takes the kernel path (forward kernel and
    B3) for these features at this depth, rather than the scan."""
    sizes = features.get("mega_sizes")
    return (bool(features.get("use_megakernel", True)) and sizes is not None
            and mkg.grad_supported(tuple(sizes), max_depth))


def render_image(scene, features, seed, *, width, height, n_samples, max_depth,
                 sqrt_spp, chunk_size=None):
    """Differentiable ``n_samples``-sample render → mean radiance [H, W, 3] on
    the scene's device (a CUDA device runs the kernels, a CPU device their
    plain versions). ``features`` is ``scene.features()`` as a dict or as
    sorted items. ``chunk_size`` bounds the scan's [rays, records]
    intermediates per chunk (the kernel path ignores it)."""
    features = dict(features)
    features.pop("use_pallas", None)  # B5 has no VJP (JAX grad.py:57)
    if takes_kernel(features, max_depth):
        acc = integrator.render_progressive(scene, features, width, height, 0, n_samples,
                                            seed, max_depth, sqrt_spp, differentiable=True)
        return acc / n_samples
    acc = torch.zeros((height, width, 3), dtype=defs.TORCH_REAL,
                      device=scene.background.device)
    for s in range(int(n_samples)):
        acc = acc + integrator.render_sample(scene, features, width, height, s, seed,
                                             max_depth, sqrt_spp, chunk_size,
                                             differentiable=True)
    return acc / n_samples


def scene_params(scene):
    """(params, leaves): ``scene`` with every float leaf a fresh autograd
    leaf, and those leaves in ``schema.map_leaves`` order."""
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

    return schema.map_leaves(scene, as_leaf), leaves


def grad_tree(params, grads):
    """The gradient as a FlatScene shaped like ``params``: ``grads`` (in
    ``scene_params``' leaf order; None where the loss does not reach a
    leaf, which becomes zeros) on the float leaves, None on the integer and
    bool ones."""
    grads = iter(grads)

    def grad_of(x):
        if not x.is_floating_point():
            return None
        d = next(grads)
        return torch.zeros_like(x) if d is None else d

    return schema.map_leaves(params, grad_of)


def value_and_grad_scene(loss_fn, scene, features, seed, **render_kw):
    """(loss, d loss / d scene) for ``loss_fn(image) -> scalar tensor``.

    ``scene`` is a FlatScene of tensors on the render device
    (``schema.to_device``). The gradient is a FlatScene of the same shape:
    a tensor for every float leaf (zeros where the loss does not reach it)
    and None for the integer and bool leaves."""
    with tracing.span("grad.value_and_grad", {"seed": seed}):
        with tracing.span("grad.params"):
            params, leaves = scene_params(scene)
        with tracing.span("grad.forward"):
            loss = loss_fn(render_image(params, features, seed, **render_kw))
        with tracing.span("grad.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        with tracing.span("grad.tree"):
            return loss.detach(), grad_tree(params, grads)
