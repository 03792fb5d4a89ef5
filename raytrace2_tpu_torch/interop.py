"""Carry state across from the JAX package.

For a renderer the scene arrays are the parameters (they are what the JAX
package differentiates with respect to), so ``from_jax_scene`` is the
weight-conversion step: it reads every leaf of a ``raytrace2_tpu`` FlatScene
with ``np.asarray`` and rebuilds the port's host FlatScene. It imports
nothing from jax; the JAX object is only read by attribute name.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from raytrace2_tpu_torch.scene import schema

_NESTED = {
    "spheres": schema.Spheres,
    "quads": schema.Quads,
    "boxes": schema.Boxes,
    "media": schema.Media,
    "materials": schema.Materials,
    "textures": schema.Textures,
    "camera": schema.CameraParams,
    "ellipsoids": schema.Ellipsoids,
}


def _leaves(cls, src) -> dict:
    return {f.name: np.asarray(getattr(src, f.name)) for f in dataclasses.fields(cls)}


def from_jax_scene(jax_flat_scene) -> schema.FlatScene:
    """A ``raytrace2_tpu.scene.schema.FlatScene`` (host numpy or device jax
    arrays) as the port's host ``FlatScene``. The JAX sphere BVH is an
    XLA-path structure and is not carried over."""
    kw = {}
    for name, cls in _NESTED.items():
        src = getattr(jax_flat_scene, name)
        kw[name] = None if src is None else cls(**_leaves(cls, src))
    return schema.FlatScene(background=np.asarray(jax_flat_scene.background), **kw)
