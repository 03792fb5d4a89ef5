"""Flattened SoA scene representation (port of ``raytrace2_tpu/scene/schema.py``).

The same dataclasses as the JAX package, without pytree registration: the
loader fills them with host numpy arrays, and ``to_device`` maps every leaf
to a torch tensor on an explicit device. ``FlatScene.features()`` computes
the same static gates as the JAX package (schema.py:302-351), including
``mega_sizes`` and the checker nesting depth.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from raytrace2_tpu_torch import defs


@dataclasses.dataclass(frozen=True)
class Spheres:
    """Center at shutter time t is ``center0 + t * displacement``."""

    center0: Any       # [S,3] f32
    displacement: Any  # [S,3] f32
    radius: Any        # [S]   f32
    material: Any      # [S]   i32
    active: Any        # [S]   bool

    @property
    def count(self) -> int:
        return self.radius.shape[0]


@dataclasses.dataclass(frozen=True)
class Quads:
    """Quads with the reference's precomputed plane quantities
    (src/cpu_raytrace/Quad.hpp:14-21): n = cross(u,v), normal = n/|n|,
    d = normal·q, w = n/(n·n)."""

    q: Any         # [Q,3]
    u: Any         # [Q,3]
    v: Any         # [Q,3]
    normal: Any    # [Q,3]
    d: Any         # [Q]
    w: Any         # [Q,3]
    material: Any  # [Q] i32
    active: Any    # [Q] bool

    @property
    def count(self) -> int:
        return self.d.shape[0]


def derive_quad_plane(quads: Quads) -> Quads:
    """The derived plane rows (normal, d, w) recomputed from q, u and v in
    torch (JAX ``schema.derive_quad_plane``): the differentiable analog of
    ``make_quads``' numpy derivation (Quad.hpp:24-29). Use it after
    perturbing quad geometry, since the intersector reads the derived rows,
    not q, u and v."""
    u, v = quads.u, quads.v
    n_raw = torch.stack([u[:, 1] * v[:, 2] - u[:, 2] * v[:, 1],
                         u[:, 2] * v[:, 0] - u[:, 0] * v[:, 2],
                         u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0]], dim=-1)
    nn = torch.sum(n_raw * n_raw, dim=-1, keepdim=True)
    safe_nn = torch.where(nn > 0, nn, 1.0)
    normal = n_raw / torch.sqrt(safe_nn)
    return dataclasses.replace(quads, normal=normal, d=torch.sum(normal * quads.q, dim=-1),
                               w=n_raw / safe_nn)


@dataclasses.dataclass(frozen=True)
class Boxes:
    """Axis-aligned boxes, swept by the kernel's slab test. The loader also
    expands each one to 6 quads, appended after the plain quads."""

    bmin: Any      # [B,3]
    bmax: Any      # [B,3]
    material: Any  # [B] i32
    active: Any    # [B] bool

    @property
    def count(self) -> int:
        return self.material.shape[0]


@dataclasses.dataclass(frozen=True)
class Media:
    """Constant-density media with an analytic sphere or box boundary,
    intersected in model space through the carried world→model affine."""

    btype: Any            # [M] i32 — defs.MEDIUM_SPHERE | defs.MEDIUM_BOX
    p0: Any               # [M,3] sphere center0 | box min
    p1: Any               # [M,3] sphere (radius,0,0) | box max
    displacement: Any     # [M,3] sphere center displacement
    inv_model: Any        # [M,3,4] world→model affine
    neg_inv_density: Any  # [M] = -1/density
    material: Any         # [M] i32
    active: Any           # [M] bool

    @property
    def count(self) -> int:
        return self.btype.shape[0]


@dataclasses.dataclass(frozen=True)
class Ellipsoids:
    """Spheres under a non-similarity affine, carried with the inverse affine
    and the inverse-transpose linear part. Only the non-kernel path renders
    them (``features()["mega_sizes"]`` is None when any is active)."""

    center0: Any       # [E,3]
    displacement: Any  # [E,3]
    radius: Any        # [E]
    inv_model: Any     # [E,3,4]
    inv_t: Any         # [E,3,3]
    material: Any      # [E] i32
    active: Any        # [E] bool

    @property
    def count(self) -> int:
        return self.radius.shape[0]


@dataclasses.dataclass(frozen=True)
class Materials:
    """Type id + packed params; ``param`` is metal fuzz or dielectric
    refraction index."""

    mtype: Any   # [K] i32
    albedo: Any  # [K,3]
    param: Any   # [K]
    tex: Any     # [K] i32

    @property
    def count(self) -> int:
        return self.mtype.shape[0]


@dataclasses.dataclass(frozen=True)
class Textures:
    """Solid (albedo), checker (inv_scale, even/odd children) and noise
    (albedo, scale, noise_type, per-texture Perlin tables) rows."""

    ttype: Any       # [L] i32
    albedo: Any      # [L,3]
    inv_scale: Any   # [L]
    scale: Any       # [L]
    even: Any        # [L] i32
    odd: Any         # [L] i32
    noise_type: Any  # [L] i32
    perm: Any        # [L,3,256] i32
    grad: Any        # [L,256,3] f32

    @property
    def count(self) -> int:
        return self.ttype.shape[0]


@dataclasses.dataclass(frozen=True)
class CameraParams:
    """Raw camera parameters (src/cpu_raytrace/Camera.hpp:108-123); the frame
    is derived in ``ops/camera.py``."""

    center: Any         # [3]
    look_at: Any        # [3]
    vup: Any            # [3]
    vfov: Any           # [] degrees
    defocus_angle: Any  # [] degrees
    focus_dist: Any     # []


@dataclasses.dataclass(frozen=True)
class FlatScene:
    """The complete scene."""

    spheres: Spheres
    quads: Quads
    boxes: Boxes
    media: Media
    materials: Materials
    textures: Textures
    camera: CameraParams
    background: Any  # [3]
    # Flattened sphere BVH (scene/bvh.py), built by the Renderer where the
    # non-kernel path walks it.
    sphere_bvh: Any = None
    ellipsoids: Any = None

    @property
    def num_records(self) -> int:
        return self.spheres.count + self.quads.count + self.media.count

    def features(self) -> dict:
        """Static feature gates, computed on the host (JAX schema.py:302-351)."""
        ttypes = _np(self.textures.ttype)

        def checker_depth() -> int:
            # Max checker nesting depth; the loader rejects cycles.
            even = _np(self.textures.even)
            odd = _np(self.textures.odd)

            def depth(i: int) -> int:
                if ttypes[i] != defs.TEX_CHECKER:
                    return 0
                return 1 + max(depth(int(even[i])), depth(int(odd[i])))

            return max((depth(i) for i in range(len(ttypes))), default=0)

        has_ell = (self.ellipsoids is not None
                   and bool(np.any(_np(self.ellipsoids.active))))
        return {
            "has_media": bool(np.any(_np(self.media.active))),
            "has_ellipsoids": has_ell,
            "has_noise": bool(np.any(ttypes == defs.TEX_NOISE)),
            "has_checker": checker_depth(),
            "noise_rows": tuple(int(r) for r in np.nonzero(ttypes == defs.TEX_NOISE)[0]),
            # (n_spheres, n_plain_quads, n_mats, n_texs, n_media, n_boxes);
            # box-derived quads sit after the plain quads.
            "mega_sizes": None if has_ell else (
                int(_np(self.spheres.active).sum()),
                int(_np(self.quads.active).sum())
                - 6 * int(_np(self.boxes.active).sum()),
                int(self.materials.mtype.shape[0]),
                int(self.textures.ttype.shape[0]),
                int(_np(self.media.active).sum()),
                int(_np(self.boxes.active).sum()),
            ),
        }


def _np(x) -> np.ndarray:
    """Host numpy view of a leaf (numpy array or torch tensor)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _pad(arr: np.ndarray, n: int) -> np.ndarray:
    """Pad the leading axis of ``arr`` to length ``n`` with zeros."""
    if arr.shape[0] == n:
        return arr
    pad = [(0, n - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


def make_spheres(center0, displacement, radius, material, pad_to: int | None = None) -> Spheres:
    center0 = np.asarray(center0, defs.REAL).reshape(-1, 3)
    n = center0.shape[0]
    target = max(pad_to or n, 1)
    active = np.zeros(target, bool)
    active[:n] = True
    return Spheres(
        center0=_pad(center0, target),
        displacement=_pad(np.asarray(displacement, defs.REAL).reshape(-1, 3), target),
        radius=_pad(np.asarray(radius, defs.REAL).reshape(-1), target),
        material=_pad(np.asarray(material, defs.INDEX).reshape(-1), target),
        active=active,
    )


def make_quads(q, u, v, material, pad_to: int | None = None) -> Quads:
    q = np.asarray(q, np.float64).reshape(-1, 3)
    u = np.asarray(u, np.float64).reshape(-1, 3)
    v = np.asarray(v, np.float64).reshape(-1, 3)
    n_raw = np.cross(u, v)
    nn = np.sum(n_raw * n_raw, axis=-1, keepdims=True)
    # Padded rows would divide by zero; park them on a unit normal.
    safe_nn = np.where(nn > 0, nn, 1.0)
    normal = n_raw / np.sqrt(safe_nn)
    d = np.sum(normal * q, axis=-1)
    w = n_raw / safe_nn
    n = q.shape[0]
    target = max(pad_to or n, 1)
    active = np.zeros(target, bool)
    active[:n] = True
    return Quads(
        q=_pad(q.astype(defs.REAL), target),
        u=_pad(u.astype(defs.REAL), target),
        v=_pad(v.astype(defs.REAL), target),
        normal=_pad(normal.astype(defs.REAL), target),
        d=_pad(d.astype(defs.REAL), target),
        w=_pad(w.astype(defs.REAL), target),
        material=_pad(np.asarray(material, defs.INDEX).reshape(-1), target),
        active=active,
    )


def empty_boxes() -> Boxes:
    return Boxes(
        bmin=np.zeros((1, 3), defs.REAL),
        bmax=np.zeros((1, 3), defs.REAL),
        material=np.zeros(1, defs.INDEX),
        active=np.zeros(1, bool),
    )


def empty_media() -> Media:
    ident = np.zeros((1, 3, 4), defs.REAL)
    ident[0, :, :3] = np.eye(3)
    return Media(
        btype=np.zeros(1, defs.INDEX),
        p0=np.zeros((1, 3), defs.REAL),
        p1=np.zeros((1, 3), defs.REAL),
        displacement=np.zeros((1, 3), defs.REAL),
        inv_model=ident,
        neg_inv_density=np.full(1, -1.0, defs.REAL),
        material=np.zeros(1, defs.INDEX),
        active=np.zeros(1, bool),
    )


def make_ellipsoids(center0, displacement, radius, inv_model, inv_t,
                    material) -> Ellipsoids:
    center0 = np.asarray(center0, defs.REAL).reshape(-1, 3)
    n = center0.shape[0]
    target = max(n, 1)
    active = np.zeros(target, bool)
    active[:n] = True
    ident34 = np.hstack([np.eye(3), np.zeros((3, 1))])[None]
    return Ellipsoids(
        center0=_pad(center0, target),
        displacement=_pad(
            np.asarray(displacement, defs.REAL).reshape(-1, 3), target),
        radius=_pad(np.asarray(radius, defs.REAL).reshape(-1), target),
        inv_model=np.concatenate(
            [np.asarray(inv_model, defs.REAL).reshape(-1, 3, 4),
             np.tile(ident34.astype(defs.REAL), (target - n, 1, 1))]
        ) if n else np.tile(ident34.astype(defs.REAL), (target, 1, 1)),
        inv_t=np.concatenate(
            [np.asarray(inv_t, defs.REAL).reshape(-1, 3, 3),
             np.tile(np.eye(3, dtype=defs.REAL)[None], (target - n, 1, 1))]
        ) if n else np.tile(np.eye(3, dtype=defs.REAL)[None], (target, 1, 1)),
        material=_pad(np.asarray(material, defs.INDEX).reshape(-1), target),
        active=active,
    )


def empty_ellipsoids() -> Ellipsoids:
    return make_ellipsoids(
        np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0,)),
        np.zeros((0, 3, 4)), np.zeros((0, 3, 3)), np.zeros((0,), np.int32))


def map_leaves(obj, fn):
    """Apply ``fn`` to every array leaf of a scene dataclass tree (None
    leaves stay None)."""
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: map_leaves(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj)
        })
    return fn(obj)


def to_device(scene: FlatScene, device) -> FlatScene:
    """Every leaf as a torch tensor on ``device`` (float32, int32 or bool,
    as the host array is)."""
    device = torch.device(device)
    return map_leaves(scene, lambda x: torch.as_tensor(np.asarray(x), device=device))


def as_float32(obj):
    """A scene (or any scene dataclass) with its floating leaves as float32
    and the others as they are: what the kernels' packers read, so that
    under ``RAYTRACE2_DOUBLE`` they see the very values a float32 load gives
    (the loader derives every leaf in float64 and rounds it once to
    ``defs.REAL``)."""
    return map_leaves(obj, lambda x: x.to(torch.float32)
                      if torch.is_tensor(x) and x.is_floating_point() else x)
