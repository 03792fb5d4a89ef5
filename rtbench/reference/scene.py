"""Scene JSON → the record tables and camera that the plain path tracer
(``pathtrace.py``) reads.

Written from the scene format's semantics (the upstream Raytrace2
``src/Serialize.cpp``: textures, materials with inline solid textures, a
``constant_medium`` wrapper that adds an isotropic material, graph nodes
whose translate · rotate · scale applies to the node's primitive and its
children; a box is six quads, kept as one axis-aligned slab record where
its transform is a diagonal; a sphere under a similarity is baked). It
imports nothing of the program: the benchmark hands both sides the same
JSON and this module works the tables out again.

Geometry is composed in float64 and rounded once to float32, as the
record values of a float32 renderer are; the quad's plane vectors and
offsets are derived the same way (``cross(v, w)`` with its first product
taken exactly, then rounded).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

MAT_LAMBERTIAN, MAT_METAL, MAT_DIELECTRIC, MAT_TEXTURE, MAT_LIGHT, MAT_ISOTROPIC = range(6)
TEX_SOLID, TEX_CHECKER, TEX_NOISE = range(3)
MEDIUM_SPHERE, MEDIUM_BOX = 0, 1
NOISE_MARBLE = 1


def _vec3(value, default=(0.0, 0.0, 0.0)) -> np.ndarray:
    return np.asarray(default if value is None else value, np.float64).reshape(3)


def _rotation(angle_deg: float, axis) -> np.ndarray:
    """Angle-axis rotation (glm::angleAxis) about the normalised axis."""
    axis = np.asarray(axis, np.float64)
    n = np.linalg.norm(axis)
    if n == 0:
        return np.eye(3)
    x, y, z = axis / n
    a = math.radians(angle_deg)
    c, s = math.cos(a), math.sin(a)
    k = 1 - c
    return np.array([[c + x * x * k, x * y * k - z * s, x * z * k + y * s],
                     [y * x * k + z * s, c + y * y * k, y * z * k - x * s],
                     [z * x * k - y * s, z * y * k + x * s, c + z * z * k]])


def _node_matrix(node: dict) -> np.ndarray | None:
    t = node.get("transform")
    if not isinstance(t, dict):
        return None
    rot = t.get("rotation", [0.0, 0.0, 1.0, 0.0])
    m = np.eye(4)
    m[:3, :3] = _rotation(float(rot[0]), rot[1:4]) @ np.diag(_vec3(t.get("scale"), (1, 1, 1)))
    m[:3, 3] = _vec3(t.get("translation"))
    return m


def _box_quads(a, b):
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    dx = np.array([hi[0] - lo[0], 0, 0])
    dy = np.array([0, hi[1] - lo[1], 0])
    dz = np.array([0, 0, hi[2] - lo[2]])
    return [(np.array([lo[0], lo[1], hi[2]]), dx, dy), (np.array([hi[0], lo[1], hi[2]]), -dz, dy),
            (np.array([hi[0], lo[1], lo[2]]), -dx, dy), (np.array([lo[0], lo[1], lo[2]]), dz, dy),
            (np.array([lo[0], hi[1], hi[2]]), dx, -dz), (np.array([lo[0], lo[1], lo[2]]), dx, dz)]


def _inverse_affine(m4: np.ndarray) -> np.ndarray:
    ainv = np.linalg.inv(m4[:3, :3])
    return np.hstack([ainv, (-ainv @ m4[:3, 3])[:, None]])


@dataclasses.dataclass
class Scene:
    """Record tables as float32 numpy columns (``to(device, dtype)`` makes
    the tensors the tracer reads)."""

    sph: dict       # c0 [S,3], dp [S,3], rad [S], mat [S]
    quad: dict      # n [Q,3], d [Q], aa [Q,3], ab [Q,3], qaa [Q], qab [Q], mat [Q]
    box: dict       # lo [B,3], hi [B,3], mat [B]
    med: dict       # btype [M], p0 [M,3], p1 [M,3], dsp [M,3], inv [M,3,4], nid [M], mat [M]
    mat: dict       # mtype, albedo [K,3], param, tex
    tex: dict       # ttype, albedo [L,3], inv_scale, scale, even, odd, ntype
    camera: dict    # center, look_at, vup, fov, defocus_angle, focus_dist (float64)
    background: np.ndarray

    @property
    def sizes(self) -> dict:
        return {k: len(getattr(self, k)["mat"]) for k in ("sph", "quad", "box", "med")}

    def table_bytes(self) -> int:
        """Bytes of the record, material and texture tables at float32: what
        a render has to read of the scene at least once."""
        return 4 * sum(int(np.asarray(v).size) for t in (self.sph, self.quad, self.box, self.med,
                                                          self.mat, self.tex) for v in t.values())


def parse(obj: dict) -> Scene:
    textures, materials = [], []

    def solid(albedo) -> int:
        textures.append(dict(ttype=TEX_SOLID, albedo=_vec3(albedo, (1, 1, 1))))
        return len(textures) - 1

    for t in obj.get("textures") or []:
        kind = t.get("type", "")
        if kind == "solid_color":
            solid(t.get("albedo"))
        elif kind == "checker":
            textures.append(dict(ttype=TEX_CHECKER, inv_scale=1.0 / float(t.get("scale", 1.0)),
                                 even=int(t.get("even_tex_idx", 0)),
                                 odd=int(t.get("odd_tex_idx", 0))))
        elif kind == "noise":
            textures.append(dict(ttype=TEX_NOISE, albedo=_vec3(t.get("albedo"), (1, 1, 1)),
                                 scale=float(t.get("scale", 1.0)),
                                 ntype=int(t.get("noise_type", NOISE_MARBLE))))
        else:
            raise ValueError(f"texture type {kind!r}")
    for m in obj.get("materials") or []:
        kind = m.get("type", "")
        if kind == "lambertian":
            materials.append(dict(mtype=MAT_LAMBERTIAN, albedo=_vec3(m.get("albedo"), (1, 1, 1))))
        elif kind == "metal":
            materials.append(dict(mtype=MAT_METAL, albedo=_vec3(m.get("albedo"), (1, 1, 1)),
                                  param=float(m.get("fuzz", 0.0))))
        elif kind == "dielectric":
            materials.append(dict(mtype=MAT_DIELECTRIC,
                                  param=float(m.get("refraction_index", 1.0))))
        elif kind in ("texture", "diffuse_light"):
            tex = int(m["tex_idx"]) if "tex_idx" in m else solid(m["albedo"])
            materials.append(dict(mtype=MAT_TEXTURE if kind == "texture" else MAT_LIGHT, tex=tex))
        else:
            raise ValueError(f"material type {kind!r}")

    prims = []
    for p in obj.get("primitives") or []:
        medium = None
        if "constant_medium" in p:
            cm = p["constant_medium"]
            materials.append(dict(mtype=MAT_ISOTROPIC, tex=solid(cm.get("albedo", (0, 0, 0)))))
            medium = dict(density=float(cm.get("density", 0.01)), mat=len(materials) - 1)
        kind = p.get("type", "")
        if kind == "sphere":
            geo = dict(c=_vec3(p.get("center")), dp=_vec3(p.get("displacement")),
                       r=float(p.get("radius", 0.5)))
        elif kind == "quad":
            geo = dict(q=_vec3(p.get("q")), u=_vec3(p.get("u"), (1, 0, 0)),
                       v=_vec3(p.get("v"), (0, 0, 1)))
        elif kind == "box":
            geo = dict(a=_vec3(p.get("a")), b=_vec3(p.get("b"), (1, 1, 1)))
        else:
            raise ValueError(f"primitive type {kind!r}")
        prims.append((kind, geo, int(p.get("material", 0)), medium))

    sph, quads, box_quads, boxes, media = [], [], [], [], []

    def emit(idx: int, m4):
        kind, g, mat, medium = prims[idx]
        m4 = np.eye(4) if m4 is None else m4
        a3, t3 = m4[:3, :3], m4[:3, 3]
        if medium is not None:
            nid = -1.0 / medium["density"]
            if kind == "sphere":
                media.append((MEDIUM_SPHERE, g["c"], np.array([g["r"], 0.0, 0.0]), g["dp"],
                              _inverse_affine(m4), nid, medium["mat"]))
            elif kind == "box":
                media.append((MEDIUM_BOX, np.minimum(g["a"], g["b"]), np.maximum(g["a"], g["b"]),
                              np.zeros(3), _inverse_affine(m4), nid, medium["mat"]))
            return  # a medium over a flat quad never scatters
        if kind == "sphere":
            gram = a3.T @ a3
            s2 = np.trace(gram) / 3.0
            if not np.allclose(gram, np.eye(3) * s2, atol=1e-6 * max(1.0, s2)):
                raise ValueError("a sphere under a non-uniform scale (an ellipsoid)")
            sph.append((a3 @ g["c"] + t3, a3 @ g["dp"], g["r"] * math.sqrt(max(s2, 0.0)), mat))
        elif kind == "quad":
            quads.append((a3 @ g["q"] + t3, a3 @ g["u"], a3 @ g["v"], mat))
        else:
            off = a3 - np.diag(np.diag(a3))
            aligned = bool(np.all(np.abs(off) <= 1e-9)) and bool(np.all(np.abs(np.diag(a3)) > 0))
            if aligned:
                ca, cb = a3 @ g["a"] + t3, a3 @ g["b"] + t3
                boxes.append((np.minimum(ca, cb), np.maximum(ca, cb), mat))
            sink = box_quads if aligned else quads
            for q, u, v in _box_quads(g["a"], g["b"]):
                sink.append((a3 @ q + t3, a3 @ u, a3 @ v, mat))

    def walk(node, parent):
        own = _node_matrix(node)
        m = parent @ own if parent is not None and own is not None else (
            own if own is not None else parent)
        if "primitive" in node:
            emit(int(node["primitive"]), m)
        for child in node.get("children") or []:
            walk(child, m)

    for node in obj.get("scene") or [{"primitive": i} for i in range(len(prims))]:
        walk(node, None)

    f32 = np.float32
    sph_t = dict(c0=np.array([s[0] for s in sph], f32).reshape(-1, 3),
                 dp=np.array([s[1] for s in sph], f32).reshape(-1, 3),
                 rad=np.array([s[2] for s in sph], f32), mat=np.array([s[3] for s in sph], f32))
    quad_t = _quad_tables(quads)
    box_t = dict(lo=np.array([b[0] for b in boxes], f32).reshape(-1, 3),
                 hi=np.array([b[1] for b in boxes], f32).reshape(-1, 3),
                 mat=np.array([b[2] for b in boxes], f32))
    med_t = dict(btype=np.array([m[0] for m in media], f32),
                 p0=np.array([m[1] for m in media], f32).reshape(-1, 3),
                 p1=np.array([m[2] for m in media], f32).reshape(-1, 3),
                 dsp=np.array([m[3] for m in media], f32).reshape(-1, 3),
                 inv=np.array([m[4] for m in media], f32).reshape(-1, 3, 4),
                 nid=np.array([m[5] for m in media], f32), mat=np.array([m[6] for m in media], f32))
    if not textures:
        solid((1, 1, 1))
    mat_t = dict(mtype=np.array([m["mtype"] for m in materials], f32),
                 albedo=np.array([m.get("albedo", np.ones(3)) for m in materials], f32).reshape(-1, 3),
                 param=np.array([m.get("param", 0.0) for m in materials], f32),
                 tex=np.array([m.get("tex", 0) for m in materials], f32))
    tex_t = dict(ttype=np.array([t["ttype"] for t in textures], f32),
                 albedo=np.array([t.get("albedo", np.ones(3)) for t in textures], f32).reshape(-1, 3),
                 inv_scale=np.array([t.get("inv_scale", 1.0) for t in textures], f32),
                 scale=np.array([t.get("scale", 1.0) for t in textures], f32),
                 even=np.array([t.get("even", 0) for t in textures], f32),
                 odd=np.array([t.get("odd", 0) for t in textures], f32),
                 ntype=np.array([t.get("ntype", 0) for t in textures], f32))
    cam = obj.get("camera") or {}
    camera = dict(center=_vec3(cam.get("center"), (0, 0, 1)),
                  look_at=_vec3(cam.get("look_at"), (0, 0, 0)), vup=np.array([0.0, 1.0, 0.0]),
                  fov=float(cam.get("fov", 90.0)),
                  defocus_angle=float(cam.get("defocus_angle", 0.0)),
                  focus_dist=float(cam.get("focus_distance", 1.0)))
    return Scene(sph_t, quad_t, box_t, med_t, mat_t, tex_t, camera,
                 _vec3(obj.get("background_color"), (1, 1, 1)).astype(f32))


def _quad_tables(quads) -> dict:
    """Plane rows of each quad: unit normal n and offset d = n·q, and the
    in-plane dual vectors aa = v × w, ab = w × u (w = (u × v) / |u × v|²)
    with the offsets q·aa, q·ab, so that alpha = p·aa - q·aa."""
    f32 = np.float32
    if not quads:
        z3, z = np.zeros((0, 3), f32), np.zeros(0, f32)
        return dict(n=z3, d=z, aa=z3, ab=z3, qaa=z, qab=z, mat=z)
    q = np.array([x[0] for x in quads], np.float64)
    u = np.array([x[1] for x in quads], np.float64)
    v = np.array([x[2] for x in quads], np.float64)
    n_raw = np.cross(u, v)
    nn = np.sum(n_raw * n_raw, axis=-1, keepdims=True)
    normal = n_raw / np.sqrt(nn)
    d = np.sum(normal * q, axis=-1).astype(f32)
    w = (n_raw / nn).astype(f32)
    q32, u32, v32 = q.astype(f32), u.astype(f32), v.astype(f32)

    def fms(a, b, c, e):  # a*b - c*e, the first product exact, rounded once
        return (a.astype(np.float64) * b.astype(np.float64)
                - (c * e).astype(np.float64)).astype(f32)

    def cross(a, b):
        return np.stack([fms(a[:, 1], b[:, 2], a[:, 2], b[:, 1]),
                         fms(a[:, 2], b[:, 0], a[:, 0], b[:, 2]),
                         fms(a[:, 0], b[:, 1], a[:, 1], b[:, 0])], -1)

    def dot(a, b):
        return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]

    aa, ab = cross(v32, w), cross(w, u32)
    return dict(n=normal.astype(f32), d=d, aa=aa, ab=ab, qaa=dot(q32, aa), qab=dot(q32, ab),
                mat=np.array([x[3] for x in quads], f32))


def camv(scene: Scene, width: int, height: int) -> list:
    """The camera's derived frame (Camera::Update) in float32: pixel00,
    pixel_delta_u, pixel_delta_v, center, defocus_disk_u, defocus_disk_v,
    defocus_angle, as a flat list of 19 floats."""
    c = scene.camera

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32)

    def normalize(x):
        return x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)).clamp(min=1e-12)

    def cross(a, b):
        return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                            a[0] * b[1] - a[1] * b[0]])

    center, look_at, vup = t(c["center"]), t(c["look_at"]), t(c["vup"])
    focus, angle = t(c["focus_dist"]), t(c["defocus_angle"])
    h = torch.tan(t(c["fov"]) * (math.pi / 180.0) / 2.0)
    w = normalize(center - look_at)
    u = normalize(cross(vup, w))
    v = cross(w, u)
    vh = 2.0 * h * focus
    vw = vh * (width / height)
    vu, vv = vw * u, vh * v
    du, dv = vu / width, vv / height
    upper_left = center - w * focus - vu / 2.0 - vv / 2.0
    p00 = upper_left + 0.5 * (du + dv)
    radius = focus * torch.tan(angle / 2.0 * (math.pi / 180.0))
    out = torch.cat([p00, du, dv, center, u * radius, v * radius, angle.reshape(1)])
    return [float(x) for x in out.tolist()]
