"""Scene authoring (port of ``tools/make_scene.py``): the ``SceneBuilder``
that emits the scene JSON the loader reads, the canned Cornell and book
scenes, and a runner that writes ``local/data/<name>.json`` with a
``settings.json`` beside it and renders it through the port's CLI.

Beyond the JAX package's canned scenes: ``cornell_box_corpus``, the corpus
Cornell box (the walls and boxes of ``cornell_box_original`` under the
book's smaller, brighter light), which ``renders/cornell32k_mega.npy``
renders; and ``book1_final``, the final scene of book 1 from a seeded
stream.

    python -m raytrace2_tpu_torch.tools.make_scene --scene cornell_corpus --root DIR
    python -m raytrace2_tpu_torch.tools.make_scene --scene book2_final --no-run --root DIR
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import tempfile

import numpy as np


class SceneBuilder:
    """Builder emitting the new-generation scene JSON format.

    Method names and index-returning behavior mirror the reference's class
    Scene so authoring scripts port unchanged.
    """

    def __init__(self) -> None:
        self.textures: list[dict] = []
        self.materials: list[dict] = []
        self.primitives: list[dict] = []
        self.nodes: list[dict] = []
        self.background_color = [0.0, 0.0, 0.0]
        self.camera = {
            "fov": 40,
            "center": [0, 0, 1],
            "look_at": [0, 0, 0],
            "width": 600,
            "aspect_ratio": 1.0,
        }

    # -- materials -------------------------------------------------------
    def _material(self, mtype: str, **params) -> int:
        self.materials.append({"type": mtype, **params})
        return len(self.materials) - 1

    def add_lambertian(self, albedo) -> int:
        return self._material("lambertian", albedo=list(albedo))

    def add_metal(self, albedo, fuzz: float) -> int:
        return self._material("metal", albedo=list(albedo), fuzz=fuzz)

    def add_dielectric(self, refraction_idx: float) -> int:
        return self._material("dielectric", refraction_index=refraction_idx)

    def add_diffuse_light(self, albedo) -> int:
        return self._material("diffuse_light", albedo=list(albedo))

    def add_texture_mat(self, idx: int) -> int:
        return self._material("texture", tex_idx=idx)

    # -- textures --------------------------------------------------------
    def add_noise_tex(self, scale, noise_type, albedo=(1, 1, 1)) -> int:
        self.textures.append(
            {"type": "noise", "scale": scale, "noise_type": noise_type,
             "albedo": list(albedo)}
        )
        return len(self.textures) - 1

    def add_solid_tex(self, albedo) -> int:
        self.textures.append({"type": "solid_color", "albedo": list(albedo)})
        return len(self.textures) - 1

    def add_checker_tex(self, scale, even_tex_idx, odd_tex_idx) -> int:
        self.textures.append(
            {"type": "checker", "scale": scale,
             "even_tex_idx": even_tex_idx, "odd_tex_idx": odd_tex_idx}
        )
        return len(self.textures) - 1

    # -- primitives ------------------------------------------------------
    def _primitive(self, record: dict, extra: dict | None) -> int:
        if extra:
            record.update(extra)
        self.primitives.append(record)
        return len(self.primitives) - 1

    def add_sphere(self, center, radius, material, args: dict | None = None) -> int:
        return self._primitive(
            {"type": "sphere", "center": list(center), "radius": radius,
             "material": material},
            args,
        )

    def add_sphere_moving(self, center, displacement, radius, material,
                          args: dict | None = None) -> int:
        merged = dict(args or {})
        merged["displacement"] = list(displacement)
        return self.add_sphere(center, radius, material, merged)

    def add_quad(self, q, u, v, material, args: dict | None = None) -> int:
        return self._primitive(
            {"type": "quad", "q": list(q), "u": list(u), "v": list(v),
             "material": material},
            args,
        )

    def add_box(self, a, b, material, args: dict | None = None) -> int:
        return self._primitive(
            {"type": "box", "a": list(a), "b": list(b), "material": material},
            args,
        )

    # -- scene graph -----------------------------------------------------
    def add_node(self, args: dict | None = None, primitive_idx: int = -1) -> None:
        node = dict(args or {})
        if primitive_idx != -1:
            node["primitive"] = primitive_idx
        self.nodes.append(node)

    # -- output ----------------------------------------------------------
    def to_json(self) -> dict:
        return {
            "textures": self.textures,
            "materials": self.materials,
            "primitives": self.primitives,
            "scene": self.nodes,
            "camera": self.camera,
            "background_color": self.background_color,
        }

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)


def constant_medium(density: float, albedo) -> dict:
    return {"constant_medium": {"density": density, "albedo": list(albedo)}}


def transform(translation=None, rotation=None, scale=None) -> dict:
    t = {}
    if translation:
        t["translation"] = list(translation)
    if scale:
        t["scale"] = list(scale)
    if rotation:
        t["rotation"] = list(rotation)
    return t


# -- canned scenes (same geometry as the reference's constructors) --------


def cornell_cam(scene: SceneBuilder) -> None:
    scene.camera.update(center=[278, 278, -800], look_at=[278, 278, 0], fov=40)


def add_cornell_walls(scene: SceneBuilder) -> None:
    green = scene.add_lambertian([0.12, 0.45, 0.15])
    red = scene.add_lambertian([0.65, 0.05, 0.05])
    white = scene.add_lambertian([0.73, 0.73, 0.73])
    light = scene.add_diffuse_light([7, 7, 7])
    walls = [
        ([555, 0, 0], [0, 555, 0], [0, 0, 555], green),
        ([0, 0, 0], [0, 555, 0], [0, 0, 555], red),
        ([113, 554, 127], [330, 0, 0], [0, 0, 305], light),
        ([0, 0, 0], [555, 0, 0], [0, 0, 555], white),
        ([0, 555, 0], [555, 0, 0], [0, 0, 555], white),
        ([0, 0, 555], [555, 0, 0], [0, 555, 0], white),
    ]
    for q, u, v, m in walls:
        scene.add_node(None, scene.add_quad(q, u, v, m))


def add_cornell_interior_boxes(scene: SceneBuilder, volumes: bool = False) -> None:
    if volumes:
        short = scene.add_box([0, 0, 0], [165, 165, 165], 0,
                              constant_medium(0.01, [1, 1, 1]))
        tall = scene.add_box([0, 0, 0], [165, 330, 165], 0,
                             constant_medium(0.01, [0, 0, 0]))
    else:
        white = scene.add_lambertian([0.73, 0.73, 0.73])
        short = scene.add_box([0, 0, 0], [165, 165, 165], white)
        tall = scene.add_box([0, 0, 0], [165, 330, 165], white)
    scene.add_node({"transform": transform([130, 0, 65], [-18, 0, 1, 0]),
                    "primitive": short})
    scene.add_node({"transform": transform([265, 0, 295], [15, 0, 1, 0]),
                    "primitive": tall})


def cornell_box_original() -> SceneBuilder:
    scene = SceneBuilder()
    add_cornell_walls(scene)
    add_cornell_interior_boxes(scene)
    cornell_cam(scene)
    return scene


def cornell_box_volume() -> SceneBuilder:
    scene = SceneBuilder()
    add_cornell_interior_boxes(scene, volumes=True)
    add_cornell_walls(scene)
    cornell_cam(scene)
    return scene


def book2_final(rng_seed: int | None = None) -> SceneBuilder:
    rnd = random.Random(rng_seed)
    scene = SceneBuilder()

    # Floor: 20×20 boxes of random height.
    ground = scene.add_lambertian([0.48, 0.83, 0.53])
    for i in range(20):
        for j in range(20):
            w = 100.0
            x0, z0 = -1000.0 + i * w, -1000.0 + j * w
            scene.add_box([x0, 0.0, z0],
                          [x0 + w, rnd.uniform(1, 101), z0 + w], ground)

    scene.add_quad([123, 554, 147], [300, 0, 0], [0, 0, 265],
                   scene.add_diffuse_light([7, 7, 7]))
    scene.add_sphere_moving([400, 400, 200], [30, 0, 0], 50,
                            scene.add_lambertian([0.7, 0.3, 0.1]))
    glass = scene.add_dielectric(1.5)
    scene.add_sphere([260, 150, 45], 50, glass)
    scene.add_sphere([0, 150, 145], 50, scene.add_metal([0.8, 0.8, 0.9], 1.0))
    scene.add_sphere([360, 150, 145], 70, glass)
    scene.add_sphere([360, 150, 145], 70, glass,
                     constant_medium(0.2, [0.2, 0.4, 0.9]))
    scene.add_sphere([0, 0, 0], 5000, glass,
                     constant_medium(0.0001, [1, 1, 1]))
    scene.add_sphere([220, 280, 300], 80,
                     scene.add_texture_mat(scene.add_noise_tex(0.2, 1)))

    for i in range(len(scene.primitives)):
        scene.add_node(None, i)

    # 1000-sphere cluster under one rotated+translated graph node.
    white = scene.add_lambertian([0.73, 0.73, 0.73])
    cluster = [
        scene.add_sphere([rnd.uniform(0, 165) for _ in range(3)], 10, white)
        for _ in range(1000)
    ]
    scene.add_node({
        "transform": transform([-100, 270, 395], [15, 0, 1, 0]),
        "children": [{"primitive": i} for i in cluster],
    })

    scene.camera.update(center=[478, 278, -600], look_at=[278, 278, 0])
    return scene


def cornell_box_corpus() -> SceneBuilder:
    """The corpus Cornell box: ``cornell_box_original``'s walls and boxes
    with the book's light, a quad at (343, 554, 332), u = (-130, 0, 0),
    v = (0, 0, -105), radiance 15 (mean linear radiance 0.15941 at 600²,
    depth 50, 32,768 spp: ``renders/cornell32k_mega.npy``)."""
    scene = cornell_box_original()
    light = scene.add_diffuse_light([15, 15, 15])
    for prim in scene.primitives:
        if prim["type"] == "quad" and prim["q"] == [113, 554, 127]:
            prim.update(q=[343, 554, 332], u=[-130, 0, 0], v=[0, 0, -105], material=light)
    return scene


def book1_final(rng_seed: int = 0) -> SceneBuilder:
    """The final scene of book 1 (Ray Tracing in One Weekend, §14.1) from a
    seeded stream: a ground sphere, a 22×22 grid of small random diffuse,
    metal and glass spheres, and three large spheres, through a defocused
    camera. About 485 spheres."""
    rnd = np.random.RandomState(rng_seed)
    scene = SceneBuilder()
    scene.add_sphere([0, -1000, 0], 1000, scene.add_lambertian([0.5, 0.5, 0.5]))
    for a in range(-11, 11):
        for b in range(-11, 11):
            choose = rnd.uniform()
            center = [a + 0.9 * rnd.uniform(), 0.2, b + 0.9 * rnd.uniform()]
            if np.linalg.norm(np.subtract(center, [4, 0.2, 0])) <= 0.9:
                continue
            if choose < 0.8:
                mat = scene.add_lambertian((rnd.uniform(size=3) * rnd.uniform(size=3)).tolist())
            elif choose < 0.95:
                mat = scene.add_metal(rnd.uniform(0.5, 1.0, size=3).tolist(),
                                      float(rnd.uniform(0.0, 0.5)))
            else:
                mat = scene.add_dielectric(1.5)
            scene.add_sphere(center, 0.2, mat)
    scene.add_sphere([0, 1, 0], 1.0, scene.add_dielectric(1.5))
    scene.add_sphere([-4, 1, 0], 1.0, scene.add_lambertian([0.4, 0.2, 0.1]))
    scene.add_sphere([4, 1, 0], 1.0, scene.add_metal([0.7, 0.6, 0.5], 0.0))
    for i in range(len(scene.primitives)):
        scene.add_node(None, i)
    scene.background_color = [0.7, 0.8, 1.0]
    scene.camera = {"fov": 20, "center": [13, 2, 3], "look_at": [0, 0, 0],
                    "defocus_angle": 0.6, "focus_distance": 10.0,
                    "width": 600, "aspect_ratio": 1.0}
    return scene


CANNED = {
    "cornell_original": cornell_box_original,
    "cornell_corpus": cornell_box_corpus,
    "cornell_volume": cornell_box_volume,
    "book1_final": book1_final,
    "book2_final": book2_final,
}
# The scenes drawn from a seeded stream (--seed).
SEEDED = ("book1_final", "book2_final")


def build(name: str, seed: int = 0) -> SceneBuilder:
    """The canned scene ``name`` (``CANNED``); ``seed`` draws the seeded ones."""
    return CANNED[name](seed) if name in SEEDED else CANNED[name]()


def load(arg: str, seed: int = 0):
    """(host scene, dims, label) of ``arg``: a canned scene's name (built in
    the process), or the path of a scene JSON."""
    from raytrace2_tpu_torch.scene import loader

    if arg not in CANNED:
        scene, dims = loader.load_scene(arg)
        return scene, dims, arg
    with tempfile.TemporaryDirectory() as work:
        path = os.path.join(work, f"{arg}.json")
        build(arg, seed).write_json(path)
        scene, dims = loader.load_scene(path)
    return scene, dims, f"make_scene.{CANNED[arg].__name__} (built in-process)"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="make_scene")
    p.add_argument("--scene", default="cornell_original", choices=sorted(CANNED))
    p.add_argument("--name", default=None, help="output scene name")
    p.add_argument("--root", default=".", help="directory for local/data + local/output")
    p.add_argument("--samples", type=int, default=10)
    p.add_argument("--depth", type=int, default=50)
    p.add_argument("--seed", type=int, default=0, help="book 1 / book 2 stream seed")
    p.add_argument("--device", default="cuda",
                   help="the port CLI's render device (cuda, or cpu for the plain versions)")
    p.add_argument("-p", "--binary", default=None,
                   help="external renderer binary (the reference workflow); by default "
                        "the port's CLI renders in process")
    p.add_argument("--no-run", action="store_true", help="only write the JSON")
    args = p.parse_args(argv)

    data_dir = os.path.join(args.root, "local", "data")
    os.makedirs(data_dir, exist_ok=True)
    settings = {
        "render_once": True,
        "save_after_render_once": True,
        "num_samples": args.samples,
        "max_depth": args.depth,
        "render_window": False,
    }
    with open(os.path.join(data_dir, "settings.json"), "w") as f:
        json.dump(settings, f, indent=2)

    name = args.name or args.scene
    scene = build(args.scene, args.seed)
    json_path = os.path.join(data_dir, f"{name}.json")
    scene.write_json(json_path)
    print(f"wrote {json_path}")

    if args.no_run:
        return 0
    if args.binary:
        return subprocess.run([args.binary, json_path]).returncode
    from raytrace2_tpu_torch.app import main as app_main

    return app_main([json_path, "--root", args.root, "--device", args.device])


if __name__ == "__main__":
    raise SystemExit(main())
