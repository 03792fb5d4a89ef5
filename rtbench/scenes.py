"""The benchmark's scenes, made once into ``configs/<name>.json``.

A frozen copy of the scene builder of ``raytrace2_tpu_torch/tools/make_scene.py``
(``SceneBuilder``, ``cornell_box_corpus``, ``book2_final``), kept here so
that a later change to the program's builder cannot change the benchmark's
scenes. Nothing imports this module while a cell runs: the configuration
files hold the scene JSON it made. Rewrite them with

    python3 -m rtbench.scenes
"""

from __future__ import annotations

import json
import random
from pathlib import Path

CONFIG_DIR = Path(__file__).resolve().parent / "configs"


class SceneBuilder:
    """Emits the new-generation scene JSON (the upstream class Scene)."""

    def __init__(self) -> None:
        self.textures: list[dict] = []
        self.materials: list[dict] = []
        self.primitives: list[dict] = []
        self.nodes: list[dict] = []
        self.background_color = [0.0, 0.0, 0.0]
        self.camera = {"fov": 40, "center": [0, 0, 1], "look_at": [0, 0, 0],
                       "width": 600, "aspect_ratio": 1.0}

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

    def add_noise_tex(self, scale, noise_type, albedo=(1, 1, 1)) -> int:
        self.textures.append({"type": "noise", "scale": scale, "noise_type": noise_type,
                              "albedo": list(albedo)})
        return len(self.textures) - 1

    def _primitive(self, record: dict, extra: dict | None) -> int:
        if extra:
            record.update(extra)
        self.primitives.append(record)
        return len(self.primitives) - 1

    def add_sphere(self, center, radius, material, args: dict | None = None) -> int:
        return self._primitive({"type": "sphere", "center": list(center), "radius": radius,
                                "material": material}, args)

    def add_sphere_moving(self, center, displacement, radius, material) -> int:
        return self.add_sphere(center, radius, material, {"displacement": list(displacement)})

    def add_quad(self, q, u, v, material) -> int:
        return self._primitive({"type": "quad", "q": list(q), "u": list(u), "v": list(v),
                                "material": material}, None)

    def add_box(self, a, b, material, args: dict | None = None) -> int:
        return self._primitive({"type": "box", "a": list(a), "b": list(b),
                                "material": material}, args)

    def add_node(self, args: dict | None = None, primitive_idx: int = -1) -> None:
        node = dict(args or {})
        if primitive_idx != -1:
            node["primitive"] = primitive_idx
        self.nodes.append(node)

    def to_json(self) -> dict:
        return {"textures": self.textures, "materials": self.materials,
                "primitives": self.primitives, "scene": self.nodes, "camera": self.camera,
                "background_color": self.background_color}


def constant_medium(density: float, albedo) -> dict:
    return {"constant_medium": {"density": density, "albedo": list(albedo)}}


def transform(translation, rotation) -> dict:
    return {"translation": list(translation), "rotation": list(rotation)}


def cornell_box_corpus() -> SceneBuilder:
    """The Cornell box of *The Next Week* with the book's 130 x 105 light at
    radiance 15 (Raytrace2 data/cornell_original_10000_samples.json)."""
    scene = SceneBuilder()
    green = scene.add_lambertian([0.12, 0.45, 0.15])
    red = scene.add_lambertian([0.65, 0.05, 0.05])
    white = scene.add_lambertian([0.73, 0.73, 0.73])
    dim = scene.add_diffuse_light([7, 7, 7])
    walls = [([555, 0, 0], [0, 555, 0], [0, 0, 555], green),
             ([0, 0, 0], [0, 555, 0], [0, 0, 555], red),
             ([113, 554, 127], [330, 0, 0], [0, 0, 305], dim),
             ([0, 0, 0], [555, 0, 0], [0, 0, 555], white),
             ([0, 555, 0], [555, 0, 0], [0, 0, 555], white),
             ([0, 0, 555], [555, 0, 0], [0, 555, 0], white)]
    for q, u, v, m in walls:
        scene.add_node(None, scene.add_quad(q, u, v, m))
    box_white = scene.add_lambertian([0.73, 0.73, 0.73])
    short = scene.add_box([0, 0, 0], [165, 165, 165], box_white)
    tall = scene.add_box([0, 0, 0], [165, 330, 165], box_white)
    scene.add_node({"transform": transform([130, 0, 65], [-18, 0, 1, 0]), "primitive": short})
    scene.add_node({"transform": transform([265, 0, 295], [15, 0, 1, 0]), "primitive": tall})
    scene.camera.update(center=[278, 278, -800], look_at=[278, 278, 0], fov=40)
    light = scene.add_diffuse_light([15, 15, 15])
    for prim in scene.primitives:
        if prim["type"] == "quad" and prim["q"] == [113, 554, 127]:
            prim.update(q=[343, 554, 332], u=[-130, 0, 0], v=[0, 0, -105], material=light)
    return scene


def book2_final(rng_seed: int = 0) -> SceneBuilder:
    """The final scene of *The Next Week* from a seeded stream: 400 ground
    boxes, a light, a moving sphere, glass, metal, two media, a marble
    sphere and a rotated cluster of 1,000 spheres."""
    rnd = random.Random(rng_seed)
    scene = SceneBuilder()
    ground = scene.add_lambertian([0.48, 0.83, 0.53])
    for i in range(20):
        for j in range(20):
            w = 100.0
            x0, z0 = -1000.0 + i * w, -1000.0 + j * w
            scene.add_box([x0, 0.0, z0], [x0 + w, rnd.uniform(1, 101), z0 + w], ground)
    scene.add_quad([123, 554, 147], [300, 0, 0], [0, 0, 265], scene.add_diffuse_light([7, 7, 7]))
    scene.add_sphere_moving([400, 400, 200], [30, 0, 0], 50,
                            scene.add_lambertian([0.7, 0.3, 0.1]))
    glass = scene.add_dielectric(1.5)
    scene.add_sphere([260, 150, 45], 50, glass)
    scene.add_sphere([0, 150, 145], 50, scene.add_metal([0.8, 0.8, 0.9], 1.0))
    scene.add_sphere([360, 150, 145], 70, glass)
    scene.add_sphere([360, 150, 145], 70, glass, constant_medium(0.2, [0.2, 0.4, 0.9]))
    scene.add_sphere([0, 0, 0], 5000, glass, constant_medium(0.0001, [1, 1, 1]))
    scene.add_sphere([220, 280, 300], 80, scene.add_texture_mat(scene.add_noise_tex(0.2, 1)))
    for i in range(len(scene.primitives)):
        scene.add_node(None, i)
    white = scene.add_lambertian([0.73, 0.73, 0.73])
    cluster = [scene.add_sphere([rnd.uniform(0, 165) for _ in range(3)], 10, white)
               for _ in range(1000)]
    scene.add_node({"transform": transform([-100, 270, 395], [15, 0, 1, 0]),
                    "children": [{"primitive": i} for i in cluster]})
    scene.camera.update(center=[478, 278, -600], look_at=[278, 278, 0])
    return scene


CONFIGS = {
    "cornell600": dict(
        scene=cornell_box_corpus,
        source=("https://github.com/tonadr1022/Raytrace2 data/cornell_original_10000_samples"
                ".json: 600x600, 10,000 spp, depth 50; the Cornell box of Ray Tracing: The "
                "Next Week"),
        reduced=[], assumed={}),
    "book2_600": dict(
        scene=lambda: book2_final(0),
        source=("https://github.com/tonadr1022/Raytrace2 data/book2_final_scene_10000_samples"
                ".json: 600x600, 10,000 spp, 1,408 primitives; the final scene of Ray Tracing: "
                "The Next Week"),
        reduced=["samples"],
        assumed={"depth": "50, the upstream settings' max_depth for its data scenes",
                 "cluster_seed": "0: book2_final's random stream (ground heights, cluster)"}),
}


def config(name: str) -> dict:
    spec = CONFIGS[name]
    return {
        "name": name,
        "source": spec["source"],
        "width": 600, "height": 600, "depth": 50, "samples": 10000,
        "reduced": spec["reduced"],
        "reduced_how": ("a run renders the job's batches in order from sample 0 for as long "
                        "as its window lasts: the first ~1,500 of the 10,000 samples here"
                        if spec["reduced"] else ""),
        "assumed": spec["assumed"],
        "scene": spec["scene"]().to_json(),
    }


def main() -> None:
    for name in CONFIGS:
        path = CONFIG_DIR / f"{name}.json"
        path.write_text(json.dumps(config(name), indent=1) + "\n")
        print(path)


if __name__ == "__main__":
    main()
