"""The benchmark's book-1 configuration, made once into ``configs/book1_1200.json``.

A frozen copy of ``book1_final`` of ``raytrace2_tpu_torch/tools/make_scene.py``,
kept here so that a later change to the program's builder cannot change the
benchmark's scene; ``SceneBuilder`` is ``rtbench.scenes``'. Nothing imports
this module while a cell runs: the configuration file holds the scene JSON
it made. Rewrite it with

    python3 -m rtbench.scenes_book1
"""

from __future__ import annotations

import json

import numpy as np

from rtbench.scenes import CONFIG_DIR, SceneBuilder

NAME = "book1_1200"
SOURCE = ("Ray Tracing in One Weekend v4 §14.1 final render: 1200x675, 500 spp, depth 50, "
          "vfov 20, defocus 0.6; Raytrace2 data/final_render_book_1.json (484 spheres)")


def book1_final(rng_seed: int = 0) -> SceneBuilder:
    """The final scene of book 1 (Ray Tracing in One Weekend, §14.1) from a
    seeded stream: a ground sphere, a 22×22 grid of small random diffuse,
    metal and glass spheres, and three large spheres, through a defocused
    camera. 486 spheres from seed 0."""
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


def config() -> dict:
    """The configuration: the book's frame, samples and depth, whole. The
    scene JSON is ``book1_final(0)``'s as the program's builder writes it;
    its camera's ``width`` and ``aspect_ratio`` are the builder's and size
    nothing here, since a run renders ``width`` × ``height``."""
    return {
        "name": NAME,
        "source": SOURCE,
        "width": 1200, "height": 675, "depth": 50, "samples": 500,
        "reduced": [],
        "reduced_how": "",
        "assumed": {
            "spheres": ("book1_final(0): the book's generator drawn from seed 0, since the "
                        "upstream data/final_render_book_1.json (484 spheres) is not at "
                        "hand: 482 small spheres here, with the ground and the three large "
                        "ones 486 sphere records"),
            "sky": ("a constant background [0.7, 0.8, 1.0]: the upstream scene format has "
                    "only a constant background_color, where the book blends a gradient"),
            "camera": ("the book's: fov 20, center (13, 2, 3), look_at the origin, "
                       "defocus_angle 0.6, focus_distance 10"),
        },
        "scene": book1_final(0).to_json(),
    }


def main() -> None:
    path = CONFIG_DIR / f"{NAME}.json"
    path.write_text(json.dumps(config(), indent=1) + "\n")
    print(path)


if __name__ == "__main__":
    main()
