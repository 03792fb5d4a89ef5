"""The benchmark's smoke-and-fog Cornell configuration, made once into
``configs/cornell_volume600.json``.

A frozen copy of ``cornell_box_volume`` of
``raytrace2_tpu_torch/tools/make_scene.py``, kept here so that a later
change to the program's builder cannot change the benchmark's scene;
``SceneBuilder`` is ``rtbench.scenes``'. Nothing imports this module while a
cell runs: the configuration file holds the scene JSON it made. Rewrite it
with

    python3 -m rtbench.scenes_volume
"""

from __future__ import annotations

import json

from rtbench.scenes import CONFIG_DIR, SceneBuilder, constant_medium, transform

NAME = "cornell_volume600"
SOURCE = ("Ray Tracing: The Next Week v4, Volumes, cornell_smoke(): 600x600, 200 spp, "
          "max_depth 50; Raytrace2 make_scene.py:324-329 cornell_box_volume, max_depth 50 "
          "(:348)")


def cornell_box_volume() -> SceneBuilder:
    """The Cornell box with smoke and fog (*The Next Week*, "Volumes"): the
    short box (165³, rotated -18°, moved to (130, 0, 65)) holds a white fog
    and the tall one (165 × 330 × 165, rotated 15°, moved to (265, 0, 295))
    a black smoke, both of density 0.01, inside the six walls with the
    330 × 305 light at radiance 7. 6 quads and 2 medium boxes."""
    scene = SceneBuilder()
    short = scene.add_box([0, 0, 0], [165, 165, 165], 0, constant_medium(0.01, [1, 1, 1]))
    tall = scene.add_box([0, 0, 0], [165, 330, 165], 0, constant_medium(0.01, [0, 0, 0]))
    scene.add_node({"transform": transform([130, 0, 65], [-18, 0, 1, 0]), "primitive": short})
    scene.add_node({"transform": transform([265, 0, 295], [15, 0, 1, 0]), "primitive": tall})
    green = scene.add_lambertian([0.12, 0.45, 0.15])
    red = scene.add_lambertian([0.65, 0.05, 0.05])
    white = scene.add_lambertian([0.73, 0.73, 0.73])
    light = scene.add_diffuse_light([7, 7, 7])
    walls = [([555, 0, 0], [0, 555, 0], [0, 0, 555], green),
             ([0, 0, 0], [0, 555, 0], [0, 0, 555], red),
             ([113, 554, 127], [330, 0, 0], [0, 0, 305], light),
             ([0, 0, 0], [555, 0, 0], [0, 0, 555], white),
             ([0, 555, 0], [555, 0, 0], [0, 0, 555], white),
             ([0, 0, 555], [555, 0, 0], [0, 555, 0], white)]
    for q, u, v, m in walls:
        scene.add_node(None, scene.add_quad(q, u, v, m))
    scene.camera.update(center=[278, 278, -800], look_at=[278, 278, 0], fov=40)
    return scene


def config() -> dict:
    """The configuration: the book's frame, samples and depth, whole."""
    return {
        "name": NAME,
        "source": SOURCE,
        "width": 600, "height": 600, "depth": 50, "samples": 200,
        "reduced": [],
        "reduced_how": "",
        "assumed": {
            "scene": ("make_scene.cornell_box_volume's, which follows Raytrace2's "
                      "make_scene.py:324-329, since the upstream's data file for this scene "
                      "is not at hand"),
            "samples": ("200, the book's (cornell_smoke(): samples_per_pixel 200): the "
                        "upstream's settings give this scene no sample count"),
        },
        "scene": cornell_box_volume().to_json(),
    }


def main() -> None:
    path = CONFIG_DIR / f"{NAME}.json"
    path.write_text(json.dumps(config(), indent=1) + "\n")
    print(path)


if __name__ == "__main__":
    main()
