"""The port's tools on the CPU: ``make_scene`` against ``tools/make_scene.py``
(the JSON of every shared builder, equal), the corpus Cornell, the runner;
``validate`` (its golden gate fails at 1 spp and the tool says so with its
exit code; the ladder steps), ``check_table_grad`` and ``bench_big_grad``
at small sizes; and every tool refusing without a card."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from raytrace2_tpu_torch.tools import (bench_big_grad, check_table_grad, dump_wavefront_states,
                                       make_scene, microbench_wavefront, sweep_wavefront,
                                       validate)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jax_make_scene(monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(ROOT, "tools"))
    import make_scene as jax_side

    return jax_side


@pytest.mark.parametrize("name,args", [("cornell_box_original", ()),
                                       ("cornell_box_volume", ()),
                                       ("book2_final", (0,)), ("book2_final", (3,))])
def test_make_scene_json_equals_tools(jax_make_scene, name, args):
    ours = getattr(make_scene, name)(*args).to_json()
    assert json.dumps(ours) == json.dumps(getattr(jax_make_scene, name)(*args).to_json())


def test_corpus_cornell_and_book1(tmp_path):
    """The corpus Cornell is the original's with the book's light (one quad
    moved, radiance 15); book 1 is the seeded stream of test_torch_scenes."""
    corpus, orig = make_scene.cornell_box_corpus().to_json(), \
        make_scene.cornell_box_original().to_json()
    diff = [(a, b) for a, b in zip(corpus["primitives"], orig["primitives"]) if a != b]
    assert len(diff) == 1 and diff[0][0]["q"] == [343, 554, 332]
    assert corpus["materials"][diff[0][0]["material"]] == {"type": "diffuse_light",
                                                           "albedo": [15, 15, 15]}
    scene, _, label = make_scene.load("book1_final")
    assert "book1_final" in label and 450 < int(np.asarray(scene.spheres.active).sum()) < 500
    assert make_scene.main(["--scene", "cornell_corpus", "--no-run", "--root",
                            str(tmp_path)]) == 0
    path = tmp_path / "local" / "data" / "cornell_corpus.json"
    assert json.loads(path.read_text()) == corpus
    assert json.loads((tmp_path / "local" / "data" / "settings.json").read_text())[
        "max_depth"] == 50


def test_tools_refuse_without_a_card(tmp_path, monkeypatch, capsys):
    """Each tool asks for CUDA by default and exits 1 without it; the
    runner of make_scene launches the port's CLI, which does the same."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((validate.main, ["--out", str(tmp_path / "v")]),
                       (check_table_grad.main, []), (bench_big_grad.main, []),
                       (sweep_wavefront.main, []), (microbench_wavefront.main, []),
                       (dump_wavefront_states.main, ["--out", str(tmp_path / "d")]),
                       (make_scene.main, ["--root", str(tmp_path), "--samples", "1"])):
        assert main(argv) == 1, main
    assert "CUDA device requested" in capsys.readouterr().err


def test_validate_on_cpu(tmp_path):
    """The golden step at 60², 1 spp (far from converged: the gate fails and
    the tool exits 1, the ladder having run) and two ladder steps at 8²."""
    out = tmp_path / "v"
    assert validate.main(["--device", "cpu", "--res", "60", "--golden-spp", "1",
                          "--bench-res", "8", "--bench-spp", "1", "--out", str(out),
                          "--steps", "golden,cornell_mega,cornell_xla"]) == 1
    res = json.loads((out / "results.json").read_text())
    assert res["failed"] == ["golden"]
    g = res["golden"]
    assert g["route"] == "kernel" and 0.1 < g["mean"] < 0.2 and g["block_psnr_db"] < 40
    assert (res["cornell_mega"]["route"], res["cornell_xla"]["route"]) == ("kernel", "xla")
    assert (out / "cornell_golden.png").exists() and (out / "cornell_xla.png").exists()
    assert validate.main(["--device", "cpu", "--steps", "nope", "--out", str(out)]) == 2
    golden = np.load(validate.GOLDEN)
    assert abs(float(golden.mean()) - validate.GOLDEN_MEAN) < 1e-5
    assert validate.block_psnr(golden[::10, ::10], golden) > 20.0
    with pytest.raises(ValueError, match="whole blocks"):
        validate.block_psnr(golden[:50, :50], golden)


def test_gradient_tools_on_cpu(capsys):
    """check_table_grad at its 64², depth 3 (AD against FD of the three
    leaves, plain replay); bench_big_grad on book 2 at 8², depth 4."""
    assert check_table_grad.main(["--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["leaf"] for r in lines[:3]] == ["tex_scale", "sphere_z", "tex_albedo_r"]
    assert lines[-1]["all_ok"] is True
    assert bench_big_grad.main(["--device", "cpu", "--res", "8", "--spp", "1", "--depth", "4",
                                "--steps", "1", "--fd-res", "8"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0]["kernel_route"] is True and lines[1]["grad_finite"] is True
    assert lines[-1] == {"all_ok": True}
    assert check_table_grad.agrees(1e-6, -2e-6) and not check_table_grad.agrees(1.0, -1.0)
    assert not check_table_grad.agrees(float("nan"), 1.0)
