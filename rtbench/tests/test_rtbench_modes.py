"""A tiny CPU run of each traffic mode through the program's plain
versions: the check holds under the cells' own limits, and a traced run
reads its per-layer metrics where the CPU gives something to read."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from raytrace2_tpu_torch.render import Renderer
from rtbench import harness, imagecheck
from rtbench.reference import pathtrace
from rtbench.tests._tiny import run_cpu


@pytest.mark.parametrize("cell", ["cornell600.final", "cornell600.live", "cornell600.grad"])
def test_mode_runs_and_checks(cell):
    run, result, lines = run_cpu(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in run.cell["end_to_end"]}
    assert list(result)[-1] == "checks" and len(lines) == len(result["checks"])


def test_book2_final_runs_and_checks():
    run, result, _ = run_cpu("book2_600.final", seconds=0.01,
                             overrides={"width": 8, "height": 8, "batch_spp": 1, "samples": 2})
    assert result["correct"], result["checks"]
    assert run.window["jobs"][-1]["frames"] >= 1


def test_final_jobs_restart_with_a_new_seed():
    run, result, _ = run_cpu("cornell600.final", seconds=1.0,
                             overrides={"samples": 4, "batch_spp": 4})
    jobs = run.window["jobs"]
    assert len(jobs) >= 2 and len({j["seed"] for j in jobs}) == len(jobs)
    assert result["correct"]


def test_grad_check_replays_steps_of_the_window():
    run, result, _ = run_cpu("cornell600.grad", seconds=0.3)
    assert result["correct"], result["checks"]
    first, win = run.window["replays"]["first"], run.window["replays"]["window"]
    assert first["k0"] == 1 and len(first["loss"]) == int(run.traffic["check_steps"])
    assert win["k0"] > len(first["loss"]) and len(win["loss"]) == 2
    assert win["k0"] + 1 <= len(first["loss"]) + result["attempted"]
    assert float(win["m0"].abs().sum()) > 0


@pytest.mark.parametrize("cell", ["cornell600.final", "cornell600.grad", "cornell600.live"])
def test_traced_run_reports_per_layer_metrics(cell):
    run, result, _ = run_cpu(cell, seconds=0.6, trace=True)
    assert result["correct"]
    names = {m["name"] for m in run.cell["per_layer"]}
    assert set(result["metrics"]) <= names
    assert run.traced_work is not None and run.traced_work["units"] >= 1
    assert sum(run.traced_work["segments"].values()) > 0


def test_reference_matches_the_plain_render_bitwise_on_cornell():
    run = harness.make_run("cornell600.final", 11, 1.0, False, device="cpu",
                           overrides={"width": 10, "height": 10})
    renderer = Renderer(run.program_scene(), 10, 10, num_samples=100, max_depth=50, seed=5,
                        device="cpu")
    renderer.update(3)
    tables, cv, _ = run.reference()
    sums, _ = pathtrace.pixel_sums(tables, cv, torch.arange(100), 0, 3, seed=5, width=10,
                                   depth=50, sqrt_spp=10)
    prog = renderer.state.accum.reshape(-1, 3).double().numpy()
    np.testing.assert_allclose(prog, sums.numpy(), rtol=1e-6, atol=1e-6)
    disp = renderer.display_pixels().reshape(-1, 3)
    assert np.array_equal(disp, imagecheck.display_u8(sums.numpy(), 3))
