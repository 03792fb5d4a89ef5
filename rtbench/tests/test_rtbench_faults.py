"""Each fault that a cell can have, planted under a run that skips only
the look for a card, turns ``correct`` false."""

from __future__ import annotations

import pytest
import torch

from raytrace2_tpu_torch import grad as G, render
from raytrace2_tpu_torch.ops import integrator
from rtbench import harness
from rtbench.tests._tiny import run_cpu

IMAGE_CELLS = ["cornell600.final", "cornell600.live"]
# A size at which the light shows in the checked pixels: where they are all
# black, a fault that changes which samples are summed reads nothing.
LIT = {"width": 16, "height": 16, "samples": 16}


def _unchanged(monkeypatch):
    """A step that returns its state unchanged: nothing is accumulated."""
    def step(scene, features, state, seed, n_samples=1, **kw):
        state.frame_idx += int(n_samples)
        return state
    monkeypatch.setattr(render, "render_step", step)


def _half(monkeypatch):
    """Half of the batch left out and the mean taken over the rest: a batch
    renders its first half of the samples and counts them twice (a 1-spp
    frame renders alternate frames twice)."""
    orig = integrator.render_progressive
    calls = {"n": 0}

    def half(scene, features, width, height, sample0, n_samples, seed, max_depth, sqrt_spp,
             **kw):
        calls["n"] += 1
        if n_samples == 1:
            s0 = sample0 - (calls["n"] % 2)
            return orig(scene, features, width, height, max(s0, 0), 1, seed, max_depth,
                        sqrt_spp, **kw)
        h = max(n_samples // 2, 1)
        out = orig(scene, features, width, height, sample0, h, seed, max_depth, sqrt_spp, **kw)
        return out * (n_samples / h)
    monkeypatch.setattr(integrator, "render_progressive", half)


def _altered(monkeypatch):
    """An answer altered where it is produced: the display conversion."""
    orig = render.display_image

    def display(state):
        out = orig(state)
        return torch.where(out < 250, out + 3, out)
    monkeypatch.setattr(render, "display_image", display)


@pytest.mark.parametrize("cell", IMAGE_CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
def test_image_fault_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    _, result, _ = run_cpu(cell, seconds=0.3, overrides=LIT)
    assert not result["correct"], result["checks"]


def _grad_unchanged(monkeypatch):
    """A step that returns its state unchanged: no gradient reaches Adam."""
    orig = G.value_and_grad_scene

    def vg(loss_fn, scene, features, seed, **kw):
        loss, g = orig(loss_fn, scene, features, seed, **kw)
        return loss, G.schema.map_leaves(g, lambda x: None if x is None else torch.zeros_like(x))
    monkeypatch.setattr(G, "value_and_grad_scene", vg)


def _grad_half(monkeypatch):
    """Half of the batch left out: the gradient's image of half its samples."""
    orig = G.render_image

    def half(scene, features, seed, *, n_samples, **kw):
        return orig(scene, features, seed, n_samples=max(n_samples // 2, 1), **kw)
    monkeypatch.setattr(G, "render_image", half)


def _grad_altered(monkeypatch):
    """An answer altered where it is produced: the loss."""
    orig = G.value_and_grad_scene

    def vg(*a, **kw):
        loss, g = orig(*a, **kw)
        return loss * 1.01, g
    monkeypatch.setattr(G, "value_and_grad_scene", vg)


@pytest.mark.parametrize("fault", [_grad_unchanged, _grad_half, _grad_altered])
def test_grad_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    _, result, _ = run_cpu("cornell600.grad", seconds=0.2)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", IMAGE_CELLS + ["cornell600.grad"])
def test_faults_planted_in_the_reference_fail_the_limits(cell):
    """The faults as ``rtbench.calibrate`` reads them on the card, at the
    cells' own sizes: the reference put in the program's place."""
    run, result, _ = run_cpu(cell, seconds=0.3, overrides=LIT)
    assert result["correct"], result["checks"]
    limits = harness.read_json(harness.PKG / "limits" / f"{cell}.json")
    readings = harness.mode_module(run.traffic["mode"]).faults(run)
    assert set(readings) == {"unchanged", "half", "altered"}
    for name, numbers in readings.items():
        ok, checks = harness.compare(numbers, limits)
        assert not ok, (name, checks)
