"""The control: the reference in bfloat16, put in the program's place, is
not correct under each cell's limits (at a size a test run holds; on the
card at the cells' own sizes with ``python3 -m rtbench.calibrate``)."""

from __future__ import annotations

import pytest

from rtbench import harness
from rtbench.tests._tiny import run_cpu


@pytest.mark.parametrize("cell", ["cornell600.final", "cornell600.live", "cornell600.grad"])
def test_control_fails_the_limits(cell):
    run, result, _ = run_cpu(cell, overrides={"width": 16, "height": 16, "samples": 16})
    assert result["correct"]
    control = harness.mode_module(run.traffic["mode"]).control(run)
    limits = harness.read_json(harness.PKG / "limits" / f"{cell}.json")
    ok, checks = harness.compare(control, limits)
    assert not ok, checks
