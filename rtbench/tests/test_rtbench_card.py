"""Card tests: a short run of each cell is correct, and the control fails,
at the cells' own sizes. They skip without a card (decided in the fixture)."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest
import torch

from rtbench import harness

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_is_correct(cuda, cell):
    out = subprocess.run([sys.executable, "-m", "rtbench.run", "--workload", cell,
                          "--seed", "2147483659", "--seconds", "3", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_card(cuda, cell):
    run = harness.make_run(cell, 2147483661, 3.0, False)
    harness.execute(run, time.perf_counter())
    control = harness.mode_module(run.traffic["mode"]).control(run)
    ok, checks = harness.compare(control, harness.read_json(
        harness.PKG / "limits" / f"{cell}.json"))
    assert not ok, checks
