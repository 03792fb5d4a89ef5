"""The port's bench (``raytrace2_tpu_torch/tools/bench.py``) on the CPU at a
tiny size: both modes print the JAX bench's record (its keys and metric
names, ``bench.py:134-143`` and ``:200-213``) with a positive value, and
``main`` runs the JAX bench's workload and refuses a missing card."""

import json

import pytest
import torch

from raytrace2_tpu_torch.tools import bench

# The keys of the JAX bench's JSON line.
JAX_KEYS = ["metric", "unit", "value", "vs_baseline"]


@pytest.fixture(scope="module")
def cornell():
    scene, dims, name = bench.load_scene(None)
    assert dims == (600, 600) and "cornell_box_original" in name
    return scene


@pytest.mark.parametrize("mode", ["forward", "grad"])
def test_bench_record(cornell, mode):
    """8x8, depth 2, 1-2 samples on the CPU (the kernels' plain versions),
    no calibration run: one JSON-serialisable record with JAX's keys, its
    metric name and a positive rate; vs_baseline against 1.17e6 paths/s,
    depth-scaled for the gradient."""
    cpu = torch.device("cpu")
    if mode == "forward":
        rec = bench.measure_forward(cornell, cpu, width=8, height=8, max_depth=2, prelim=2,
                                    target_s=0.0, log=lambda m: None)
        assert rec["metric"] == "cornell600_paths_per_sec"
        base = bench.BASELINE_PATHS_PER_SEC
    else:
        rec = bench.measure_grad(cornell, cpu, width=8, height=8, max_depth=2, n_samples=2,
                                 prelim=1, target_s=0.0, log=lambda m: None)
        assert rec["metric"] == "cornell600_fwdbwd_d2_paths_per_sec"
        base = bench.BASELINE_PATHS_PER_SEC * 50 / 2
    line = json.dumps(rec)
    assert "\n" not in line and sorted(json.loads(line)) == JAX_KEYS
    assert rec["unit"] == "paths/s" and rec["value"] > 0
    assert rec["vs_baseline"] == round(rec["value"] / base, 3)


def test_bench_main(monkeypatch, capsys):
    """main measures the scene at its own size (600x600) with the JAX
    bench's depth, sqrt_spp and gradient batch, and prints only the record
    on stdout; without a card, --device cuda exits 1 and prints nothing."""
    seen = {}

    def fake(kind):
        def run(scene, device, **kw):
            seen[kind] = dict(kw, device=device.type)
            return {"metric": kind, "value": 1.0, "unit": "paths/s", "vs_baseline": 0.0}
        return run

    monkeypatch.setattr(bench, "measure_forward", fake("forward"))
    monkeypatch.setattr(bench, "measure_grad", fake("grad"))
    assert bench.main(["--device", "cpu"]) == 0
    assert bench.main(["--device", "cpu", "--grad", "--grad-depth", "16"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(x)["metric"] for x in lines] == ["forward", "grad"]
    assert seen["forward"] == dict(width=600, height=600, device="cpu")
    assert seen["grad"] == dict(width=600, height=600, max_depth=16,
                                n_samples=bench.GRAD_SAMPLES, device="cpu")
    assert (bench.DEPTH, bench.SQRT_SPP, bench.MAX_BATCH) == (50, 10, 128)
    assert (bench.GRAD_SAMPLES, bench.GRAD_SQRT_SPP) == (64, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 1
    assert capsys.readouterr().out == ""
