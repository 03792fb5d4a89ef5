"""The harness finds every piece of a cell by its name, and a cell added as
files only (a traffic mix, its limits, an entry in BENCHMARK.json) runs with
no code edited."""

from __future__ import annotations

import json
import shutil

import pytest

from rtbench import harness
from rtbench.tests._tiny import run_cpu

BENCH = harness.load_benchmark()


def test_every_named_piece_has_its_file():
    for cfg in BENCH["configs"]:
        assert (harness.ROOT / cfg["file"]).is_file()
    for cell in BENCH["workloads"]:
        assert (harness.PKG / "configs" / f"{cell['config']}.json").is_file()
        traffic = harness.read_json(harness.PKG / "traffic" / f"{cell['traffic']}.json")
        mode = harness.mode_module(traffic["mode"])
        for fn in ("setup", "window", "release", "check", "control", "traced_work"):
            assert callable(getattr(mode, fn))
        limits = harness.read_json(harness.PKG / "limits" / f"{cell['name']}.json")
        assert limits and all(v > 0 for v in limits.values())
    for metric in BENCH["per_layer"]:
        reader = harness.load_file_module(harness.PKG / "metrics" / f"{metric['name']}.py")
        assert callable(reader.read)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_spec_lists_its_metrics(cell):
    spec = harness.cell_spec(BENCH, cell)
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert m["moves"] in names


def test_metric_counters_are_read_by_name():
    names = []
    for metric in BENCH["per_layer"]:
        reader = harness.load_file_module(harness.PKG / "metrics" / f"{metric['name']}.py")
        names += list(getattr(reader, "COUNTERS", ()))
    assert names
    values = harness.counter_reader(names)()
    assert set(values) == set(names)
    assert all(isinstance(v, int) for v in values.values())


def test_unknown_cell_is_refused():
    with pytest.raises(harness.CellError):
        harness.cell_spec(BENCH, "no.such.cell")


def test_cell_added_as_files_runs(tmp_path):
    pkg = tmp_path / "rtbench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(harness.PKG / sub, pkg / sub)
    traffic = harness.read_json(pkg / "traffic" / "final.json")
    (pkg / "traffic" / "final_b6.json").write_text(json.dumps(dict(traffic, batch_spp=6)))
    (pkg / "limits" / "cornell600.final.b6.json").write_text(
        (pkg / "limits" / "cornell600.final.json").read_text())
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "cornell600.final.b6", "config": "cornell600",
                               "traffic": "final_b6", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "cornell600.final" in m.get("workloads", []):
            m["workloads"].append("cornell600.final.b6")
    run, result, _ = run_cpu("cornell600.final.b6", bench=bench, pkg=pkg,
                             overrides={"batch_spp": 6, "samples": 12})
    assert result["correct"]
    assert run.tracer is not None and set(result["metrics"]) == {"mpaths_per_s", "setup_s"}
    assert result["attempted"] >= 1
