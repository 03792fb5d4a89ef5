"""The port's wavefront tools on the CPU at small sizes: ``sweep_wavefront``
(gather and multi give one image), ``dump_wavefront_states`` then
``microbench_wavefront`` and ``analyze_sweep`` on the dump, and the JAX
options with no meaning on the card refused."""

import json

import numpy as np
import pytest

from raytrace2_tpu_torch.ops.kernels import wavefront as wf
from raytrace2_tpu_torch.tools import (analyze_sweep, dump_wavefront_states,
                                       microbench_wavefront, sweep_wavefront)


def test_sweep_gather_and_multi(tmp_path, capsys):
    out = tmp_path / "sweep.jsonl"
    assert sweep_wavefront.main(["cornell_original", "--device", "cpu", "--res", "8", "--spp",
                                 "2", "--keys", "pos,depth", "--kb", "2", "--sort-every", "1",
                                 "--sort-impl", "gather,multi", "--out", str(out)]) == 0
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert [(r["key"], r["sort_impl"]) for r in recs] == [
        ("pos", "gather"), ("pos", "multi"), ("depth", "gather"), ("depth", "multi")]
    assert all(r["same_image"] and r["mean"] > 0 for r in recs)
    assert "BEST:" in capsys.readouterr().out


@pytest.mark.parametrize("tool,argv", [(sweep_wavefront, ["--sublanes", "8"]),
                                       (sweep_wavefront, ["--state-packed", "1"]),
                                       (dump_wavefront_states, ["--out", "x", "--sublanes", "8"])])
def test_tpu_options_refused(tool, argv, capsys):
    with pytest.raises(SystemExit) as e:
        tool.main(["--device", "cpu", *argv])
    assert e.value.code == 2 and "no meaning on the card" in capsys.readouterr().err


def test_dump_microbench_and_analyze(tmp_path, capsys):
    """Book 2 at 16², 2 spp: three sorted states dumped; the microbench on
    the last (its multi sort checked against the gather); the analysis of
    the dumps counts both sweeps of both clustered families."""
    d = tmp_path / "states"
    assert dump_wavefront_states.main(["--device", "cpu", "--res", "16", "--spp", "2",
                                       "--bounces", "3", "--out", str(d)]) == 0
    z = np.load(d / "state_02.npz")
    assert set(wf.STATE_KEYS) <= set(z.files) and float(z["n_samples"]) == 2.0
    assert microbench_wavefront.main(["--device", "cpu", "--res", "16", "--spp", "2",
                                      "--state", str(d / "state_02.npz"), "--reps", "1"]) == 0
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rec["n_rays"] == 256 and rec["alive"] > 0
    assert all(rec[k] > 0 for k in ("keys_ms", "sort_multi_ms", "step_k1_ms"))
    recs = analyze_sweep.analyze(str(d), "book2_final", max_groups=3)
    assert [r["file"] for r in recs] == ["state_00.npz", "state_01.npz", "state_02.npz"]
    live = recs[2]
    assert live["groups"] == 3
    for fam in ("sph", "box"):
        assert live[fam]["bvh_nodes/group"] >= 1 and live[fam]["hier_tests/group"] >= 1
