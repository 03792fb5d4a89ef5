"""The roofline arithmetic on known counts, and the reduction of a trace."""

from __future__ import annotations

import types

import pytest

from rtbench import roofline, trace


def test_segment_ops_counts_shading_and_the_hit_record():
    seg = {"sphere": 10, "quad": 5, "box": 2, "medium": 1, "miss": 4}
    fwd = 10 * 155 + 5 * 166 + 2 * 148 + 1 * 205 + 4 * 120
    assert roofline.segment_ops(seg) == fwd
    assert roofline.segment_ops(seg, adjoint=True) == fwd + 60 * 22


def test_least_time_takes_the_larger_bound():
    assert roofline.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.least_seconds(67e9, 6.7e12) == pytest.approx(2.0)


def test_share_of_a_kernel():
    run = types.SimpleNamespace(
        trace_summary={"kernels": {"megakernel_v4": 0.010}, "window_s": 0.02, "busy_s": 0.01},
        traced_work={"segments": {"quad": 1e9, "miss": 0}, "units": 2,
                     "table_bytes": 1000, "output_bytes": 4_320_000, "spp": 128})
    ops = 1e9 * 166
    assert roofline.kernel_share(run, "megakernel_v4") == pytest.approx(
        100 * (ops / 67e12) / 0.010)
    assert roofline.kernel_share(run, "wavefront_step") is None


def test_kernel_key_strips_signature():
    assert trace.kernel_key("megakernel_v4(float const*, int)") == "megakernel_v4"
    assert trace.kernel_key("void wavefront_step<2>(float*)") == "wavefront_step"
    assert trace.kernel_key("megakernel_v4_wave") == "megakernel_v4_wave"
    assert trace.kernel_key("void (anonymous namespace)::megakernel_grad<2>(float const*, "
                            "int)") == "megakernel_grad"


def test_summarize_busy_gaps_and_ops():
    ev = [
        {"ph": "X", "cat": "kernel", "name": "k1(int)", "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "k1(int)", "ts": 50.0, "dur": 100.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 400.0, "dur": 100.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 160.0, "dur": 200.0},
        {"ph": "X", "cat": "user_annotation", "name": "Renderer.update", "ts": 100.0,
         "dur": 300.0},
    ]
    s = trace.summarize(ev, window_s=1000e-6)
    assert s["busy_s"] == pytest.approx(250e-6)
    assert s["kernels"]["k1"] == pytest.approx(200e-6)
    assert s["device_ops"][0] == ["k1", pytest.approx(200e-6)]
    name, secs = s["idle_gaps"][0]
    assert secs == pytest.approx(500e-6) and name == "host outside any operation"
    name, secs = s["idle_gaps"][1]
    assert secs == pytest.approx(250e-6) and name == "Renderer.update > aten::item"


def test_summarize_without_device_events_reads_nothing():
    s = trace.summarize([{"ph": "X", "cat": "cpu_op", "name": "x", "ts": 0, "dur": 1}], 1.0)
    assert s["busy_s"] == 0.0 and s["kernels"] == {}
