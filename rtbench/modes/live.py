"""``live``: the upstream's interactive loop (App.cpp:196-239). One frame is
``Renderer.update(1)`` and the display image read back to the host as u8
pixels; the accumulation runs on through the window, frame after frame.

End to end: ``frame_ms_p95``, the 95th percentile of every frame's time in
the window. Checked: the accumulated image at the window's close, at the
checked pixels. The host's enqueue time of each ``Renderer.update`` (no
sync) is kept for ``render.host_ms_per_frame``.
"""

from __future__ import annotations

import time

from rtbench import harness, imagecheck, stats


def setup(run):
    from raytrace2_tpu_torch.render import Renderer

    renderer = Renderer(run.program_scene(), run.width, run.height,
                        num_samples=int(run.cfg["samples"]), max_depth=run.depth,
                        seed=harness.derived_seed(run.seed, "job", 0), device=run.device)
    renderer.update(1)
    renderer.display_pixels()
    renderer.reset()
    run.sync()
    return {"renderer": renderer}


def window(run, st) -> dict:
    renderer = st["renderer"]
    tracer = run.tracer
    pixels = run.pixels()
    frame_ms, traced_host_ms = [], []
    t0 = time.perf_counter()
    while True:
        tracer.step(time.perf_counter() - t0)
        ta = time.perf_counter()
        with tracer.span("Renderer.update"):
            renderer.update(1)
        tb = time.perf_counter()
        with tracer.span("Renderer.display_pixels"):
            display = renderer.display_pixels()
        tc = time.perf_counter()
        if tracer.active:
            traced_host_ms.append(1e3 * (tb - ta))
        tracer.unit((renderer.seed, renderer.frame_idx - 1, 1, renderer.sqrt_spp))
        frame_ms.append(1e3 * (tc - ta))
        if tc - t0 >= run.seconds and not tracer.active:
            break
    tracer.stop()
    frames = renderer.frame_idx
    job = {"seed": renderer.seed, "frames": frames, "sqrt_spp": renderer.sqrt_spp,
           "pixels": pixels, "display": display.reshape(-1, 3)[pixels.cpu().numpy()],
           "sums": renderer.state.accum.reshape(-1, 3)[pixels].double().cpu().numpy()}
    return {"units": len(frame_ms), "jobs": [job], "traced_host_ms": traced_host_ms,
            "e2e": {"frame_ms_p95": stats.percentile(frame_ms, 95)}}


def release(st) -> None:
    st.clear()


def check(run) -> dict:
    return imagecheck.check_jobs(run, run.window["jobs"])


def control(run) -> dict:
    return imagecheck.control_jobs(run, run.window["jobs"])


def faults(run) -> dict:
    return imagecheck.fault_jobs(run, run.window["jobs"])


def traced_work(run) -> dict | None:
    units = run.tracer.units
    if not units:
        return None
    _, _, sc = run.reference()
    return {"segments": imagecheck.traced_segments(run, units), "units": len(units),
            "spp": len(units), "table_bytes": sc.table_bytes(),
            "output_bytes": 3 * 4 * run.n_pix}
