"""``final``: the progressive render of a finished image, as the CLI makes
it. One closed-loop user: a job renders ``job_spp`` samples of every pixel
through ``Renderer.update(batch)`` and ends with the display image read
back to the host; the next job starts on a fresh accumulator with the next
render seed. The window closes after the batch that crosses ``--seconds``
and reads back the job in progress.

End to end: ``mpaths_per_s``, the paths of every batch the window rendered
over the whole window. Checked: the last job and, where the window finished
two or more, one finished job drawn from the seed, at the checked pixels.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rtbench import harness, imagecheck, stats


class Fence:
    """Keeps the host at most ``depth`` batches ahead of the card."""

    def __init__(self, run, depth: int = 2):
        self.cuda = run.device.type == "cuda"
        self.depth = depth
        self.events: list = []

    def mark(self) -> None:
        if not self.cuda:
            return
        ev = torch.cuda.Event()
        ev.record()
        self.events.append(ev)
        if len(self.events) > self.depth:
            self.events.pop(0).synchronize()


def setup(run):
    from raytrace2_tpu_torch.render import Renderer

    renderer = Renderer(run.program_scene(), run.width, run.height,
                        num_samples=int(run.cfg["samples"]), max_depth=run.depth,
                        seed=harness.derived_seed(run.seed, "job", 0), device=run.device)
    # The shapes of the mix: the batch, and the job's last, shorter batch.
    batch, job_spp = int(run.traffic["batch_spp"]), int(run.cfg["samples"])
    for n in sorted({min(batch, job_spp), job_spp % batch} - {0}):
        renderer.update(n)
        renderer.display_pixels()
        renderer.reset()
    run.sync()
    return {"renderer": renderer}


def _finish(run, renderer, pixels, frames) -> dict:
    display = renderer.display_pixels().reshape(-1, 3)
    sums = renderer.state.accum.reshape(-1, 3)[pixels]
    return {"seed": renderer.seed, "frames": frames, "sqrt_spp": renderer.sqrt_spp,
            "sums": sums, "display": display[pixels.cpu().numpy()]}


def window(run, st) -> dict:
    renderer = st["renderer"]
    tracer = run.tracer
    pixels = run.pixels()
    batch = int(run.traffic["batch_spp"])
    job_spp = int(run.cfg["samples"])
    fence = Fence(run)
    jobs, batches, paths, frames = [], 0, 0, 0
    t0 = time.perf_counter()
    while True:
        tracer.step(time.perf_counter() - t0)
        n = min(batch, job_spp - frames)
        with tracer.span("Renderer.update"):
            renderer.update(n)
        tracer.unit((renderer.seed, frames, n, renderer.sqrt_spp))
        fence.mark()
        frames += n
        batches += 1
        paths += n * run.n_pix
        if frames == job_spp:
            with tracer.span("Renderer.display_pixels"):
                jobs.append(_finish(run, renderer, pixels, frames))
            renderer.reset()
            renderer.seed = harness.derived_seed(run.seed, "job", len(jobs))
            frames = 0
        if time.perf_counter() - t0 >= run.seconds and not tracer.active:
            break
    tracer.stop()
    if frames:
        jobs.append(_finish(run, renderer, pixels, frames))
    run.sync()
    elapsed = time.perf_counter() - t0
    for job in jobs:
        job["sums"] = job["sums"].double().cpu().numpy()
        job["pixels"] = pixels
    return {"units": batches, "jobs": jobs,
            "e2e": {"mpaths_per_s": stats.rate(paths, elapsed) / 1e6}}


def release(st) -> None:
    st.clear()


def checked_jobs(run) -> list:
    """The last job, and one more finished job drawn from the seed."""
    jobs = run.window["jobs"]
    done = jobs[:-1]
    picked = [jobs[-1]]
    if done:
        g = np.random.default_rng(harness.derived_seed(run.seed, "check"))
        picked.append(done[int(g.integers(len(done)))])
    return picked


def check(run) -> dict:
    return imagecheck.check_jobs(run, checked_jobs(run))


def control(run) -> dict:
    return imagecheck.control_jobs(run, checked_jobs(run))


def faults(run) -> dict:
    return imagecheck.fault_jobs(run, checked_jobs(run))


def traced_work(run) -> dict | None:
    units = run.tracer.units
    if not units:
        return None
    _, _, sc = run.reference()
    return {"segments": imagecheck.traced_segments(run, units), "units": len(units),
            "spp": sum(u[2] for u in units), "table_bytes": sc.table_bytes(),
            "output_bytes": 3 * 4 * run.n_pix}
