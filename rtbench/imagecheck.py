"""The comparison that decides ``correct`` for the image cells: the
program's accumulated radiance and display pixels at the checked pixels
against the reference's, traced over the same samples."""

from __future__ import annotations

import numpy as np
import torch

from rtbench.reference import pathtrace


def display_u8(sums: np.ndarray, frames: int) -> np.ndarray:
    """Display pixels of radiance sums: clamp(sum / frames) → sqrt →
    × 255.999 → truncated to u8."""
    lin = np.clip(sums / max(frames, 1), 0.0, 1.0)
    return np.clip(np.sqrt(lin) * 255.999, 0.0, 255.0).astype(np.uint8)


def numbers(prog_sums: np.ndarray, prog_display: np.ndarray, ref_sums: np.ndarray,
            frames: int) -> dict:
    """``rel_rms``: the root mean square of the program's radiance sums less
    the reference's, over the checked pixels and channels, as a share of the
    reference's mean; ``display_off``: the share of checked pixel channels
    whose display value is more than one step from the reference's."""
    diff = prog_sums.astype(np.float64) - ref_sums
    mean = max(float(np.mean(ref_sums)), 1e-30)
    rel_rms = float(np.sqrt(np.mean(diff * diff))) / mean
    steps = np.abs(prog_display.astype(np.int64) - display_u8(ref_sums, frames).astype(np.int64))
    return {"rel_rms": rel_rms, "display_off": float(np.mean(steps > 1))}


def reference_sums(run, job: dict, dtype=torch.float32) -> tuple[np.ndarray, torch.Tensor]:
    """The reference's radiance sums at the job's checked pixels over its
    samples [0, frames), and the segments by family."""
    tables, cv, _ = run.reference(dtype)
    sums, segments = pathtrace.pixel_sums(
        tables, cv, job["pixels"], 0, job["frames"], seed=job["seed"], width=run.width,
        depth=run.depth, sqrt_spp=job["sqrt_spp"])
    return sums.cpu().numpy(), segments


def checked(run, job: dict) -> dict:
    """``job`` cut to the pixels the reference traces: as many of its
    checked pixels (a prefix of a random sample) as ``check_lane_records``
    lane-record tests allow at its sample count, between 16 and all."""
    records = 1 + sum(len(v["mat"]) for v in (run.ref_scene.sph, run.ref_scene.quad,
                                              run.ref_scene.box, run.ref_scene.med))
    budget = float(run.traffic["check_lane_records"]) / (max(job["frames"], 1) * records)
    k = max(16, min(len(job["pixels"]), int(budget)))
    return dict(job, pixels=job["pixels"][:k], sums=job["sums"][:k], display=job["display"][:k])


def check_jobs(run, jobs: list, dtype=torch.float32) -> dict:
    """The worst of each number over ``jobs``."""
    worst: dict = {}
    for job in jobs:
        job = checked(run, job)
        ref, _ = reference_sums(run, job, dtype)
        for k, v in numbers(job["sums"], job["display"], ref, job["frames"]).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def control_jobs(run, jobs: list) -> dict:
    """The control: the reference in bfloat16 put in the program's place for
    ``jobs``, compared as the program is."""
    fakes = []
    for job in jobs:
        job = checked(run, job)
        low, _ = reference_sums(run, job, torch.bfloat16)
        fakes.append(dict(job, sums=low, display=display_u8(low, job["frames"])))
    return check_jobs(run, fakes)


def fault_jobs(run, jobs: list) -> dict:
    """Each fault that an image cell can have, planted in the reference put
    in the program's place for ``jobs`` at their own sample counts: a step
    that returns its state unchanged (nothing accumulated); half of the
    batch left out and the mean taken over the rest (the sums of half of
    the samples, scaled to all of them); an answer altered where it is
    produced (3 display steps added below 250). Each number is the least
    over ``jobs``: the job that shows the fault least."""
    least: dict = {}
    for job in jobs:
        job = checked(run, job)
        frames = job["frames"]
        ref, _ = reference_sums(run, job)
        kept = max(frames // 2, 1)
        half, _ = reference_sums(run, dict(job, frames=kept))
        half = half * (frames / kept)
        zero = np.zeros_like(ref)
        shown = display_u8(ref, frames)
        fakes = {"unchanged": (zero, display_u8(zero, frames)),
                 "half": (half, display_u8(half, frames)),
                 "altered": (ref, np.where(shown < 250, shown + 3, shown))}
        for name, (sums, display) in fakes.items():
            got = least.setdefault(name, {})
            for k, v in numbers(sums, display, ref, frames).items():
                got[k] = min(got.get(k, float("inf")), v)
    return least


def traced_segments(run, units: list) -> dict:
    """Segments by family that the traced units' paths need, estimated from
    the checked pixels: {family: count} over all pixels of each unit.
    ``units`` holds (seed, s0, n_samples, sqrt_spp) tuples; consecutive
    sample ranges of one seed are traced together."""
    tables, cv, _ = run.reference()
    pixels = run.pixels()
    ranges: list = []
    for seed, s0, n, sqrt_spp in units:
        last = ranges[-1] if ranges else None
        if last and last[0] == seed and last[3] == sqrt_spp and last[1] + last[2] == s0:
            last[2] += n
        else:
            ranges.append([seed, s0, n, sqrt_spp])
    total = torch.zeros(len(pathtrace.FAMILIES), dtype=torch.float64)
    for seed, s0, n, sqrt_spp in ranges:
        _, seg = pathtrace.pixel_sums(tables, cv, pixels, s0, n, seed=seed, width=run.width,
                                      depth=run.depth, sqrt_spp=sqrt_spp)
        total += seg.cpu().double() * (run.n_pix / pixels.shape[0])
    return {fam: float(total[i]) for i, fam in enumerate(pathtrace.FAMILIES)}
