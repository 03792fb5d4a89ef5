"""Small sizes at which the harness runs on the CPU through the program's
plain versions (the tests only: a benchmark run refuses the CPU)."""

from __future__ import annotations

import time

from rtbench import harness

TINY = dict(width=12, height=12, samples=8, depth=8, batch_spp=4, spp=2,
            check_pixels=24, trace_start_s=0.1, trace_s=0.3)
SEED = 2**31 + 4097


def run_cpu(cell: str, *, seconds: float = 0.3, trace: bool = False, seed: int = SEED,
            limits=None, **kw):
    run = harness.make_run(cell, seed, seconds, trace, device="cpu",
                           overrides=dict(TINY, **kw.pop("overrides", {})), **kw)
    result, lines = harness.execute(run, time.perf_counter(), limits=limits)
    return run, result, lines
