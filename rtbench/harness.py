"""One run of one cell: find its pieces by name, set up, measure, check.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own, found by the name that ``BENCHMARK.json``
gives it:

* ``configs/<config>.json``: the scene JSON, its size, depth and source;
* ``traffic/<traffic>.json``: a mix's parameters and the ``mode`` that
  drives it, ``modes/<mode>.py`` (``setup``, ``window``, ``release``,
  ``check``, ``control``, ``traced_work``);
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``,
  which returns None where it finds nothing to read, and ``COUNTERS``, the
  program counters it reads (dotted paths), where it reads any;
* ``limits/<cell>.json``: the limit of each number that the cell's check
  compares.

The program (``raytrace2_tpu_torch``) is driven only through its public
entries; the reference (``reference/``) imports nothing of it.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import importlib
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# Top-level modules that must not be loaded in a run: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "raytrace2_tpu")


class CellError(RuntimeError):
    """A cell that cannot run here (no card, a missing file)."""


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(path: Path | None = None) -> dict:
    return read_json(path or ROOT / "BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    """Whether ``metric`` is reported in ``cell``: every cell where it
    lists none (``setup_s``), else the cells it lists."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell_spec(bench: dict, name: str) -> dict:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise CellError(f"no workload {name!r} in BENCHMARK.json")
    cell = dict(cells[name])
    cell["end_to_end"] = [m for m in bench["end_to_end"] if applies(m, name)]
    cell["per_layer"] = [m for m in bench["per_layer"] if applies(m, name)]
    return cell


def load_file_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"rtbench_{path.stem}".replace(".", "_"), path)
    if spec is None:
        raise CellError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mode_module(mode: str):
    return importlib.import_module(f"rtbench.modes.{mode}")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def derived_seed(seed: int, *tags) -> int:
    """A seed in [0, 2^31) drawn from ``seed`` and ``tags``."""
    text = ":".join(str(x) for x in (seed, *tags)).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=4).digest(), "little") & 0x7FFFFFFF


@dataclasses.dataclass
class Run:
    """The state of one run that modes and metric readers read."""

    cell: dict
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    tracer: object = None
    trace_summary: dict | None = None
    traced_work: dict | None = None
    window: dict | None = None
    numbers: dict | None = None
    pkg: Path = PKG

    @property
    def width(self) -> int:
        return int(self.cfg["width"])

    @property
    def height(self) -> int:
        return int(self.cfg["height"])

    @property
    def depth(self) -> int:
        return int(self.cfg["depth"])

    @property
    def n_pix(self) -> int:
        return self.width * self.height

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def pixels(self) -> torch.Tensor:
        """The checked pixels: ``check_pixels`` distinct ids drawn from the
        seed, in the order drawn (any prefix is a sample too), on the device."""
        g = torch.Generator().manual_seed(derived_seed(self.seed, "pixels"))
        k = min(int(self.traffic["check_pixels"]), self.n_pix)
        return torch.randperm(self.n_pix, generator=g)[:k].to(self.device)

    def program_scene(self):
        """The scene as the program loads it, through its loader, from the
        configuration's JSON written to a temporary file."""
        from raytrace2_tpu_torch.scene import loader

        fd, path = tempfile.mkstemp(prefix="rtbench_scene_", suffix=".json")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.cfg["scene"], f)
            scene, _ = loader.load_scene(path)
        finally:
            os.remove(path)
        return scene

    @functools.cached_property
    def ref_scene(self):
        """The reference's scene (``reference/scene.py``), parsed once."""
        from rtbench.reference import scene as rscene

        return rscene.parse(self.cfg["scene"])

    def reference(self, dtype=torch.float32):
        """(tables, camera frame, reference scene) of the reference tracer."""
        from rtbench.reference import pathtrace, scene as rscene

        sc = self.ref_scene
        return (pathtrace.Tables.of(sc, self.device, dtype),
                rscene.camv(sc, self.width, self.height), sc)


def make_run(name: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             bench: dict | None = None, overrides: dict | None = None, pkg: Path = PKG) -> Run:
    """The run of cell ``name``, its files read from ``pkg``; ``overrides``
    replace configuration or traffic keys (the tests' small sizes)."""
    cell = cell_spec(bench or load_benchmark(), name)
    cfg = read_json(pkg / "configs" / f"{cell['config']}.json")
    traffic = read_json(pkg / "traffic" / f"{cell['traffic']}.json")
    for key, value in (overrides or {}).items():
        (cfg if key in cfg else traffic)[key] = value
    return Run(cell=cell, cfg=cfg, traffic=traffic, seed=int(seed), seconds=float(seconds),
               trace=bool(trace), device=torch.device(device), pkg=pkg)


def require_cards(chips: int) -> None:
    if not torch.cuda.is_available():
        raise CellError("torch.cuda.is_available() is false: the benchmark runs on the card")
    if torch.cuda.device_count() < chips:
        raise CellError(f"the cell asks for {chips} cards, {torch.cuda.device_count()} visible")


def compare(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}): every number at or under its limit."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok &= good
        out[name] = {"value": value, "limit": limit}
    return ok, out


def counter_reader(names):
    """A function that reads the program's counters ``names``, each the
    dotted path of a module attribute
    (``raytrace2_tpu_torch.ops.kernels.wavefront.SORTS``)."""
    names = sorted(set(names))

    def read() -> dict:
        out = {}
        for name in names:
            module, attr = name.rsplit(".", 1)
            out[name] = getattr(importlib.import_module(module), attr)
        return out
    return read


def execute(run: Run, t_start: float, limits: dict | None = None) -> tuple[dict, list]:
    """Set up, measure, check. Returns (result line, stderr lines)."""
    from rtbench import trace as trace_mod

    mode = mode_module(run.traffic["mode"])
    # Each per-layer reader names the program counters it reads (COUNTERS).
    readers = {m["name"]: load_file_module(run.pkg / "metrics" / f"{m['name']}.py")
               for m in run.cell["per_layer"]} if run.trace else {}
    counters = counter_reader(c for r in readers.values() for c in getattr(r, "COUNTERS", ()))
    run.tracer = trace_mod.Tracer(run.trace, float(run.traffic["trace_start_s"]),
                                  float(run.traffic["trace_s"]), counters,
                                  sync=run.sync, cuda=run.device.type == "cuda")
    run.tracer.warm()
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    state = mode.setup(run)
    setup_s = time.perf_counter() - t_start
    run.window = mode.window(run, state)
    run.tracer.stop()
    run.trace_summary = run.tracer.summary
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    mode.release(state)
    del state
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    if run.trace:
        run.traced_work = mode.traced_work(run)
    numbers = run.numbers = mode.check(run)
    limits = limits if limits is not None else read_json(
        run.pkg / "limits" / f"{run.cell['name']}.json")
    correct, checks = compare(numbers, limits)

    metrics = {}
    if not run.trace:
        # A metric named <quantity>.<qualifier> reports the mode's <quantity>
        # (mpaths_per_s.wavefront: the rate of the wavefront route's cell).
        e2e = dict(run.window["e2e"], setup_s=setup_s)
        for m in run.cell["end_to_end"]:
            value = e2e.get(m["name"], e2e.get(m["name"].split(".")[0]))
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in run.cell["per_layer"]:
            value = readers[m["name"]].read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
              "kind": (torch.cuda.get_device_name(run.device) if run.device.type == "cuda"
                       else "cpu"),
              "count": int(run.cell.get("chips", 1)), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(run.window["units"]),
              "failed": 0 if correct else 1, "metrics": metrics, "device": device}
    if run.trace and run.trace_summary:
        s = run.trace_summary
        device.update(busy_s=s["busy_s"], window_s=s["window_s"])
        result["breakdown"] = {"device_ops": s["device_ops"], "idle_gaps": s["idle_gaps"]}
    result["checks"] = checks
    lines = [f"check {k}: {v['value']!r} (limit {v['limit']!r})" for k, v in checks.items()]
    return result, lines
