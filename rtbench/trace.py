"""The traced sub-window of a ``--trace 1`` run: ``torch.profiler`` over a
short steady stretch of the window, its chrome trace written under
``TMPDIR``, read back into a summary and deleted."""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


def kernel_key(name: str) -> str:
    """A device event's function name without return type, namespace,
    template arguments and parameter list:
    ``void (anonymous namespace)::f<3>(float*, int)`` → ``f``."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].split("<")[0].strip()
    return name.split(" ")[-1].split("::")[-1]


def union(intervals) -> list:
    """Merge [start, end) intervals into disjoint ones, in order."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events: list, window_s: float) -> dict:
    """Busy time, device time by kernel, the longest device operations and
    idle gaps of a chrome trace's events (times in microseconds)."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    if not dev:
        return dict(window_s=window_s, busy_s=0.0, kernels={}, device_ops=[], idle_gaps=[])
    spans = union((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in dev)
    busy_s = min(sum(e - s for s, e in spans) * 1e-6, window_s)
    kernels: dict = {}
    for e in dev:
        key = kernel_key(e["name"]) if e["cat"] == "kernel" else e["cat"]
        kernels[key] = kernels.get(key, 0.0) + float(e.get("dur", 0.0)) * 1e-6
    t0 = min(float(e["ts"]) for e in events if "ts" in e)
    t1 = t0 + window_s * 1e6
    bounds = [t0] + [x for s, e in spans for x in (s, e)] + [max(t1, spans[-1][1])]
    gaps = [(bounds[i], bounds[i + 1]) for i in range(0, len(bounds) - 1, 2)
            if bounds[i + 1] > bounds[i]]

    def host_at(t: float) -> str:
        inner = {}
        for e in host:
            s = float(e["ts"])
            if s <= t <= s + float(e.get("dur", 0.0)):
                kind = "annotation" if e["cat"] == "user_annotation" else "op"
                if kind not in inner or e.get("dur", 0.0) < inner[kind].get("dur", 0.0):
                    inner[kind] = e
        names = [inner[k]["name"] for k in ("annotation", "op") if k in inner]
        return " > ".join(names) or "host outside any operation"

    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [[host_at(0.5 * (s + e)), (e - s) * 1e-6] for s, e in gaps[:TOP]]
    ops = sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(window_s=window_s, busy_s=busy_s, kernels=kernels,
                device_ops=[[k, v] for k, v in ops], idle_gaps=idle)


class Tracer:
    """Profiles the units of a window that start from ``start_s`` seconds
    into it until ``length_s`` seconds after the profiler started. A mode
    calls ``step`` before each unit and ``unit`` after it; ``span`` names
    host work in the trace. ``counters`` returns the program's counters,
    read at both ends."""

    def __init__(self, enabled: bool, start_s: float, length_s: float, counters=None,
                 sync=torch.cuda.synchronize, cuda: bool = True):
        self.enabled = enabled
        self.sync, self.cuda = sync, cuda
        self.start_s, self.length_s = start_s, length_s
        self.counters = counters or (lambda: {})
        self.active = False
        self.done = not enabled
        self.units: list = []
        self.summary: dict | None = None
        self._prof = None
        self._t0 = 0.0
        self._c0: dict = {}

    def _activities(self) -> list:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def warm(self) -> None:
        """Start and stop the profiler once on a small operation: its first
        start (CUPTI's) takes seconds, which would fall inside the window."""
        if not self.enabled:
            return
        with torch.profiler.profile(activities=self._activities()):
            x = torch.ones(8, device="cuda" if self.cuda else "cpu") + 1
            self.sync()
        del x

    def step(self, elapsed: float) -> None:
        if self.done:
            return
        if not self.active and elapsed >= self.start_s:
            self._start()
        elif self.active and time.perf_counter() - self._t0 >= self.length_s:
            self.stop()

    def unit(self, info: dict) -> None:
        if self.active:
            self.units.append(info)

    def span(self, name: str):
        if self.active:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def _start(self) -> None:
        self.sync()
        self._c0 = self.counters()
        self._prof = torch.profiler.profile(activities=self._activities())
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        self.active = True

    def stop(self) -> None:
        """End the sub-window (at the latest when the window closes)."""
        if not self.active:
            return
        self.sync()
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        c1 = self.counters()
        self.active, self.done = False, True
        fd, path = tempfile.mkstemp(prefix="rtbench_trace_", suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        self._prof = None
        self.summary = summarize(events, window_s)
        self.summary["counters"] = {k: c1[k] - self._c0.get(k, 0) for k in c1}
