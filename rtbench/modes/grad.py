"""``grad``: inverse rendering of material albedos, one optimisation step
at a time, as ``tools/optimize_scene.py`` takes it: the L2 loss of the
image against a target rendered at set-up, ``grad.value_and_grad_scene``
(the forward kernel, then the replay kernel's backward) and an Adam update
of ``materials.albedo``, which set-up perturbed from the seed. Each step
renders with a render seed of its own.

Set-up builds the optimiser state and drives it through its first
``check_steps`` steps, which the reference follows from the same initial
albedos; the window goes on with the same state, and the reference also
replays ``WINDOW_STEPS`` consecutive steps of the window, drawn from the
seed, from the state the program had before them. End to end:
``grad_step_ms``, the whole window over the steps it completed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import torch

from rtbench import harness, imagecheck, stats
from rtbench.reference import gradient as rgrad

B1, B2, EPS = 0.9, 0.999, 1e-8
# Consecutive steps of the window that the check replays.
WINDOW_STEPS = 2


def _seeds(run):
    return (harness.derived_seed(run.seed, "target"),
            lambda k: harness.derived_seed(run.seed, "step", k))


def _initial_albedo(run, truth: torch.Tensor) -> torch.Tensor:
    g = torch.Generator(device=run.device).manual_seed(harness.derived_seed(run.seed, "albedo"))
    rel = float(run.traffic["perturb_rel"])
    u = torch.rand(tuple(truth.shape), generator=g, device=run.device)
    return truth + (2.0 * u - 1.0) * rel * (torch.abs(truth) + 0.3)


def adam(state: dict, grad: torch.Tensor, lr: float) -> None:
    """One Adam update of ``state["theta"]`` (optimize_scene's constants)."""
    state["step"] += 1
    k = state["step"]
    state["m"] = B1 * state["m"] + (1 - B1) * grad
    state["v"] = B2 * state["v"] + (1 - B2) * grad * grad
    mh = state["m"] / (1 - B1 ** k)
    vh = state["v"] / (1 - B2 ** k)
    state["theta"] = state["theta"] - lr * mh / (torch.sqrt(vh) + EPS)


def render_kw(run) -> dict:
    s = int(run.traffic["spp"])
    return dict(width=run.width, height=run.height, n_samples=s, max_depth=run.depth,
                sqrt_spp=max(int(math.sqrt(s)), 1))


def setup(run):
    from raytrace2_tpu_torch import grad as G
    from raytrace2_tpu_torch.scene import schema

    host = run.program_scene()
    features = host.features()
    scene = schema.to_device(host, run.device)
    kw = render_kw(run)
    target_seed, step_seed = _seeds(run)
    with torch.no_grad():
        target = G.render_image(scene, features, target_seed, **kw)
    theta0 = _initial_albedo(run, scene.materials.albedo)
    opt = {"theta": theta0, "m": torch.zeros_like(theta0), "v": torch.zeros_like(theta0),
           "step": 0}

    def loss_fn(img):
        return torch.mean((img - target) ** 2)

    def step(span):
        k = opt["step"] + 1
        cur = dataclasses.replace(scene, materials=dataclasses.replace(
            scene.materials, albedo=opt["theta"]))
        with span("grad.value_and_grad_scene"):
            loss, g = G.value_and_grad_scene(loss_fn, cur, features, step_seed(k), **kw)
        with span("adam"):
            adam(opt, g.materials.albedo.to(opt["theta"].dtype), float(run.traffic["lr"]))
        return loss

    st = {"step": step, "opt": opt, "history": []}
    for _ in range(int(run.traffic["check_steps"])):
        _record(st, lambda name: contextlib.nullcontext())
    st["first"] = _replay(st, 0, int(run.traffic["check_steps"]))
    st["history"].clear()
    run.sync()
    return st


def _snapshot(opt: dict) -> dict:
    return {key: opt[key] for key in ("step", "theta", "m", "v")}


def _record(st, span) -> None:
    """One step, keeping the optimiser's state before it and its loss. Adam
    makes new tensors, so keeping them costs the card nothing."""
    before = _snapshot(st["opt"])
    st["history"].append((before, st["step"](span)))


def _replay(st, i: int, n: int) -> dict:
    """What the program did in steps ``i`` to ``i + n`` of its history: the
    state before them, their losses, Adam's first moment after the first
    and the albedos after the last."""
    states = [before for before, _ in st["history"]] + [_snapshot(st["opt"])]
    return {"k0": states[i]["step"] + 1, "theta0": states[i]["theta"], "m0": states[i]["m"],
            "v0": states[i]["v"], "loss": [loss for _, loss in st["history"][i:i + n]],
            "m1": states[i + 1]["m"], "theta": states[i + n]["theta"]}


def _to_host(rep: dict) -> dict:
    return {k: (v.cpu() if torch.is_tensor(v) else
                [float(x) for x in v] if isinstance(v, list) else v) for k, v in rep.items()}


def window(run, st) -> dict:
    tracer = run.tracer
    _, step_seed = _seeds(run)
    spp = int(run.traffic["spp"])
    sqrt_spp = render_kw(run)["sqrt_spp"]
    steps = 0
    t0 = time.perf_counter()
    while True:
        tracer.step(time.perf_counter() - t0)
        k = st["opt"]["step"] + 1
        _record(st, tracer.span)
        tracer.unit((step_seed(k), 0, spp, sqrt_spp))
        steps += 1
        if steps % 2 == 0:
            run.sync()
        if steps >= WINDOW_STEPS and time.perf_counter() - t0 >= run.seconds \
                and not tracer.active:
            break
    tracer.stop()
    run.sync()
    elapsed = time.perf_counter() - t0
    g = torch.Generator().manual_seed(harness.derived_seed(run.seed, "window step"))
    i = int(torch.randint(steps - WINDOW_STEPS + 1, (1,), generator=g))
    replays = {"first": st["first"], "window": _replay(st, i, WINDOW_STEPS)}
    return {"units": steps, "replays": {k: _to_host(v) for k, v in replays.items()},
            "e2e": {"grad_step_ms": stats.per_unit_ms(elapsed, steps)}}


def release(st) -> None:
    st.clear()


def reference_steps(run, dtype=torch.float32, n_samples=None, frozen=False) -> dict:
    """The reference's target, then each replay of the program's steps
    (``run.window["replays"]``): the same steps from the same state, with
    its own gradients and Adam. ``n_samples`` renders the steps' images from
    fewer samples and ``frozen`` keeps the optimiser's state unchanged
    (planted faults). Each replay is shaped as the program's is, so that it
    can stand in the program's place."""
    target_seed, step_seed = _seeds(run)
    tables, cv, _ = run.reference(dtype)
    kw = render_kw(run)
    tkw = dict(width=kw["width"], height=kw["height"], n_samples=kw["n_samples"],
               depth=kw["max_depth"], sqrt_spp=kw["sqrt_spp"])
    skw = dict(tkw, n_samples=n_samples or kw["n_samples"])
    ev = torch.float64 if dtype == torch.float32 else dtype
    truth = tables.mat
    truth = torch.stack([truth["alr"], truth["alg"], truth["alb"]], -1)
    paths = rgrad.trace_image(tables, cv, seed=target_seed, **tkw)
    target = rgrad.image(paths, truth, ev)
    del paths
    out = {}
    for name, prog in run.window["replays"].items():
        opt = {key: prog[key + "0"].to(run.device, ev) for key in ("theta", "m", "v")}
        opt["step"] = prog["k0"] - 1
        rep = {"k0": prog["k0"], "theta0": opt["theta"], "m0": opt["m"], "v0": opt["v"],
               "loss": []}
        for k in range(prog["k0"], prog["k0"] + len(prog["loss"])):
            paths = rgrad.trace_image(tables, cv, seed=step_seed(k), **skw)
            loss, g = rgrad.loss_and_grad(paths, opt["theta"], target, ev)
            del paths
            rep["loss"].append(float(loss))
            if "grad1" not in rep:
                rep["grad1"] = g
            if frozen:
                opt["step"] += 1
            else:
                adam(opt, g, float(run.traffic["lr"]))
            rep.setdefault("m1", opt["m"])
        rep["theta"] = opt["theta"]
        out[name] = {k: (v.double().cpu() if torch.is_tensor(v) else v) for k, v in rep.items()}
    return out


def _numbers(prog: dict, ref: dict) -> dict:
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    g_prog = (prog["m1"].double() - B1 * prog["m0"].double()) / (1 - B1)
    g_ref = ref["grad1"]
    grad_gap = abs(float(g_prog.norm()) - float(g_ref.norm())) / float(g_ref.norm())
    rows = g_ref.norm(dim=1)
    keep = rows >= 1e-3 * rows.median()
    d_prog = (prog["theta"].double() - prog["theta0"].double())[keep]
    d_ref = (ref["theta"] - ref["theta0"])[keep]
    change_gap = abs(float(d_prog.norm()) - float(d_ref.norm())) / float(d_ref.norm())
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}


def numbers(prog: dict, ref: dict) -> dict:
    """The worst over the replays (the first ``check_steps`` steps, and
    ``WINDOW_STEPS`` steps of the window drawn from the seed) of:
    ``loss_gap``, the worst relative gap of the steps' losses;
    ``grad_gap``, the gap of the first step's gradient's norm (the
    program's from its Adam state before and after that step) over the
    reference's; ``change_gap``, the gap of the norm of the albedos' change
    over the steps over the reference's, leaving out rows whose reference
    gradient is under a thousandth of the median row's (they move under Adam
    by round-off)."""
    worst: dict = {}
    for name in ref:
        for key, value in _numbers(prog[name], ref[name]).items():
            worst[key] = max(worst.get(key, 0.0), value)
    return worst


def check(run) -> dict:
    return numbers(run.window["replays"], reference_steps(run))


def control(run) -> dict:
    return numbers(reference_steps(run, torch.bfloat16), reference_steps(run))


def faults(run) -> dict:
    """Each fault that this cell can have, planted in the reference put in
    the program's place, read against the reference: a step that leaves its
    state unchanged (Adam never moves, its state takes no gradient); half of
    the batch left out (each step's image and gradient from half of its
    samples, the mean taken over them); the loss altered where it is made
    (by 1 %)."""
    ref = reference_steps(run)
    frozen = reference_steps(run, frozen=True)
    half = reference_steps(run, n_samples=max(int(run.traffic["spp"]) // 2, 1))
    altered = {name: dict(rep, loss=[x * 1.01 for x in rep["loss"]]) for name, rep in ref.items()}
    return {name: numbers(prog, ref) for name, prog in
            (("unchanged", frozen), ("half", half), ("altered", altered))}


def traced_work(run) -> dict | None:
    units = run.tracer.units
    if not units:
        return None
    _, _, sc = run.reference()
    return {"segments": imagecheck.traced_segments(run, units), "units": len(units),
            "spp": sum(u[2] for u in units), "table_bytes": 2 * sc.table_bytes(),
            "output_bytes": 3 * 4 * run.n_pix}
