"""``grad_full``: the ``grad`` mode on a scene of any material. The program's
side (set-up, the window of Adam steps, ``traced_work``) and the numbers
compared are ``grad.py``'s; the reference of each replayed step is
``reference/gradient_full.py``, whose paths may scatter off textured
lambertians, dielectrics and isotropic media, whose factors are no albedo
row (``reference/gradient.py`` refuses them).
"""

from __future__ import annotations

import torch

from rtbench.modes import grad
from rtbench.modes.grad import adam, numbers, release, setup, traced_work, window
from rtbench.reference import gradient_full as rgrad

__all__ = ["setup", "window", "release", "traced_work", "reference_steps", "check", "control",
           "faults"]


def reference_steps(run, dtype=torch.float32, n_samples=None, frozen=False) -> dict:
    """The reference's target, then each replay of the program's steps
    (``run.window["replays"]``), as ``grad.reference_steps`` makes them,
    with ``gradient_full``'s paths: the same steps from the same state, with
    its own gradients and Adam. The paths of the target and of every step
    are traced together, since they depend on the render seed alone and not
    on the albedos. ``n_samples`` renders the steps' images from fewer
    samples and ``frozen`` keeps the optimiser's state unchanged (planted
    faults)."""
    target_seed, step_seed = grad._seeds(run)
    tables, cv, _ = run.reference(dtype)
    kw = grad.render_kw(run)
    ev = torch.float64 if dtype == torch.float32 else dtype
    truth = tables.mat
    truth = torch.stack([truth["alr"], truth["alg"], truth["alb"]], -1)
    steps = {name: range(prog["k0"], prog["k0"] + len(prog["loss"]))
             for name, prog in run.window["replays"].items()}
    images = [(target_seed, kw["n_samples"])] + [
        (step_seed(k), n_samples or kw["n_samples"]) for ks in steps.values() for k in ks]
    traced = iter(rgrad.trace_images(tables, cv, images, width=kw["width"],
                                     height=kw["height"], depth=kw["max_depth"],
                                     sqrt_spp=kw["sqrt_spp"]))
    target = rgrad.image(next(traced), truth, ev)
    out = {}
    for name, prog in run.window["replays"].items():
        opt = {key: prog[key + "0"].to(run.device, ev) for key in ("theta", "m", "v")}
        opt["step"] = prog["k0"] - 1
        rep = {"k0": prog["k0"], "theta0": opt["theta"], "m0": opt["m"], "v0": opt["v"],
               "loss": []}
        for _ in steps[name]:
            loss, g = rgrad.loss_and_grad(next(traced), opt["theta"], target, ev)
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


def check(run) -> dict:
    return numbers(run.window["replays"], reference_steps(run))


def control(run) -> dict:
    return numbers(reference_steps(run, torch.bfloat16), reference_steps(run))


def faults(run) -> dict:
    """``grad.faults``' three, planted in this reference put in the
    program's place, read against it: a step that leaves its state
    unchanged; half of the batch left out; the loss altered by 1 %."""
    ref = reference_steps(run)
    frozen = reference_steps(run, frozen=True)
    half = reference_steps(run, n_samples=max(int(run.traffic["spp"]) // 2, 1))
    altered = {name: dict(rep, loss=[x * 1.01 for x in rep["loss"]]) for name, rep in ref.items()}
    return {name: numbers(prog, ref) for name, prog in
            (("unchanged", frozen), ("half", half), ("altered", altered))}
