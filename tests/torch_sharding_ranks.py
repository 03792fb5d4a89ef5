"""What each rank of ``tests/test_torch_sharding.py`` runs, in a module that
imports neither jax nor the JAX package, so that a spawned rank starts
quickly. ``run_cases`` is the function ``parallel.dryrun.run_ranks`` calls
on every rank."""

import torch

from raytrace2_tpu_torch import render as render_mod
from raytrace2_tpu_torch.parallel import sharding
from raytrace2_tpu_torch.scene import loader, schema


def run_cases(cases: list) -> dict:
    """``cases``: (name, function of ``sharding``, scene path, extra features, (sp, dp),
    keyword arguments); returns {name: this rank's result}: the image, the
    (loss, gradient FlatScene), or the accumulated RenderState."""
    torch.set_num_threads(1)  # the ranks share the test worker's cores
    out = {}
    for name, fn_name, path, feats, (sp, dp), kw in cases:
        host, _ = loader.load_scene(path)
        scene = schema.to_device(host, "cpu")
        features = dict(host.features(), **feats)
        mesh = sharding.make_mesh(sp=sp, dp=dp, device="cpu")
        kw = dict(kw)
        if fn_name == "train_step_analog":
            state = render_mod.init_state(kw["width"], kw["height"], "cpu")
            for _ in range(kw.pop("steps")):
                state = sharding.train_step_analog(scene, features, state, 0, mesh=mesh, **kw)
            out[name] = state
        elif fn_name in ("render_samples_sharded", "render_samples_sharded_mega"):
            out[name] = getattr(sharding, fn_name)(scene, features, 0, 0, mesh=mesh, **kw)
        else:
            target = torch.as_tensor(kw.pop("target"))
            out[name] = getattr(sharding, fn_name)(scene, features, target, 0, mesh=mesh, **kw)
    return out
