"""Offline sweep-structure analysis over dumped wavefront states (port of
``tools/analyze_sweep.py``), numpy on the CPU.

    python -m raytrace2_tpu_torch.tools.analyze_sweep STATES_DIR [SCENE]
        [--lanes 32] [--max-groups 40]

``STATES_DIR`` holds ``dump_wavefront_states``' ``state_NN.npz``; ``SCENE``
is the scene they were dumped from (a scene JSON or a canned scene of the
port's ``make_scene``, default ``book2_final``). The port's kernels walk
each warp's rays in one visit order, so a group of ``--lanes`` consecutive
sorted slots (a warp) is the unit, where the JAX tool took a TPU tile. For
each dumped state and a spread of at most ``--max-groups`` groups with a
live ray, it simulates on the family's cluster tables (the port's
``megakernel.cluster_tables`` and ``threaded_bvh``, for spheres and AA
boxes of at least ``2 * CLUSTER`` records) the two sweeps a group runs:

* ``bvh``, the threaded cluster BVH walk: nodes visited and records swept;
* ``hier``, the two-level cluster skip: slab tests and records swept;

with the group's shrinking best t (records in visit order, as the kernels
test them). The order is the group's dominant direction axis (the kernels'
rule). One JSON line a state. Distances are in float64, so a count may
differ from the kernel's at a near-tie.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np


def slab(lo, hi, o, inv):
    """Slab entry and exit t of rays o, inv [L, 3] against one box."""
    ta = (lo[None, :] - o) * inv
    tb = (hi[None, :] - o) * inv
    return np.minimum(ta, tb).max(1), np.maximum(ta, tb).min(1)


def sphere_ts(c, r, o, d):
    """Nearest root above 1e-3 of rays [L, 3] against spheres [P]: [L, P],
    inf where none."""
    oc = c[None, :, :] - o[:, None, :]
    a = (d * d).sum(1)[:, None]
    h = (d[:, None, :] * oc).sum(2)
    cc = (oc * oc).sum(2) - r[None, :] ** 2
    disc = h * h - a * cc
    ok = disc >= 0
    sq = np.sqrt(np.where(ok, disc, 0.0))
    r0, r1 = (h - sq) / a, (h + sq) / a
    t = np.where(r0 > 1e-3, r0, r1)
    return np.where(ok & (t > 1e-3), t, np.inf)


def box_ts(b0, b1, o, d):
    """Entry t above 1e-3 of rays against AA boxes [P]: [L, P], inf where none."""
    inv = 1.0 / np.where(np.abs(d) < 1e-12, 1e-12, d)
    ta = (b0[None] - o[:, None]) * inv[:, None]
    tb = (b1[None] - o[:, None]) * inv[:, None]
    t0, t1 = np.minimum(ta, tb).max(2), np.maximum(ta, tb).min(2)
    t = np.where(t0 >= 1e-3, t0, t1)
    return np.where((t1 > t0) & (t > 1e-3), t, np.inf)


def families(scene_arg):
    """Per clustered family: its records' hit function and its cluster and
    BVH tables (numpy)."""
    import torch

    from raytrace2_tpu_torch.ops.kernels import megakernel as mk
    from raytrace2_tpu_torch.scene import schema
    from raytrace2_tpu_torch.tools import make_scene

    host, _, _ = make_scene.load(scene_arg)
    sizes = tuple(host.features()["mega_sizes"])
    sph, _, box, *_ = mk.pack_tables(schema.to_device(host, "cpu"), sizes)
    fams = []
    for name, cols, n in (("sph", sph, sizes[0]), ("box", box, sizes[5])):
        if n < 2 * mk.CLUSTER:
            continue
        pad = -n % mk.SUPER
        t = {k: torch.nn.functional.pad(v[:n].double(), (0, pad)) for k, v in cols.items()}
        if name == "sph":
            c0 = torch.stack([t["c0x"], t["c0y"], t["c0z"]], -1)
            c1 = c0 + torch.stack([t["dpx"], t["dpy"], t["dpz"]], -1)
            lo = torch.minimum(c0, c1) - t["rad"][:, None]
            hi = torch.maximum(c0, c1) + t["rad"][:, None]
            c, r = c0.numpy(), t["rad"].numpy()
            hits = (lambda o, d, c=c, r=r, n=n:
                    np.where(np.arange(c.shape[0]) < n, sphere_ts(c, r, o, d), np.inf))
        else:
            lo = torch.stack([t["x0"], t["y0"], t["z0"]], -1)
            hi = torch.stack([t["x1"], t["y1"], t["z1"]], -1)
            b0, b1 = lo.numpy(), hi.numpy()
            hits = (lambda o, d, b0=b0, b1=b1, n=n:
                    np.where(np.arange(b0.shape[0]) < n, box_ts(b0, b1, o, d), np.inf))
        act = torch.arange(n + pad) < n
        tabs = mk.cluster_tables(lo.float(), hi.float(), act)
        tabs.update(mk.threaded_bvh(*tabs.pop("raw")))
        fams.append(dict(name=name, hits=hits, ratio=mk.SUPER // mk.CLUSTER,
                         **{k: v.numpy().astype(np.float64) for k, v in tabs.items()}))
    return fams


def walk(fam, o, d, alive, direction):
    """(bvh nodes, bvh records, hier slab tests, hier records) of one group."""
    inv = 1.0 / np.where(np.abs(d) < 1e-12, 1e-12, d)
    ts = fam["hits"](o, d)
    n_cl = fam["cb"].shape[1]
    n_l2 = fam["sb"].shape[1]
    m = fam["bv"].shape[1]

    def sweep(g, best):
        tc = ts[:, g * (ts.shape[1] // n_cl):(g + 1) * (ts.shape[1] // n_cl)]
        return np.minimum(best, np.where(alive, tc.min(1), np.inf))

    def live(lo, hi, best):
        t0, t1 = slab(lo, hi, o, inv)
        return bool((alive & (t1 > np.maximum(t0, 1e-3)) & (t0 < best)).any())

    per = ts.shape[1] // n_cl
    best = np.full(o.shape[0], np.inf)
    node, nodes, swept = 0, 0, 0
    while node >= 0:
        nodes += 1
        hit = live(fam["bv"][:3, node], fam["bv"][3:, node], best)
        g = int(fam["bleaf"][node])
        if hit and g >= 0:
            swept += per
            best = sweep(g, best)
        node = int((fam["bhit"] if hit else fam["bmiss"])[direction * m + node])
    best = np.full(o.shape[0], np.inf)
    conds, h_swept = 0, 0
    for i in range(n_l2):
        c2 = int(fam["ord"][direction * n_l2 + i])
        conds += 1
        if not live(fam["sb"][:3, c2], fam["sb"][3:, c2], best):
            continue
        for j in range(fam["ratio"]):
            c1 = int(fam["lord"][direction * n_cl + c2 * fam["ratio"] + j])
            conds += 1
            if live(fam["cb"][:3, c1], fam["cb"][3:, c1], best):
                h_swept += per
                best = sweep(c1, best)
    return nodes, swept, conds, h_swept


def analyze(states_dir, scene_arg="book2_final", lanes=32, max_groups=40) -> list:
    """One record a dumped state (see the module doc)."""
    fams = families(scene_arg)
    out = []
    for f in sorted(glob.glob(os.path.join(states_dir, "state_*.npz"))):
        st = dict(np.load(f))
        n = st["al"].shape[0]
        groups = [g for g in range(n // lanes) if (st["al"][g * lanes:(g + 1) * lanes] > 0).any()]
        groups = groups[::max(1, len(groups) // max_groups)][:max_groups]
        rec = {"file": os.path.basename(f), "alive": int((st["al"] > 0).sum()),
               "groups": len(groups), "lanes": lanes}
        for fam in fams:
            tot = np.zeros(4)
            for g in groups:
                sl = slice(g * lanes, (g + 1) * lanes)
                alive = st["al"][sl] > 0
                o = np.stack([st["ox"][sl], st["oy"][sl], st["oz"][sl]], 1).astype(np.float64)
                d = np.stack([st["dx"][sl], st["dy"][sl], st["dz"][sl]], 1).astype(np.float64)
                s = d[alive].sum(0)
                axis = int(np.argmax(np.abs(s)))
                tot += walk(fam, o, d, alive, 2 * axis + (0 if s[axis] >= 0 else 1))
            k = max(len(groups), 1)
            rec[fam["name"]] = {"bvh_nodes/group": tot[0] / k, "bvh_records/group": tot[1] / k,
                                "hier_tests/group": tot[2] / k,
                                "hier_records/group": tot[3] / k}
        out.append(rec)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="analyze_sweep")
    p.add_argument("states_dir")
    p.add_argument("scene", nargs="?", default="book2_final")
    p.add_argument("--lanes", type=int, default=32)
    p.add_argument("--max-groups", type=int, default=40)
    args = p.parse_args(argv)
    for rec in analyze(args.states_dir, args.scene, args.lanes, args.max_groups):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
