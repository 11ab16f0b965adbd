"""Bundle adjustment solves of the sizes the full run makes, timed and
counted on the card: synchronizing CUDA calls per solve (torch's sync
debug mode, on a second call: the first has one-time set-up), LM
iterations, and wall ms per solve (median of repeats,
each ended by a synchronize). The problems are synthetic and seeded, so
two trees see the same ones: pass ``--tree DIR`` to import tpu3d_torch
from another checkout (an unpacked parent commit) and compare in one call.

  global  — 24 cameras, 5,250 points, ~46,600 observations (the 24-view
            full run's final sizes), Huber, a mid-run global BA's
            arguments (12 LM iterations, 24 CG, stall 1e-4)
  focal   — the same problem at refine_focal's arguments (12, 24, 1e-5)
  local   — 8 local problems (4 cameras, 3 frozen; 600 points, 1,200
            observations each) at the engine's local arguments (10, 8,
            1e-4), one by one, and batched where the tree has
            ``bundle_adjust_batch``

    python3 scripts/torch_ba_syncs.py [--tree DIR] [--repeats 5]

Prints one JSON line.
"""
import argparse
import json
import os
import sys
import time
import warnings

import numpy as np


def _rot(w):
    t = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if t < 1e-12:
        return np.eye(3)
    return np.eye(3) + np.sin(t) / t * K + (1 - np.cos(t)) / t ** 2 * K @ K


def problem(rng, n_cams, n_pts, per_pt, free_cams, perturb_cam, perturb_pt):
    """A scene of n_pts points in front of n_cams cameras on an arc, each
    point observed by ``per_pt`` cameras (0.3 px noise at focal 800);
    cameras outside ``free_cams`` frozen at their poses."""
    X = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                  rng.uniform(6, 10, n_pts)], -1)
    cams = np.zeros((n_cams, 6))
    cams[:, 1] = np.linspace(-0.4, 0.4, n_cams)
    cams[:, 3] = np.linspace(-2.0, 2.0, n_cams)
    ci, pi, uv = [], [], []
    for p in range(n_pts):
        for c in rng.choice(n_cams, per_pt, replace=False):
            Xc = _rot(cams[c, :3]) @ X[p] + cams[c, 3:]
            ci.append(c)
            pi.append(p)
            uv.append(Xc[:2] / Xc[2] + rng.normal(0, 0.3 / 800, 2))
    order = np.argsort(pi, kind="stable")
    cam_fixed = np.ones(n_cams, np.float32)
    cam_fixed[free_cams] = 0.0
    cams0 = cams + (1.0 - cam_fixed)[:, None] * rng.normal(0, perturb_cam, cams.shape)
    X0 = X + rng.normal(0, perturb_pt, X.shape)
    f32 = np.float32
    return [cams0.astype(f32), X0.astype(f32), np.asarray(ci)[order].astype(np.int64),
            np.asarray(pi)[order].astype(np.int64), np.asarray(uv)[order].astype(f32),
            np.ones(len(ci), f32), cam_fixed, np.zeros(n_pts, f32)]


def _measured(torch, fn, repeats):
    """(result, synchronizing calls of one call after a first one, median
    wall ms)."""
    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum(1 for w in caught if "synchroniz" in str(w.message))
    walls = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return out, syncs, float(np.median(walls))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="the checkout whose tpu3d_torch to import (default: this one)")
    ap.add_argument("--repeats", type=int, default=5)
    opts = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(opts.tree))
    import torch

    if not torch.cuda.is_available():
        print("torch_ba_syncs: needs a CUDA device", file=sys.stderr)
        return 1
    from tpu3d_torch.ba import lm

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    big = problem(rng, 24, 5250, 9, list(range(1, 24)), 0.01, 0.05)
    locals_ = [problem(rng, 4, 600, 2, [0], 0.02, 0.05) for _ in range(8)]
    on = [[torch.from_numpy(a).to(dev) for a in p] for p in [big] + locals_]
    out = {"tree": os.path.abspath(opts.tree), "device": torch.cuda.get_device_name(0),
           "observations": {"global": len(big[2]), "local": [len(p[2]) for p in locals_]}}
    for name, kw in (("global", dict(max_iters=12, cg_iters=24, robust_delta=3.0 / 800,
                                     stall_tol=1e-4)),
                     ("focal", dict(max_iters=12, cg_iters=24, stall_tol=1e-5))):
        st, syncs, ms = _measured(torch, lambda: lm.bundle_adjust(*on[0], **kw), opts.repeats)
        out[name] = {"n_iters": int(st.n_iters), "syncs": syncs, "ms": round(ms, 3),
                     "cost": float(st.cost)}
    kw = dict(max_iters=10, cg_iters=8, stall_tol=1e-4)
    rows = [_measured(torch, lambda a=a: lm.bundle_adjust(*a, **kw), opts.repeats)
            for a in on[1:]]
    out["local_one_by_one"] = {"n_iters": [int(r[0].n_iters) for r in rows],
                               "syncs": [r[1] for r in rows],
                               "ms": round(sum(r[2] for r in rows), 3)}
    if hasattr(lm, "bundle_adjust_batch"):
        from tpu3d_torch.sfm.engine import stack_ba_problems

        stacked = [torch.from_numpy(a).to(dev) for a in stack_ba_problems(locals_)]
        st, syncs, ms = _measured(torch, lambda: lm.bundle_adjust_batch(*stacked, **kw),
                                  opts.repeats)
        out["local_batched"] = {"n_iters": st.n_iters.tolist(), "syncs": syncs,
                                "ms": round(ms, 3)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
