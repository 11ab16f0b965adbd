"""Which of bundle adjustment's operations give a row the same bits whether
it is computed alone or among others (the rows of several problems side
by side), on the card: each operation runs on rows of three problems at
once and on each problem's rows alone, and the largest difference over
the rows is printed (0 = batch-invariant). Shapes are a local BA chunk's
(4 cameras, 2,000 points, 7,000 observations a problem).

    python3 scripts/torch_batch_invariance.py [--device cuda]

Prints one JSON line: {operation: max |batched - alone|}.
"""
import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    opts = ap.parse_args(argv)
    import torch

    from tpu3d_torch.ba import lm
    from tpu3d_torch.ba.residuals import observation_jacobians
    from tpu3d_torch.core.lie import so3_exp, so3_exp_jacobian

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(opts.device)
    g = torch.Generator().manual_seed(0)
    B, C, P, O = 3, 4, 2000, 7000

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    def diff(fn, *args):
        """fn on all rows (the leading axis of every arg holds B blocks)
        against fn on each block alone."""
        whole = fn(*args)
        whole = whole if isinstance(whole, tuple) else (whole,)
        worst = 0.0
        for b in range(B):
            part = fn(*(a.reshape(B, -1, *a.shape[1:])[b] for a in args))
            part = part if isinstance(part, tuple) else (part,)
            for w, p in zip(whole, part):
                w = w.reshape(B, -1, *w.shape[1:])[b]
                worst = max(worst, (w.double() - p.double()).abs().max().item())
        return worst

    out = {"device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"}
    Jc, Jp, r = rnd(B * O, 2, 6), rnd(B * O, 2, 3), rnd(B * O, 2)
    W, x6, x3 = rnd(B * O, 6, 3), rnd(B * O, 6), rnd(B * O, 3)
    U, xc = rnd(B * C, 6, 6), rnd(B * C, 6)
    V, xp = rnd(B * P, 3, 3), rnd(B * P, 3)
    out["einsum oia,oib->oab"] = diff(lambda a: torch.einsum("oia,oib->oab", a, a), Jc)
    out["einsum oia,oi->oa"] = diff(lambda a, b: torch.einsum("oia,oi->oa", a, b), Jc, r)
    out["einsum oab,oa->ob"] = diff(lambda a, b: torch.einsum("oab,oa->ob", a, b), W, x6)
    out["einsum oab,ob->oa"] = diff(lambda a, b: torch.einsum("oab,ob->oa", a, b), W, x3)
    out["einsum cab,cb->ca"] = diff(lambda a, b: torch.einsum("cab,cb->ca", a, b), U, xc)
    out["einsum pab,pb->pa"] = diff(lambda a, b: torch.einsum("pab,pb->pa", a, b), V, xp)
    out["mul-sum oab,oa->ob"] = diff(lambda a, b: (a * b[:, :, None]).sum(1), W, x6)
    out["mul-sum oab,ob->oa"] = diff(lambda a, b: (a * b[:, None, :]).sum(-1), W, x3)
    out["mul-sum cab,cb->ca"] = diff(lambda a, b: (a * b[:, None, :]).sum(-1), U, xc)
    out["mul-sum pab,pb->pa"] = diff(lambda a, b: (a * b[:, None, :]).sum(-1), V, xp)
    spd = U @ U.transpose(1, 2) + 6 * torch.eye(6, device=dev)
    out["linalg.inv_ex 6x6"] = diff(lambda a: torch.linalg.inv_ex(a).inverse, spd)
    out["linalg.inv 6x6"] = diff(lambda a: torch.linalg.inv(a), spd)
    w3 = 0.3 * rnd(B * C, 3)
    out["so3_exp"] = diff(so3_exp, w3)
    out["so3_exp_jacobian"] = diff(so3_exp_jacobian, w3)
    cams = torch.cat([0.1 * rnd(B * C, 3), rnd(B * C, 3)], 1)
    pts = rnd(B * P, 3) + torch.tensor([0.0, 0.0, 8.0], device=dev)
    ci = torch.randint(0, C, (B, O), generator=g).to(dev) + torch.arange(B, device=dev)[:, None] * C
    pi = torch.randint(0, P, (B, O), generator=g).to(dev) + torch.arange(B, device=dev)[:, None] * P
    uv, w = 0.1 * rnd(B * O, 2), torch.ones(B * O, device=dev)
    whole = observation_jacobians(cams, pts, ci.reshape(-1), pi.reshape(-1), uv, w)
    worst = 0.0
    for b in range(B):
        part = observation_jacobians(cams[b * C:(b + 1) * C], pts[b * P:(b + 1) * P],
                                     ci[b] - b * C, pi[b] - b * P, uv[b * O:(b + 1) * O],
                                     w[b * O:(b + 1) * O])
        for t, p in zip(whole, part):
            worst = max(worst, (t[b * O:(b + 1) * O] - p).abs().max().item())
    out["observation_jacobians"] = worst
    dots = rnd(B, 6 * C)
    out["sum over 6C per problem"] = max(
        (dots.sum(1)[b] - dots[b:b + 1].sum(1)[0]).abs().item() for b in range(B))
    big = rnd(B, 2 * O)
    out["sum over 2O per problem"] = max(
        (big.sum(1)[b] - big[b:b + 1].sum(1)[0]).abs().item() for b in range(B))
    out["tree over 2O per problem"] = max(
        (lm._problem_sum(big, B)[b] - lm._problem_sum(big[b:b + 1], 1)[0]).abs().item()
        for b in range(B))
    idx = torch.sort(ci.reshape(-1)).values
    rows = lm._segments(idx, B * C)
    x = rnd(B * O, 6, 6)
    seg_tree = lm._seg_sum(x, rows)
    pad = torch.cat([x, x.new_zeros((1, 6, 6))])
    seg_sum = pad[rows].sum(1)
    worst_t = worst_s = 0.0
    for b in range(B):
        sl = slice(b * O, (b + 1) * O)
        rb = lm._segments(idx[sl] - b * C, C)
        xb = x[sl]
        worst_t = max(worst_t, (seg_tree[b * C:(b + 1) * C]
                                - lm._seg_sum(xb, rb)).abs().max().item())
        pb = torch.cat([xb, xb.new_zeros((1, 6, 6))])
        worst_s = max(worst_s, (seg_sum[b * C:(b + 1) * C] - pb[rb].sum(1)).abs().max().item())
    out["segment sum, tree of fours"] = worst_t
    out["segment sum, torch.sum over the width"] = worst_s
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
