"""Plain PyTorch training steps of a plenoxel grid: the reference that the
benchmark holds the program's first training steps against.

A step renders a batch of rays (reference/render.py) at depths jittered by
the given uniforms, takes the mean squared error against the rays' colours,
differentiates it with respect to the trained grid by autograd (the gather's
backward), and updates the grid with Adam (betas, eps outside the root,
bias-corrected, as Kingma and Ba) or RMSprop (eps inside the root, from a
zero second moment). The trained grid starts as a constant; a cascade's
frozen base is added before the activations and gets no gradient.

The grid is compared leaf by leaf, a leaf being one group of its channels:
the density, and the 9 SH coefficients of each colour.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from portbench.reference.render import Grids, render_rays, render_rays_hierarchical

LEAVES = (("density", 0, 1), ("sh_r", 1, 10), ("sh_g", 10, 19), ("sh_b", 19, 28))


def channel_sq_sums(t: torch.Tensor, minus: float = 0.0) -> List[float]:
    """Sum of squares of each channel of an (..., C) tensor less ``minus``,
    one channel at a time (no copy of the whole tensor), in float64."""
    return [float(torch.sum((t[..., c].double() - minus) ** 2)) for c in range(t.shape[-1])]


def channel_sums(t: torch.Tensor) -> List[float]:
    return [float(torch.sum(t[..., c].double())) for c in range(t.shape[-1])]


def leaf_norms(sq: Sequence[float]) -> Dict[str, float]:
    """Each leaf's L2 norm from its channels' sums of squares."""
    return {name: math.sqrt(sum(sq[a:b])) for name, a, b in LEAVES}


class StepConfig:
    """What a reference step needs of a configuration."""

    def __init__(self, cfg: dict, near: float, far: float):
        self.near, self.far = near, far
        self.n_samples = int(cfg["num_samples"])
        self.clip = bool(cfg["per_ray_aabb"])
        self.contracted = bool(cfg["contraction"])
        self.hierarchical = bool(cfg["hierarchical"])
        self.n_coarse, self.n_fine = int(cfg.get("n_coarse", 64)), int(cfg.get("n_fine", 64))


def loss(g: Grids, sc: StepConfig, o, d, rgb, u, u_fine) -> torch.Tensor:
    if sc.hierarchical:
        pred = render_rays_hierarchical(g, o, d, sc.near, sc.far, sc.n_coarse, sc.n_fine,
                                        sc.clip, sc.contracted, u, u_fine)
    else:
        pred = render_rays(g, o, d, sc.near, sc.far, sc.n_samples, sc.clip, sc.contracted, u)
    return ((pred - rgb) ** 2).mean()


def train_steps(sc: StepConfig, opt: dict, shape: Tuple[int, ...], init: float, lo, hi,
                batches: Sequence[Tuple[torch.Tensor, ...]],
                draws: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]],
                base: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
                dtype=torch.float32, half_batch: bool = False) -> dict:
    """Steps from a constant grid ``init`` of ``shape`` over [lo, hi], one
    per batch (origins, directions, colours) with its draws (u, u_fine),
    computed in ``dtype``. ``half_batch`` plants a fault: each step's loss
    over the first half of its batch only. Returns {"losses": [...],
    "grad": leaf norms of the first step's gradient, "change": leaf norms
    of the grid's change after the last step}."""
    dev = lo.device
    p = torch.full(shape, init, dtype=dtype, device=dev, requires_grad=True)
    m = torch.zeros_like(p, requires_grad=False)
    v = torch.zeros_like(p, requires_grad=False) if opt["name"] == "adam" else None
    lo_c, hi_c = lo.to(dtype), hi.to(dtype)
    b = None if base is None else tuple(t.to(dtype) for t in base)
    losses, grad = [], None
    for t, ((o, d, rgb), (u, uf)) in enumerate(zip(batches, draws), start=1):
        if half_batch:
            h = o.shape[0] // 2
            o, d, rgb, u = o[:h], d[:h], rgb[:h], u[:h]
            uf = None if uf is None else uf[:h]
        g = Grids(p, lo_c, hi_c, *(b or ()))
        cast = [x.to(dtype) for x in (o, d, rgb, u)]
        lv = loss(g, sc, *cast, None if uf is None else uf.to(dtype))
        (gr,) = torch.autograd.grad(lv, p)
        losses.append(float(lv.detach()))
        if t == 1:
            grad = leaf_norms(channel_sq_sums(gr))
        with torch.no_grad():
            lr = opt["lr"]
            if opt["name"] == "adam":
                b1, b2 = opt["betas"]
                m.mul_(b1).add_(gr, alpha=1 - b1)
                v.mul_(b2).addcmul_(gr, gr, value=1 - b2)
                denom = (v.sqrt() / math.sqrt(1 - b2 ** t)).add_(opt["eps"])
                p.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))
            else:
                m.mul_(opt["decay"]).addcmul_(gr, gr, value=1 - opt["decay"])
                p.addcmul_(gr, torch.rsqrt(m + opt["eps"]), value=-lr)
        del gr
    change = leaf_norms(channel_sq_sums(p.detach(), init))
    return {"losses": losses, "grad": grad, "change": change}
