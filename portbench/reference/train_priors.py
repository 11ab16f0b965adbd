"""Plain PyTorch training steps of a plenoxel grid under the crop priors:
the reference that the benchmark holds the program's steps against when a
configuration turns the TV (and sparsity) priors on.

A step is reference/train.py's step (render, mean squared error, the
gradient by autograd) plus the priors of Plenoxels' loss on a block of the
grid at an origin drawn for the step:

- TV: for each axis, the mean over the block of the squared differences
  of neighbouring voxels, per channel, summed over the axes; the density
  channel's weighted by ``tv_sigma``, the 27 SH channels' summed and
  weighted by ``tv_sh``. The block is (crop + 1)^3, cut to the grid.
- sparsity: the mean over a crop^3 block of log(1 + relu(sigma)^2 / 0.25),
  weighted by ``sparsity_sigma``.

Their gradients are taken in closed form and added to the block's voxels
alone, so that a grid that fills the card needs nothing of its size for
them: TV, per axis, w 2 d / M added to the later neighbour and taken from
the earlier (d the difference, M the differences per channel); sparsity,
w (2 relu(sigma) / 0.25) / (1 + relu(sigma)^2 / 0.25) / M. The optimizer
(Adam or RMSprop, as reference/train.py's) updates the grid slab by slab
along x, the same arithmetic in pieces, so that its temporaries stay small.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from portbench.reference.render import Grids
from portbench.reference.train import StepConfig, channel_sq_sums, leaf_norms, loss

SLAB = 16           # x planes of the grid an optimizer pass updates at a time


def tv_size(shape: Sequence[int], crop: int) -> Tuple[int, int, int]:
    return tuple(min(crop, int(d) - 1) + 1 for d in shape[:3])


def sparsity_size(shape: Sequence[int], crop: int) -> Tuple[int, int, int]:
    return tuple(min(crop, int(d)) for d in shape[:3])


def _block(origin: Sequence[int], size: Sequence[int]):
    return tuple(slice(int(o), int(o) + int(n)) for o, n in zip(origin, size))


def tv_value_grad(block: torch.Tensor, w_sigma: float, w_sh: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w_sigma * density TV + w_sh * SH TV, its gradient with respect to
    the (n0, n1, n2, C) block)."""
    C = block.shape[-1]
    w = torch.full((C,), w_sh, dtype=block.dtype, device=block.device)
    w[0] = w_sigma
    per_channel = torch.zeros((C,), dtype=block.dtype, device=block.device)
    grad = torch.zeros_like(block)
    for axis in range(3):
        d = torch.diff(block, dim=axis)
        m = d.numel() // C
        per_channel = per_channel + (d * d).sum(dim=(0, 1, 2)) / m
        step = d * (2.0 * w / m)
        n = d.shape[axis]
        grad.narrow(axis, 1, n).add_(step)
        grad.narrow(axis, 0, n).sub_(step)
    return (w * per_channel).sum(), grad


def sparsity_value_grad(sigma: torch.Tensor, w: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w * mean log(1 + relu(sigma)^2 / 0.25), its gradient with respect
    to the densities ``sigma``)."""
    r = torch.relu(sigma)
    q = r * r / 0.25
    value = w * torch.log1p(q).mean()
    return value, w * (2.0 * r / 0.25) / (1.0 + q) / sigma.numel()


def priors(p: torch.Tensor, pri: dict, tv_origin, sparsity_origin) -> Tuple[torch.Tensor, list]:
    """The priors' value on grid ``p`` (no autograd) and their gradients,
    each as (block slices, gradient, channel or None)."""
    value = torch.zeros((), dtype=p.dtype, device=p.device)
    grads = []
    if pri.get("tv_sigma") or pri.get("tv_sh"):
        at = _block(tv_origin, tv_size(p.shape, pri["tv_crop"]))
        v, g = tv_value_grad(p[at], pri.get("tv_sigma", 0.0), pri.get("tv_sh", 0.0))
        value, grads = value + v, grads + [(at, g, None)]
    if pri.get("sparsity_sigma"):
        at = _block(sparsity_origin, sparsity_size(p.shape, pri["tv_crop"]))
        v, g = sparsity_value_grad(p[at][..., 0], pri["sparsity_sigma"])
        value, grads = value + v, grads + [(at, g, 0)]
    return value, grads


def optimizer_step(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: Optional[torch.Tensor],
                   opt: dict, t: int) -> None:
    """reference/train.py's Adam or RMSprop update of ``p`` in place, slab
    by slab along x."""
    lr = opt["lr"]
    for x0 in range(0, p.shape[0], SLAB):
        s = slice(x0, x0 + SLAB)
        if opt["name"] == "adam":
            b1, b2 = opt["betas"]
            m[s].mul_(b1).add_(g[s], alpha=1 - b1)
            v[s].mul_(b2).addcmul_(g[s], g[s], value=1 - b2)
            denom = (v[s].sqrt() / math.sqrt(1 - b2 ** t)).add_(opt["eps"])
            p[s].addcdiv_(m[s], denom, value=-lr / (1 - b1 ** t))
        else:
            m[s].mul_(opt["decay"]).addcmul_(g[s], g[s], value=1 - opt["decay"])
            p[s].addcmul_(g[s], torch.rsqrt(m[s] + opt["eps"]), value=-lr)


def train_steps(sc: StepConfig, opt: dict, pri: dict, shape: Tuple[int, ...], init: float,
                lo, hi, batches: Sequence[Tuple[torch.Tensor, ...]], draws: Sequence[tuple],
                base: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
                dtype=torch.float32, half_batch: bool = False) -> dict:
    """reference/train.py's train_steps with the priors ``pri`` (tv_sigma,
    tv_sh, tv_crop, sparsity_sigma) added to each step's loss and gradient.
    ``draws`` holds per step (u, u_fine, TV origin, sparsity origin), the
    origins as (3,) integer tensors or None. Returns {"losses", "grad",
    "change"} as reference/train.py's."""
    dev = lo.device
    p = torch.full(shape, init, dtype=dtype, device=dev, requires_grad=True)
    m = torch.zeros_like(p, requires_grad=False)
    v = torch.zeros_like(p, requires_grad=False) if opt["name"] == "adam" else None
    lo_c, hi_c = lo.to(dtype), hi.to(dtype)
    b = None if base is None else tuple(t.to(dtype) for t in base)
    losses, grad = [], None
    for t, ((o, d, rgb), (u, uf, tv_o, sp_o)) in enumerate(zip(batches, draws), start=1):
        if half_batch:
            h = o.shape[0] // 2
            o, d, rgb, u = o[:h], d[:h], rgb[:h], u[:h]
            uf = None if uf is None else uf[:h]
        g = Grids(p, lo_c, hi_c, *(b or ()))
        cast = [x.to(dtype) for x in (o, d, rgb, u)]
        lv = loss(g, sc, *cast, None if uf is None else uf.to(dtype))
        (gr,) = torch.autograd.grad(lv, p)
        with torch.no_grad():
            value, blocks = priors(p.detach(), pri,
                                   None if tv_o is None else tv_o.tolist(),
                                   None if sp_o is None else sp_o.tolist())
            for at, gb, channel in blocks:
                if channel is None:
                    gr[at] += gb
                else:
                    gr[at][..., channel] += gb
        losses.append(float(lv.detach() + value))
        if t == 1:
            grad = leaf_norms(channel_sq_sums(gr))
        with torch.no_grad():
            optimizer_step(p, gr, m, v, opt, t)
        del gr
    change = leaf_norms(channel_sq_sums(p.detach(), init))
    return {"losses": losses, "grad": grad, "change": change}
