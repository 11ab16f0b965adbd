"""Plain PyTorch training steps of DVGO's fine stage: the reference that the
benchmark holds the program's first DVGO training steps against.

DVGO: Sun, Sun and Chen, CVPR 2022, arXiv:2111.11215; code
github.com/sunset1995/DirectVoxGO (``configs/default.py``
``fine_model_and_render`` / ``fine_train``, ``lib/dvgo.py``,
``lib/masked_adam.py``). A step, in float32 with TF32 off:

- samples each ray at S = int(||res + 1|| / 0.5) + 1 steps of half a voxel
  (voxel = the cube root of the box's volume over res^3) from its box entry
  clamped to [near, far], the steps shifted by the ray's uniform; a ray that
  misses the box, and a sample outside it, is dead;
- gathers the 8 corners of each sample's cell by indexing (align-corners
  trilinear on the grid's nodes; a point outside the box reads the nearest
  point of the box) and differentiates through it with autograd;
- alpha = 1 - (1 + exp(D + b))^(-0.5), b = log(1 / (1 - 0.01) - 1), 0 on a
  dead sample (as -expm1(-0.5 log1p(exp(D + b)))); alpha' = alpha [alpha > 1e-4]; the transmittance the
  cumulative product of clamp_min(1 - alpha', 1e-10) (DVGO's
  ``cumprod_exclusive``); w = alpha' T; colour where w > 1e-4;
- c = sigmoid(MLP([k0, d, sin(2^l d), cos(2^l d)])), the MLP 39-128-128-3
  with ReLU (``torch.nn.functional.linear``);
- loss = MSE + 0.001 x the mean entropy of clamp(T_last, 1e-6, 1 - 1e-6) +
  0.01 x sum [w > 1e-4] sg(w) ||c - C_gt||^2 / N, white background;
- MaskedAdam (betas 0.9, 0.99, eps 1e-8; step lr sqrt(1 - b2^t) / (1 -
  b1^t)): on the grid only the elements whose gradient is not 0, the MLP
  everywhere; lr 0.1 and 1e-3, each x 0.1^((t - 1) / 20000) at step t.

Departures from DVGO's code, each on purpose:

- The density and ``k0`` share one (X, Y, Z, 13) grid, channels last, as
  the program holds them; DVGO keeps a (1, 1, X, Y, Z) and a (1, 12, X, Y,
  Z) grid and samples them with ``grid_sample`` (align_corners=True). The
  interpolation and every per-element rule are the same.
- The lr decay in closed form; DVGO multiplies each group's lr by
  0.1^(1/20000) after every step.
- The fine stage alone: no coarse stage and so no mask cache (every in-box
  sample is live), no progressive growing (the grid at its resolution from
  step 0), all the training rays (not ``in_maskcache``), the box given (the
  program's normalised box, not a bound scaled by ``world_bound_scale``).
- The MLP's first weights are given (the program's, as torch.nn.Linear
  draws them), not drawn here.
- The view directions are the rays' directions as given (unit vectors).
- alpha through expm1 and log1p: DVGO's CUDA ``raw2alpha`` forms 1 +
  exp(D + b) and 1 - pow(...) in float32, whose cancellations lose ~1e-5 of
  alpha near alpha_init (a bias of that size in every gradient).

Faults, for the limits' readings: ``half_batch`` (each step's loss over the
first half of its batch), ``tf32`` (each linear's inputs rounded to TF32's
10-bit mantissa, as a tensor core takes them), ``plain_adam`` (the grid's
update not masked), ``no_box_mask`` (samples outside the box read the
clamped gather's density, not alpha 0), ``no_tau`` (neither tau filter).

The model is compared leaf by leaf: the density, k0, and each linear
layer's weight and bias together.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

STEPSIZE, ALPHA_INIT, TAU = 0.5, 1e-2, 1e-4
K0_DIM, PE = 12, 4
W_ENTROPY, W_RGBPER = 1e-3, 1e-2
GRID_LR, RGBNET_LR, DECAY_STEPS = 0.1, 1e-3, 20000
BETAS, EPS = (0.9, 0.99), 1e-8
LEAVES = ("density", "k0", "rgbnet_0", "rgbnet_1", "rgbnet_2")


class Spec:
    """What a step needs of the configuration: the grid's resolution and
    box [-s, s]^3, the band, the sample count and the step."""

    def __init__(self, res: Sequence[int], scene_scale: float, near: float, far: float):
        self.res = tuple(int(r) for r in res)
        self.s, self.near, self.far = float(scene_scale), float(near), float(far)
        self.n = int(np.linalg.norm(np.asarray(self.res) + 1) / STEPSIZE) + 1
        voxel = ((2 * self.s) ** 3 / float(np.prod(self.res))) ** (1.0 / 3.0)
        self.step = STEPSIZE * voxel


def leaf_sq_sums(grid: torch.Tensor, params: Sequence[torch.Tensor],
                 grid0: Optional[torch.Tensor] = None,
                 params0: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, float]:
    """Each leaf's sum of squares (less ``grid0`` / ``params0`` when given),
    in float64, one channel of the grid at a time."""
    def sq(t, t0=None):
        d = t.double() if t0 is None else t.double() - t0.double()
        return float(torch.sum(d * d))

    ch = [sq(grid[..., c], None if grid0 is None else grid0[..., c])
          for c in range(grid.shape[-1])]
    out = {"density": ch[0], "k0": sum(ch[1:])}
    for i in range(3):
        out[f"rgbnet_{i}"] = sum(sq(params[2 * i + j],
                                    None if params0 is None else params0[2 * i + j])
                                 for j in (0, 1))
    return out


def leaf_norms(sq: Dict[str, float]) -> Dict[str, float]:
    return {k: math.sqrt(v) for k, v in sq.items()}


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to nearest (even) at TF32's 10-bit mantissa, the
    gradient passed through."""
    i = t.detach().float().contiguous().view(torch.int32)
    r = ((i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF).view(torch.float32).to(t.dtype)
    return t + (r - t).detach()


def gather(grid: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
           pts: torch.Tensor) -> torch.Tensor:
    """(M, C) align-corners trilinear values of an (X, Y, Z, C) grid at
    (M, 3) points, the 8 corners gathered by indexing."""
    X, Y, Z, C = grid.shape
    res = torch.tensor([X, Y, Z], dtype=pts.dtype, device=pts.device)
    v = (pts - lo) / (hi - lo) * (res - 1)
    i0 = torch.minimum(torch.floor(v).clamp(min=0), res - 2)
    f = (v - i0).clamp(0, 1)       # a point outside the box reads the nearest face
    i0 = i0.long()
    flat = grid.reshape(-1, C)
    out = 0
    for a in (0, 1):
        for b in (0, 1):
            for c in (0, 1):
                idx = ((i0[:, 0] + a) * Y + i0[:, 1] + b) * Z + i0[:, 2] + c
                wgt = ((f[:, 0] if a else 1 - f[:, 0]) * (f[:, 1] if b else 1 - f[:, 1])
                       * (f[:, 2] if c else 1 - f[:, 2]))
                out = out + wgt[:, None] * flat[idx]
    return out


def step_loss(grid, params, lo, hi, sp: Spec, o, d, rgb, u, **faults) -> torch.Tensor:
    """One batch's loss, the sum of its three weighted terms."""
    _, mse, entropy, per = step_terms(grid, params, lo, hi, sp, o, d, rgb, u, **faults)
    return mse + W_ENTROPY * entropy + W_RGBPER * per


def step_terms(grid, params, lo, hi, sp: Spec, o, d, rgb, u, tf32=False, no_box_mask=False,
               no_tau=False) -> Tuple[torch.Tensor, ...]:
    """One batch through the model: (pixels (N, 3), the MSE, the mean
    entropy of T_last, the per-sample colour loss)."""
    N, S, dt = o.shape[0], sp.n, o.dtype
    vec = torch.where(d == 0, torch.full_like(d, 1e-6), d)
    rate_a, rate_b = (hi - o) / vec, (lo - o) / vec
    t_min = torch.minimum(rate_a, rate_b).amax(-1).clamp(min=sp.near, max=sp.far)
    t_max = torch.maximum(rate_a, rate_b).amin(-1).clamp(min=sp.near, max=sp.far)
    rng = torch.arange(S, dtype=dt, device=o.device)[None] + u
    t = t_min[:, None] + sp.step * rng / d.norm(dim=-1, keepdim=True)
    pts = o[:, None, :] + d[:, None, :] * t[..., None]
    dead = (t_max <= t_min)[:, None] | ((lo > pts) | (pts > hi)).any(-1)
    if no_box_mask:
        dead = torch.zeros_like(dead)
    vals = gather(grid, lo, hi, pts.reshape(-1, 3))
    shift = math.log(1.0 / (1.0 - ALPHA_INIT) - 1.0)
    # 1 - (1 + e^x)^(-iota), without float32's cancellation in 1 + e^x and 1 - (...)
    alpha = -torch.expm1(-STEPSIZE * torch.log1p(torch.exp(vals[:, 0].view(N, S) + shift)))
    live = ~dead if no_tau else ~dead & (alpha > TAU)
    alpha = torch.where(live, alpha, torch.zeros_like(alpha))
    trans = torch.cat([torch.ones_like(alpha[:, :1]),
                       (1 - alpha).clamp_min(1e-10).cumprod(-1)], -1)
    w = alpha * trans[:, :-1]
    t_last = trans[:, -1]
    coloured = torch.ones_like(live) if no_tau else w > TAU
    freq = 2.0 ** torch.arange(PE, dtype=dt, device=o.device)
    emb = (d[:, :, None] * freq).flatten(1)
    emb = torch.cat([d, emb.sin(), emb.cos()], -1)
    x = torch.cat([vals[:, 1:].view(N, S, K0_DIM), emb[:, None, :].expand(N, S, emb.shape[1])],
                  -1).view(N * S, -1)
    h = x
    for i in range(3):
        wgt, b = params[2 * i], params[2 * i + 1]
        h = F.linear(_tf32(h), _tf32(wgt), b) if tf32 else F.linear(h, wgt, b)
        if i < 2:
            h = F.relu(h)
    c = torch.sigmoid(h).view(N, S, 3)
    wc = torch.where(coloured, w, torch.zeros_like(w))
    pix = (wc[..., None] * c).sum(1) + t_last[:, None]
    mse = ((pix - rgb) ** 2).mean()
    p = t_last.clamp(1e-6, 1 - 1e-6)
    entropy = -(p * torch.log(p) + (1 - p) * torch.log(1 - p)).mean()
    per = (((c - rgb[:, None, :]) ** 2).sum(-1) * wc.detach()).sum() / N
    return pix, mse, entropy, per


def masked_adam(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, t: int,
                lr: float, masked: bool) -> None:
    """DVGO's update of one leaf at step t (1-based), in place; with
    ``masked`` only where the gradient is not 0."""
    b1, b2 = BETAS
    size = lr * math.sqrt(1 - b2 ** t) / (1 - b1 ** t)
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * g * g
    p_new = p - size * m_new / (torch.sqrt(v_new) + EPS)
    keep = (g == 0) if masked else torch.zeros_like(g, dtype=torch.bool)
    for old, new in ((m, m_new), (v, v_new), (p, p_new)):
        old.copy_(torch.where(keep, old, new))


def train_steps(sp: Spec, grid0: torch.Tensor, params0: Sequence[torch.Tensor],
                lo: torch.Tensor, hi: torch.Tensor, batches: Sequence[Tuple[torch.Tensor, ...]],
                draws: Sequence[torch.Tensor], dtype=torch.float32, half_batch: bool = False,
                tf32: bool = False, plain_adam: bool = False, no_box_mask: bool = False,
                no_tau: bool = False) -> dict:
    """Steps from ``grid0`` and the MLP's ``params0`` over [lo, hi], one per
    batch (origins, directions, colours) with its (B, 1) uniforms, in
    ``dtype`` with TF32 off (the faults as the module says). Returns
    {"losses": [...], "grad": leaf norms of the first step's gradient,
    "change": leaf norms of the model's change after the last step}."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        leaves = [grid0.to(dtype).clone().requires_grad_()]
        leaves += [q.to(dtype).clone().requires_grad_() for q in params0]
        moments = [(torch.zeros_like(q), torch.zeros_like(q)) for q in leaves]
        lo_c, hi_c = lo.to(dtype), hi.to(dtype)
        losses: List[float] = []
        grad = None
        for t, ((o, d, rgb), u) in enumerate(zip(batches, draws), start=1):
            if half_batch:
                h = o.shape[0] // 2
                o, d, rgb, u = o[:h], d[:h], rgb[:h], u[:h]
            lv = step_loss(leaves[0], leaves[1:], lo_c, hi_c, sp,
                           *(x.to(dtype) for x in (o, d, rgb, u)), tf32=tf32,
                           no_box_mask=no_box_mask, no_tau=no_tau)
            grads = torch.autograd.grad(lv, leaves)
            losses.append(float(lv.detach()))
            if t == 1:
                grad = leaf_norms(leaf_sq_sums(grads[0], grads[1:]))
            decay = 0.1 ** ((t - 1) / DECAY_STEPS)
            with torch.no_grad():
                for k, (q, g, (m, v)) in enumerate(zip(leaves, grads, moments)):
                    masked_adam(q, g, m, v, t, (GRID_LR if k == 0 else RGBNET_LR) * decay,
                                masked=k == 0 and not plain_adam)
            del grads
        change = leaf_norms(leaf_sq_sums(leaves[0].detach(), [q.detach() for q in leaves[1:]],
                                         grid0, params0))
        return {"losses": losses, "grad": grad, "change": change}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
