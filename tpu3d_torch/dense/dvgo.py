"""DVGO's fine stage as ``densify --model dvgo``: Sun, Sun and Chen, "Direct
Voxel Grid Optimization: Super-fast Convergence for Radiance Fields
Reconstruction", CVPR 2022, arXiv:2111.11215; code
github.com/sunset1995/DirectVoxGO (``configs/default.py``
``fine_model_and_render`` / ``fine_train``, ``lib/dvgo.py``,
``lib/masked_adam.py``). An explicit voxel grid whose colour comes from a
shallow MLP, at the published widths:

- one (X, Y, Z, 13) grid: channel 0 is DVGO's raw density grid, channels
  1-12 its feature grid ``k0`` (``rgbnet_dim`` 12); every per-element rule
  of the two (the masked update, the colour skipping) holds per element;
- post-activated density: trilinear on the raw density D, then
  alpha = 1 - (1 + exp(D + b))^(-iota), b = log(1 / (1 - alpha_init) - 1),
  iota = ``stepsize`` 0.5 (``voxel_size_ratio`` 1), computed as
  1 - exp(-iota softplus(D + b)), the same number with a finite gradient;
- the first release's dense ``sample_ray``: S = int(||res + 1|| / 0.5) + 1
  steps of half a voxel from the ray's box entry (clamped to [near, far]);
  a training ray jittered by one uniform; a sample outside the box is dead
  (alpha 0, not the alpha of a zero density);
- ``fast_color_thres`` tau 1e-4: alpha' = alpha [alpha > tau],
  w_k = alpha'_k prod_{j<k} (1 - alpha'_j), T_last = prod (1 - alpha'_j),
  each factor clamped below at 1e-10 as DVGO's ``cumprod_exclusive`` (the
  products as exponentials of sums of logs, -iota softplus(D + b), so no
  factor is divided by), colour only where w_k > tau;
- colour c = sigmoid(MLP([k0(x), d, sin(2^l d), cos(2^l d)]_{l=0..3})), the
  MLP Linear(39, 128)-ReLU-Linear(128, 128)-ReLU-Linear(128, 3)
  (``rgbnet_direct``, depth 3, width 128, ``viewbase_pe`` 4, last bias 0);
- pixel C = sum_k [w_k > tau] w_k c_k + T_last bg, white background;
- loss: MSE + 0.001 x the mean binary entropy of clamp(T_last, 1e-6,
  1 - 1e-6) + 0.01 x sum_k [w_k > tau] sg(w_k) ||c_k - C_gt||^2 / N;
- DVGO's MaskedAdam (dense/train.py :class:`MaskedAdam`), betas (0.9,
  0.99), eps 1e-8: the grid skips elements whose gradient is exactly 0, the
  MLP updates everywhere; lr 0.1 (grid) and 1e-3 (MLP), each x 0.1^(t /
  20000).

The step keeps the dense (N, S) layout with masks: every sample of every
ray is sampled, read from the grid and composited (``dense.rgbnet_rows``
counts them), and the masks zero what DVGO's equations leave out. Only the
samples they colour (``dense.colour_samples``) go through the MLP, as DVGO
skips the others: kernels/rgbnet.py compacts their rows on the device and
runs the MLP's forward and backward on them alone (hand-written kernels on
the card that read the row count there, so a step still replays as one
CUDA graph; ``dense.rgbnet_rows_run`` counts the rows they ran), and every
other sample's colour and k0 cotangent is 0. The trilinear gather and its
scatter are the plenoxel step's kernels at 13 channels; the MLP's forward
and backward, compaction included, are one autograd Function whose device
spans are ``dense.rgbnet`` and ``dense.rgbnet_backward``. The grid spans
[-scene_scale, scene_scale]^3.
"""
from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpu3d_torch import resolve_device
from tpu3d_torch.config import DenseConfig
from tpu3d_torch.dense.grid import VoxelGrid, create_grid
from tpu3d_torch.dense.train import (LAST_TRAIN_AUX, LrSchedule, MaskedAdam, RayDataset,
                                     StepNoise, TrainState, _train_loop, _update)
from tpu3d_torch.kernels.rgbnet import rgbnet_backward, rgbnet_forward
from tpu3d_torch.kernels.trilinear import trilinear_sample
from tpu3d_torch.kernels.trilinear_grad import trilinear_sample_diff
from tpu3d_torch.utils.trace import adopt, device_span, thread_context

K0_DIM = 12                    # rgbnet_dim
CHANNELS = 1 + K0_DIM          # the density and k0 in one grid
STEPSIZE = 0.5                 # half a voxel a step; also iota
ALPHA_INIT = 1e-2
FAST_COLOR_THRES = 1e-4        # tau
LOG_Q_MIN = math.log(1e-10)    # the transmittance factors' floor, as a log
VIEWBASE_PE = 4
RGBNET_WIDTH = 128
RGBNET_IN = K0_DIM + 3 + 2 * 3 * VIEWBASE_PE     # 39
WEIGHT_ENTROPY_LAST = 1e-3
WEIGHT_RGBPER = 1e-2
GRID_LR, RGBNET_LR = 0.1, 1e-3
LR_DECAY_STEPS = 20 * 1000     # lrate_decay 20, in thousands of steps
BETAS, EPS = (0.9, 0.99), 1e-8
TALLIES = ("dense.rgbnet_rows", "dense.colour_samples", "dense.rgbnet_rows_run")


def act_shift(alpha_init: float = ALPHA_INIT) -> float:
    """b = log(1 / (1 - alpha_init) - 1)."""
    return math.log(1.0 / (1.0 - alpha_init) - 1.0)


def n_samples(res: Sequence[int]) -> int:
    """S = int(||res + 1|| / stepsize) + 1: 558 at 160^3."""
    return int(np.linalg.norm(np.asarray(res, np.int64) + 1) / STEPSIZE) + 1


def step_length(lo: Sequence[float], hi: Sequence[float], res: Sequence[int]) -> float:
    """A step in world units: stepsize times DVGO's voxel size, the cube
    root of the box's volume over its voxel count."""
    vol = float(np.prod(np.asarray(hi, np.float64) - np.asarray(lo, np.float64)))
    return STEPSIZE * (vol / float(np.prod(np.asarray(res, np.float64)))) ** (1.0 / 3.0)


def sample_ray(rays_o: torch.Tensor, rays_d: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
               near: float, far: float, n: int, step: float,
               u: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(points (N, n, 3), dead (N, n)): ``n`` steps of ``step`` along each
    ray from its box entry (clamped to [near, far]), each ray's steps
    shifted by its uniform in ``u`` (N, 1) when given; a ray that misses
    the box, and a point outside it, is dead."""
    vec = torch.where(rays_d == 0, torch.full_like(rays_d, 1e-6), rays_d)
    rate_a = (hi - rays_o) / vec
    rate_b = (lo - rays_o) / vec
    t_min = torch.minimum(rate_a, rate_b).amax(-1).clamp(min=near, max=far)
    t_max = torch.maximum(rate_a, rate_b).amin(-1).clamp(min=near, max=far)
    rng = torch.arange(n, dtype=rays_o.dtype, device=rays_o.device)[None]
    if u is not None:
        rng = rng + u
    t = t_min[:, None] + step * rng / rays_d.norm(dim=-1, keepdim=True)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
    dead = (t_max <= t_min)[:, None] | ((lo > pts) | (pts > hi)).any(-1)
    return pts, dead


def view_encoding(dirs: torch.Tensor) -> torch.Tensor:
    """(N, 27): d, sin(2^l d), cos(2^l d) for l = 0..3, each block in
    DVGO's (coordinate, frequency) order."""
    freq = 2.0 ** torch.arange(VIEWBASE_PE, dtype=dirs.dtype, device=dirs.device)
    emb = (dirs[:, :, None] * freq).flatten(1)
    return torch.cat([dirs, emb.sin(), emb.cos()], -1)


def init_rgbnet(seed: int = 0, device="cpu") -> Tuple[torch.Tensor, ...]:
    """The colour MLP's leaves (W1 (128, 39), b1, W2 (128, 128), b2,
    W3 (3, 128), b3) as torch.nn.Linear initialises them, drawn on the CPU
    from ``seed``: U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the last bias 0."""
    g = torch.Generator().manual_seed(int(seed))
    out = []
    for fan_in, fan_out in ((RGBNET_IN, RGBNET_WIDTH), (RGBNET_WIDTH, RGBNET_WIDTH),
                            (RGBNET_WIDTH, 3)):
        bound = 1.0 / math.sqrt(fan_in)
        out.append(torch.empty(fan_out, fan_in).uniform_(-bound, bound, generator=g))
        out.append(torch.empty(fan_out).uniform_(-bound, bound, generator=g))
    out[-1].zero_()
    return tuple(t.to(resolve_device(device)) for t in out)


class _RgbNet(torch.autograd.Function):
    """The colour MLP over the coloured samples: the view encoding of each
    ray's direction beside each coloured sample's k0, three linears with
    ReLU between, the sigmoid (kernels/rgbnet.py); (c (R, 3), 0 at every
    other sample, and the count of rows run). The forward is the device
    span ``dense.rgbnet``, the backward ``dense.rgbnet_backward``, recorded
    in the forward's thread context (the autograd engine runs a CUDA
    backward on its own thread). Saves what the backward needs only when
    ``save``."""

    @staticmethod
    def forward(ctx, k0, dirs, coloured, save, w1, b1, w2, b2, w3, b3):
        ctx.context = thread_context()
        params = (w1, b1, w2, b2, w3, b3)
        with device_span("dense.rgbnet"):
            c, count, saved = rgbnet_forward(k0, view_encoding(dirs), coloured, params, save)
        if saved is not None:
            ctx.save_for_backward(*saved, *params)
        ctx.mark_non_differentiable(count)
        return c, count

    @staticmethod
    def backward(ctx, g, _):
        *saved, w1, b1, w2, b2, w3, b3 = ctx.saved_tensors
        with adopt(ctx.context), device_span("dense.rgbnet_backward"):
            gk0, grads = rgbnet_backward(g, saved, (w1, b1, w2, b2, w3, b3))
        return (gk0, None, None, None, *grads)


def march(vg: VoxelGrid, rgbnet: Sequence[torch.Tensor], rays_o: torch.Tensor,
          rays_d: torch.Tensor, near: float, far: float, step: float,
          u: Optional[torch.Tensor] = None, tallies: Optional[dict] = None):
    """One batch of rays through the model, on a white background: (pixels
    (N, 3), colours (N, S, 3), 0 where uncoloured, the colouring weights
    [w > tau] w (N, S), T_last (N,), the coloured samples' mask (N, S)).
    Samples the grid with its gradient when it requires grad; adds the
    batch's samples, coloured samples and rows run through the MLP to
    ``tallies`` (:data:`TALLIES`) when given."""
    N = rays_o.shape[0]
    S = n_samples(vg.grid.shape[:3])
    pts, dead = sample_ray(rays_o, rays_d, vg.min_bound, vg.max_bound, near, far, S, step, u)
    fn = trilinear_sample_diff if vg.grid.requires_grad else trilinear_sample
    vals, _ = fn(vg.grid, vg.min_bound, vg.max_bound, pts.reshape(-1, 3))
    sp = F.softplus(vals[:, 0].view(N, S) + act_shift())
    alpha = -torch.expm1(-STEPSIZE * sp)
    live = ~dead & (alpha > FAST_COLOR_THRES)
    log_q = torch.where(live, torch.clamp(-STEPSIZE * sp, min=LOG_Q_MIN),
                        torch.zeros_like(sp))                       # log(1 - alpha')
    cum = torch.cumsum(log_q, -1)
    trans = torch.exp(torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], -1))
    w = torch.where(live, alpha, torch.zeros_like(alpha)) * trans
    t_last = torch.exp(cum[:, -1])
    coloured = w > FAST_COLOR_THRES
    k0 = vals[:, 1:]
    save = torch.is_grad_enabled() and any(t.requires_grad for t in (k0, *rgbnet))
    c, count = _RgbNet.apply(k0, rays_d, coloured, save, *rgbnet)
    c = c.view(N, S, 3)
    if tallies is not None:
        tallies["dense.rgbnet_rows"].add_(coloured.numel())
        tallies["dense.colour_samples"].add_(coloured.sum())
        tallies["dense.rgbnet_rows_run"].add_(count[0])
    wc = torch.where(coloured, w, torch.zeros_like(w))
    pix = (wc[..., None] * c).sum(1) + t_last[:, None]
    return pix, c, wc, t_last, coloured


def loss_terms(pix: torch.Tensor, c: torch.Tensor, wc: torch.Tensor, t_last: torch.Tensor,
               rgb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(MSE, the mean binary entropy of the clamped T_last, the per-sample
    colour loss sum_k sg(wc_k) ||c_k - C_gt||^2 / N)."""
    mse = ((pix - rgb) ** 2).mean()
    p = t_last.clamp(1e-6, 1 - 1e-6)
    entropy = -(p * torch.log(p) + (1 - p) * torch.log(1 - p)).mean()
    per = (((c - rgb[:, None, :]) ** 2).sum(-1) * wc.detach()).sum() / rgb.shape[0]
    return mse, entropy, per


def _step_length(cfg: DenseConfig, res: Sequence[int]) -> float:
    s = cfg.scene_scale
    return step_length((-s,) * 3, (s,) * 3, res)


def draw_noise(n_rays: int, generator: torch.Generator, device) -> StepNoise:
    """A training step's draws: one uniform a ray, (N, 1)."""
    return StepNoise(torch.rand((n_rays, 1), generator=generator, device=device))


def dvgo_train_step(state: TrainState, cfg: DenseConfig, rays_o: torch.Tensor,
                    rays_d: torch.Tensor, rgb: torch.Tensor, cid: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[StepNoise] = None) -> torch.Tensor:
    """One DVGO training step on a ray batch: the jittered march, the three
    loss terms, one backward for the grid and the MLP, the tallies, then
    MaskedAdam at each group's scheduled lr (dense/train.py ``_update``).
    Updates ``state`` in place and returns the loss as a 0-d device
    tensor (no host sync)."""
    vg = state.grid
    if noise is None:
        noise = draw_noise(rays_o.shape[0], generator, rays_o.device)
    pix, c, wc, t_last, _ = march(vg, state.params, rays_o, rays_d, cfg.near, cfg.far,
                                  _step_length(cfg, vg.grid.shape[:3]), noise.u, state.tallies)
    mse, entropy, per = loss_terms(pix, c, wc, t_last, rgb)
    loss = mse + WEIGHT_ENTROPY_LAST * entropy + WEIGHT_RGBPER * per
    return _update(state, cfg, loss, None, None)


def init_state(cfg: DenseConfig, grid: VoxelGrid, steps_per_epoch: int,
               n_cams: Optional[int] = None, seed: int = 0) -> TrainState:
    """A fresh TrainState that trains ``grid``'s storage in place (13
    channels) and the colour MLP of ``seed``, with MaskedAdam's two groups
    and their decaying lrs."""
    g = grid.grid.detach().requires_grad_()
    dev = g.device
    params = tuple(t.requires_grad_() for t in init_rgbnet(seed, dev))

    def lr(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    opt = MaskedAdam([{"params": [g], "lr": lr(GRID_LR), "skip_zero_grad": True},
                      {"params": list(params), "lr": lr(RGBNET_LR)}], betas=BETAS, eps=EPS)
    zero = functools.partial(torch.zeros, (), dtype=torch.int64, device=dev)
    return TrainState(VoxelGrid(g, grid.min_bound, grid.max_bound), opt,
                      LrSchedule(GRID_LR, (), LR_DECAY_STEPS), 0, None, None, zero(), params,
                      LrSchedule(RGBNET_LR, (), LR_DECAY_STEPS), {n: zero() for n in TALLIES})


def new_grid(cfg: DenseConfig, device) -> VoxelGrid:
    """DVGO's grids at cfg.grid_resolution^3 over [-s, s]^3 (s the
    scene scale), zero-initialised as DVGO initialises both."""
    s = cfg.scene_scale
    return create_grid(cfg.grid_resolution, (-s, -s, -s), (s, s, s), channels=CHANNELS,
                       init=0.0, device=device)


def train_dvgo(dataset: RayDataset, cfg: DenseConfig, seed: int = 0,
               grid: Optional[VoxelGrid] = None, verbose: bool = True, log_every: int = 170,
               checkpoint_store=None, resume: bool = False, device="cuda"
               ) -> Tuple[VoxelGrid, Tuple[torch.Tensor, ...], List[float]]:
    """DVGO's fine stage through the plenoxel loop (dense/train.py
    ``_train_loop``: the rays on the device, each epoch's permutation, every
    chunk through ``MultiStep``'s graph replays, the loss read back every
    ``log_every`` steps, a ``dense_ckpt`` each epoch and ``resume``).
    Returns (the trained grid, the MLP's leaves, the logged losses)."""
    dev = resolve_device(device)
    vg, losses = _train_loop(dataset, cfg, seed, grid or new_grid(cfg, dev), verbose, log_every,
                             dev, step_fn=dvgo_train_step, with_occ=False, prefix="[dvgo]",
                             checkpoint_store=checkpoint_store, resume=resume,
                             init=functools.partial(init_state, seed=seed))
    return vg, tuple(LAST_TRAIN_AUX["params"]), losses


@torch.no_grad()
def render_image(vg: VoxelGrid, rgbnet: Sequence[torch.Tensor], rays_o: torch.Tensor,
                 rays_d: torch.Tensor, near: float, far: float, chunk: int = 8192
                 ) -> torch.Tensor:
    """(N, 3) colours of rays through the model, unjittered, in chunks of
    ``chunk`` rays, on a white background."""
    step = step_length(vg.min_bound.tolist(), vg.max_bound.tolist(), vg.grid.shape[:3])
    return torch.cat([march(vg, rgbnet, rays_o[s:s + chunk], rays_d[s:s + chunk], near, far,
                            step)[0] for s in range(0, rays_o.shape[0], chunk)])


def rgbnet_arrays(rgbnet: Sequence[torch.Tensor]) -> dict:
    """The MLP's leaves as a saved grid's arrays ``rgbnet_0`` .. ``rgbnet_5``."""
    return {f"rgbnet_{i}": t.detach().cpu().numpy() for i, t in enumerate(rgbnet)}


def rgbnet_from_arrays(arrays: dict, device) -> Optional[Tuple[torch.Tensor, ...]]:
    """The MLP's leaves from a saved grid's arrays, or None without them."""
    if "rgbnet_0" not in arrays:
        return None
    return tuple(torch.as_tensor(np.asarray(arrays[f"rgbnet_{i}"], np.float32), device=device)
                 for i in range(6))


def check_flags(flags: dict) -> None:
    """Refuse the densify options that DVGO's fine stage does not take: a
    ValueError naming each flag in ``flags`` (flag -> value) whose value is
    set."""
    bad = [k for k, v in flags.items() if v]
    if bad:
        raise ValueError(f"--model dvgo does not take {', '.join(bad)}")

