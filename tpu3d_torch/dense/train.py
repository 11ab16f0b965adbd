"""Dense-stage training (tpu3d/dense/train.py): ray datasets from
registered cameras, the scene normalizations and the scene-derived sampling
band (numpy, on the host), and plenoxel training of the voxel grid on the
device: the lr schedule, the grid optimizers, the per-image exposure and
SH-background latents, the stochastic TV and sparsity priors, one training
step and ``train_plenoxel``, with tpu3d's ``dense_ckpt`` checkpoints, its
coarse-to-fine phase, its occupancy refreshes, its camera gate and the
frozen base of its two-level cascade, on tpu3d's loop cadence; and the SDF
grid's step and loop (``sdf_train_step``, ``train_sdf``). The loop also
trains DVGO's fine stage (dense/dvgo.py): a state with further leaves (its
colour MLP) in a second parameter group, per-group schedules with DVGO's
exponential decay, and DVGO's ``MaskedAdam``.

tpu3d has two step routes, ``make_train_step`` (XLA autodiff through the
gather) and ``make_train_step_packed`` (the Pallas kernel pair), and the
same two for the SDF grid; here ``train_step`` and ``sdf_train_step`` are
one step each whose backward runs through kernels/trilinear_grad.py (the
CUDA scatter kernel on the card). Random
draws (the depth jitter, the epoch permutation, the crop origins) come from
a ``torch.Generator``; tests inject tpu3d's draws instead (``StepNoise``).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tpu3d_torch import f32_scope, resolve_device
from tpu3d_torch.config import DenseConfig
from tpu3d_torch.core import lie
from tpu3d_torch.dense.grid import (CHANNELS, VoxelGrid, create_grid, eval_sh, grid_tensor,
                                    resample_grid)
from tpu3d_torch.dense.occupancy import occupancy_from_grid
from tpu3d_torch.dense.render import jitter_width, render_rays, render_rays_hierarchical
from tpu3d_torch.dense.sdf import ray_aabb
from tpu3d_torch.io.ply import filter_point_cloud
from tpu3d_torch.kernels import LAUNCHES
from tpu3d_torch.kernels.rmsprop import rmsprop_update
from tpu3d_torch.utils.cuda_graph import capture
from tpu3d_torch.utils.trace import device_span, get_tracer, graph_marks, hot_span, tracing


class RayDataset(NamedTuple):
    origins: np.ndarray   # (N, 3)
    dirs: np.ndarray      # (N, 3) unit
    rgb: np.ndarray       # (N, 3) in [0, 1]
    # Per-ray source-camera index (0..M-1); None for external ray files.
    cam_ids: Optional[np.ndarray] = None


@dataclasses.dataclass
class SceneNormalization:
    center: np.ndarray
    scale: float

    def apply(self, pts: np.ndarray) -> np.ndarray:
        return (pts - self.center) / self.scale


def normalize_scene_contracted(points: np.ndarray, core_q: float = 90.0,
                               core_radius: float = 0.9) -> SceneNormalization:
    """For the contraction warp: the p``core_q`` radius of the
    median-centred cloud lands at ``core_radius``."""
    center = np.median(points, axis=0)
    dist = np.linalg.norm(points - center, axis=1)
    extent = float(np.percentile(dist, core_q)) / core_radius
    return SceneNormalization(center.astype(np.float32), extent + 1e-9)


def normalize_scene(points: np.ndarray, target_extent: float = 1.0,
                    core_q: float = 92.0, margin: float = 1.15) -> SceneNormalization:
    """Gauge-invariant: median centre, extent = margin x p``core_q`` of
    the radial distances."""
    center = np.median(points, axis=0)
    dist = np.linalg.norm(points - center, axis=1)
    extent = margin * float(np.percentile(dist, core_q))
    return SceneNormalization(center.astype(np.float32),
                              float(extent / target_extent + 1e-9))


def normalize_scene_coremax(points: np.ndarray, target_extent: float = 1.0,
                            q: float = 80.0, k: float = 1.0) -> SceneNormalization:
    """Gauge-invariant form of the legacy normalization: keep points within
    k x p``q`` radial distance of the median, max-abs extent of those."""
    keep = core_points(points, q, k)
    p = keep if len(keep) else points
    center = p.mean(axis=0)
    extent = np.abs(p - center).max()
    return SceneNormalization(center.astype(np.float32),
                              float(extent / target_extent + 1e-9))


def normalize_scene_legacy(points: np.ndarray, target_extent: float = 1.0) -> SceneNormalization:
    """Outlier filter + per-axis max extent: what grids saved without a
    recorded normalization were trained under."""
    keep = filter_point_cloud(points)
    p = points[keep] if keep.any() else points
    center = p.mean(axis=0)
    extent = np.abs(p - center).max()
    return SceneNormalization(center.astype(np.float32), float(extent / target_extent + 1e-9))


def core_points(points: np.ndarray, q: float = 90.0, k: float = 4.0) -> np.ndarray:
    """Points within k x p``q`` radial distance of the median centre."""
    center = np.median(points, axis=0)
    dist = np.linalg.norm(points - center, axis=1)
    return points[dist <= k * np.percentile(dist, q)]


def rays_from_cameras(cams: np.ndarray, images_rgb: np.ndarray, focal: float,
                      norm: Optional[SceneNormalization] = None,
                      stride: int = 1) -> RayDataset:
    """Per-pixel world rays and colours. cams: (M, 6) [rvec | t]
    world->camera; images_rgb: (M, H, W, 3) uint8."""
    M, H, W, _ = images_rgb.shape
    ys, xs = np.meshgrid(np.arange(0, H, stride), np.arange(0, W, stride), indexing="ij")
    u = xs.reshape(-1).astype(np.float32) - W / 2.0
    v = -(ys.reshape(-1).astype(np.float32) - H / 2.0)
    d_cam = np.stack([u / focal, v / focal, np.ones_like(u)], axis=-1)
    origins, dirs, rgbs = [], [], []
    for m in range(M):
        R = lie.so3_exp_np(cams[m, :3])
        t = cams[m, 3:6]
        o = -R.T @ t
        d = d_cam @ R
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        if norm is not None:
            o = norm.apply(o)
        origins.append(np.broadcast_to(o, d.shape).copy())
        dirs.append(d.astype(np.float32))
        rgbs.append(images_rgb[m, ys.reshape(-1), xs.reshape(-1)].astype(np.float32) / 255.0)
    rays_per = len(ys.reshape(-1))
    return RayDataset(
        np.concatenate(origins).astype(np.float32),
        np.concatenate(dirs).astype(np.float32),
        np.concatenate(rgbs).astype(np.float32),
        np.repeat(np.arange(M, dtype=np.int32), rays_per),
    )


def auto_near_far(cams: np.ndarray, points: np.ndarray,
                  norm: Optional[SceneNormalization] = None) -> Tuple[float, float]:
    """Sampling band from the sparse cloud: percentiles of the points'
    depth along each (of up to ~32) camera's optical axis."""
    pts = core_points(points)
    if not len(pts):
        pts = points
    if norm is not None:
        pts = norm.apply(pts)
    depths = []
    for m in range(0, len(cams), max(len(cams) // 32, 1)):
        R = lie.so3_exp_np(cams[m, :3])
        C = -R.T @ cams[m, 3:6]
        if norm is not None:
            C = norm.apply(C)
        d = (pts - C) @ R[2]
        depths.append([np.percentile(d, 2), np.percentile(d, 98)])
    depths = np.asarray(depths)
    near = max(float(np.percentile(depths[:, 0], 10)) * 0.8, 1e-2)
    far = float(np.percentile(depths[:, 1], 90)) * 1.3
    return near, max(far, near + 1e-2)


def psnr(pred: np.ndarray, gt: np.ndarray) -> float:
    mse = float(np.mean((pred - gt) ** 2))
    return -10.0 * np.log10(mse + 1e-12)


# Aux outputs of the last train_plenoxel call, as tpu3d's: the learned
# background SH coefficients, the exposure gains and the cameras dropped by
# the camera gate; and the port's own record: the logged losses with their
# epoch, step in the epoch, update count and wall time ("log"), the update
# count ("steps"), the occupancy refreshes
# ("occupancy_refreshes": global step, epoch, occupied share), the gate's
# probe ("camera_gate") and, per training phase, its grid resolution,
# steps and log ("phases": coarse, then fine, or one phase).
LAST_TRAIN_AUX: Dict[str, object] = {}


class LrSchedule(NamedTuple):
    """optax.piecewise_constant_schedule(lr, {m * steps_per_epoch: gamma}):
    the lr of update k (0-based) is lr * gamma^#{m : m * steps_per_epoch <=
    k}, and with ``decay_steps`` also times 0.1^(k / decay_steps) (DVGO's
    per-step exponential decay, in closed form). Called with an int it gives
    the host's float; :meth:`on_device` gives the same number from a device
    count, for a step that a CUDA graph replays."""
    base: float
    boundaries: Tuple[Tuple[int, float], ...]   # (update count, scale), sorted
    decay_steps: float = 0.0

    def __call__(self, count: int) -> float:
        v = self.base
        for b, scale in self.boundaries:
            if count >= b:
                v *= scale
        if self.decay_steps:
            v *= 0.1 ** (count / self.decay_steps)
        return v

    def on_device(self, count: torch.Tensor) -> torch.Tensor:
        """The lr of update ``count`` (a 0-d integer tensor) as a 0-d f32
        tensor on its device, without reading it on the host: the host's
        float64 products, rounded to f32 as Adam rounds a float lr."""
        v = torch.full((), self.base, dtype=torch.float64, device=count.device)
        for b, scale in self.boundaries:
            v = torch.where(count >= b, v * scale, v)
        if self.decay_steps:
            v = v * torch.full_like(v, 0.1).pow(count.double() / self.decay_steps)
        return v.float()


def _lr_schedule(cfg: DenseConfig, steps_per_epoch: int) -> LrSchedule:
    """The grid's lr schedule (see :class:`LrSchedule`)."""
    boundaries = {m * steps_per_epoch: cfg.lr_gamma for m in cfg.lr_milestones}
    return LrSchedule(cfg.learning_rate, tuple(sorted(boundaries.items())))


class RMSprop(torch.optim.Optimizer):
    """optax.rmsprop(lr, decay, eps) as optax 0.2.6 computes it:
    nu <- (1 - decay) g^2 + decay nu from nu = 0, then p <- p - lr g / sqrt(nu
    + eps), eps INSIDE the root. torch.optim.RMSprop adds eps outside the
    root, which is another optimizer where nu is near 0. nu exists from the
    start and is updated in place, and the lr may be a device tensor, so
    that a CUDA graph can capture the step. The update is
    kernels/rmsprop.py::rmsprop_update: one ``rmsprop_kernel`` launch per
    parameter on the card, the plain torch version on the CPU."""

    def __init__(self, params, lr=1e-2, decay: float = 0.95, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["nu"] = torch.zeros_like(p, memory_format=torch.preserve_format)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    rmsprop_update(p, p.grad, self.state[p]["nu"], group["lr"],
                                   group["decay"], group["eps"])


class MaskedAdam(torch.optim.Optimizer):
    """DVGO's MaskedAdam (lib/masked_adam.py and its CUDA updates): Adam with
    eps outside the root and the step size lr sqrt(1 - b2^t) / (1 - b1^t),
    p -= step m / (sqrt(v) + eps). In a group with ``skip_zero_grad`` an
    element whose gradient is exactly zero is not touched: its p, m and v
    stay as they are; other groups update every element. Plain torch and
    capturable: the moments and the step count live on the parameters'
    device from the start, each group's lr is a 0-d device tensor that the
    training step sets, and the step size is computed there."""

    def __init__(self, groups, betas: Tuple[float, float] = (0.9, 0.99), eps: float = 1e-8):
        super().__init__(groups, dict(betas=betas, eps=eps, skip_zero_grad=False))
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = {"step": torch.zeros((), dtype=torch.float32, device=p.device),
                                 "exp_avg": torch.zeros_like(p),
                                 "exp_avg_sq": torch.zeros_like(p)}

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st, g = self.state[p], p.grad
                st["step"].add_(1)
                t = st["step"].double()
                size = (group["lr"].double() * torch.sqrt(1 - b2 ** t) / (1 - b1 ** t)).float()
                m = st["exp_avg"].mul(b1).add_(g, alpha=1 - b1)
                v = st["exp_avg_sq"].mul(b2).addcmul_(g, g, value=1 - b2)
                upd = m.mul(size).div_(v.sqrt().add_(group["eps"]))
                if group["skip_zero_grad"]:
                    nz = g != 0
                    m = torch.where(nz, m, st["exp_avg"])
                    v = torch.where(nz, v, st["exp_avg_sq"])
                    upd.masked_fill_(~nz, 0.0)
                st["exp_avg"].copy_(m)
                st["exp_avg_sq"].copy_(v)
                p.sub_(upd)


def make_optimizer(cfg: DenseConfig, grid: torch.Tensor) -> torch.optim.Optimizer:
    """The grid optimizer: Adam (betas 0.9/0.999, eps 1e-8 outside the root,
    as optax.adam: the same update m_hat / (sqrt(v_hat) + eps)), fused into
    one kernel, or with cfg.optimizer == "rmsprop" optax's rmsprop
    (:class:`RMSprop`). Both update the whole grid every step, as optax's:
    a voxel with zero gradient still moves under Adam's momentum. The lr is
    a 0-d f32 tensor on the grid's device that each step sets from the
    schedule (TrainState.lr), and Adam is capturable, so that a CUDA graph
    can replay the step (:func:`make_multi_step`)."""
    lr = torch.tensor(cfg.learning_rate, dtype=torch.float32, device=grid.device)
    if cfg.optimizer == "rmsprop":
        return RMSprop([grid], lr=lr, decay=0.95, eps=1e-8)
    opt = torch.optim.Adam([grid], lr=lr, betas=(0.9, 0.999), eps=1e-8, fused=True,
                           capturable=True)
    # The eager steps (a graph's warm-up chunk, scan_chunk 1) are intended:
    # no warning that a capturable Adam runs uncaptured.
    opt._warned_capturable_if_run_uncaptured = True
    return opt


@dataclasses.dataclass
class TrainState:
    """What a training step reads and updates (in place: the grid and its
    moments are updated where they lie, as tpu3d donates its state, and so
    are the latents and the device count, which a CUDA graph's replays read
    and write)."""
    grid: VoxelGrid                       # grid.grid: the trained leaf
    optimizer: torch.optim.Optimizer
    lr: LrSchedule                        # the schedule, by update count
    step: int = 0                         # updates so far: the host's copy of ``count``
    # Per-image exposure latents (3, M, 3) = [log-gains, Adam m, Adam v].
    exposure: Optional[torch.Tensor] = None
    # View-directional background SH (3, 3, 9) = [coeffs, Adam m, Adam v].
    background: Optional[torch.Tensor] = None
    # Updates so far, a 0-d int64 tensor on the grid's device: the lr
    # schedule and the latents' bias correction read it there.
    count: Optional[torch.Tensor] = None
    # The model's leaves beside the grid (DVGO's colour MLP), the optimizer's
    # second parameter group, and their lr schedule.
    params: Tuple[torch.Tensor, ...] = ()
    params_lr: Optional[LrSchedule] = None
    # Counters that the step adds to on the device (0-d int64 tensors by
    # tracer counter name), folded into the tracer at a loss read-back.
    tallies: Optional[Dict[str, torch.Tensor]] = None

    def set_step(self, step: int) -> None:
        """Set the update count on the host and on the device."""
        self.step = int(step)
        self.count.fill_(self.step)

    def schedules(self) -> Tuple[LrSchedule, ...]:
        """Each parameter group's lr schedule: the grid's, then the
        further leaves'."""
        return (self.lr,) + ((self.params_lr,) if self.params else ())


def fold_tallies(state: TrainState) -> None:
    """The step's device tallies added to the tracer's counters while
    tracing is on, and zeroed in place (a captured step keeps adding to the
    same tensors): at a loss read-back, when the card has finished the
    chunk, so the one read waits for nothing."""
    if not state.tallies:
        return
    values = torch.stack(list(state.tallies.values())).tolist()
    for t in state.tallies.values():
        t.zero_()
    if tracing():
        for name, v in zip(state.tallies, values):
            get_tracer().count(name, v)


def init_exposure(n_cams: int, device="cpu") -> torch.Tensor:
    return torch.zeros((3, n_cams, 3), dtype=torch.float32, device=device)


def init_background(device="cpu") -> torch.Tensor:
    """(3, 3, 9) [coeffs, m, v], the coefficients white (DC 1/C0), so that
    training starts at the white-background behaviour."""
    g = torch.zeros((3, 9), dtype=torch.float32, device=device)
    g[:, 0] = 1.0 / 0.282095
    return torch.stack([g, torch.zeros_like(g), torch.zeros_like(g)])


def init_state(cfg: DenseConfig, grid: VoxelGrid, steps_per_epoch: int,
               n_cams: Optional[int] = None) -> TrainState:
    """A fresh TrainState that trains ``grid``'s storage in place, with the
    exposure latents for ``n_cams`` cameras when cfg.exposure and the
    background when cfg.sh_background."""
    g = grid.grid.detach().requires_grad_()
    dev = g.device
    return TrainState(
        VoxelGrid(g, grid.min_bound, grid.max_bound), make_optimizer(cfg, g),
        _lr_schedule(cfg, steps_per_epoch), 0,
        init_exposure(n_cams, dev) if cfg.exposure and n_cams is not None else None,
        init_background(dev) if cfg.sh_background else None,
        torch.zeros((), dtype=torch.int64, device=dev))


def _ray_background(bg_sh: Optional[torch.Tensor], rd: torch.Tensor) -> Optional[torch.Tensor]:
    """Per-ray background colours from (3, 9) SH coefficients."""
    if bg_sh is None:
        return None
    return eval_sh(bg_sh.expand(rd.shape[0], 3, 9), rd)


def _exposure_apply(pred: torch.Tensor, gains: Optional[torch.Tensor],
                    cid: Optional[torch.Tensor]) -> torch.Tensor:
    """pred * e^{gains[cid]}: the grid's colours in each photograph's
    exposure. gains: (M, 3) log-gains."""
    if gains is None or cid is None:
        return pred
    return pred * torch.exp(gains[cid])


def _exposure_adam(exposure: torch.Tensor, g: torch.Tensor, step, lr: float) -> torch.Tensor:
    """Adam on stacked latents [values, m, v] with the grid's step count,
    as tpu3d's manual update (kept out of the grid optimizer), in place.
    ``step`` is the update's 0-based count: an int, or a 0-d tensor on the
    latents' device (no host read, for a CUDA graph). Returns
    ``exposure``."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    gains, m, v = exposure[0], exposure[1], exposure[2]
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    t = ((step + 1).float() if torch.is_tensor(step)
         else torch.tensor(step + 1.0, dtype=torch.float32))
    mhat = m / (1 - torch.full_like(t, b1) ** t)
    vhat = v / (1 - torch.full_like(t, b2) ** t)
    gains = gains - lr * mhat / (torch.sqrt(vhat) + eps)
    return exposure.copy_(torch.stack([gains, m, v]))


def _crop_rows(shape, origin, size) -> torch.Tensor:
    """The (size[0], size[1], size[2]) row indices, into the (X*Y*Z, C)
    view of a grid of ``shape``, of the block at ``origin`` (a (3,) integer
    tensor, on the device, so no host sync)."""
    X, Y, Z = shape[:3]
    o = torch.as_tensor(origin)
    ax = [o[a] + torch.arange(size[a], device=o.device) for a in range(3)]
    return (ax[0][:, None, None] * Y + ax[1][None, :, None]) * Z + ax[2][None, None, :]


def _crop(grid: torch.Tensor, origin, size, channel: Optional[int] = None) -> torch.Tensor:
    """The size[0] x size[1] x size[2] block of ``grid`` at ``origin`` (a
    (3,) integer tensor, on the device, so no host sync), as one row gather
    on the (X*Y*Z, C) view; one channel of it when ``channel`` is given."""
    X, Y, Z, C = grid.shape
    rows = _crop_rows(grid.shape, torch.as_tensor(origin, device=grid.device), size)
    flat = grid.reshape(X * Y * Z, C)
    return flat[rows] if channel is None else flat[rows, channel]


def _tv_size(shape, crop: int) -> Tuple[int, int, int]:
    """The TV prior's block: (crop + 1)^3, cut to the grid."""
    return tuple(min(crop, d - 1) + 1 for d in shape[:3])


def _sparsity_size(shape, crop: int) -> Tuple[int, int, int]:
    """The sparsity prior's block: crop^3, cut to the grid."""
    return tuple(min(crop, d) for d in shape[:3])


def _tv_per_channel(c: torch.Tensor) -> torch.Tensor:
    """(C,) mean squared neighbour differences of a block, summed over the
    three axes."""
    return (((c[1:] - c[:-1]) ** 2).mean(dim=(0, 1, 2))
            + ((c[:, 1:] - c[:, :-1]) ** 2).mean(dim=(0, 1, 2))
            + ((c[:, :, 1:] - c[:, :, :-1]) ** 2).mean(dim=(0, 1, 2)))


def _tv_crop_loss(grid: torch.Tensor, origin, crop: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stochastic total variation on a (crop+1)^3 block at ``origin``:
    (density TV, summed SH TV), the mean squared neighbour differences."""
    per_ch = _tv_per_channel(_crop(grid, origin, _tv_size(grid.shape, crop)))
    return per_ch[0], per_ch[1:].sum()


def _sparsity_crop_loss(grid: torch.Tensor, origin, crop: int) -> torch.Tensor:
    """Cauchy sparsity on the density of a crop^3 block at ``origin``:
    mean log(1 + relu(sigma)^2 / 0.25)."""
    sig = torch.relu(_crop(grid, origin, _sparsity_size(grid.shape, crop), 0))
    return torch.log1p(sig * sig / 0.25).mean()


def _tv_value_grad(c: torch.Tensor, w_sigma: float, w_sh: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The TV prior on a block c (n0, n1, n2, C) without autograd: (density
    TV, summed SH TV, the gradient of w_sigma * density TV + w_sh * SH TV
    with respect to c), the gradient in closed form: for each axis, with d
    the neighbour differences and M their count per channel, w_c 2 d / M
    added to the later neighbour and taken from the earlier (rounded as
    autograd's mean, pow and sub backwards round them)."""
    per_ch = _tv_per_channel(c)
    w = torch.full(c.shape[-1:], w_sh, dtype=c.dtype, device=c.device)
    w[:1].fill_(w_sigma)
    g = torch.zeros_like(c)
    for dim in range(3):
        n = c.shape[dim] - 1
        d = c.narrow(dim, 1, n) - c.narrow(dim, 0, n)
        gd = (w / (d.numel() // d.shape[-1])) * (2 * d)
        g.narrow(dim, 1, n).add_(gd)
        g.narrow(dim, 0, n).sub_(gd)
    return per_ch[0], per_ch[1:].sum(), g


def _sparsity_value_grad(s: torch.Tensor, w: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sparsity prior on a block of densities s without autograd: (mean
    log(1 + relu(s)^2 / 0.25), the gradient of w times it with respect to
    s), the gradient in closed form, rounded as autograd's backwards of
    mean, log1p, the division, the product and relu round it."""
    sig = torch.relu(s)
    x = sig * sig / 0.25
    t = torch.full((), w, dtype=s.dtype, device=s.device) / s.numel() / (x + 1) / 0.25 * sig
    return torch.log1p(x).mean(), torch.where(sig > 0, t + t, torch.zeros_like(t))


class CropPrior(NamedTuple):
    """One crop prior of a step (``kind`` "tv" or "sparsity"): its block's
    ``origin`` from the step's draws, the crop size and the weights (TV:
    density, SH; sparsity: density)."""
    kind: str
    origin: torch.Tensor
    crop: int
    weights: Tuple[float, ...]


def _crop_priors(cfg: DenseConfig, noise: StepNoise) -> Tuple[CropPrior, ...]:
    """The TV and sparsity crop priors that cfg turns on, in the order the
    loss adds them."""
    out: Tuple[CropPrior, ...] = ()
    if cfg.tv_sigma or cfg.tv_sh:
        out += (CropPrior("tv", noise.tv_origin, cfg.tv_crop, (cfg.tv_sigma, cfg.tv_sh)),)
    if cfg.sparsity_sigma:
        out += (CropPrior("sparsity", noise.sparsity_origin, cfg.tv_crop,
                          (cfg.sparsity_sigma,)),)
    return out


def _apply_priors(grid: torch.Tensor, priors: Tuple[CropPrior, ...],
                  loss: torch.Tensor) -> torch.Tensor:
    """Each prior's value added to ``loss`` (in the order and with the
    roundings of the autograd form: TV density, TV SH, sparsity), and its
    gradient added to ``grid.grad`` in its block's rows alone, by one
    ``index_add_`` each (the rows are distinct, so the sums are in no
    question of order); nothing of the grid's size is allocated. Returns
    the loss."""
    X, Y, Z, C = grid.shape
    flat = grid.detach().view(X * Y * Z, C)
    gflat = grid.grad.view(X * Y * Z, C)
    for p in priors:
        if p.kind == "tv":
            rows = _crop_rows(grid.shape, p.origin, _tv_size(grid.shape, p.crop)).reshape(-1)
            c = flat[rows].view(*_tv_size(grid.shape, p.crop), C)
            tv_s, tv_c, g = _tv_value_grad(c, *p.weights)
            loss = loss + p.weights[0] * tv_s + p.weights[1] * tv_c
            gflat.index_add_(0, rows, g.view(-1, C))
        else:
            rows = _crop_rows(grid.shape, p.origin,
                              _sparsity_size(grid.shape, p.crop)).reshape(-1)
            value, g = _sparsity_value_grad(flat[rows, 0], p.weights[0])
            loss = loss + p.weights[0] * value
            gflat[:, 0].index_add_(0, rows, g)
    return loss


class StepNoise(NamedTuple):
    """The random numbers of one training step. tpu3d draws them from the
    step key: u = uniform(k, (B, S)) (sdf.py:71, or through sample_pdf
    under occupancy, occupancy.py:153); under ``hierarchical``, u from
    split(k)[0] over the n_coarse depths and u_fine from split(k)[1]
    (render.py:428); under contraction u covers the stratified three
    quarters of the depths (render.py:75); the TV and sparsity crop origins
    from fold_in(k, 7) and fold_in(k, 11) (train.py:302-306, 371-373)."""
    u: torch.Tensor                                  # (B, jitter_width(S or n_coarse))
    u_fine: Optional[torch.Tensor] = None            # (B, n_fine)
    tv_origin: Optional[torch.Tensor] = None         # (3,) int64
    sparsity_origin: Optional[torch.Tensor] = None   # (3,) int64


def draw_step_noise(cfg: DenseConfig, grid_shape, n_rays: int,
                    generator: torch.Generator, device) -> StepNoise:
    """One step's StepNoise from ``generator``, on ``device``."""
    X, Y, Z = grid_shape[:3]

    def origin(highs):
        return torch.stack([torch.randint(0, h, (), generator=generator, device=device)
                            for h in highs])

    def uniform(n):
        return torch.rand((n_rays, n), generator=generator, device=device)

    u = uniform(jitter_width(cfg.n_coarse if cfg.hierarchical else cfg.num_samples,
                             cfg.contraction))
    u_fine = uniform(cfg.n_fine) if cfg.hierarchical else None
    tv = (origin([d - min(cfg.tv_crop, d - 1) for d in (X, Y, Z)])
          if cfg.tv_sigma or cfg.tv_sh else None)
    sp = (origin([d - min(cfg.tv_crop, d) + 1 for d in (X, Y, Z)])
          if cfg.sparsity_sigma else None)
    return StepNoise(u, u_fine, tv, sp)


def _latents(state: TrainState, cid: Optional[torch.Tensor]):
    """(gains, bg_sh): the exposure latents (when the batch has camera ids)
    and the background latents as leaves that take a gradient in this
    step, or None."""
    gains = (state.exposure[0].clone().requires_grad_()
             if state.exposure is not None and cid is not None else None)
    bg_sh = state.background[0].clone().requires_grad_() if state.background is not None else None
    return gains, bg_sh


def _update(state: TrainState, cfg: DenseConfig, loss: torch.Tensor,
            gains: Optional[torch.Tensor], bg_sh: Optional[torch.Tensor],
            *priors: CropPrior) -> torch.Tensor:
    """One backward for the grid and the latents; then the crop
    ``priors``' values and gradients (:func:`_apply_priors`, the device
    span ``dense.prior``); the latents' Adam, then the grid optimizer at
    the scheduled lr, all from the device count (no host value that a graph
    replay would repeat).
    Returns the detached loss, the priors' values in it."""
    loss.backward()
    loss = loss.detach()
    with torch.no_grad():
        if priors:
            with device_span("dense.prior"):
                loss = _apply_priors(state.grid.grid, priors, loss)
        if gains is not None:
            _exposure_adam(state.exposure, gains.grad, state.count, cfg.exposure_lr)
        if bg_sh is not None:
            _exposure_adam(state.background, bg_sh.grad, state.count, cfg.background_lr)
        for group, schedule in zip(state.optimizer.param_groups, state.schedules()):
            group["lr"].copy_(schedule.on_device(state.count))
    with device_span("dense.optimizer"):
        state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.count.add_(1)
    state.step += 1
    return loss


def train_step(state: TrainState, cfg: DenseConfig, rays_o: torch.Tensor,
               rays_d: torch.Tensor, rgb: torch.Tensor, cid: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               noise: Optional[StepNoise] = None, occ: Optional[torch.Tensor] = None,
               base: Optional[VoxelGrid] = None) -> torch.Tensor:
    """One plenoxel training step on a ray batch, as tpu3d's step_body
    (train.py:420-443, 484-507): render with jittered depths (or
    hierarchically), MSE against the photographs' colours (after the
    exposure gains), plus the TV and sparsity priors; one backward gives the
    grid, exposure and background gradients; then the latents' Adam and the
    grid optimizer at the scheduled lr. ``noise`` injects the step's random
    numbers; otherwise they are drawn from ``generator``. ``occ`` is the
    occupancy grid that guides the depths (cfg.occupancy_prune);
    cfg.contraction warps the samples; ``base`` is a frozen cascade base
    (the trained grid is then its detail layer, tpu3d's
    make_train_step_packed(base_res=...)). Updates ``state`` in place and
    returns the loss as a 0-d device tensor (no host sync)."""
    vg = state.grid
    if noise is None:
        noise = draw_step_noise(cfg, vg.grid.shape, rays_o.shape[0], generator, rays_o.device)
    gains, bg_sh = _latents(state, cid)
    bg = _ray_background(bg_sh, rays_d)
    if cfg.hierarchical:
        pred = render_rays_hierarchical(vg, rays_o, rays_d, cfg.near, cfg.far, cfg.n_coarse,
                                        cfg.n_fine, cfg.white_background,
                                        clip_aabb=cfg.per_ray_aabb, bg=bg,
                                        u_coarse=noise.u, u_fine=noise.u_fine, occ=occ,
                                        occ_probes=cfg.occupancy_probes,
                                        contract=cfg.contraction, base_vg=base)
    else:
        pred = render_rays(vg, rays_o, rays_d, cfg.near, cfg.far, cfg.num_samples,
                           cfg.white_background, clip_aabb=cfg.per_ray_aabb, bg=bg,
                           contract=cfg.contraction, base_vg=base, perturb=True, u=noise.u,
                           occ=occ, occ_probes=cfg.occupancy_probes)
    loss = ((_exposure_apply(pred, gains, cid) - rgb) ** 2).mean()
    return _update(state, cfg, loss, gains, bg_sh, *_crop_priors(cfg, noise))


# The SDF step's band: from the ray's box entry to its exit (far is only an
# upper clip), as tpu3d's packed SDF step (train.py:949).
SDF_FAR = 1e6


def sdf_noise_config(cfg: DenseConfig) -> DenseConfig:
    """The config whose StepNoise an SDF step takes: the SDF path samples
    cfg.num_samples stratified depths whatever cfg.hierarchical and
    cfg.contraction say (tpu3d's SDF steps read neither)."""
    return dataclasses.replace(cfg, hierarchical=False, contraction=False)


def sdf_train_step(state: TrainState, cfg: DenseConfig, rays_o: torch.Tensor,
                   rays_d: torch.Tensor, rgb: torch.Tensor, cid: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[StepNoise] = None) -> torch.Tensor:
    """One SDF-grid training step (tpu3d/dense/train.py:940-1021, ref
    sdf.py:423-438): the SDF grid is structurally a plenoxel grid (relu
    density in channel 0, SH colour), so it renders through the same
    trilinear kernel and scatter backward, with the SDF path's band: near 0,
    far SDF_FAR, clipped to each ray's stretch inside the box; the MSE
    counts only the rays that meet the box, divided by max(3 x their
    count, 1); then the TV and sparsity priors, the exposure gains and the
    SH background as in :func:`train_step`. Updates ``state`` in place and
    returns the loss."""
    vg = state.grid
    if noise is None:
        noise = draw_step_noise(sdf_noise_config(cfg), vg.grid.shape, rays_o.shape[0],
                                generator, rays_o.device)
    gains, bg_sh = _latents(state, cid)
    pred = render_rays(vg, rays_o, rays_d, 0.0, SDF_FAR, cfg.num_samples,
                       cfg.white_background, clip_aabb=True, bg=_ray_background(bg_sh, rays_d),
                       perturb=True, u=noise.u)
    pred = _exposure_apply(pred, gains, cid)
    _, _, valid = ray_aabb(rays_o, rays_d, vg.min_bound, vg.max_bound)
    w = valid.to(pred.dtype)[:, None]
    loss = (w * (pred - rgb) ** 2).sum() / torch.clamp(w.sum() * 3, min=1.0)
    return _update(state, cfg, loss, gains, bg_sh, *_crop_priors(cfg, noise))


def _optimizer_leaves(state: TrainState, moments: Dict[str, np.ndarray], shape
                      ) -> List[np.ndarray]:
    """The grid optimizer's state in optax's leaf order: adam (count, mu,
    nu, schedule count), rmsprop (nu, schedule count); ``moments`` holds
    the grid-shaped ones (zeros of ``shape`` before the first step)."""
    st = state.optimizer.state.get(state.grid.grid, {})

    def host(name):
        t = moments.get(name)
        return np.zeros(shape, np.float32) if t is None else t

    count = np.asarray(state.step, np.int32)
    if isinstance(state.optimizer, RMSprop):
        return [host("nu"), count]
    adam_count = np.asarray(int(st["step"]) if "step" in st else 0, np.int32)
    return [adam_count, host("exp_avg"), host("exp_avg_sq"), count]


def save_checkpoint(store, state: TrainState, epoch: int, losses: List[float],
                    grid: Optional[np.ndarray] = None,
                    moments: Optional[Dict[str, np.ndarray]] = None) -> None:
    """tpu3d's ``dense_ckpt``: grid, bounds, step, epoch, losses, the
    latents, and the optimizer's state as opt_0, opt_1, ... in optax's leaf
    order, so that tpu3d's load_checkpoint resumes it. ``grid`` and
    ``moments`` (host arrays by the optimizer's state names), when given,
    stand for the state's own: the whole of a bricked grid."""
    if grid is None:
        p = state.grid.grid
        grid = p.detach().cpu().numpy()
        moments = {k: v.detach().cpu().numpy()
                   for k, v in state.optimizer.state.get(p, {}).items()
                   if torch.is_tensor(v) and v.dim() == 4}
    extra = {}
    for i, q in enumerate(state.params):
        st = state.optimizer.state[q]
        extra.update({f"param_{i}": q.detach().cpu().numpy(),
                      f"param_{i}_m": st["exp_avg"].cpu().numpy(),
                      f"param_{i}_v": st["exp_avg_sq"].cpu().numpy()})
    if state.exposure is not None:
        extra["exposure"] = state.exposure.cpu().numpy()
    if state.background is not None:
        extra["background"] = state.background.cpu().numpy()
    vg = state.grid
    leaves = _optimizer_leaves(state, moments, grid.shape)
    store.save("dense_ckpt", grid=grid,
               min_bound=vg.min_bound.cpu().numpy(), max_bound=vg.max_bound.cpu().numpy(),
               step=np.asarray(state.step, np.int32), epoch=np.asarray(epoch),
               losses=np.asarray(losses, np.float32), **extra,
               **{f"opt_{i}": a for i, a in enumerate(leaves)})


def load_checkpoint(store, cfg: DenseConfig, steps_per_epoch: int, device,
                    rows: Optional[Tuple[int, int]] = None, init: Optional[Callable] = None
                    ) -> Optional[Tuple[TrainState, int, List[float]]]:
    """(state, epoch, losses) from a ``dense_ckpt`` that tpu3d or the port
    wrote, or None. A grid and moments saved in tpu3d's packed layout are
    unpacked; the optimizer's leaves fill torch.optim.Adam's step, exp_avg
    and exp_avg_sq (rmsprop: nu); the further leaves (``param_i``) and
    their moments fill the state's own in place. ``rows`` (lo, hi) reads
    only those X rows of the grid and its moments (a brick of a sharded
    grid). ``init`` builds the state (:func:`init_state`'s signature)."""
    data = store.load("dense_ckpt") if rows is None else store.load("dense_ckpt", rows=rows)
    if data is None:
        return None

    def vec(name):
        return torch.as_tensor(np.asarray(data[name], np.float32), device=device)

    channels = np.asarray(data["grid"]).shape[-1] if np.ndim(data["grid"]) == 4 else CHANNELS
    grid = VoxelGrid(grid_tensor(data["grid"], device, channels), vec("min_bound"),
                     vec("max_bound"))
    state = (init or init_state)(cfg, grid, steps_per_epoch)
    state.set_step(int(data["step"]))
    state.exposure = vec("exposure") if "exposure" in data else None
    state.background = vec("background") if "background" in data else None
    p = state.grid.grid
    if isinstance(state.optimizer, RMSprop):
        state.optimizer.state[p] = {"nu": grid_tensor(data["opt_0"], device)}
    else:
        state.optimizer.state[p] = {
            "step": torch.tensor(float(data["opt_0"]), dtype=torch.float32, device=device),
            "exp_avg": grid_tensor(data["opt_1"], device, channels),
            "exp_avg_sq": grid_tensor(data["opt_2"], device, channels)}
    for i, q in enumerate(state.params):
        st = state.optimizer.state[q]
        with torch.no_grad():
            q.copy_(vec(f"param_{i}"))
        st["exp_avg"].copy_(vec(f"param_{i}_m"))
        st["exp_avg_sq"].copy_(vec(f"param_{i}_v"))
        st["step"].fill_(float(data["opt_0"]))
    return state, int(data["epoch"]), [float(x) for x in data["losses"]]


def _chunk_plan(steps_per_epoch: int, chunk: int) -> List[Tuple[int, int]]:
    """(first step, length) of each of tpu3d's scan chunks over an epoch
    (train.py:548): the occupancy refresh is due at chunk starts only."""
    out, b = [], 0
    while b < steps_per_epoch:
        k = min(chunk, steps_per_epoch - b)
        out.append((b, k))
        b += k
    return out


class _Graph(NamedTuple):
    """One captured chunk length: the graph, its static (k, B) index block,
    its (k,) losses, the kernel launches its capture recorded, the
    addresses of the tensors it reads, and the (name, start, end) event
    pairs of the device spans it records (utils/trace.py ``graph_marks``:
    ``dense.optimizer`` around each step's optimizer, ``dense.prior``
    around its crop priors)."""
    graph: "torch.cuda.CUDAGraph"
    idx: torch.Tensor
    losses: torch.Tensor
    launches: Dict[str, int]
    inputs: Tuple[int, ...]
    marks: Tuple[tuple, ...]


class MultiStep:
    """What :func:`make_multi_step` returns: a callable that runs one chunk
    of training steps. ``replays``, ``eager_chunks`` and
    ``capture_seconds`` record how the chunks ran; :meth:`release` drops
    the graphs and their memory pool.

    Each call is the hot span ``dense.chunk`` (``k``, ``mode`` "eager",
    "capture" or "replay"). A replay enqueued while tracing is on is
    armed: at the next call (or :meth:`release`), before another replay
    rewrites its events, its graph marks are read into the tracer under its
    chunk span if the card has finished them (counter ``dense.marks_read``),
    else it counts as ``dense.marks_missed``. With ``eager_only`` every
    chunk runs eagerly."""

    def __init__(self, step_fn: Callable, with_occ: bool, eager_only: bool = False):
        self.step_fn, self.with_occ, self.eager_only = step_fn, with_occ, eager_only
        self.graphs: Dict[int, _Graph] = {}
        self.warm: set = set()
        self.pool = None
        self.replays = self.eager_chunks = 0
        self.capture_seconds: List[float] = []
        self._armed = None      # (marks, chunk span, event before the replay)

    def _steps(self, state, cfg, idx, rays, generator, noise, kw) -> torch.Tensor:
        """The chunk's steps, one ``step_fn`` call each, over the rows of
        ``idx`` into ``rays`` (origins, directions, colours, camera ids or
        None): (k,) losses."""
        o_all, d_all, rgb_all, cid_all = rays
        losses = []
        for j in range(idx.shape[0]):
            ix = idx[j]
            losses.append(self.step_fn(
                state, cfg, o_all[ix], d_all[ix], rgb_all[ix],
                None if cid_all is None else cid_all[ix], generator=generator,
                noise=None if noise is None else noise(j), **kw))
        return torch.stack(losses)

    def __call__(self, state: TrainState, cfg: DenseConfig, idx: torch.Tensor,
                 o_all: torch.Tensor, d_all: torch.Tensor, rgb_all: torch.Tensor,
                 occ: Optional[torch.Tensor] = None, cid_all: Optional[torch.Tensor] = None,
                 base: Optional[VoxelGrid] = None, generator: Optional[torch.Generator] = None,
                 noise: Optional[Callable[[int], StepNoise]] = None) -> torch.Tensor:
        """Steps ``state`` over the (k, B) index block ``idx`` into the
        device-resident rays (and their camera ids ``cid_all``), with the
        occupancy grid ``occ`` and the cascade base ``base`` (``with_occ``),
        random numbers from ``generator`` or ``noise(j)`` for the chunk's
        j-th step. Returns the (k,) losses on the device. ``occ`` must be
        updated in place between chunks: a replay reads the tensor its
        capture saw."""
        self._read_marks()
        kw = dict(occ=occ, base=base) if self.with_occ else {}
        rays = (o_all, d_all, rgb_all, cid_all)
        k = idx.shape[0]
        eager = (self.eager_only or not idx.is_cuda
                 or (k not in self.graphs and k not in self.warm))
        mode = "eager" if eager else "replay" if k in self.graphs else "capture"
        with hot_span("dense.chunk", k=k, mode=mode) as span:
            if eager:
                self.warm.add(k)
                self.eager_chunks += 1
                return self._steps(state, cfg, idx, rays, generator, noise, kw)
            inputs = tuple(t.data_ptr() for t in (*rays, occ, None if base is None else base.grid)
                           if t is not None)
            g = self.graphs.get(k)
            if g is None:
                static = torch.empty_like(idx)
                g = self.graphs[k] = self._capture(
                    lambda: self._steps(state, cfg, static, rays, generator, noise, kw), state,
                    static, generator, inputs)
            elif g.inputs != inputs:
                raise RuntimeError("make_multi_step: a chunk's rays, occupancy or base are not "
                                   "the tensors its graph was captured with")
            g.idx.copy_(idx)
            with device_span("dense.replay") as origin:
                g.graph.replay()
            if span is not None and g.marks:
                self._armed = (g.marks, span, origin)
        for name, n in g.launches.items():
            LAUNCHES[name] += n
        state.step += k
        self.replays += 1
        return g.losses.clone()     # the graph's own buffer is rewritten by its next replay

    def _read_marks(self) -> None:
        """Read the armed replay's graph marks, if the card has finished
        them (never waits)."""
        if self._armed is None:
            return
        marks, span, origin = self._armed
        self._armed = None
        tr = get_tracer()
        tr.count("dense.marks_read" if tr.read_marks(marks, span, origin)
                 else "dense.marks_missed")

    def _capture(self, steps: Callable[[], torch.Tensor], state: TrainState,
                 static: torch.Tensor, generator: Optional[torch.Generator],
                 inputs: Tuple[int, ...]) -> _Graph:
        """``steps`` (the chunk's steps over the static index block
        ``static``) captured as one graph. The capture runs the steps'
        Python but no kernel, so the host's step count and the launch
        counts it added are taken back (each replay adds them). The first
        capture hands the card the memory that the eager chunks left in
        the allocator's cache first: the graphs' pool is memory of its own,
        and a grid that fills the card leaves no room for a second
        gradient beside a cached one."""
        step0, before = state.step, dict(LAUNCHES)
        if self.pool is None:
            torch.cuda.empty_cache()
        out = []
        t0 = time.time()
        with graph_marks() as marks:
            graph = capture(lambda: out.append(steps()), [] if generator is None else [generator],
                            self.pool, static.device)
        self.capture_seconds.append(time.time() - t0)
        self.pool = self.pool or graph.pool()
        launches = {name: LAUNCHES[name] - before[name] for name in LAUNCHES}
        LAUNCHES.update(before)
        state.step = step0
        return _Graph(graph, static, out[0], launches, inputs, tuple(marks))

    def release(self) -> None:
        """Drop the captured graphs and hand their memory pool back to the
        card, for the next phase (after reading an armed replay's marks)."""
        self._read_marks()
        captured = bool(self.graphs)
        marks = [g.marks for g in self.graphs.values()]
        self.graphs.clear()     # the graphs go before the events their nodes record
        del marks
        self.pool = None
        if captured:
            torch.cuda.empty_cache()


def make_multi_step(step_fn: Callable, with_occ: bool, chunk: Optional[int] = None
                    ) -> MultiStep:
    """tpu3d's make_multi_step (train.py:514): K training steps, one
    chunk of tpu3d's scan, against a ray dataset that stays on the device;
    the host sends only the (K, batch) block of indices. ``step_fn`` is
    :func:`train_step` (``with_occ``: it takes the occupancy grid and the
    cascade base) or :func:`sdf_train_step`. ``chunk`` is the loop's scan
    chunk: a loop of single steps (``chunk`` 1: scan_chunk 1, or a dataset
    smaller than one batch) runs each step as an eager chunk, as tpu3d's
    loop without a scan.

    On the card a chunk of K steps is one CUDA graph, replayed: the first
    chunk of each length K runs eagerly (the warm-up: the kernel library,
    the optimizer's state and every kernel load there), the second is
    captured, on a side stream, and replayed, and every later chunk of that
    length replays it. The graphs share one memory pool; the loop releases
    them at the end of its phase. The step is the same code eagerly and
    captured: its lr, bias corrections and state updates read and write
    device tensors in place, and its draws come from a generator registered
    with the graph, so a replay continues the eager stream of draws. On the
    CPU every chunk runs eagerly."""
    return MultiStep(step_fn, with_occ, eager_only=chunk == 1)


def _coarse_stage(dataset: RayDataset, cfg: DenseConfig, seed: int, grid: VoxelGrid,
                  verbose: bool, log_every: int, dev, train_fn: Optional[Callable] = None,
                  x_multiple: int = 8) -> Tuple[VoxelGrid, List[float], DenseConfig, dict]:
    """tpu3d's coarse-to-fine phase (train.py:559-594): train
    cfg.coarse_epochs on ``grid`` resampled down by cfg.coarse_factor (X
    floored to a multiple of ``x_multiple``, lcm(8, model) under the
    brick-sharded trainer, Y and Z to 8), camera gate off, then resample
    the result back up. Returns (the upsampled grid, the coarse losses,
    the config of the remaining epochs, the coarse phase's record).
    ``train_fn`` trains the coarse grid: train_plenoxel, train_sdf or the
    brick-sharded trainer."""
    f = max(int(cfg.coarse_factor), 2)
    full_res = grid.resolution
    mults = (max(int(x_multiple), 8), 8, 8)
    coarse_res = tuple(max((r // f) // m * m, m) for r, m in zip(full_res, mults))
    small = VoxelGrid(resample_grid(grid.grid, coarse_res), grid.min_bound.clone(),
                      grid.max_bound.clone())
    if verbose:
        print(f"[dense] coarse stage: {coarse_res} for {cfg.coarse_epochs} epochs", flush=True)
    sub = dataclasses.replace(cfg, epochs=cfg.coarse_epochs, coarse_epochs=0, camera_gate=False)
    small, losses = (train_fn or train_plenoxel)(dataset, sub, seed=seed, grid=small,
                                                 verbose=verbose, log_every=log_every,
                                                 device=dev)
    phase = dict(LAST_TRAIN_AUX["phases"][0], phase="coarse")
    up = VoxelGrid(resample_grid(small.grid, full_res), grid.min_bound.clone(),
                   grid.max_bound.clone())
    rest = dataclasses.replace(cfg, epochs=cfg.epochs - cfg.coarse_epochs, coarse_epochs=0)
    return up, losses, rest, phase


class _LossLog:
    """A training loop's loss log: the loss of every ``log_every``-th step
    of an epoch, read back from its chunk's (k,) device losses (tpu3d's
    ``loss_chunk``) into ``losses``, and recorded in ``entries`` with its
    epoch, step, update count and seconds since the log began; printed
    after ``prefix`` unless it is None, with the loop's rays/s so far: its
    steps since the log began (the read-back waits for the whole chunk)
    times the batch, over those seconds."""

    def __init__(self, losses: List[float], log_every: int, batch: int, steps_per_epoch: int,
                 prefix: Optional[str]):
        self.losses, self.entries = losses, []
        self.log_every, self.batch, self.steps_per_epoch = log_every, batch, steps_per_epoch
        self.prefix = prefix
        self.steps = 0      # the loop's steps so far, the current chunk's included
        self.t0 = time.time()

    def chunk(self, lc: torch.Tensor, b: int, epoch: int, updates: int) -> bool:
        """The chunk of steps b, b + 1, ... that ends at update ``updates``.
        Returns whether it read a loss back."""
        k = lc.shape[0]
        self.steps += k
        read = False
        for j in range(b, b + k):
            if j % self.log_every:
                continue
            lv = float(lc[j - b])
            read = True
            self.losses.append(lv)
            self.entries.append({"epoch": epoch, "step": j, "update": updates - (b + k - 1 - j),
                                 "loss": lv, "seconds": time.time() - self.t0})
            if self.prefix is not None:
                rate = self.steps * self.batch / (time.time() - self.t0)
                print(f"{self.prefix} epoch {epoch} step {j}/{self.steps_per_epoch} "
                      f"loss {lv:.5f} ({rate:.0f} rays/s)", flush=True)
        return read


def _graph_record(multi: MultiStep) -> dict:
    """A phase's record of how make_multi_step ran its chunks: graph
    replays, chunks run eagerly (all of them on the CPU and in a loop of
    single steps; a length's warm-up on the card) and each capture's
    seconds."""
    return dict(replays=multi.replays, eager_chunks=multi.eager_chunks,
                capture_seconds=list(multi.capture_seconds))


def _n_cams(cfg: DenseConfig, dataset: RayDataset) -> Optional[int]:
    """The camera count of the exposure latents, None without them."""
    return (int(dataset.cam_ids.max()) + 1
            if cfg.exposure and dataset.cam_ids is not None else None)


def _upload_rays(dataset: RayDataset, n_cams: Optional[int], dev
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The ray dataset on ``dev``, once: origins, directions, colours, and
    the camera ids when the exposure latents read them (else None)."""
    o_all, d_all, rgb_all = (torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
                             for a in (dataset.origins, dataset.dirs, dataset.rgb))
    cid_all = (torch.from_numpy(dataset.cam_ids.astype(np.int64)).to(dev)
               if n_cams is not None else None)
    return o_all, d_all, rgb_all, cid_all


def _record(state: TrainState, log: _LossLog, phases: List[dict], phase: str, res,
            steps: int, graphs: Optional[dict] = None, **aux) -> None:
    """A training loop's record: its phase entry (name, grid resolution,
    steps, log, seconds and ``graphs``, how its chunks ran) appended to
    ``phases``, and LAST_TRAIN_AUX anew (the latents, the log, the step
    count, the phases, the model's further leaves ``params``; ``aux`` sets
    the camera gate's and the occupancy refreshes' keys, or adds the loop's
    own)."""
    phases.append(dict(phase=phase, res=list(res), steps=steps, log=log.entries,
                       seconds=time.time() - log.t0, **(graphs or {})))
    LAST_TRAIN_AUX.clear()
    LAST_TRAIN_AUX.update(
        background=None if state.background is None else state.background[0].cpu().numpy(),
        exposure=None if state.exposure is None else state.exposure[0].cpu().numpy(),
        dropped_cameras=[], log=log.entries, steps=state.step, occupancy_refreshes=[],
        camera_gate=None, phases=phases, params=tuple(p.detach() for p in state.params))
    LAST_TRAIN_AUX.update(aux)


def _camera_gate_probe(state: TrainState, dataset: RayDataset, cfg: DenseConfig,
                       rng: np.random.Generator, dev) -> np.ndarray:
    """(M,) probe MSE of each training camera under the current grid
    (train.py:597-650): up to cfg.camera_gate_probe_rays of its rays,
    chosen by ``rng``, rendered unjittered (cfg.num_samples, the box
    clipping and the contraction of training, the background and exposure
    latents) in chunks of 8,192, the squared error averaged per camera."""
    cid = dataset.cam_ids
    M = int(cid.max()) + 1
    k = cfg.camera_gate_probe_rays
    sel = []
    for c in range(M):
        ids = np.flatnonzero(cid == c)
        if len(ids) > k:
            ids = rng.choice(ids, k, replace=False)
        sel.append(ids)
    sel = np.concatenate(sel)
    seg = cid[sel]
    vg = VoxelGrid(state.grid.grid.detach(), state.grid.min_bound, state.grid.max_bound)
    gains = None if state.exposure is None else state.exposure[0]
    bg_sh = None if state.background is None else state.background[0]
    preds = []
    with torch.no_grad():
        for s in range(0, len(sel), 8192):
            ids = sel[s:s + 8192]
            ro, rd = (torch.from_numpy(a[ids]).to(dev) for a in (dataset.origins, dataset.dirs))
            out = render_rays(vg, ro, rd, cfg.near, cfg.far, cfg.num_samples,
                              cfg.white_background, clip_aabb=cfg.per_ray_aabb,
                              bg=_ray_background(bg_sh, rd), contract=cfg.contraction)
            out = _exposure_apply(out, gains, torch.from_numpy(cid[ids].astype(np.int64)).to(dev))
            preds.append(out.cpu().numpy())
    err = (np.concatenate(preds) - dataset.rgb[sel]) ** 2
    sums = np.bincount(seg, weights=err.mean(axis=1), minlength=M)
    return sums / np.maximum(np.bincount(seg, minlength=M), 1)


def apply_camera_gate(state: TrainState, dataset: RayDataset, cfg: DenseConfig,
                      verbose: bool, dev) -> Tuple[np.ndarray, List[int], np.ndarray, float]:
    """tpu3d's camera gate (train.py:653-679): probe every training
    camera's fit (numpy default_rng(12345) picks the probe rays) and drop
    those above median + cfg.camera_gate_mad x MAD, worst first, keeping at
    least cfg.camera_gate_min_keep of the cameras. Returns (the rays to
    keep (n,) bool, the dropped camera ids, each camera's probe MSE, the
    threshold)."""
    mse = _camera_gate_probe(state, dataset, cfg, np.random.default_rng(12345), dev)
    med = float(np.median(mse))
    mad = float(np.median(np.abs(mse - med))) * 1.4826
    thr = med + cfg.camera_gate_mad * max(mad, 1e-9)
    max_drop = int((1.0 - cfg.camera_gate_min_keep) * len(mse))
    dropped = [int(c) for c in np.argsort(-mse)[:max_drop] if mse[c] > thr]
    if verbose:
        print(f"[dense] camera gate: dropped {dropped} of {len(mse)} cameras (median "
              f"{med:.4f}, max {mse.max():.4f}, thr {thr:.4f})", flush=True)
    return ~np.isin(dataset.cam_ids, dropped), dropped, mse, thr


def train_plenoxel(dataset: RayDataset, cfg: Optional[DenseConfig] = None, seed: int = 0,
                   grid: Optional[VoxelGrid] = None, verbose: bool = True,
                   log_every: int = 170, checkpoint_store=None, resume: bool = False,
                   base_grid: Optional[VoxelGrid] = None, mesh=None, device="cuda"
                   ) -> Tuple[VoxelGrid, List[float]]:
    """tpu3d's plenoxel training loop (train.py:729-917) on ``device``: the
    ray dataset is uploaded once; each epoch shuffles it on the device and
    each step indexes its batch there; the loss comes back to the host only
    every ``log_every`` steps; a checkpoint is saved after each epoch when a
    store is given, and ``resume`` continues after the saved epoch.

    tpu3d's options, on its cadence: under cfg.contraction the grid spans
    [-2, 2]^3; cfg.coarse_epochs first trains a coarse grid
    (:func:`_coarse_stage`), then the fine phase starts afresh (optimizer,
    schedule, latents); cfg.occupancy_prune starts from an all-occupied
    grid and refreshes it from the live density at the first scan-chunk
    boundary (cfg.scan_chunk steps, restarting each epoch) at or after each
    cfg.occupancy_every global steps; cfg.camera_gate probes the cameras
    once, at the start of epoch cfg.camera_gate_epoch, and the rest of the
    run draws only the kept cameras' rays. ``base_grid`` is a frozen
    cascade base: the trained grid is its detail layer. ``mesh`` (a
    dist.mesh.Mesh) trains through the ray-DP x brick-TP step instead
    (dist/dense_tp.py::train_dense_tp), without occupancy, gate or cascade
    base; the grid then comes back on rank 0 alone (None on the others).
    Returns (the trained grid, the logged losses); LAST_TRAIN_AUX has the
    rest."""
    cfg = cfg or DenseConfig()
    dev = resolve_device(device)
    if mesh is not None:
        from tpu3d_torch.dist.dense_tp import train_dense_tp

        if base_grid is not None:
            raise ValueError("a cascade base grid cannot train on a mesh")
        return train_dense_tp(dataset, cfg, mesh, seed=seed, grid=grid, verbose=verbose,
                              log_every=log_every, checkpoint_store=checkpoint_store,
                              resume=resume, sdf_mode=False, device=dev)
    return _train_loop(dataset, cfg, seed, grid, verbose, log_every, dev, step_fn=train_step,
                       with_occ=True, prefix="[dense]", checkpoint_store=checkpoint_store,
                       resume=resume, base_grid=base_grid)


def train_sdf(dataset: RayDataset, cfg: Optional[DenseConfig] = None, seed: int = 0,
              grid: Optional[VoxelGrid] = None, verbose: bool = True, log_every: int = 170,
              mesh=None, device="cuda") -> Tuple[VoxelGrid, List[float]]:
    """tpu3d's SDF-grid training loop (train.py:1024-1124, ref
    sdf.py:409-445) on ``device``: the plenoxel loop's schedule and batching
    (:func:`sdf_train_step` per step, the rays uploaded once and shuffled on
    the device each epoch, the loss read back every ``log_every`` steps of
    an epoch, on tpu3d's scan-chunk plan), a coarse phase first when
    cfg.coarse_epochs asks (:func:`_coarse_stage`), and a fresh grid over
    [-s, s]^3, s 2 under contraction and cfg.scene_scale otherwise. No
    checkpoints, occupancy or camera gate (tpu3d's has none). ``mesh``
    trains through the brick-sharded step with the SDF band
    (dist/dense_tp.py::train_dense_tp, sdf_mode; the grid comes back on
    rank 0 alone). Returns (the trained grid, the logged losses);
    LAST_TRAIN_AUX has the latents, the log and the phases."""
    cfg = cfg or DenseConfig()
    dev = resolve_device(device)
    if mesh is not None:
        from tpu3d_torch.dist.dense_tp import train_dense_tp

        return train_dense_tp(dataset, cfg, mesh, seed=seed, grid=grid, verbose=verbose,
                              log_every=log_every, sdf_mode=True, device=dev)
    cfg = dataclasses.replace(cfg, occupancy_prune=False, camera_gate=False)
    return _train_loop(dataset, cfg, seed, grid, verbose, log_every, dev,
                       step_fn=sdf_train_step, with_occ=False, prefix="[sdf]",
                       noise=_sdf_step_noise)


def _permutation(n: int, generator: torch.Generator, device, epoch: int) -> torch.Tensor:
    """An epoch's ray order. A test replaces this function (and
    :func:`_sdf_step_noise`) to feed tpu3d's draws."""
    return torch.randperm(n, generator=generator, device=device)


def _sdf_step_noise(cfg: DenseConfig, grid_shape, n_rays: int, generator: torch.Generator,
                    device, epoch: int, step: int) -> StepNoise:
    """Step ``step`` of epoch ``epoch``'s random numbers for the SDF step."""
    return draw_step_noise(sdf_noise_config(cfg), grid_shape, n_rays, generator, device)


def _train_loop(dataset: RayDataset, cfg: DenseConfig, seed: int, grid: Optional[VoxelGrid],
                verbose: bool, log_every: int, device, *, step_fn: Callable, with_occ: bool,
                prefix: str, noise: Optional[Callable[..., StepNoise]] = None,
                checkpoint_store=None, resume: bool = False,
                base_grid: Optional[VoxelGrid] = None,
                init: Callable[..., TrainState] = init_state) -> Tuple[VoxelGrid, List[float]]:
    """The single-card loop of :func:`train_plenoxel`, :func:`train_sdf`
    and dense/dvgo.py's ``train_dvgo`` on ``device``. Set-up: a fresh grid unless one is given, the coarse
    phase through this loop, the training state (or the checkpoint's), the
    rays uploaded once, the generator and the chunk plan. Each epoch: the
    camera gate, the permutation, then each chunk's occupancy refresh, its
    steps through :func:`make_multi_step` (``step_fn``, ``with_occ``) and
    its loss log (printed after ``prefix``); the checkpoint after the
    epoch. Then the phase record and LAST_TRAIN_AUX. ``noise`` (the
    signature of :func:`_sdf_step_noise`) gives each step's random
    numbers; without it the step draws them from the generator. ``init``
    builds the training state (:func:`init_state`'s signature); a loss
    read-back folds the state's tallies into the tracer
    (:func:`fold_tallies`)."""
    n = len(dataset.origins)
    steps_per_epoch = max(n // cfg.batch_size, 1)
    if grid is None:
        s = 2.0 if cfg.contraction else cfg.scene_scale
        grid = create_grid(cfg.grid_resolution, (-s, -s, -s), (s, s, s), device=device)
    phases: List[dict] = []
    losses: List[float] = []
    if cfg.coarse_epochs > 0 and cfg.epochs > cfg.coarse_epochs and not resume:
        loop = functools.partial(_train_loop, step_fn=step_fn, with_occ=with_occ, prefix=prefix,
                                 noise=noise)
        grid, losses, cfg, coarse = _coarse_stage(dataset, cfg, seed, grid, verbose, log_every,
                                                  device, train_fn=loop)
        phases.append(coarse)
    n_cams = _n_cams(cfg, dataset)
    state = init(cfg, grid, steps_per_epoch, n_cams)
    del grid
    start_epoch = 0
    if resume and checkpoint_store is not None:
        ck = load_checkpoint(checkpoint_store, cfg, steps_per_epoch, device, init=init)
        if ck is not None:
            state, start_epoch, losses = ck
            start_epoch += 1
            if verbose:
                print(f"{prefix} resumed at epoch {start_epoch}", flush=True)
    base = None if base_grid is None else VoxelGrid(
        base_grid.grid.detach(), base_grid.min_bound, base_grid.max_bound)
    o_all, d_all, rgb_all, cid_all = _upload_rays(dataset, n_cams, device)
    occ = None
    if cfg.occupancy_prune:
        f = cfg.occupancy_factor
        occ = torch.ones(tuple(-(-d // f) for d in state.grid.resolution), dtype=torch.bool,
                         device=device)
    chunk = 1 if n < cfg.batch_size else max(int(cfg.scan_chunk), 1)
    plan = _chunk_plan(steps_per_epoch, chunk)
    multi = make_multi_step(step_fn, with_occ, chunk=chunk)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    refreshes = []
    gate, gate_dropped, kept = None, [], None
    global_step, next_occ, step0 = 0, cfg.occupancy_every, state.step
    B, shape = cfg.batch_size, state.grid.grid.shape
    log = _LossLog(losses, log_every, B, steps_per_epoch, prefix if verbose else None)
    with f32_scope():
        for epoch in range(start_epoch, cfg.epochs):
            if (cfg.camera_gate and gate is None and dataset.cam_ids is not None
                    and epoch >= cfg.camera_gate_epoch):
                keep, gate_dropped, mse, thr = apply_camera_gate(state, dataset, cfg, verbose,
                                                                 device)
                gate = dict(epoch=epoch, step=global_step, probe_mse=mse.tolist(),
                            threshold=thr, dropped=gate_dropped)
                if gate_dropped:
                    kept = torch.from_numpy(np.flatnonzero(keep)).to(device)
                    plan = _chunk_plan(max(len(kept) // B, 1), chunk)
            perm = _permutation(n, gen, device, epoch)
            if kept is not None:
                perm = kept[_permutation(len(kept), gen, device, epoch)]
            for b, k_steps in plan:
                if occ is not None and global_step >= next_occ:
                    # in place: a captured chunk reads this tensor
                    occ.copy_(occupancy_from_grid(state.grid.grid.detach(), cfg.occupancy_factor,
                                                  cfg.occupancy_threshold))
                    refreshes.append(dict(step=global_step, epoch=epoch,
                                          occupied=float(occ.float().mean())))
                    next_occ += cfg.occupancy_every
                # (k_steps, B) rows; a dataset smaller than one batch is one short step
                idx = perm[b * B:(b + k_steps) * B].view(k_steps, -1)
                step_noise = None if noise is None else (
                    lambda j: noise(cfg, shape, idx.shape[1], gen, device, epoch, b + j))
                lc = multi(state, cfg, idx, o_all, d_all, rgb_all, occ=occ, cid_all=cid_all,
                           base=base, generator=gen, noise=step_noise)
                global_step += k_steps
                if log.chunk(lc, b, epoch, state.step):
                    fold_tallies(state)
            if checkpoint_store is not None:
                save_checkpoint(checkpoint_store, state, epoch, losses)
    _record(state, log, phases, "detail" if base is not None else "fine" if phases else "train",
            state.grid.resolution, state.step - step0, _graph_record(multi),
            dropped_cameras=gate_dropped, occupancy_refreshes=refreshes, camera_gate=gate)
    multi.release()
    vg = state.grid
    return VoxelGrid(vg.grid.detach(), vg.min_bound, vg.max_bound), losses
