"""Dense-stage training (tpu3d/dense/train.py): ray datasets from
registered cameras, the scene normalizations and the scene-derived sampling
band (numpy, on the host), and plenoxel training of the voxel grid on the
device: the lr schedule, the grid optimizers, the per-image exposure and
SH-background latents, the stochastic TV and sparsity priors, one training
step and ``train_plenoxel``, with tpu3d's ``dense_ckpt`` checkpoints, its
coarse-to-fine phase, its occupancy refreshes, its camera gate and the
frozen base of its two-level cascade, on tpu3d's loop cadence; and the SDF
grid's step and loop (``sdf_train_step``, ``train_sdf``).

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
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tpu3d_torch import f32_scope, resolve_device
from tpu3d_torch.config import DenseConfig
from tpu3d_torch.core import lie
from tpu3d_torch.dense.grid import VoxelGrid, create_grid, eval_sh, grid_tensor, resample_grid
from tpu3d_torch.dense.occupancy import occupancy_from_grid
from tpu3d_torch.dense.render import jitter_width, render_rays, render_rays_hierarchical
from tpu3d_torch.dense.sdf import ray_aabb
from tpu3d_torch.io.ply import filter_point_cloud


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


def _lr_schedule(cfg: DenseConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """optax.piecewise_constant_schedule(lr, {m * steps_per_epoch: gamma}):
    the lr of update k (0-based) is lr * gamma^#{m : m * steps_per_epoch <= k}."""
    boundaries = {m * steps_per_epoch: cfg.lr_gamma for m in cfg.lr_milestones}

    def lr(count: int) -> float:
        v = cfg.learning_rate
        for b, scale in sorted(boundaries.items()):
            if count >= b:
                v *= scale
        return v

    return lr


class RMSprop(torch.optim.Optimizer):
    """optax.rmsprop(lr, decay, eps) as optax 0.2.6 computes it:
    nu <- (1 - decay) g^2 + decay nu from nu = 0, then p <- p - lr g / sqrt(nu
    + eps), eps INSIDE the root. torch.optim.RMSprop adds eps outside the
    root, which is another optimizer where nu is near 0."""

    def __init__(self, params, lr: float = 1e-2, decay: float = 0.95, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            d = group["decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if "nu" not in st:
                    st["nu"] = torch.zeros_like(p)
                g = p.grad
                st["nu"] = (1 - d) * (g * g) + d * st["nu"]
                p.add_(torch.rsqrt(st["nu"] + group["eps"]) * g, alpha=-group["lr"])


def make_optimizer(cfg: DenseConfig, grid: torch.Tensor) -> torch.optim.Optimizer:
    """The grid optimizer: Adam (betas 0.9/0.999, eps 1e-8 outside the root,
    as optax.adam: the same update m_hat / (sqrt(v_hat) + eps)), fused into
    one kernel, or with cfg.optimizer == "rmsprop" optax's rmsprop
    (:class:`RMSprop`). Both update the whole grid every step, as optax's:
    a voxel with zero gradient still moves under Adam's momentum. The lr
    is set each step from the schedule (TrainState.lr)."""
    if cfg.optimizer == "rmsprop":
        return RMSprop([grid], lr=cfg.learning_rate, decay=0.95, eps=1e-8)
    return torch.optim.Adam([grid], lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            fused=True)


@dataclasses.dataclass
class TrainState:
    """What a training step reads and updates (in place: the grid and its
    moments are updated where they lie, as tpu3d donates its state)."""
    grid: VoxelGrid                       # grid.grid: the trained leaf
    optimizer: torch.optim.Optimizer
    lr: Callable[[int], float]            # the schedule, by update count
    step: int = 0
    # Per-image exposure latents (3, M, 3) = [log-gains, Adam m, Adam v].
    exposure: Optional[torch.Tensor] = None
    # View-directional background SH (3, 3, 9) = [coeffs, Adam m, Adam v].
    background: Optional[torch.Tensor] = None


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
        init_background(dev) if cfg.sh_background else None)


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


def _exposure_adam(exposure: torch.Tensor, g: torch.Tensor, step: int,
                   lr: float) -> torch.Tensor:
    """Adam on stacked latents [values, m, v] with the grid's step count,
    as tpu3d's manual update (kept out of the grid optimizer)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    gains, m, v = exposure[0], exposure[1], exposure[2]
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    t = torch.tensor(step + 1.0, dtype=torch.float32)
    mhat = m / (1 - torch.tensor(b1, dtype=torch.float32) ** t)
    vhat = v / (1 - torch.tensor(b2, dtype=torch.float32) ** t)
    gains = gains - lr * mhat / (torch.sqrt(vhat) + eps)
    return torch.stack([gains, m, v])


def _crop(grid: torch.Tensor, origin, size, channel: Optional[int] = None) -> torch.Tensor:
    """The size[0] x size[1] x size[2] block of ``grid`` at ``origin`` (a
    (3,) integer tensor, on the device, so no host sync), as one row gather
    on the (X*Y*Z, C) view; one channel of it when ``channel`` is given."""
    X, Y, Z, C = grid.shape
    o = torch.as_tensor(origin, device=grid.device)
    ax = [o[a] + torch.arange(size[a], device=grid.device) for a in range(3)]
    rows = (ax[0][:, None, None] * Y + ax[1][None, :, None]) * Z + ax[2][None, None, :]
    flat = grid.reshape(X * Y * Z, C)
    return flat[rows] if channel is None else flat[rows, channel]


def _tv_crop_loss(grid: torch.Tensor, origin, crop: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stochastic total variation on a (crop+1)^3 block at ``origin``:
    (density TV, summed SH TV), the mean squared neighbour differences."""
    X, Y, Z, _ = grid.shape
    c = _crop(grid, origin, (min(crop, X - 1) + 1, min(crop, Y - 1) + 1, min(crop, Z - 1) + 1))
    per_ch = (((c[1:] - c[:-1]) ** 2).mean(dim=(0, 1, 2))
              + ((c[:, 1:] - c[:, :-1]) ** 2).mean(dim=(0, 1, 2))
              + ((c[:, :, 1:] - c[:, :, :-1]) ** 2).mean(dim=(0, 1, 2)))
    return per_ch[0], per_ch[1:].sum()


def _sparsity_crop_loss(grid: torch.Tensor, origin, crop: int) -> torch.Tensor:
    """Cauchy sparsity on the density of a crop^3 block at ``origin``:
    mean log(1 + relu(sigma)^2 / 0.25)."""
    X, Y, Z, _ = grid.shape
    sig = torch.relu(_crop(grid, origin, (min(crop, X), min(crop, Y), min(crop, Z)), 0))
    return torch.log1p(sig * sig / 0.25).mean()


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


def _add_priors(loss: torch.Tensor, grid: torch.Tensor, cfg: DenseConfig,
                noise: StepNoise) -> torch.Tensor:
    """The loss plus the TV and sparsity crop priors that cfg turns on."""
    if cfg.tv_sigma or cfg.tv_sh:
        tv_s, tv_c = _tv_crop_loss(grid, noise.tv_origin, cfg.tv_crop)
        loss = loss + cfg.tv_sigma * tv_s + cfg.tv_sh * tv_c
    if cfg.sparsity_sigma:
        loss = loss + cfg.sparsity_sigma * _sparsity_crop_loss(grid, noise.sparsity_origin,
                                                               cfg.tv_crop)
    return loss


def _update(state: TrainState, cfg: DenseConfig, loss: torch.Tensor,
            gains: Optional[torch.Tensor], bg_sh: Optional[torch.Tensor]) -> torch.Tensor:
    """One backward for the grid and the latents, the latents' Adam, then
    the grid optimizer at the scheduled lr. Returns the detached loss."""
    loss.backward()
    with torch.no_grad():
        if gains is not None:
            state.exposure = _exposure_adam(state.exposure, gains.grad, state.step,
                                            cfg.exposure_lr)
        if bg_sh is not None:
            state.background = _exposure_adam(state.background, bg_sh.grad, state.step,
                                              cfg.background_lr)
    for group in state.optimizer.param_groups:
        group["lr"] = state.lr(state.step)
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.step += 1
    return loss.detach()


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
    return _update(state, cfg, _add_priors(loss, vg.grid, cfg, noise), gains, bg_sh)


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
    return _update(state, cfg, _add_priors(loss, vg.grid, cfg, noise), gains, bg_sh)


def _optimizer_leaves(state: TrainState) -> List[np.ndarray]:
    """The grid optimizer's state in optax's leaf order: adam (count, mu,
    nu, schedule count), rmsprop (nu, schedule count)."""
    p = state.grid.grid
    st = state.optimizer.state.get(p, {})

    def host(name):
        t = st.get(name)
        return np.zeros(p.shape, np.float32) if t is None else t.detach().cpu().numpy()

    count = np.asarray(state.step, np.int32)
    if isinstance(state.optimizer, RMSprop):
        return [host("nu"), count]
    adam_count = np.asarray(int(st["step"]) if "step" in st else 0, np.int32)
    return [adam_count, host("exp_avg"), host("exp_avg_sq"), count]


def save_checkpoint(store, state: TrainState, epoch: int, losses: List[float]) -> None:
    """tpu3d's ``dense_ckpt``: grid, bounds, step, epoch, losses, the
    latents, and the optimizer's state as opt_0, opt_1, ... in optax's leaf
    order, so that tpu3d's load_checkpoint resumes it."""
    extra = {}
    if state.exposure is not None:
        extra["exposure"] = state.exposure.cpu().numpy()
    if state.background is not None:
        extra["background"] = state.background.cpu().numpy()
    vg = state.grid
    store.save("dense_ckpt", grid=vg.grid.detach().cpu().numpy(),
               min_bound=vg.min_bound.cpu().numpy(), max_bound=vg.max_bound.cpu().numpy(),
               step=np.asarray(state.step, np.int32), epoch=np.asarray(epoch),
               losses=np.asarray(losses, np.float32), **extra,
               **{f"opt_{i}": a for i, a in enumerate(_optimizer_leaves(state))})


def load_checkpoint(store, cfg: DenseConfig, steps_per_epoch: int, device
                    ) -> Optional[Tuple[TrainState, int, List[float]]]:
    """(state, epoch, losses) from a ``dense_ckpt`` that tpu3d or the port
    wrote, or None. A grid and moments saved in tpu3d's packed layout are
    unpacked; the optimizer's leaves fill torch.optim.Adam's step, exp_avg
    and exp_avg_sq (rmsprop: nu)."""
    data = store.load("dense_ckpt")
    if data is None:
        return None

    def vec(name):
        return torch.as_tensor(np.asarray(data[name], np.float32), device=device)

    grid = VoxelGrid(grid_tensor(data["grid"], device), vec("min_bound"), vec("max_bound"))
    state = init_state(cfg, grid, steps_per_epoch)
    state.step = int(data["step"])
    state.exposure = vec("exposure") if "exposure" in data else None
    state.background = vec("background") if "background" in data else None
    p = state.grid.grid
    if isinstance(state.optimizer, RMSprop):
        state.optimizer.state[p] = {"nu": grid_tensor(data["opt_0"], device)}
    else:
        state.optimizer.state[p] = {
            "step": torch.tensor(float(data["opt_0"]), dtype=torch.float32, device=device),
            "exp_avg": grid_tensor(data["opt_1"], device),
            "exp_avg_sq": grid_tensor(data["opt_2"], device)}
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


def _coarse_stage(dataset: RayDataset, cfg: DenseConfig, seed: int, grid: VoxelGrid,
                  verbose: bool, log_every: int, dev, train_fn: Optional[Callable] = None
                  ) -> Tuple[VoxelGrid, List[float], DenseConfig, dict]:
    """tpu3d's coarse-to-fine phase (train.py:559-594): train
    cfg.coarse_epochs on ``grid`` resampled down by cfg.coarse_factor (each
    dimension floored to a multiple of 8), camera gate off, then resample
    the result back up. Returns (the upsampled grid, the coarse losses,
    the config of the remaining epochs, the coarse phase's record).
    ``train_fn`` trains the coarse grid: train_plenoxel, or train_sdf."""
    f = max(int(cfg.coarse_factor), 2)
    full_res = grid.resolution
    coarse_res = tuple(max((r // f) // 8 * 8, 8) for r in full_res)
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
                   base_grid: Optional[VoxelGrid] = None, device="cuda"
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
    cascade base: the trained grid is its detail layer. Returns (the
    trained grid, the logged losses); LAST_TRAIN_AUX has the rest."""
    cfg = cfg or DenseConfig()
    dev = resolve_device(device)
    n = len(dataset.origins)
    steps_per_epoch = max(n // cfg.batch_size, 1)
    if grid is None:
        s = 2.0 if cfg.contraction else cfg.scene_scale
        grid = create_grid(cfg.grid_resolution, (-s, -s, -s), (s, s, s), device=dev)
    phases: List[dict] = []
    losses: List[float] = []
    if cfg.coarse_epochs > 0 and cfg.epochs > cfg.coarse_epochs and not resume:
        grid, losses, cfg, coarse = _coarse_stage(dataset, cfg, seed, grid, verbose, log_every,
                                                  dev)
        phases.append(coarse)
    n_cams = (int(dataset.cam_ids.max()) + 1
              if cfg.exposure and dataset.cam_ids is not None else None)
    state = init_state(cfg, grid, steps_per_epoch, n_cams)
    del grid
    start_epoch = 0
    if resume and checkpoint_store is not None:
        ck = load_checkpoint(checkpoint_store, cfg, steps_per_epoch, dev)
        if ck is not None:
            state, start_epoch, losses = ck
            start_epoch += 1
            if verbose:
                print(f"[dense] resumed at epoch {start_epoch}", flush=True)
    base = None if base_grid is None else VoxelGrid(
        base_grid.grid.detach(), base_grid.min_bound, base_grid.max_bound)
    o_all, d_all, rgb_all = (torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
                             for a in (dataset.origins, dataset.dirs, dataset.rgb))
    cid_all = (torch.from_numpy(dataset.cam_ids.astype(np.int64)).to(dev)
               if n_cams is not None else None)
    occ = None
    if cfg.occupancy_prune:
        f = cfg.occupancy_factor
        occ = torch.ones(tuple(-(-d // f) for d in state.grid.resolution), dtype=torch.bool,
                         device=dev)
    chunk = 1 if n < cfg.batch_size else max(int(cfg.scan_chunk), 1)
    plan = _chunk_plan(steps_per_epoch, chunk)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    log, refreshes = [], []
    gate, gate_dropped, kept = None, [], None
    global_step, next_occ, step0 = 0, cfg.occupancy_every, state.step
    B = cfg.batch_size
    t0 = time.time()
    with f32_scope():
        for epoch in range(start_epoch, cfg.epochs):
            if (cfg.camera_gate and gate is None and dataset.cam_ids is not None
                    and epoch >= cfg.camera_gate_epoch):
                keep, gate_dropped, mse, thr = apply_camera_gate(state, dataset, cfg, verbose, dev)
                gate = dict(epoch=epoch, step=global_step, probe_mse=mse.tolist(),
                            threshold=thr, dropped=gate_dropped)
                if gate_dropped:
                    kept = torch.from_numpy(np.flatnonzero(keep)).to(dev)
                    plan = _chunk_plan(max(len(kept) // B, 1), chunk)
            perm = torch.randperm(n, generator=gen, device=dev)
            if kept is not None:
                perm = kept[torch.randperm(len(kept), generator=gen, device=dev)]
            for b, k_steps in plan:
                if occ is not None and global_step >= next_occ:
                    occ = occupancy_from_grid(state.grid.grid.detach(), cfg.occupancy_factor,
                                              cfg.occupancy_threshold)
                    refreshes.append(dict(step=global_step, epoch=epoch,
                                          occupied=float(occ.float().mean())))
                    next_occ += cfg.occupancy_every
                for j in range(b, b + k_steps):
                    idx = perm[j * B:(j + 1) * B]
                    loss = train_step(state, cfg, o_all[idx], d_all[idx], rgb_all[idx],
                                      None if cid_all is None else cid_all[idx], generator=gen,
                                      occ=occ, base=base)
                    if j % log_every == 0:
                        lv = float(loss)
                        losses.append(lv)
                        log.append({"epoch": epoch, "step": j, "update": state.step,
                                    "loss": lv, "seconds": time.time() - t0})
                        if verbose:
                            rate = (j + 1) * B / (time.time() - t0)
                            print(f"[dense] epoch {epoch} step {j}/{steps_per_epoch} "
                                  f"loss {lv:.5f} ({rate:.0f} rays/s)", flush=True)
                global_step += k_steps
            if checkpoint_store is not None:
                save_checkpoint(checkpoint_store, state, epoch, losses)
    phases.append(dict(phase="detail" if base is not None else "fine" if phases else "train",
                       res=list(state.grid.resolution), steps=state.step - step0, log=log,
                       seconds=time.time() - t0))
    LAST_TRAIN_AUX.clear()
    LAST_TRAIN_AUX.update(
        background=None if state.background is None else state.background[0].cpu().numpy(),
        exposure=None if state.exposure is None else state.exposure[0].cpu().numpy(),
        dropped_cameras=gate_dropped, log=log, steps=state.step,
        occupancy_refreshes=refreshes, camera_gate=gate, phases=phases)
    vg = state.grid
    return VoxelGrid(vg.grid.detach(), vg.min_bound, vg.max_bound), losses


def _permutation(n: int, generator: torch.Generator, device, epoch: int) -> torch.Tensor:
    """An epoch's ray order. A test replaces this function (and
    :func:`_sdf_step_noise`) to feed tpu3d's draws."""
    return torch.randperm(n, generator=generator, device=device)


def _sdf_step_noise(cfg: DenseConfig, grid_shape, n_rays: int, generator: torch.Generator,
                    device, epoch: int, step: int) -> StepNoise:
    """Step ``step`` of epoch ``epoch``'s random numbers for the SDF step."""
    return draw_step_noise(sdf_noise_config(cfg), grid_shape, n_rays, generator, device)


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
    (tpu3d's brick-sharded trainer) is ROADMAP Queue 1 item 10. Returns
    (the trained grid, the logged losses); LAST_TRAIN_AUX has the latents,
    the log and the phases."""
    if mesh is not None:
        raise NotImplementedError("tpu3d_torch: train_sdf(mesh=...) is not ported yet "
                                  "(ROADMAP Queue 1 item 10)")
    cfg = cfg or DenseConfig()
    dev = resolve_device(device)
    n = len(dataset.origins)
    steps_per_epoch = max(n // cfg.batch_size, 1)
    if grid is None:
        s = 2.0 if cfg.contraction else cfg.scene_scale
        grid = create_grid(cfg.grid_resolution, (-s, -s, -s), (s, s, s), device=dev)
    phases: List[dict] = []
    losses: List[float] = []
    if cfg.coarse_epochs > 0 and cfg.epochs > cfg.coarse_epochs:
        grid, losses, cfg, coarse = _coarse_stage(dataset, cfg, seed, grid, verbose, log_every,
                                                  dev, train_fn=train_sdf)
        phases.append(coarse)
    n_cams = (int(dataset.cam_ids.max()) + 1
              if cfg.exposure and dataset.cam_ids is not None else None)
    state = init_state(cfg, grid, steps_per_epoch, n_cams)
    del grid
    o_all, d_all, rgb_all = (torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
                             for a in (dataset.origins, dataset.dirs, dataset.rgb))
    cid_all = (torch.from_numpy(dataset.cam_ids.astype(np.int64)).to(dev)
               if n_cams is not None else None)
    chunk = 1 if n < cfg.batch_size else max(int(cfg.scan_chunk), 1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    B, log = cfg.batch_size, []
    t0 = time.time()
    with f32_scope():
        for epoch in range(cfg.epochs):
            perm = _permutation(n, gen, dev, epoch)
            for b, k_steps in _chunk_plan(steps_per_epoch, chunk):
                for j in range(b, b + k_steps):
                    idx = perm[j * B:(j + 1) * B]
                    noise = _sdf_step_noise(cfg, state.grid.grid.shape, len(idx), gen, dev,
                                            epoch, j)
                    loss = sdf_train_step(state, cfg, o_all[idx], d_all[idx], rgb_all[idx],
                                          None if cid_all is None else cid_all[idx],
                                          noise=noise)
                    if j % log_every == 0:
                        lv = float(loss)
                        losses.append(lv)
                        log.append({"epoch": epoch, "step": j, "update": state.step,
                                    "loss": lv, "seconds": time.time() - t0})
                        if verbose:
                            rate = (j + 1) * B / (time.time() - t0)
                            print(f"[sdf] epoch {epoch} step {j}/{steps_per_epoch} "
                                  f"loss {lv:.5f} ({rate:.0f} rays/s)", flush=True)
    phases.append(dict(phase="fine" if phases else "train", res=list(state.grid.resolution),
                       steps=state.step, log=log, seconds=time.time() - t0))
    LAST_TRAIN_AUX.clear()
    LAST_TRAIN_AUX.update(
        background=None if state.background is None else state.background[0].cpu().numpy(),
        exposure=None if state.exposure is None else state.exposure[0].cpu().numpy(),
        dropped_cameras=[], log=log, steps=state.step, occupancy_refreshes=[],
        camera_gate=None, phases=phases)
    vg = state.grid
    return VoxelGrid(vg.grid.detach(), vg.min_bound, vg.max_bound), losses
