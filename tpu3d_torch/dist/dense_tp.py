"""Voxel-brick tensor parallelism for dense training (tpu3d/dist/dense_tp.py).

One device holds a grid of at most its memory less the optimizer's moments
and the render's temporaries; this module shards the grid itself, so the
resolution scales with the device count.

  - The (X, Y, Z, C) grid shards into bricks along X over ``model``; the
    optimizer's moments shard alike, so each rank holds 1/m of the grid
    state and nothing is replicated.
  - Ray batches shard over ``data``.
  - Trilinear interpolation is linear in the grid: each rank sums the
    8-corner lerp over the corners its brick owns (a corner row at a brick
    border belongs to exactly one brick), and one all-reduce over
    ``model`` of the (N, C) sample values gives the exact interpolation.
    That all-reduce is the halo exchange: no halo planes are stored, and
    its payload (batch x samples x 28 floats) does not depend on the
    grid's resolution (:func:`psum_bytes_per_step`).
  - The backward of the masked gather is a scatter into the local brick
    only; the all-reduce's backward is the identity (mesh.psum). Grid
    gradients are summed over ``data`` and divided by its size; the
    optimizer updates each brick where it lies.
  - The checkpoint and the trained grid go brick by brick to rank 0's
    host (mesh.gather_rows_to_root), never whole onto a device; a resumed
    rank reads only its own X rows of the checkpoint.

The brick partial is plain PyTorch, as tpu3d's is jnp: the all-reduce
takes the place of the trilinear kernel's gather. Per-ray random numbers
are a counter-based hash of (step key, salt, global ray index, sample), so
the trajectory does not depend on the mesh's shape; tests inject tpu3d's
``_ray_uniforms`` draws instead (``noise=``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu3d_torch import f32_scope, resolve_device
from tpu3d_torch.config import DenseConfig
from tpu3d_torch.dense.contract import contract as contract_pts
from tpu3d_torch.dense.grid import VoxelGrid, create_grid, eval_sh
from tpu3d_torch.dense.render import (_CONTRACT_BG_FAR, _band, _sample_z, composite,
                                      composite_weights, jitter_width)
from tpu3d_torch.dense.sdf import ray_aabb, sample_pdf
from tpu3d_torch.dense.train import (StepNoise, TrainState, _exposure_adam, _exposure_apply,
                                     _LossLog, _n_cams, _ray_background, _record,
                                     _sparsity_crop_loss, _tv_crop_loss, _upload_rays,
                                     init_state)
from tpu3d_torch.dist.mesh import (Mesh, all_reduce_, data_sharding, gather_rows,
                                   gather_rows_to_root, grid_sharding, pmean, psum)


def trilinear_partial(grid_local: torch.Tensor, x_lo: int, global_res: Tuple[int, int, int],
                      min_bound: torch.Tensor, max_bound: torch.Tensor, pts: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brick-local partial trilinear interpolation. grid_local (Xl, Y, Z, C)
    covers the global x rows [x_lo, x_lo + Xl). Returns (partial (N, C),
    in_bounds (N,)): the sum of the partials over every brick is the
    grid's trilinear sample, each corner's w_c * grid[c] coming from the
    brick that owns corner row c."""
    X, Y, Z = global_res
    Xl, C = grid_local.shape[0], grid_local.shape[3]
    dev = pts.device
    res = torch.tensor((X, Y, Z), dtype=pts.dtype, device=dev)
    u = (pts - min_bound) / (max_bound - min_bound)
    in_bounds = ((u >= 0.0) & (u <= 1.0)).all(dim=-1)
    v = u * (res - 1.0)
    hi = torch.tensor((X - 2, Y - 2, Z - 2), device=dev)
    i0 = torch.minimum(torch.clamp(torch.floor(v).long(), min=0), hi)
    frac = v - i0.to(v.dtype)
    x0, y0, z0 = i0[:, 0], i0[:, 1], i0[:, 2]
    fx, fy, fz = frac[:, 0], frac[:, 1:2], frac[:, 2:3]
    flat = grid_local.reshape(Xl * Y * Z, C)
    offs = torch.tensor([0, 1, Z, Z + 1], device=dev)
    out = torch.zeros((pts.shape[0], C), dtype=grid_local.dtype, device=dev)
    # The two x planes x0 and x0 + 1 are the only corner coordinates that
    # can cross a brick border: gather each plane's 4 (y, z) corners as one
    # row gather on the brick, weighted by the x lerp factor and ownership.
    for bit, wx in ((0, 1.0 - fx), (1, fx)):
        lx = x0 + bit - x_lo
        own = (lx >= 0) & (lx < Xl)
        base = (torch.clamp(lx, 0, Xl - 1) * Y + y0) * Z + z0
        vals = flat[(base[:, None] + offs).reshape(-1)].reshape(-1, 4, C)
        c00 = vals[:, 0] * (1 - fz) + vals[:, 1] * fz
        c01 = vals[:, 2] * (1 - fz) + vals[:, 3] * fz
        plane = c00 * (1 - fy) + c01 * fy
        out = out + plane * (wx[:, None] * own[:, None].to(plane.dtype))
    return out, in_bounds


def _query_tp(grid_local, x_lo, gres, minb, maxb, pts, dirs, mesh: Mesh):
    """(sigma, rgb) at world points from the bricked grid: the partial, one
    psum over ``model``, then grid.query's relu and SH on the sum."""
    partial, in_b = trilinear_partial(grid_local, x_lo, gres, minb, maxb, pts)
    vals = psum(partial, mesh, mesh.axis_names[1])
    sigma = torch.relu(vals[:, 0]) * in_b
    rgb = eval_sh(vals[:, 1:28].reshape(-1, 3, 9), dirs) * in_b[:, None]
    return sigma, rgb


# --------------------------------------------------------------------------
# Counter-based draws: integers held in int64 tensors as uint32 values, mixed
# by the 0x45d9f3b integer hash (products stay below 2^59).

_M32 = 0xFFFFFFFF


def _mix(h):
    """The 0x45d9f3b integer hash of uint32 values (int64 tensors or ints)."""
    h = h ^ (h >> 16)
    h = (h * 0x45D9F3B) & _M32
    h = h ^ (h >> 16)
    h = (h * 0x45D9F3B) & _M32
    return h ^ (h >> 16)


def step_key(seed: int, epoch: int, step: int) -> int:
    """The key of one training step: a hash of (seed, epoch, step)."""
    h = _mix(seed & _M32)
    h = _mix(h ^ (epoch & _M32))
    return _mix(h ^ ((step * 0x9E3779B1) & _M32))


def _ray_uniforms(key: int, gidx: torch.Tensor, salt: int, S: int) -> torch.Tensor:
    """(N, S) f32 uniforms in [0, 1) keyed by (key, salt, GLOBAL ray index,
    sample index) alone: a ray draws the same numbers on whichever rank it
    lands, so the training trajectory does not depend on the mesh's shape."""
    h = _mix(_mix(key & _M32) ^ ((salt * 0x9E3779B1) & _M32))
    h = _mix(h ^ gidx.long())[:, None]
    s = torch.arange(S, dtype=torch.int64, device=gidx.device)
    h = _mix(h ^ ((s * 0x27D4EB2D) & _M32)[None, :])
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _crop_origin(key: int, fold: int, dims, crop: int, extra: int) -> torch.Tensor:
    """(3,) int64 origin of a prior's crop: along each axis of size d, an
    integer in [0, d - min(crop, d - 1 + extra) + extra)."""
    h = _mix(_mix(key & _M32) ^ fold)
    out = []
    for a, d in enumerate(dims):
        h = _mix(h ^ (a + 1))
        out.append(h % (d - min(crop, d - 1 + extra) + extra))
    return torch.tensor(out, dtype=torch.int64)


def tp_step_noise(cfg: DenseConfig, key: int, gidx: torch.Tensor, local_shape,
                  sdf_mode: bool = False) -> StepNoise:
    """One TP step's random numbers for this rank's rays (global indices
    ``gidx``): the stratified jitter (salt 1; the coarse pass's under
    ``hierarchical``, the foreground three quarters under contraction), the
    fine pass's quantiles (salt 2) and the prior crops' origins on the
    brick of ``local_shape`` (folds 7 and 11, as tpu3d's)."""
    hier = cfg.hierarchical and not sdf_mode
    contract = cfg.contraction and not sdf_mode
    S = cfg.n_coarse if hier else cfg.num_samples
    u = _ray_uniforms(key, gidx, 1, jitter_width(S, contract))
    u_fine = _ray_uniforms(key, gidx, 2, cfg.n_fine) if hier else None
    dims = tuple(local_shape[:3])
    dev = gidx.device
    tv = (_crop_origin(key, 7, dims, cfg.tv_crop, 0).to(dev)
          if cfg.tv_sigma or cfg.tv_sh else None)
    sp = _crop_origin(key, 11, dims, cfg.tv_crop, 1).to(dev) if cfg.sparsity_sigma else None
    return StepNoise(u, u_fine, tv, sp)


def _render_tp(cfg: DenseConfig, grid_local, x_lo, gres, minb, maxb, noise: StepNoise, ro, rd,
               bg, mesh: Mesh, sdf_mode: bool):
    """The bricked grid's counterpart of render_rays / render_rays_hierarchical
    / the SDF band (tpu3d/dist/dense_tp.py:128-198): the same depths and
    compositing, the grid query replaced by the psum of the partials.
    sdf_mode takes the SDF trainer's band (each ray's stretch in the box)
    and returns its valid mask for the masked MSE."""
    n = ro.shape[0]
    if sdf_mode:
        t_near, t_far, valid = ray_aabb(ro, rd, minb, maxb)
        t_far = torch.where(valid, t_far, t_near + 1.0)
    else:
        t_near, t_far = _band(ro, rd, cfg.near, cfg.far, minb, maxb, cfg.per_ray_aabb)
        valid = torch.ones((n,), dtype=torch.bool, device=ro.device)
    contract = cfg.contraction and not sdf_mode
    bg_far = _CONTRACT_BG_FAR if contract else None
    if cfg.hierarchical and not sdf_mode:
        z_c = _sample_z(ro, rd, t_near, t_far, cfg.n_coarse, bg_far, True, None, noise.u)
        with torch.no_grad():
            pts_c = ro[:, None, :] + z_c[..., None] * rd[:, None, :]
            if contract:
                pts_c = contract_pts(pts_c)
            dens, in_c = trilinear_partial(grid_local.detach()[..., :1], x_lo, gres, minb, maxb,
                                           pts_c.reshape(-1, 3))
            dens = all_reduce_(dens, mesh, mesh.axis_names[1])
            sigma_c = torch.relu(dens[:, 0] * in_c).reshape(n, cfg.n_coarse)
            w = composite_weights(sigma_c, z_c)
        z_f = sample_pdf(z_c, w, cfg.n_fine, u=noise.u_fine)
        z = torch.sort(torch.cat([z_c, z_f], dim=-1), dim=-1).values
        S = cfg.n_coarse + cfg.n_fine
    else:
        S = cfg.num_samples
        z = _sample_z(ro, rd, t_near, t_far, S, bg_far, True, None, noise.u)
    pts = ro[:, None, :] + z[..., None] * rd[:, None, :]
    if contract:
        pts = contract_pts(pts)
    dirs = rd[:, None, :].expand(pts.shape).reshape(-1, 3)
    sigma, rgb = _query_tp(grid_local, x_lo, gres, minb, maxb, pts.reshape(-1, 3), dirs, mesh)
    out = composite(sigma.reshape(n, S), rgb.reshape(n, S, 3), z, cfg.white_background, bg)
    return out, valid


class TPDenseStep:
    """The DP x TP train step on the bricked grid (tpu3d's
    make_tp_dense_step). :meth:`place` builds this rank's TrainState (its
    brick of the grid, the optimizer over the brick, the replicated
    latents); calling the step with this rank's rays runs one update and
    returns the loss, averaged over ``data``. ``keep_grad`` keeps the
    reduced grid gradient of the last step in ``last_grad``."""

    def __init__(self, cfg: DenseConfig, mesh: Mesh, global_shape, sdf_mode: bool = False,
                 with_exposure: bool = False, with_background: bool = False,
                 keep_grad: bool = False):
        data_ax, model_ax = mesh.axis_names
        self.n_model, self.n_data = mesh.size(model_ax), mesh.size(data_ax)
        X, Y, Z, C = global_shape
        if X % self.n_model:
            raise ValueError(f"grid X={X} must divide the model axis ({self.n_model})")
        self.cfg, self.mesh, self.sdf_mode = cfg, mesh, sdf_mode
        self.with_exposure, self.with_background = with_exposure, with_background
        self.global_shape = tuple(global_shape)
        self.Xl = X // self.n_model
        self.x_lo = mesh.index(model_ax) * self.Xl
        self.keep_grad = keep_grad
        self.last_grad: Optional[torch.Tensor] = None

    @property
    def local_shape(self):
        return (self.Xl,) + self.global_shape[1:]

    def place(self, grid: VoxelGrid, steps_per_epoch: int, n_cams: Optional[int] = None
              ) -> TrainState:
        """This rank's TrainState from a whole grid (or from this rank's
        brick when grid.grid already has the brick's shape)."""
        g = grid.grid
        if tuple(g.shape) != self.local_shape:
            g = grid_sharding(self.mesh, g)
        brick = VoxelGrid(g.detach().clone().contiguous(), grid.min_bound, grid.max_bound)
        cfg = dataclasses.replace(self.cfg, exposure=self.with_exposure,
                                  sh_background=self.with_background)
        return init_state(cfg, brick, steps_per_epoch, n_cams)

    def gidx(self, n_local: int, device) -> torch.Tensor:
        """Global indices of this rank's rays in the batch."""
        d = self.mesh.index(self.mesh.axis_names[0])
        return d * n_local + torch.arange(n_local, device=device)

    def __call__(self, state: TrainState, key: int, ro, rd, rgb, cid=None,
                 noise: Optional[StepNoise] = None) -> torch.Tensor:
        cfg, mesh = self.cfg, self.mesh
        data_ax, model_ax = mesh.axis_names
        g = state.grid.grid
        minb, maxb = state.grid.min_bound, state.grid.max_bound
        if noise is None:
            noise = tp_step_noise(cfg, key, self.gidx(ro.shape[0], ro.device), self.local_shape,
                                  self.sdf_mode)
        has_exp = self.with_exposure and cid is not None
        gains = state.exposure[0].clone().requires_grad_() if has_exp else None
        bg_sh = state.background[0].clone().requires_grad_() if self.with_background else None
        pred, valid = _render_tp(cfg, g, self.x_lo, self.global_shape[:3], minb, maxb, noise,
                                 ro, rd, _ray_background(bg_sh, rd), mesh, self.sdf_mode)
        pred = _exposure_apply(pred, gains, cid if has_exp else None)
        if self.sdf_mode:
            # The global masked mean: the valid rays' count is summed over
            # data (per-shard ratios would weight a shard with fewer valid
            # rays more); the local numerator times n_data, after the
            # gradient's sum over data and division by n_data, gives
            # exactly num_global / den_global and its gradient.
            w = valid.to(pred.dtype)[:, None]
            num = (w * (pred - rgb) ** 2).sum()
            den = all_reduce_((w.sum() * 3).detach(), mesh, data_ax)
            loss = self.n_data * num / torch.clamp(den, min=1.0)
        else:
            loss = ((pred - rgb) ** 2).mean()
        # Per-brick crop priors averaged over model: the same priors with
        # brick-local support (a crop never spans two bricks).
        if cfg.tv_sigma or cfg.tv_sh:
            tv_s, tv_c = _tv_crop_loss(g, noise.tv_origin, cfg.tv_crop)
            loss = loss + pmean(cfg.tv_sigma * tv_s + cfg.tv_sh * tv_c, mesh, model_ax)
        if cfg.sparsity_sigma:
            loss = loss + pmean(cfg.sparsity_sigma * _sparsity_crop_loss(
                g, noise.sparsity_origin, cfg.tv_crop), mesh, model_ax)
        loss.backward()
        with torch.no_grad():
            # Each data shard's loss is a mean over its rays: the global
            # batch's gradient is the mean over data. Bricks and latents
            # reduce over data only (the summed sample values, and so every
            # latent's gradient, are already the same on each model rank).
            grads = [g.grad] + [x.grad for x in (gains, bg_sh) if x is not None]
            for x in grads:
                all_reduce_(x, mesh, data_ax).div_(self.n_data)
            if has_exp:
                state.exposure = _exposure_adam(state.exposure, gains.grad, state.step,
                                                cfg.exposure_lr)
            if bg_sh is not None:
                state.background = _exposure_adam(state.background, bg_sh.grad, state.step,
                                                  cfg.background_lr)
            loss_v = all_reduce_(loss.detach().clone(), mesh, data_ax) / self.n_data
        if self.keep_grad:
            self.last_grad = g.grad.detach().clone()
        for group in state.optimizer.param_groups:
            group["lr"] = state.lr(state.step)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return loss_v


def make_tp_dense_step(cfg: DenseConfig, mesh: Mesh, global_shape, sdf_mode: bool = False,
                       with_exposure: bool = False, with_background: bool = False,
                       keep_grad: bool = False) -> TPDenseStep:
    """The DP x TP step on the bricked grid (:class:`TPDenseStep`)."""
    return TPDenseStep(cfg, mesh, global_shape, sdf_mode, with_exposure, with_background,
                       keep_grad)


def psum_bytes_per_step(cfg: DenseConfig, n_model: int, n_data: int) -> int:
    """Collective payload of one TP train step per device (ring all-reduce
    over the model axis; zero when the grid is not sharded). It does not
    depend on the grid's resolution: the point of the value-psum design."""
    if n_model <= 1:
        return 0
    B = cfg.batch_size // max(n_data, 1)
    S = (cfg.n_coarse + cfg.n_fine) if cfg.hierarchical else cfg.num_samples
    fine = B * S * 28 * 4
    coarse = B * cfg.n_coarse * 1 * 4 if cfg.hierarchical else 0
    # forward psum + backward (the transpose moves the same cotangent bytes)
    return 2 * (fine + coarse) * (n_model - 1) // n_model


def gather_grid(brick: torch.Tensor, X: int, mesh: Mesh) -> torch.Tensor:
    """The whole (X, Y, Z, C) array from every rank's brick, on every rank
    of the model axis (the coarse phase's grid, which every rank
    upsamples)."""
    return gather_rows(brick.detach(), X, mesh, mesh.axis_names[1])


def _gather_to_root(step: TPDenseStep, state: TrainState
                    ) -> Optional[Tuple[np.ndarray, Dict[str, np.ndarray]]]:
    """(the whole grid, its moments by name) on rank 0's host, sent there
    brick by brick (mesh.gather_rows_to_root); None on every other rank."""
    X, model_ax = step.global_shape[0], step.mesh.axis_names[1]
    p = state.grid.grid
    grid = gather_rows_to_root(p, X, step.mesh, model_ax)
    moments = {k: gather_rows_to_root(v, X, step.mesh, model_ax)
               for k, v in state.optimizer.state.get(p, {}).items()
               if torch.is_tensor(v) and v.dim() == 4}
    return None if grid is None else (grid, moments)


def _save_tp_checkpoint(store, step: TPDenseStep, state: TrainState, epoch: int,
                        losses: List[float]) -> None:
    """tpu3d's dense_ckpt of the whole grid and moments: each brick goes to
    rank 0's host, and rank 0 alone writes. No device holds more than its
    brick."""
    from tpu3d_torch.dense.train import save_checkpoint

    whole = _gather_to_root(step, state)
    if whole is not None:
        save_checkpoint(store, state, epoch, losses, *whole)


def train_dense_tp(dataset, cfg: DenseConfig, mesh: Mesh, seed: int = 0,
                   grid: Optional[VoxelGrid] = None, verbose: bool = True, log_every: int = 170,
                   checkpoint_store=None, resume: bool = False, sdf_mode: bool = False,
                   device="cuda") -> Tuple[Optional[VoxelGrid], List[float]]:
    """The ray-DP x brick-TP counterpart of train_plenoxel / train_sdf's
    loop (tpu3d/dist/dense_tp.py:349-506): the same schedule, batching,
    coarse phase (X a multiple of lcm(8, model)), checkpoints and (grid,
    losses) contract, one :class:`TPDenseStep` per batch. Every rank holds
    the whole ray dataset and draws the same permutation; each takes its
    data shard of each batch.

    Each epoch's checkpoint is tpu3d's dense_ckpt of the whole grid: the
    bricks and moments go to rank 0's host, and rank 0 alone writes it. On
    ``resume`` each rank reads only its own X rows. The whole grid comes
    back on rank 0 (on ``device``, once the training state is freed); the
    other ranks get None for it. No device holds more of the grid's state
    than its brick, except in the coarse phase, which builds the
    full-resolution grid on each rank before sharding it, as tpu3d's builds
    it on one device.

    Refused: occupancy pruning (its refresh reads the whole grid), and a
    batch that the data axis does not divide. Batches of a dataset smaller
    than one batch wrap the permutation (np.resize), so every shard has
    the same length."""
    dev = resolve_device(device)
    state, step, losses = _train_tp(dataset, cfg, mesh, seed, grid, verbose, log_every,
                                    checkpoint_store, resume, sdf_mode, dev)
    vg = state.grid
    if step.n_model == 1:
        whole = vg.grid.detach() if mesh.index(mesh.axis_names[0]) == 0 else None
    else:
        host = gather_rows_to_root(vg.grid, step.global_shape[0], mesh, mesh.axis_names[1])
        del state
        whole = None if host is None else torch.from_numpy(host).to(dev)
    return (None if whole is None else VoxelGrid(whole, vg.min_bound, vg.max_bound)), losses


def _train_tp(dataset, cfg: DenseConfig, mesh: Mesh, seed: int, grid: Optional[VoxelGrid],
              verbose: bool, log_every: int, checkpoint_store, resume: bool, sdf_mode: bool,
              dev) -> Tuple[TrainState, TPDenseStep, List[float]]:
    """train_dense_tp's loop: (this rank's trained state, its step, the
    logged losses)."""
    from tpu3d_torch.dense.train import _coarse_stage, load_checkpoint

    data_ax, model_ax = mesh.axis_names
    n_data, n_model = mesh.size(data_ax), mesh.size(model_ax)
    if cfg.occupancy_prune:
        raise ValueError("occupancy_prune is not supported with a sharded grid (the refresh "
                         "reads the full grid); disable it for mesh dense training")
    if cfg.batch_size % n_data:
        raise ValueError(f"batch_size {cfg.batch_size} must be divisible by the data-axis size "
                         f"{n_data} of mesh {mesh.shape} (each ray shard must be equal-length)")
    n = len(dataset.origins)
    steps_per_epoch = max(n // cfg.batch_size, 1)
    s = 2.0 if cfg.contraction else cfg.scene_scale
    if grid is None and cfg.coarse_epochs > 0 and cfg.epochs > cfg.coarse_epochs and not resume:
        grid = create_grid(cfg.grid_resolution, (-s, -s, -s), (s, s, s), device=dev)
    phases: List[dict] = []
    losses: List[float] = []
    if cfg.coarse_epochs > 0 and cfg.epochs > cfg.coarse_epochs and not resume:
        def coarse_fn(ds, sub, seed, grid, verbose, log_every, device):
            st, stp, ls = _train_tp(ds, sub, mesh, seed, grid, verbose, log_every, None, False,
                                    sdf_mode, device)
            small = gather_grid(st.grid.grid, stp.global_shape[0], mesh)
            return VoxelGrid(small, st.grid.min_bound, st.grid.max_bound), ls

        grid, losses, cfg, coarse = _coarse_stage(dataset, cfg, seed, grid, verbose, log_every,
                                                  dev, train_fn=coarse_fn,
                                                  x_multiple=math.lcm(8, n_model))
        phases.append(coarse)
    if grid is None:
        r = cfg.grid_resolution
        res = (r, r, r) if isinstance(r, int) else tuple(r)
        if res[0] % n_model:
            raise ValueError(f"grid X={res[0]} must divide the model axis ({n_model})")
        # Only this rank's brick is ever allocated.
        grid = create_grid((res[0] // n_model,) + res[1:], (-s, -s, -s), (s, s, s), device=dev)
        global_shape = res + (grid.grid.shape[3],)
    else:
        global_shape = tuple(grid.grid.shape)
    n_cams = _n_cams(cfg, dataset)
    step = make_tp_dense_step(cfg, mesh, global_shape, sdf_mode=sdf_mode,
                              with_exposure=n_cams is not None,
                              with_background=bool(cfg.sh_background))
    state = step.place(grid, steps_per_epoch, n_cams)
    del grid
    start_epoch = 0
    if resume and checkpoint_store is not None:
        ck = load_checkpoint(checkpoint_store, cfg, steps_per_epoch, dev,
                             rows=(step.x_lo, step.x_lo + step.Xl))
        if ck is not None:
            brick, start_epoch, losses = ck
            start_epoch += 1
            state = step.place(brick.grid, steps_per_epoch, n_cams)
            state.optimizer.state[state.grid.grid] = brick.optimizer.state[brick.grid.grid]
            state.set_step(brick.step)
            state.exposure, state.background = brick.exposure, brick.background
            del brick
            if verbose:
                print(f"[dense-tp] resumed at epoch {start_epoch}", flush=True)
    o_all, d_all, rgb_all, cid_all = _upload_rays(dataset, n_cams, dev)
    B = cfg.batch_size
    gen = torch.Generator()
    gen.manual_seed(seed)
    step0 = state.step
    if verbose:
        print(f"[dense-tp] mesh {mesh.shape}: grid {global_shape} bricked x{n_model}, batch "
              f"{B} over {n_data} shards, psum "
              f"{psum_bytes_per_step(cfg, n_model, n_data) / 1e6:.1f} MB/step/device",
              flush=True)
    log = _LossLog(losses, log_every, B, steps_per_epoch, "[dense-tp]" if verbose else None)
    with f32_scope():
        for epoch in range(start_epoch, cfg.epochs):
            perm = torch.randperm(n, generator=gen)
            for b in range(steps_per_epoch):
                idx = perm[b * B:(b + 1) * B].numpy()
                if len(idx) < B:
                    idx = np.resize(idx, B)
                idx = data_sharding(mesh, torch.from_numpy(idx)).to(dev)
                loss = step(state, step_key(seed, epoch, b), o_all[idx], d_all[idx],
                            rgb_all[idx], None if cid_all is None else cid_all[idx])
                log.chunk(loss[None], b, epoch, state.step)
            if checkpoint_store is not None:
                _save_tp_checkpoint(checkpoint_store, step, state, epoch, losses)
    _record(state, log, phases, "fine" if phases else "train", global_shape[:3],
            state.step - step0, mesh=dict(mesh.shape),
            psum_bytes_per_step=psum_bytes_per_step(cfg, n_model, n_data))
    return state, step, losses
