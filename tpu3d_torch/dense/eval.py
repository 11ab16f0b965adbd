"""Held-out view evaluation of the dense stage (tpu3d/dense/eval.py): hold
out every k-th camera by image name, render those views in full, and report
per-view and mean PSNR against the photographs.

A view's rays are built where its grid lives: on a CUDA grid by
``view_rays_kernel`` from the pose (nothing uploaded), on a CPU grid, or
where the caller needs them on the host (evaluate_views' core split), by
numpy ``view_rays``. The render runs on the grid's device and its image
comes back as a numpy array.
"""
from __future__ import annotations

import re
from typing import List, Optional, Tuple

import numpy as np
import torch

from tpu3d_torch.config import DenseConfig
from tpu3d_torch.core import lie
from tpu3d_torch.dense import dvgo
from tpu3d_torch.dense.grid import VoxelGrid
from tpu3d_torch.dense.render import render_image
from tpu3d_torch.dense.train import RayDataset, SceneNormalization, psnr, rays_from_cameras
from tpu3d_torch.kernels import view_rays as kernel_rays
from tpu3d_torch.utils.trace import get_tracer, hot_span, tracing


def split_views(n_views: int, holdout_every: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """(train_idx, test_idx). holdout_every <= 0 disables the split."""
    idx = np.arange(n_views)
    if holdout_every <= 0 or n_views < 2:
        return idx, np.array([], np.int64)
    test = idx[holdout_every // 2 :: holdout_every]
    return np.setdiff1d(idx, test), test


def split_views_by_name(names, holdout_every: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Name-keyed holdout: an image is a test view iff the last number in
    its file name is holdout_every // 2 modulo holdout_every, so every
    reconstruction of a dataset scores on the same views. Falls back to the
    positional split when no name carries digits or the split is degenerate."""
    idx = np.arange(len(names))
    if holdout_every <= 0 or len(names) < 2:
        return idx, np.array([], np.int64)
    nums = []
    for n in names:
        m = re.findall(r"(\d+)", n)
        nums.append(int(m[-1]) if m else -1)
    if all(v < 0 for v in nums):
        return split_views(len(names), holdout_every)
    test = np.asarray([i for i, v in enumerate(nums)
                       if v >= 0 and v % holdout_every == holdout_every // 2], np.int64)
    if len(test) == 0 or len(test) == len(names):
        return split_views(len(names), holdout_every)
    return np.setdiff1d(idx, test), test


def view_pose(cam: np.ndarray,
              norm: Optional[SceneNormalization] = None) -> Tuple[np.ndarray, np.ndarray]:
    """A camera's rotation R (3, 3) and centre -R^T t in the normalized
    frame (3,), float32 both: what every ray of its view shares."""
    R = lie.so3_exp_np(cam[:3])
    o = -R.T @ cam[3:6]
    if norm is not None:
        o = norm.apply(o)
    return R, o.astype(np.float32)


def view_rays(cam: np.ndarray, H: int, W: int, focal: float,
              norm: Optional[SceneNormalization] = None,
              stride: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Ray grid of one camera in numpy: (origins (P, 3), dirs (P, 3)) in
    the normalized frame, row-major pixel order. The hot span
    ``render.ray_build``; counts ``render.rays_host`` while tracing."""
    with hot_span("render.ray_build"):
        ys, xs = np.meshgrid(np.arange(0, H, stride), np.arange(0, W, stride), indexing="ij")
        u = xs.reshape(-1).astype(np.float32) - W / 2.0
        v = -(ys.reshape(-1).astype(np.float32) - H / 2.0)
        d_cam = np.stack([u / focal, v / focal, np.ones_like(u)], axis=-1)
        R, o = view_pose(cam, norm)
        d = d_cam @ R
        d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
        out = np.broadcast_to(o, d.shape).copy(), d
    if tracing():
        get_tracer().count("render.rays_host")
    return out


def device_view_rays(cam: np.ndarray, H: int, W: int, focal: float,
                     norm: Optional[SceneNormalization] = None, stride: int = 1,
                     device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`view_rays` built on ``device``: the pose on the host, the
    rays by ``view_rays_kernel`` on a CUDA device (its plain version on the
    CPU), as tensors there: numpy's rays, bit for bit where numpy's sgemm
    is an fma chain (OpenBLAS on x86-64), else within a few ulp. The hot
    span ``render.ray_build``; counts ``render.rays_device`` while
    tracing."""
    with hot_span("render.ray_build"):
        R, o = view_pose(cam, norm)
        out = kernel_rays.view_rays(R, o, H, W, focal, stride, device)
    if tracing():
        get_tracer().count("render.rays_device")
    return out


def render_view(grid: VoxelGrid, cam: np.ndarray, H: int, W: int, focal: float,
                cfg: DenseConfig, norm: Optional[SceneNormalization] = None,
                stride: int = 1, chunk: int = 8192,
                bg_sh: Optional[torch.Tensor] = None,
                rays: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                base_grid: Optional[VoxelGrid] = None,
                rgbnet: Optional[Tuple[torch.Tensor, ...]] = None) -> np.ndarray:
    """One full camera view on the grid's device -> (H', W', 3) float
    numpy. rays: optional precomputed (origins, dirs) from view_rays.
    Without them a CUDA grid's view builds its rays on the card
    (:func:`device_view_rays`), a CPU grid's in numpy. The hot span
    ``render.view`` (``rays``, ``chunks``), around the ray build
    (``render.ray_build``), ``render.upload`` (host rays to the device; not
    on the card's build), ``render.enqueue`` (render_image's chunks) and
    ``render.image_copy`` (the image to the host, where the host waits for
    the card). With ``rgbnet`` (the colour MLP's leaves) ``grid`` is a DVGO
    model's, rendered by dense/dvgo.py ``render_image`` (its own sampler,
    the MLP colour head, eager compositing)."""
    h = len(range(0, H, stride))
    w = len(range(0, W, stride))
    with hot_span("render.view", rays=h * w, chunks=-(-h * w // chunk)):
        dev = grid.grid.device
        if rays is None and dev.type == "cuda":
            ro, rd = device_view_rays(cam, H, W, focal, norm, stride, dev)
        else:
            ro, rd = rays if rays is not None else view_rays(cam, H, W, focal, norm, stride)
            with hot_span("render.upload"):
                ro, rd = torch.from_numpy(ro).to(dev), torch.from_numpy(rd).to(dev)
        with hot_span("render.enqueue"):
            if rgbnet is not None:
                img = dvgo.render_image(grid, rgbnet, ro, rd, cfg.near, cfg.far, chunk)
            else:
                img = render_image(grid, ro, rd, cfg.near, cfg.far, cfg.num_samples,
                                   chunk=chunk, clip_aabb=cfg.per_ray_aabb, bg_sh=bg_sh,
                                   contract=cfg.contraction, base_grid=base_grid)
        with hot_span("render.image_copy"):
            return img.cpu().numpy().reshape(h, w, 3)


def fit_view_exposure(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Per-channel gain a = <pred, gt> / <pred, pred> minimizing
    ||a pred - gt||^2 (fit on one half of a held-out view)."""
    num = (pred * gt).sum(axis=(0, 1))
    den = (pred * pred).sum(axis=(0, 1)) + 1e-12
    return num / den


def evaluate_views(grid: VoxelGrid, cams: np.ndarray, images_rgb: np.ndarray,
                   focal: float, cfg: DenseConfig,
                   norm: Optional[SceneNormalization] = None,
                   stride: int = 2, chunk: int = 8192, max_views: int = 0,
                   bg_sh: Optional[torch.Tensor] = None,
                   base_grid: Optional[VoxelGrid] = None,
                   rgbnet: Optional[Tuple[torch.Tensor, ...]] = None) -> dict:
    """PSNR of renders against the photographs of the given cameras: raw,
    and exposure-calibrated (3 gains fit on the left half, scored on the
    right), plus the split between rays passing the unit ball (core) and
    the rest. Returns {"per_view", "mean_psnr", "per_view_calibrated",
    "mean_psnr_calibrated", "psnr_core", "psnr_background",
    "core_pixel_fraction", "renders"}. ``rgbnet``: a DVGO model's colour
    MLP."""
    n = len(cams) if not max_views else min(len(cams), max_views)
    per_view: List[float] = []
    per_view_cal: List[float] = []
    core_err, bg_err = [], []
    core_n = bg_n = 0
    renders = []
    H, W = images_rgb.shape[1:3]
    for m in range(n):
        ro, rd = view_rays(cams[m], H, W, focal, norm, stride)
        pred = render_view(grid, cams[m], H, W, focal, cfg, norm, stride, chunk,
                           bg_sh=bg_sh, rays=(ro, rd), base_grid=base_grid, rgbnet=rgbnet)
        gt = images_rgb[m, ::stride, ::stride].astype(np.float32) / 255.0
        gt = gt[: pred.shape[0], : pred.shape[1]]
        per_view.append(psnr(pred, gt))
        half = pred.shape[1] // 2
        gains = fit_view_exposure(pred[:, :half], gt[:, :half])
        per_view_cal.append(psnr(np.clip(pred[:, half:] * gains, 0.0, 1.0), gt[:, half:]))
        renders.append(pred)
        # A ray is "core" if its forward half-line passes within the unit
        # ball: closest approach at t* = max(0, -o.d).
        t_star = np.maximum(0.0, -np.sum(ro * rd, axis=-1))
        closest = ro + t_star[:, None] * rd
        core = (np.linalg.norm(closest, axis=-1) < 1.0).reshape(pred.shape[:2])
        se = np.sum((pred - gt) ** 2, axis=-1) / 3.0
        core_err.append(float(se[core].sum()))
        bg_err.append(float(se[~core].sum()))
        core_n += int(core.sum())
        bg_n += int((~core).sum())

    def mse_to_psnr(s, c):
        return float(-10 * np.log10(max(s / c, 1e-12))) if c else float("nan")

    return {
        "per_view": per_view,
        "mean_psnr": float(np.mean(per_view)) if per_view else float("nan"),
        "per_view_calibrated": per_view_cal,
        "mean_psnr_calibrated": float(np.mean(per_view_cal)) if per_view_cal else float("nan"),
        "psnr_core": mse_to_psnr(sum(core_err), core_n),
        "psnr_background": mse_to_psnr(sum(bg_err), bg_n),
        "core_pixel_fraction": core_n / max(core_n + bg_n, 1),
        "renders": renders,
    }


def interpolate_poses(cams: np.ndarray, n_frames: int) -> np.ndarray:
    """Novel views along the registered trajectory: piecewise slerp of the
    rotations and lerp of the camera centres, at uniform arc length over
    the centre polyline. cams: (M, 6) [rvec, t] -> (n_frames, 6)."""
    cams = np.asarray(cams, np.float64)
    M = len(cams)
    if M == 1 or n_frames < 1:
        return np.repeat(cams[:1], max(n_frames, 1), axis=0)
    Rs = np.stack([lie.so3_exp_np(c[:3]) for c in cams])
    Cs = np.stack([-R.T @ c[3:6] for R, c in zip(Rs, cams)])
    seg = np.linalg.norm(np.diff(Cs, axis=0), axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    total = cum[-1] if cum[-1] > 0 else 1.0
    out = []
    k = 0
    for s in np.linspace(0.0, total, n_frames):
        while k < M - 2 and cum[k + 1] < s:
            k += 1
        a = float(np.clip((s - cum[k]) / max(cum[k + 1] - cum[k], 1e-12), 0.0, 1.0))
        w = lie.so3_log_np(Rs[k + 1] @ Rs[k].T)
        R = lie.so3_exp_np(a * w) @ Rs[k]
        c = (1.0 - a) * Cs[k] + a * Cs[k + 1]
        out.append(np.concatenate([lie.so3_log_np(R), -R @ c]))
    return np.stack(out)


def dataset_from_views(cams: np.ndarray, images_rgb: np.ndarray, focal: float,
                       view_idx: np.ndarray, norm: Optional[SceneNormalization] = None,
                       stride: int = 1) -> RayDataset:
    """RayDataset restricted to a view subset (the train split)."""
    return rays_from_cameras(cams[view_idx], images_rgb[view_idx], focal, norm, stride)
