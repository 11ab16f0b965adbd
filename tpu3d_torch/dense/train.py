"""Host-side part of the dense stage's training module (tpu3d/dense/train.py):
ray datasets from registered cameras, the scene normalizations, the
scene-derived sampling band and PSNR. All numpy. The optimizer, the train
steps and ``train_plenoxel`` come with dense training."""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np

from tpu3d_torch.core import lie
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
