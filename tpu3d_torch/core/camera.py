"""Pinhole camera model in the reference's centered coordinate convention
(tpu3d/core/camera.py): ``u = x - W/2, v = -(y - H/2)``, K = diag(f, f, 1).
Every 2D coordinate of geometry, sfm and ba is centered."""
from __future__ import annotations

import torch


def pixel_to_centered(xy: torch.Tensor, image_size: torch.Tensor) -> torch.Tensor:
    """(x, y) pixel -> centered y-up coords. image_size = (W, H)."""
    w = image_size[..., 0]
    h = image_size[..., 1]
    return torch.stack([xy[..., 0] - w / 2.0, -(xy[..., 1] - h / 2.0)], dim=-1)


def centered_to_pixel(uv: torch.Tensor, image_size: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pixel_to_centered`."""
    w = image_size[..., 0]
    h = image_size[..., 1]
    return torch.stack([uv[..., 0] + w / 2.0, -uv[..., 1] + h / 2.0], dim=-1)


def intrinsics_matrix(focal, dtype=torch.float32, device=None) -> torch.Tensor:
    """K = diag(f, f, 1)."""
    K = torch.eye(3, dtype=dtype, device=device)
    K[0, 0] = focal
    K[1, 1] = focal
    return K


def _safe_z(z: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.where(z.abs() < eps, torch.where(z < 0, -eps, eps), z)


def project_extrinsic(X: torch.Tensor, R: torch.Tensor, t: torch.Tensor, focal) -> torch.Tensor:
    """World points (..., N, 3) through [R|t] into centered coords (..., N, 2)."""
    Xc = torch.einsum("...ij,...nj->...ni", R, X) + t[..., None, :]
    return focal * Xc[..., :2] / _safe_z(Xc[..., 2:3], 1e-9)


def project(X: torch.Tensor, focal) -> torch.Tensor:
    """Camera-frame points (..., N, 3) -> centered 2D."""
    return focal * X[..., :2] / _safe_z(X[..., 2:3], 1e-9)


def camera_center(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """World-space camera center C = -Rᵀ t of a world->cam [R|t]."""
    return -torch.einsum("...ji,...j->...i", R, t)


def camera_rays(R: torch.Tensor, t: torch.Tensor, uv: torch.Tensor, focal):
    """World-space rays through centered image coords ``uv`` (..., N, 2):
    (origins (..., 3), unit directions (..., N, 3)); the pixel direction
    (u / f, v / f, 1) rotated to the world by Rᵀ."""
    d_cam = torch.cat([uv / focal, torch.ones_like(uv[..., :1])], dim=-1)
    d_world = torch.einsum("...ji,...nj->...ni", R, d_cam)
    d_world = d_world / torch.linalg.vector_norm(d_world, dim=-1, keepdim=True)
    return camera_center(R, t), d_world
