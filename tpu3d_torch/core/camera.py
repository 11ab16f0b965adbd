"""Pinhole camera model in the reference's centered coordinate convention
(tpu3d/core/camera.py): ``u = x - W/2, v = -(y - H/2)``, K = diag(f, f, 1)."""
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
