"""Gaussian scale-space pyramid (tpu3d/features/pyramid.py).

Blurs are separable shifted adds with Python-scalar taps, as in tpu3d: the
same taps in the same order, so the levels agree with tpu3d's to f32
rounding. No cuDNN convolution is involved.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel1d(sigma: float, radius: int | None = None,
                      device="cpu") -> torch.Tensor:
    if radius is None:
        radius = max(1, int(math.ceil(3.0 * sigma)))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _host_kernel1d(sigma: float) -> list:
    radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return list((k / k.sum()).astype(float))


def blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (B, H, W) images (reflect padding)."""
    w = _host_kernel1d(sigma)
    r = (len(w) - 1) // 2
    B, H, W = img.shape
    xp = F.pad(img, (0, 0, r, r), mode="reflect")
    x = sum(wi * xp[:, i: i + H, :] for i, wi in enumerate(w))
    xp = F.pad(x, (r, r, 0, 0), mode="reflect")
    return sum(wi * xp[:, :, i: i + W] for i, wi in enumerate(w))


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x nearest downsample of (B, H, W)."""
    return img[:, ::2, ::2]


def build_pyramid(
    images: torch.Tensor,
    num_octaves: int = 4,
    scales_per_octave: int = 3,
    sigma0: float = 1.6,
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Gaussian + DoG pyramids of (B, H, W) float32 images in [0, 1].
    Per octave, gauss is (B, S+3, Ho, Wo) and dogs is (B, S+2, Ho, Wo)."""
    S = scales_per_octave
    k = 2.0 ** (1.0 / S)
    base = blur(images, math.sqrt(max(sigma0**2 - 0.5**2, 0.01)))
    gauss_oct, dog_oct = [], []
    current = base
    for _o in range(num_octaves):
        levels = [current]
        sigma_prev = sigma0
        for s in range(1, S + 3):
            sigma_total = sigma0 * (k**s)
            sigma_inc = math.sqrt(max(sigma_total**2 - sigma_prev**2, 1e-4))
            levels.append(blur(levels[-1], sigma_inc))
            sigma_prev = sigma_total
        g = torch.stack(levels, dim=1)
        gauss_oct.append(g)
        dog_oct.append(g[:, 1:] - g[:, :-1])
        current = downsample2(levels[S]).contiguous()
    return gauss_oct, dog_oct
