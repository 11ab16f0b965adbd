"""Rotation-invariant 128-D gradient-histogram (SIFT-style) descriptors
(tpu3d/features/descriptor.py).

Per keypoint: 11x11 orientation samples and a 36-bin histogram give the
dominant orientation θ; a θ-rotated 16x16 grid of gradient samples is
binned 4x4x8 and SIFT-normalized. On the split path (the default) the
samples come from ``sample_gradient_patches`` (``patch_sample_kernel`` on
the card); on the fused path (``fused_descriptor=True``) θ and the rotated
samples come from ``orient_desc_samples`` (``orient_desc_kernel``).
Histograms are one-hot products, not scatter-adds, so their sums are
deterministic on the card.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from tpu3d_torch.kernels.orient_desc import orient_desc_samples
from tpu3d_torch.kernels.patch_sample import sample_gradient_patches

GRID = 16          # descriptor sample grid (GRID x GRID)
CELLS = 4          # spatial cells per side
ORI_BINS = 8       # orientation bins per cell
HIST_BINS = 36     # orientation-assignment histogram


def gradients(levels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradients of (..., H, W) levels. The roll wraps
    around the border, as tpu3d's does (descriptor.py:29-33)."""
    gx = 0.5 * (torch.roll(levels, -1, -1) - torch.roll(levels, 1, -1))
    gy = 0.5 * (torch.roll(levels, -1, -2) - torch.roll(levels, 1, -2))
    return gx, gy


def _sample_gradients(gx, gy, lvl, ky, kx, dy, dx, ymax=None, xmax=None):
    """Gradient samples at kp + offsets (dy/dx: (K, N)); coordinates are
    clamped into [0, bound] per keypoint (its own octave's rectangle).
    Returns (gxs, gys), each (K, N)."""
    ys = ky[:, None] + dy
    xs = kx[:, None] + dx
    if ymax is not None:
        ys = torch.minimum(torch.clamp(ys, min=0.0), ymax[:, None])
    if xmax is not None:
        xs = torch.minimum(torch.clamp(xs, min=0.0), xmax[:, None])
    out = sample_gradient_patches(gx, gy, ys.contiguous(), xs.contiguous(),
                                  lvl.to(torch.int32).contiguous())
    return out[:, 0], out[:, 1]


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def keypoint_orientations(gx, gy, kx, ky, lvl, sigma, ymax=None, xmax=None):
    """Dominant gradient orientation per keypoint (radians): 11x11 samples
    at ~0.9 sigma spacing, a gaussian-weighted soft 36-bin histogram, two
    circular 3-tap smoothings, argmax + parabolic peak interpolation."""
    R = 5
    dev = kx.device
    offs = torch.arange(-R, R + 1, dtype=torch.float32, device=dev)
    dyg, dxg = torch.meshgrid(offs, offs, indexing="ij")
    dyg = dyg.reshape(-1)
    dxg = dxg.reshape(-1)
    spacing = 0.9 * sigma[:, None]
    gxs, gys = _sample_gradients(gx, gy, lvl, ky, kx, dyg[None, :] * spacing,
                                 dxg[None, :] * spacing, ymax, xmax)
    mag = torch.sqrt(gxs**2 + gys**2)
    wgt = torch.exp(-(dyg**2 + dxg**2)[None, :] / (2 * (1.5 * R / 3.0) ** 2))
    ang = torch.atan2(gys, gxs)
    binf = (ang / (2 * math.pi) + 0.5) * HIST_BINS
    b0 = torch.remainder(torch.floor(binf).to(torch.int64), HIST_BINS)
    frac = binf - torch.floor(binf)
    w = mag * wgt
    oh0 = _one_hot(b0, HIST_BINS, w.dtype)
    oh1 = _one_hot((b0 + 1) % HIST_BINS, HIST_BINS, w.dtype)
    hist = (torch.bmm((w * (1 - frac))[:, None, :], oh0)[:, 0]
            + torch.bmm((w * frac)[:, None, :], oh1)[:, 0])
    for _ in range(2):
        hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)) / 3.0
    peak = torch.argmax(hist, dim=-1)
    hp = torch.gather(hist, 1, peak[:, None])[:, 0]
    hl = torch.gather(hist, 1, ((peak - 1) % HIST_BINS)[:, None])[:, 0]
    hr = torch.gather(hist, 1, ((peak + 1) % HIST_BINS)[:, None])[:, 0]
    denom = hl - 2 * hp + hr
    safe = torch.where(denom.abs() > 1e-9, denom, torch.ones_like(denom))
    off = torch.where(denom.abs() > 1e-9, 0.5 * (hl - hr) / safe,
                      torch.zeros_like(denom))
    binp = peak.to(torch.float32) + torch.clamp(off, -0.5, 0.5)
    return (binp / HIST_BINS - 0.5) * 2 * math.pi


def sift_descriptors(gx, gy, kx, ky, lvl, sigma, theta, ymax=None, xmax=None):
    """(K, 128) descriptors from a gradient level stack."""
    dev = kx.device
    g = torch.arange(GRID, dtype=torch.float32, device=dev) - (GRID - 1) / 2.0
    dyg, dxg = torch.meshgrid(g, g, indexing="ij")
    dyg = dyg.reshape(-1)
    dxg = dxg.reshape(-1)
    spacing = 0.75 * sigma[:, None]
    ct = torch.cos(theta)[:, None]
    st = torch.sin(theta)[:, None]
    dx = (ct * dxg[None, :] - st * dyg[None, :]) * spacing
    dy = (st * dxg[None, :] + ct * dyg[None, :]) * spacing
    gxs, gys = _sample_gradients(gx, gy, lvl, ky, kx, dy, dx, ymax, xmax)
    return bin_descriptor(gxs, gys, theta, dyg, dxg)


def bin_descriptor(gxs, gys, theta, dyg, dxg) -> torch.Tensor:
    """4x4x8 gradient-histogram binning + SIFT normalization (L2, clip 0.2,
    L2) of (K, 256) rotated-grid gradient samples."""
    mag = torch.sqrt(gxs**2 + gys**2)
    wgt = torch.exp(-(dyg**2 + dxg**2)[None, :] / (2 * (GRID / 2.0) ** 2))
    w = mag * wgt
    ang = torch.atan2(gys, gxs) - theta[:, None]
    binf = (ang / (2 * math.pi)) * ORI_BINS
    b0 = torch.remainder(torch.floor(binf).to(torch.int64), ORI_BINS)
    frac = binf - torch.floor(binf)
    oh0 = _one_hot(b0, ORI_BINS, w.dtype)
    oh1 = _one_hot((b0 + 1) % ORI_BINS, ORI_BINS, w.dtype)
    contrib = oh0 * (w * (1 - frac))[..., None] + oh1 * (w * frac)[..., None]
    K = gxs.shape[0]
    cells = contrib.reshape(K, CELLS, GRID // CELLS, CELLS, GRID // CELLS, ORI_BINS)
    desc = cells.sum(dim=(2, 4)).reshape(K, CELLS * CELLS * ORI_BINS)
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-9)
    desc = torch.clamp(desc, max=0.2)
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-9)
    return desc


def orient_and_describe(gx, gy, kx, ky, lvl, sigma, ymax, xmax,
                        fused: Optional[bool] = None):
    """Dominant orientation + descriptor for a keypoint batch. fused=True
    takes θ and the rotated samples from one ``orient_desc_samples`` pass
    (tpu3d's descriptor.py:220-228), then bins them; otherwise the split
    path. Returns (desc, theta)."""
    if fused:
        gxs, gys, theta = orient_desc_samples(
            gx, gy, ky.contiguous(), kx.contiguous(), lvl.to(torch.int32).contiguous(),
            sigma.contiguous(), ymax.contiguous(), xmax.contiguous())
        g = torch.arange(GRID, dtype=torch.float32, device=kx.device) - (GRID - 1) / 2.0
        dyg, dxg = torch.meshgrid(g, g, indexing="ij")
        return bin_descriptor(gxs, gys, theta, dyg.reshape(-1), dxg.reshape(-1)), theta
    theta = keypoint_orientations(gx, gy, kx, ky, lvl, sigma, ymax, xmax)
    return sift_descriptors(gx, gy, kx, ky, lvl, sigma, theta, ymax, xmax), theta
