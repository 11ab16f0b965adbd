"""Fused orientation + descriptor sampling, one pass per keypoint.

Counterpart of tpu3d/kernels/orient_desc.py::orient_desc_samples. Per
keypoint: 11x11 gradient samples at 0.9 sigma, a gaussian-weighted 36-bin
soft histogram of their angles (``atan2_poly``), the [1,2,3,2,1]/9
circulant smoothing, the first maximum and its parabolic peak give theta;
then the theta-rotated 16x16 grid of gradient samples at 0.75 sigma. All
coordinates are clamped to the keypoint's octave rectangle, and samples
follow tpu3d's gather semantics (features/descriptor.py::_bilinear); the
Pallas kernel's 96x256 VMEM window has no counterpart. On a CUDA tensor the
wrapper launches ``orient_desc_kernel`` (csrc/orient_desc.cu); on a CPU
tensor it runs the plain version.
"""
from __future__ import annotations

import math
import struct
from typing import Dict, Tuple

import numpy as np
import torch

from tpu3d_torch.kernels import LAUNCHES
from tpu3d_torch.kernels._build import check, function, stream
from tpu3d_torch.kernels.patch_sample import sample_gradient_patches_plain

ORI_N = 121       # 11x11 orientation samples
DESC_N = 256      # 16x16 descriptor samples
HIST = 36         # orientation histogram bins
_NAMES = ("gx", "gy", "ky", "kx", "lvl", "sigma", "ymax", "xmax")
_DTYPES = (torch.float32,) * 4 + (torch.int32,) + (torch.float32,) * 3
# csrc/orient_desc.cu's OrientDescArgs: gx, gy, ky, kx, lvl, sigma, ymax,
# xmax, table, gxs, gys, theta, stream; L, H, W, K
_ARGS = struct.Struct("13Q4i")


def _ori_grid() -> np.ndarray:
    """(3, 121) float32 rows (dy, dx, gaussian weight) of the 11x11
    orientation grid, built in numpy float32 as tpu3d's ``_ori_grid``."""
    i = np.arange(ORI_N)
    dy = (i // 11 - 5).astype(np.float32)
    dx = (i % 11 - 5).astype(np.float32)
    wgt = np.exp(-(dy**2 + dx**2) / (2 * (1.5 * 5 / 3.0) ** 2)).astype(np.float32)
    return np.stack([dy, dx, wgt])


_ORI_TABLE = _ori_grid()
_TABLES: Dict[torch.device, torch.Tensor] = {}


def _table(device: torch.device) -> torch.Tensor:
    if device not in _TABLES:
        _TABLES[device] = torch.from_numpy(_ORI_TABLE).to(device).contiguous()
    return _TABLES[device]


def atan2_poly(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """tpu3d's degree-9 odd minimax atan2 (|err| < 1e-5 rad), operation for
    operation (tpu3d/kernels/orient_desc.py::_atan2_poly)."""
    ax = x.abs()
    ay = y.abs()
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    z = lo / torch.clamp(hi, min=1e-30)
    z2 = z * z
    a = z * (0.9998660 + z2 * (-0.3302995 + z2 * (0.1801410
             + z2 * (-0.0851330 + z2 * 0.0208351))))
    a = torch.where(ay > ax, math.pi / 2 - a, a)
    a = torch.where(x < 0, math.pi - a, a)
    return torch.where(y < 0, -a, a)


def _clamp(v, hi):
    return torch.minimum(torch.clamp(v, min=0.0), hi[:, None])


def orientation_coords(ky, kx, sigma, ymax, xmax):
    """(ys, xs), each (K, 121): the 11x11 grid at 0.9 sigma, clamped to the
    octave rectangle [0, ymax] x [0, xmax]."""
    tab = _table(ky.device)
    sp = 0.9 * sigma[:, None]
    return (_clamp(ky[:, None] + tab[0][None, :] * sp, ymax),
            _clamp(kx[:, None] + tab[1][None, :] * sp, xmax))


def descriptor_coords(ky, kx, sigma, theta, ymax, xmax):
    """(ys, xs), each (K, 256): the 16x16 grid at 0.75 sigma rotated by
    theta, clamped to the octave rectangle."""
    lane = torch.arange(DESC_N, device=ky.device)
    dyd = (lane // 16).to(torch.float32) - 7.5
    dxd = (lane % 16).to(torch.float32) - 7.5
    spacing = (0.75 * sigma)[:, None]
    ct = torch.cos(theta)[:, None]
    st = torch.sin(theta)[:, None]
    dx = (ct * dxd - st * dyd) * spacing
    dy = (st * dxd + ct * dyd) * spacing
    return _clamp(ky[:, None] + dy, ymax), _clamp(kx[:, None] + dx, xmax)


def _orientation(gx, gy, ky, kx, lvl, sigma, ymax, xmax):
    """theta (K,) and the smoothed histogram (K, 36) of the plain version."""
    K = ky.shape[0]
    s = sample_gradient_patches_plain(gx, gy, *orientation_coords(ky, kx, sigma, ymax, xmax),
                                      lvl.to(torch.int32))
    sx, sy = s[:, 0], s[:, 1]
    mag = torch.sqrt(sx * sx + sy * sy) * _table(ky.device)[2]
    # Divisions by a tensor: PyTorch's CUDA division by a Python number
    # multiplies by its reciprocal, which rounds differently from the
    # kernel's (and tpu3d's) true division.
    ang = atan2_poly(sy, sx)
    binf = (ang / torch.full_like(ang, 2 * math.pi) + 0.5) * HIST
    fl = torch.floor(binf)
    b0 = torch.remainder(fl.to(torch.int64), HIST)
    frac = binf - fl
    w0 = mag * (1.0 - frac)
    w1 = mag * frac
    # Soft histogram, summed over the samples in ascending order (the
    # kernel's fixed order): bin j gets the w0 votes of b0 == j, plus the
    # w1 votes of b0 == j - 1.
    bins = torch.arange(HIST, device=ky.device)
    h0 = torch.zeros((K, HIST), dtype=torch.float32, device=ky.device)
    h1 = torch.zeros_like(h0)
    for i in range(ORI_N):
        at = b0[:, i: i + 1] == bins
        h0 = h0 + torch.where(at, w0[:, i: i + 1], 0.0)
        h1 = h1 + torch.where(torch.roll(at, 1, dims=1), w1[:, i: i + 1], 0.0)
    hist = h0 + h1
    # the [1,2,3,2,1]/9 circulant, left to right from bin j - 2
    sm = (1.0 / 9.0 * torch.roll(hist, 2, 1) + 2.0 / 9.0 * torch.roll(hist, 1, 1)
          + 3.0 / 9.0 * hist + 2.0 / 9.0 * torch.roll(hist, -1, 1)
          + 1.0 / 9.0 * torch.roll(hist, -2, 1))
    # the first maximum (argmax returns the first of equal values)
    peak = torch.argmax(sm, dim=1)
    hp = torch.gather(sm, 1, peak[:, None])[:, 0]
    hl = torch.gather(sm, 1, ((peak - 1) % HIST)[:, None])[:, 0]
    hr = torch.gather(sm, 1, ((peak + 1) % HIST)[:, None])[:, 0]
    denom = hl - 2.0 * hp + hr
    big = denom.abs() > 1e-9
    off = torch.where(big, 0.5 * (hl - hr) / torch.where(big, denom, 1.0), 0.0)
    binp = peak.to(torch.float32) + torch.clamp(off, -0.5, 0.5)
    return (binp / torch.full_like(binp, HIST) - 0.5) * 2.0 * math.pi, sm


def orient_desc_samples_plain(gx, gy, ky, kx, lvl, sigma, ymax, xmax
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version. gx, gy: (L, H, W) f32 level stacks; ky, kx,
    sigma, ymax, xmax: (K,) f32; lvl: (K,) int32 level per keypoint.
    Returns (gxs, gys): (K, 256) rotated-grid samples, and theta (K,)."""
    theta, _ = _orientation(gx, gy, ky, kx, lvl, sigma, ymax, xmax)
    d = sample_gradient_patches_plain(gx, gy, *descriptor_coords(ky, kx, sigma, theta, ymax, xmax),
                                      lvl.to(torch.int32))
    return d[:, 0], d[:, 1], theta


def orient_desc_samples(gx, gy, ky, kx, lvl, sigma, ymax, xmax
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(gxs, gys, theta); see :func:`orient_desc_samples_plain` for the
    arguments. A CPU tensor takes the plain version; a CUDA tensor
    launches ``orient_desc_kernel``. The checks run in one pass over plain
    attributes, and the arguments cross ctypes as one packed block."""
    if not gx.is_cuda:
        if gx.device.type == "cpu":
            return orient_desc_samples_plain(gx, gy, ky, kx, lvl, sigma, ymax, xmax)
        raise ValueError(f"orient_desc_samples: unsupported device {gx.device}")
    dev = gx.get_device()
    L, H, W = gx.shape
    K = ky.shape[0]
    if gy.shape != gx.shape or H < 2 or W < 2:
        raise ValueError(f"orient_desc_samples: bad gradient shapes {tuple(gx.shape)}, "
                         f"{tuple(gy.shape)}")
    args = (gx, gy, ky, kx, lvl, sigma, ymax, xmax)
    if (tuple(t.dtype for t in args) != _DTYPES
            or not all(t.is_contiguous() and t.get_device() == dev for t in args)
            or (ky.shape, kx.shape, lvl.shape, sigma.shape, ymax.shape, xmax.shape)
            != ((K,),) * 6):
        for name, t, dt in zip(_NAMES, args, _DTYPES):
            if t.get_device() != dev or t.dtype != dt or not t.is_contiguous():
                raise ValueError(f"orient_desc_samples: {name} must be a contiguous {dt} "
                                 f"tensor on {gx.device}")
            if name not in ("gx", "gy") and t.shape != (K,):
                raise ValueError(f"orient_desc_samples: {name} must be ({K},), "
                                 f"got {tuple(t.shape)}")
    gxs = gx.new_empty((K, DESC_N))
    gys = gx.new_empty((K, DESC_N))
    theta = gx.new_empty((K,))
    err = function("tpu3d_orient_desc")(_ARGS.pack(
        gx.data_ptr(), gy.data_ptr(), ky.data_ptr(), kx.data_ptr(), lvl.data_ptr(),
        sigma.data_ptr(), ymax.data_ptr(), xmax.data_ptr(), _table(gx.device).data_ptr(),
        gxs.data_ptr(), gys.data_ptr(), theta.data_ptr(), stream(dev), L, H, W, K))
    check(err, "orient_desc_kernel")
    LAUNCHES["orient_desc_kernel"] += 1
    return gxs, gys, theta


def sample_tolerance(gx, gy, sigma, dtheta, rel: float = 1e-5) -> torch.Tensor:
    """(K, 1) bound on |kernel - plain| (or |port - tpu3d|) of a keypoint's
    rotated samples when the two thetas differ by ``dtheta``: ``rel`` x
    max|g| for rounding, plus the most a sample can move: a bilinear
    sample's slope is at most 2 max|g| per px on each axis, and a theta
    change moves a sample at radius r (at most 7.5 sqrt(2) x 0.75 sigma
    px) by r dtheta px."""
    scale = torch.maximum(gx.abs().max(), gy.abs().max())
    radius = 7.5 * math.sqrt(2.0) * 0.75 * sigma
    return (scale * (rel + 2.0 * math.sqrt(2.0) * radius * dtheta))[:, None]


def near_ties(gx, gy, ky, kx, lvl, sigma, ymax, xmax, rel: float = 1e-5) -> torch.Tensor:
    """(K,) bool: keypoints whose two largest smoothed histogram bins (of
    the plain version) lie within ``rel`` of each other, relative to the
    larger, where a rounding difference may pick the other peak."""
    top = torch.topk(_orientation(gx, gy, ky, kx, lvl, sigma, ymax, xmax)[1], 2, dim=1).values
    return top[:, 0] - top[:, 1] <= rel * top[:, 0]
