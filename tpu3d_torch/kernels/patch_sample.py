"""Bilinear samples of a level stack at per-keypoint coordinate grids.

Counterpart of tpu3d/kernels/patch_sample.py::sample_gradient_patches. On a
CUDA tensor the wrapper launches ``patch_sample_kernel``
(csrc/patch_sample.cu); on a CPU tensor it runs the plain version. Both
compute tpu3d's gather path (features/descriptor.py::_bilinear): the base
cell is clipped to [0, H-2] x [0, W-2] and the fraction comes from the
unclipped coordinate. Exact f32 always: tpu3d's MXU precision modes have no
counterpart here.
"""
from __future__ import annotations

from typing import Optional

import torch

from tpu3d_torch.kernels import LAUNCHES
from tpu3d_torch.kernels._build import check, library


def _channels(gx, gy):
    return [gx] if gy is None else [gx, gy]


def sample_gradient_patches_plain(
    gx: torch.Tensor,
    gy: Optional[torch.Tensor],
    ys: torch.Tensor,
    xs: torch.Tensor,
    lvl: torch.Tensor,
    dlvl: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version. gx, gy: (L, H, W) f32 (gy may be None for one
    channel); ys, xs: (K, S) f32; lvl: (K,) int32 per-keypoint level;
    dlvl: optional (S,) int32 per-sample level offset. Returns (K, C, S)."""
    L, H, W = gx.shape
    l = lvl.long()[:, None]
    if dlvl is not None:
        l = l + dlvl.long()[None, :]
    l = l.clamp(0, L - 1).expand(ys.shape)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = ys - y0
    wx = xs - x0
    y0i = y0.long().clamp(0, H - 2)
    x0i = x0.long().clamp(0, W - 2)
    out = []
    for img in _channels(gx, gy):
        v00 = img[l, y0i, x0i]
        v01 = img[l, y0i, x0i + 1]
        v10 = img[l, y0i + 1, x0i]
        v11 = img[l, y0i + 1, x0i + 1]
        out.append(v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
                   + v10 * wy * (1 - wx) + v11 * wy * wx)
    return torch.stack(out, dim=1)


def sample_gradient_patches(
    gx: torch.Tensor,
    gy: Optional[torch.Tensor],
    ys: torch.Tensor,
    xs: torch.Tensor,
    lvl: torch.Tensor,
    dlvl: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(K, C, S) bilinear samples; see :func:`sample_gradient_patches_plain`
    for the arguments. A CPU tensor takes the plain version; a CUDA tensor
    launches ``patch_sample_kernel``."""
    if gx.device.type == "cpu":
        return sample_gradient_patches_plain(gx, gy, ys, xs, lvl, dlvl)
    if gx.device.type != "cuda":
        raise ValueError(f"sample_gradient_patches: unsupported device {gx.device}")
    chans = _channels(gx, gy)
    K, S = ys.shape
    L, H, W = gx.shape
    for name, t, dt in (("gx", gx, torch.float32), ("ys", ys, torch.float32),
                        ("xs", xs, torch.float32), ("lvl", lvl, torch.int32)):
        if t.device != gx.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"sample_gradient_patches: {name} must be a "
                             f"contiguous {dt} tensor on {gx.device}")
    if gy is not None and (gy.shape != gx.shape or gy.dtype != torch.float32
                           or gy.device != gx.device or not gy.is_contiguous()):
        raise ValueError("sample_gradient_patches: gy must match gx")
    if xs.shape != (K, S) or lvl.shape != (K,) or H < 2 or W < 2:
        raise ValueError("sample_gradient_patches: bad shapes "
                         f"gx {tuple(gx.shape)} ys {tuple(ys.shape)} "
                         f"xs {tuple(xs.shape)} lvl {tuple(lvl.shape)}")
    if dlvl is not None and (dlvl.shape != (S,) or dlvl.dtype != torch.int32
                             or dlvl.device != gx.device
                             or not dlvl.is_contiguous()):
        raise ValueError("sample_gradient_patches: dlvl must be (S,) int32 "
                         "on the same device")
    out = torch.empty((K, len(chans), S), dtype=torch.float32, device=gx.device)
    err = library().tpu3d_patch_sample(
        gx.data_ptr(), chans[-1].data_ptr(), len(chans), lvl.data_ptr(),
        None if dlvl is None else dlvl.data_ptr(), ys.data_ptr(),
        xs.data_ptr(), out.data_ptr(), L, H, W, K, S,
        torch.cuda.current_stream(gx.device).cuda_stream)
    check(err, "patch_sample_kernel")
    LAUNCHES["patch_sample_kernel"] += 1
    return out
