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

import struct
from typing import Optional

import torch

from tpu3d_torch.kernels import LAUNCHES
from tpu3d_torch.kernels._build import check, function, stream

_F32, _I32 = torch.float32, torch.int32
_DTYPES = (_F32, _F32, _F32, _F32, _I32, _I32)     # gx, gy, ys, xs, lvl, dlvl
# csrc/patch_sample.cu's PatchSampleArgs: gx, gy, lvl, dlvl, ys, xs, out,
# stream; nch, L, H, W, K, S
_ARGS = struct.Struct("8Q6i")


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
    launches ``patch_sample_kernel``. The detector calls this with a few
    microseconds of device work, so the checks run in one pass over plain
    attributes and the C function and stream come without a lock or a
    Stream object."""
    if not gx.is_cuda:
        if gx.device.type == "cpu":
            return sample_gradient_patches_plain(gx, gy, ys, xs, lvl, dlvl)
        raise ValueError(f"sample_gradient_patches: unsupported device {gx.device}")
    dev = gx.get_device()
    g1 = gx if gy is None else gy
    dl = lvl if dlvl is None else dlvl
    K, S = ys.shape
    L, H, W = gx.shape
    if ((gx.dtype, g1.dtype, ys.dtype, xs.dtype, lvl.dtype, dl.dtype) != _DTYPES
            or not (gx.is_contiguous() and g1.is_contiguous() and ys.is_contiguous()
                    and xs.is_contiguous() and lvl.is_contiguous() and dl.is_contiguous())
            or not (dev == g1.get_device() == ys.get_device() == xs.get_device()
                    == lvl.get_device() == dl.get_device())):
        for name, t, dt in zip(("gx", "gy", "ys", "xs", "lvl", "dlvl"),
                               (gx, g1, ys, xs, lvl, dl), _DTYPES):
            if t.dtype is not dt or t.get_device() != dev or not t.is_contiguous():
                raise ValueError(f"sample_gradient_patches: {name} must be a "
                                 f"contiguous {dt} tensor on {gx.device}")
    if ((xs.shape, lvl.shape, dl.shape) != (ys.shape, (K,), (K,) if dlvl is None else (S,))
            or (gy is not None and gy.shape != gx.shape) or H < 2 or W < 2):
        raise ValueError("sample_gradient_patches: bad shapes "
                         f"gx {tuple(gx.shape)} gy {tuple(g1.shape)} ys {tuple(ys.shape)} "
                         f"xs {tuple(xs.shape)} lvl {tuple(lvl.shape)} dlvl "
                         f"{None if dlvl is None else tuple(dlvl.shape)} (dlvl must be (S,))")
    nch = 1 if gy is None else 2
    out = ys.new_empty((K, nch, S))
    err = function("tpu3d_patch_sample")(_ARGS.pack(
        gx.data_ptr(), g1.data_ptr(), lvl.data_ptr(), 0 if dlvl is None else dlvl.data_ptr(),
        ys.data_ptr(), xs.data_ptr(), out.data_ptr(), stream(dev),
        nch, L, H, W, K, S))
    check(err, "patch_sample_kernel")
    LAUNCHES["patch_sample_kernel"] += 1
    return out
