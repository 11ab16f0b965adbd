"""Trilinear samples of a voxel grid at world points.

Counterpart of tpu3d/kernels/trilinear.py::sample_packed (and of the gather
it replaces, tpu3d/dense/grid.py::trilinear_sample). On a CUDA tensor the
wrapper launches ``trilinear_kernel`` (csrc/trilinear.cu); on a CPU tensor it
runs the plain version. Both compute tpu3d's ``_corner_setup`` and ``_lerp8``
in the same order with the same roundings, so they agree bit for bit:

    u = (p - min) / (max - min)      in_bounds = all(0 <= u <= 1)
    v = u * (res - 1)                i0 = clip(floor(v), 0, res - 2)
    f = v - i0                       lerp z, then y, then x; zero if out

The grid keeps tpu3d's channels-last (X, Y, Z, C) layout, C <= 32 (28 for a
dense grid: density + 27 SH); see csrc/trilinear.cu for why it is not
padded to 32 channels.
"""
from __future__ import annotations

import struct
from typing import Tuple

import torch

from tpu3d_torch.kernels import LAUNCHES
from tpu3d_torch.kernels._build import check, function, stream

MAX_CHANNELS = 32
_F32 = torch.float32
_INT32_MAX = 2 ** 31 - 1
# csrc/trilinear.cu's TrilinearArgs: grid, min_bound, max_bound, pts, out,
# in_bounds, stream; N; X, Y, Z, C, vec, idx32
_ARGS = struct.Struct("7Qq6i")


def _corner_setup(res, min_bound, max_bound, pts):
    """(i0 (N, 3) int64, frac (N, 3), in_bounds (N,)) as tpu3d's
    dense/grid.py::_corner_setup."""
    resf = torch.tensor(res, dtype=pts.dtype, device=pts.device)
    u = (pts - min_bound) / (max_bound - min_bound)
    in_bounds = ((u >= 0.0) & (u <= 1.0)).all(dim=-1)
    v = u * (resf - 1.0)
    # Clipped in float before the integer cast: the same index for every
    # finite v, and no overflow for points far outside the box.
    i0 = torch.minimum(torch.floor(v).clamp(min=0.0), resf - 2.0)
    frac = v - i0
    return i0.long(), frac, in_bounds


def _lerp8(c, fx, fy, fz):
    """c: 8 corner values in zyx bit order (c000..c111), as tpu3d's _lerp8."""
    c000, c001, c010, c011, c100, c101, c110, c111 = c
    c00 = c000 * (1 - fz) + c001 * fz
    c01 = c010 * (1 - fz) + c011 * fz
    c10 = c100 * (1 - fz) + c101 * fz
    c11 = c110 * (1 - fz) + c111 * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx


def trilinear_sample_plain(grid: torch.Tensor, min_bound: torch.Tensor,
                           max_bound: torch.Tensor, pts: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version. grid: (X, Y, Z, C) f32; min_bound, max_bound: (3,);
    pts: (N, 3) world points. Returns (values (N, C), in_bounds (N,) bool),
    align-corners, with out-of-box samples zeroed. The 8 corners come from
    one row gather on the (X*Y*Z, C) view, as tpu3d's gather path."""
    X, Y, Z, C = grid.shape
    i0, frac, in_bounds = _corner_setup((X, Y, Z), min_bound, max_bound, pts)
    fx, fy, fz = frac[:, 0:1], frac[:, 1:2], frac[:, 2:3]
    base = (i0[:, 0] * Y + i0[:, 1]) * Z + i0[:, 2]
    offs = torch.tensor([0, 1, Z, Z + 1, Y * Z, Y * Z + 1, Y * Z + Z, Y * Z + Z + 1],
                        dtype=torch.int64, device=pts.device)
    vals = grid.reshape(X * Y * Z, C)[(base[:, None] + offs[None, :]).reshape(-1)]
    vals = vals.reshape(-1, 8, C)
    out = _lerp8(tuple(vals[:, k] for k in range(8)), fx, fy, fz)
    return out * in_bounds[:, None], in_bounds


def index32(grid_numel: int, out_numel: int) -> bool:
    """Whether ``trilinear_kernel``'s grid (X*Y*Z*C) and output (N*C)
    offsets fit in an int32, so that it computes them in 32 bits."""
    return grid_numel <= _INT32_MAX and out_numel <= _INT32_MAX


def vector_width(C: int, *ptrs: int) -> int:
    """Channels per load of ``trilinear_kernel``: 4 (float4 loads and
    stores) when C is a multiple of 4 and every pointer is 16-byte aligned,
    so that every corner row and output row starts on a 16-byte boundary;
    else 1 (csrc/trilinear.cu)."""
    return 4 if C % 4 == 0 and all(p % 16 == 0 for p in ptrs) else 1


def trilinear_sample(grid: torch.Tensor, min_bound: torch.Tensor,
                     max_bound: torch.Tensor, pts: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values (N, C), in_bounds (N,)); see :func:`trilinear_sample_plain`
    for the arguments. A CPU tensor takes the plain version; a CUDA tensor
    launches ``trilinear_kernel``."""
    if not grid.is_cuda:
        if grid.device.type == "cpu":
            return trilinear_sample_plain(grid, min_bound, max_bound, pts)
        raise ValueError(f"trilinear_sample: unsupported device {grid.device}")
    if (grid.dim() != 4 or grid.dtype is not _F32 or not grid.is_contiguous()
            or min(grid.shape[:3]) < 2 or not 1 <= grid.shape[3] <= MAX_CHANNELS):
        raise ValueError("trilinear_sample: grid must be a contiguous f32 "
                         f"(X, Y, Z, C<={MAX_CHANNELS}) tensor with X, Y, Z >= 2, "
                         f"got {tuple(grid.shape)} {grid.dtype}")
    dev = grid.get_device()
    N = pts.shape[0]
    for name, t, shape in (("min_bound", min_bound, (3,)), ("max_bound", max_bound, (3,)),
                           ("pts", pts, (N, 3))):
        if (t.get_device() != dev or t.dtype is not _F32 or not t.is_contiguous()
                or t.shape != shape):
            raise ValueError(f"trilinear_sample: {name} must be a contiguous f32 "
                             f"{shape} tensor on {grid.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    X, Y, Z, C = grid.shape
    out = pts.new_empty((N, C))
    in_bounds = torch.empty((N,), dtype=torch.bool, device=grid.device)
    err = function("tpu3d_trilinear")(_ARGS.pack(
        grid.data_ptr(), min_bound.data_ptr(), max_bound.data_ptr(), pts.data_ptr(),
        out.data_ptr(), in_bounds.data_ptr(), stream(dev), N, X, Y, Z, C,
        vector_width(C, grid.data_ptr(), out.data_ptr()) == 4, index32(X * Y * Z * C, N * C)))
    check(err, "trilinear_kernel")
    LAUNCHES["trilinear_kernel"] += 1
    return out, in_bounds
