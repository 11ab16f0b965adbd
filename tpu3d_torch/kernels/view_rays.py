"""One camera view's rays on the device, from its pose.

dense/eval.py's render of a view without precomputed rays on a CUDA grid:
every ``stride``-th row and column of an H x W image, row-major, each
pixel's origin (the camera centre) and unit direction, the camera ray (u /
f, v / f, 1) times the rotation R, u = x - W/2 and v = -(y - H/2). The pose
(R, the normalized centre) is formed on the host by the caller. On a CUDA
device ``view_rays`` launches ``view_rays_kernel`` (csrc/view_rays.cu), one
thread a ray; on the CPU it runs the plain version, which repeats the
kernel's f32 operations in its order: numpy view_rays' operations, its
product with R rounded as the BLAS sgemm rounds it (a fused multiply-add
chain over R's rows in order), every other operation rounded on its own.
The quotients and the root are taken in f64 and rounded once to f32, which
gives the correctly rounded f32 result (f64 holds more than twice f32's
digits), as the kernel's __fdiv_rn and __fsqrt_rn do; torch's f32 sqrt on
a CPU with AVX-512 is not always so rounded. The kernel equals it bit for
bit, and both equal numpy view_rays wherever numpy's sgemm is that chain
(OpenBLAS on x86-64); the origins are numpy's.
"""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np
import torch

from tpu3d_torch.kernels import LAUNCHES
from tpu3d_torch.kernels._build import check, function, stream
from tpu3d_torch.utils.trace import launch_span

_ARGS = struct.Struct("3Q15f3i")
_F32 = torch.float32


def _pose(R: np.ndarray, o: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    R = np.asarray(R, np.float32)
    o = np.asarray(o, np.float32)
    if R.shape != (3, 3) or o.shape != (3,):
        raise ValueError(f"view_rays: R must be (3, 3) and o (3,), got {R.shape} and {o.shape}")
    return R, o


def _div(x: torch.Tensor, y) -> torch.Tensor:
    """x / y correctly rounded to f32 (by way of f64)."""
    return (x.double() / y.double() if isinstance(y, torch.Tensor) else x.double() / y).float()


def _fma(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """x y + z rounded once to f32, as the card's fmaf: the product exact in
    f64, the sum rounded to odd there (TwoSum's exact error moves an inexact
    sum with an even last bit to its odd neighbour), then to f32, which
    rounding to odd first makes the single correct rounding."""
    p = x.double() * y.double()
    z = z.double()
    s = p + z
    bz = s - p
    err = (p - (s - bz)) + (z - bz)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s).float()


def view_rays_plain(R: np.ndarray, o: np.ndarray, H: int, W: int, focal: float,
                    stride: int = 1, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version; see :func:`view_rays` for the arguments."""
    R, o = _pose(R, o)
    dev = torch.device(device)
    ys = torch.arange(0, H, stride, dtype=_F32, device=dev)
    xs = torch.arange(0, W, stride, dtype=_F32, device=dev)
    y, x = (t.reshape(-1) for t in torch.meshgrid(ys, xs, indexing="ij"))
    f = float(np.float32(focal))
    a, b = _div(x - W / 2.0, f), _div(-(y - H / 2.0), f)
    Rt = torch.from_numpy(R).to(dev)
    d = _fma(b[:, None], Rt[1], a[:, None] * Rt[0]) + Rt[2]
    norm = torch.sqrt(((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]).double())
    origins = torch.from_numpy(o).to(dev).expand(d.shape).contiguous()
    return origins, _div(d, norm.float()[:, None])


def view_rays(R: np.ndarray, o: np.ndarray, H: int, W: int, focal: float, stride: int = 1,
              device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """(origins, dirs), (P, 3) f32 each on ``device``, P = ceil(H / stride)
    x ceil(W / stride) rays in row-major pixel order, from the view's
    rotation ``R`` (3, 3) and normalized centre ``o`` (3,). On the CPU
    :func:`view_rays_plain`; on a CUDA device one launch of
    ``view_rays_kernel`` on the current stream, nothing uploaded (the pose
    goes in the launch's arguments)."""
    R, o = _pose(R, o)
    dev = torch.device(device)
    if H < 1 or W < 1 or stride < 1:
        raise ValueError(f"view_rays: H, W and stride must be positive, got {H}, {W}, {stride}")
    if dev.type == "cpu":
        return view_rays_plain(R, o, H, W, focal, stride, dev)
    if dev.type != "cuda":
        raise ValueError(f"view_rays: unsupported device {dev}")
    h, w = len(range(0, H, stride)), len(range(0, W, stride))
    if h * w >= 2 ** 31:
        raise ValueError(f"view_rays: {h} x {w} rays exceed the kernel's int32 ray index")
    origins = torch.empty((h * w, 3), dtype=_F32, device=dev)
    dirs = torch.empty((h * w, 3), dtype=_F32, device=dev)
    with launch_span("kernels.view_rays"):
        err = function("tpu3d_view_rays")(_ARGS.pack(
            origins.data_ptr(), dirs.data_ptr(), stream(origins.get_device()),
            *R.reshape(-1).tolist(), *o.tolist(), float(np.float32(focal)), W / 2.0, H / 2.0,
            stride, w, h * w))
    check(err, "view_rays_kernel")
    LAUNCHES["view_rays_kernel"] += 1
    return origins, dirs
