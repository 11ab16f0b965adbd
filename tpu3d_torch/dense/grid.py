"""Dense voxel radiance grid (tpu3d/dense/grid.py): a channels-last
(X, Y, Z, 28) grid of 1 density + 27 SH channels, queried by trilinear
interpolation, plus the carry-over of tpu3d's saved grids.

``trilinear_sample`` here is the plain version (the definition); the render
path samples through ``tpu3d_torch.kernels.trilinear.trilinear_sample``,
which launches the CUDA kernel on the card.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tpu3d_torch.kernels import trilinear as _tri
from tpu3d_torch.kernels.trilinear import trilinear_sample_plain as trilinear_sample

__all__ = ["VoxelGrid", "create_grid", "resample_grid", "trilinear_sample", "eval_sh", "query",
           "grid_from_tpu3d", "grid_from_mesh_grid", "grid_tensor", "unpack_grid"]

CHANNELS = 28          # 1 density + 3 colours x 9 SH coefficients
# tpu3d's packed layout (tpu3d/kernels/trilinear.py:40-65): rows of 8
# z-cells x 32 channels folded into (2, 128), one padding row.
ZROW, CPAD = 8, 32


class VoxelGrid(NamedTuple):
    grid: torch.Tensor        # (X, Y, Z, C), C = 1 + 27
    min_bound: torch.Tensor   # (3,)
    max_bound: torch.Tensor   # (3,)

    @property
    def resolution(self) -> Tuple[int, int, int]:
        return tuple(self.grid.shape[:3])


def create_grid(resolution, min_bound, max_bound, channels: int = CHANNELS,
                init: float = 0.01, device="cpu") -> VoxelGrid:
    """Uniform init 1/100 like the reference (plenoxel.py:27)."""
    if isinstance(resolution, int):
        resolution = (resolution, resolution, resolution)
    g = torch.full((*resolution, channels), init, dtype=torch.float32, device=device)
    return VoxelGrid(g, torch.as_tensor(min_bound, dtype=torch.float32, device=device),
                     torch.as_tensor(max_bound, dtype=torch.float32, device=device))


def resample_grid(g: torch.Tensor, new_res) -> torch.Tensor:
    """Align-corners trilinear resample of an (X, Y, Z, C) grid to
    ``new_res``, one axis at a time (tpu3d/dense/grid.py:47-72): node i of
    the new axis lands at i * (old - 1) / (new - 1) of the old one, so an
    upsampled grid keeps every value the sampler read at the old nodes."""
    for axis, n_new in enumerate(int(n) for n in new_res):
        n_old = g.shape[axis]
        if n_new == n_old:
            continue
        # jnp.linspace(0, n_old - 1, n_new) as XLA evaluates it: i times
        # (n_old - 1) times the f32 reciprocal of n_new - 1, the last exact
        step = np.float32(n_old - 1) * (np.float32(1.0) / np.float32(n_new - 1))
        pos = torch.arange(n_new, dtype=torch.float32, device=g.device) * float(step)
        pos[-1] = n_old - 1.0
        i0 = torch.floor(pos).long().clamp(0, n_old - 2)
        shape = [1] * g.dim()
        shape[axis] = n_new
        f = (pos - i0).reshape(shape)
        # a0 (1 - f) + a1 f, each product rounded as tpu3d's, in place
        a1 = torch.index_select(g, axis, i0 + 1).mul_(f)
        g = torch.index_select(g, axis, i0).mul_(1.0 - f).add_(a1)
        del a1
    return g


# Real SH degree-2 constants (google/spherical-harmonics; ref plenoxel.py:13-16).
_C0 = 0.282095
_C1 = 0.488603
_C2 = (1.092548, 1.092548, 0.315392, 1.092548, 0.546274)


def eval_sh(k: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Degree-2 real spherical harmonics. k: (..., 3, 9) per-colour
    coefficients, d: (..., 3) unit directions -> (..., 3) colours, in
    tpu3d's term order and signs."""
    x, y, z = d[..., 0:1], d[..., 1:2], d[..., 2:3]
    return (
        _C0 * k[..., 0]
        - _C1 * y * k[..., 1]
        + _C1 * z * k[..., 2]
        - _C1 * x * k[..., 3]
        + _C2[0] * x * y * k[..., 4]
        - _C2[1] * y * z * k[..., 5]
        + _C2[2] * (2.0 * z * z - x * x - y * y) * k[..., 6]
        - _C2[3] * x * z * k[..., 7]
        + _C2[4] * (x * x - y * y) * k[..., 8]
    )


def query(vg: VoxelGrid, pts: torch.Tensor, dirs: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sigma (N,), rgb (N, 3)) at world points with view directions;
    density = relu(channel 0). Samples through the kernel wrapper."""
    vals, in_bounds = _tri.trilinear_sample(vg.grid, vg.min_bound, vg.max_bound, pts)
    sigma = torch.relu(vals[:, 0]) * in_bounds
    k = vals[:, 1:].reshape(*vals.shape[:-1], 3, 9)
    rgb = eval_sh(k, dirs) * in_bounds[:, None]
    return sigma, rgb


def unpack_grid(packed: np.ndarray, shape) -> np.ndarray:
    """tpu3d's (X, Y, Z/8 + 1, 2, 128) packed layout -> (X, Y, Z, C), as
    tpu3d/kernels/trilinear.py::unpack_grid."""
    X, Y, Z, C = shape
    g = packed.reshape(X, Y, (Z // ZROW + 1) * ZROW, CPAD)
    return g[:, :, :Z, :C]


def grid_tensor(g: np.ndarray, device, channels: int = CHANNELS) -> torch.Tensor:
    """A grid-shaped array of tpu3d's -- a grid or one of its Adam moments,
    in the (X, Y, Z, C) layout or the packed (X, Y, Z/8 + 1, 2, 128) one
    (then ``channels`` is C) -- as a contiguous (X, Y, Z, C) f32 tensor on
    ``device``."""
    g = np.asarray(g)
    if g.ndim == 5 and g.shape[3:] == (2, ZROW * CPAD // 2):
        X, Y, zr = g.shape[:3]
        g = unpack_grid(g, (X, Y, (zr - 1) * ZROW, channels))
    elif g.ndim != 4:
        raise ValueError(f"grid of shape {g.shape} is neither (X, Y, Z, C) nor "
                         "tpu3d's packed (X, Y, Z/8+1, 2, 128)")
    return torch.from_numpy(np.ascontiguousarray(g, dtype=np.float32)).to(device)


def grid_from_tpu3d(arrays: Dict[str, np.ndarray], device,
                    channels: int = CHANNELS
                    ) -> Tuple[VoxelGrid, Optional[torch.Tensor]]:
    """A tpu3d ``dense_grid`` / ``dense_grid_detail`` npz dict -> the port's
    (VoxelGrid, bg_sh or None) on ``device``. ``grid`` is tpu3d's
    (X, Y, Z, C) array or its packed (X, Y, Z/8 + 1, 2, 128) layout (then
    ``channels`` is C); ``bg_sh`` is the learned (3, 9) background SH."""
    grid = grid_tensor(arrays["grid"], device, channels)

    def vec(name):
        return torch.as_tensor(np.asarray(arrays[name], np.float32), device=device)

    bg = arrays.get("bg_sh")
    bg_sh = None if bg is None else vec("bg_sh").reshape(3, 9)
    return VoxelGrid(grid, vec("min_bound"), vec("max_bound")), bg_sh


def grid_from_mesh_grid(arrays: Dict[str, np.ndarray], device) -> VoxelGrid:
    """tpu3d's compact ``mesh_grid`` (density + SH DC per colour, f16) as a
    28-channel grid with DC-only colours (tpu3d/cli.py:1034-1045)."""
    m = arrays["grid"]
    g = np.zeros((*m.shape[:3], CHANNELS), np.float32)
    for src, dst in [(0, 0), (1, 1), (2, 10), (3, 19)]:
        g[..., dst] = m[..., src].astype(np.float32)
    return grid_from_tpu3d({"grid": g, "min_bound": arrays["min_bound"],
                            "max_bound": arrays["max_bound"]}, device)[0]
