"""The work a kernel or a step cannot do without, from a configuration's
shapes alone, and the card's data-sheet peaks.

Bytes count each input read once and each output written once, whatever an
implementation reads again; FLOPs count the arithmetic of the model's
equations. Neither depends on how the program does the work, so a later
change that fuses, splits or removes a kernel is measured against the same
least time.
"""
from __future__ import annotations

from typing import Sequence

# NVIDIA H100 SXM data sheet, at its full 700 W power limit.
H100_BYTES_PER_S = 3.35e12        # HBM3
H100_FP32_FLOPS = 67e12           # float32 outside the tensor cores

F32 = 4
RAY_BYTES = 9 * F32               # origin, direction and colour of a training ray
# FLOPs of one trilinear sample of C channels: 7 lerps of 3 operations per
# channel, plus the corner setup.
TRILINEAR_FLOPS_PER_CHANNEL, TRILINEAR_SETUP_FLOPS = 21, 18
SHADE_FLOPS = 80                  # relu, 27 SH products and sums, the basis
COMPOSITE_FLOPS = 12              # delta, exp, product scan, weight, blend
OPTIMIZER_FLOPS = {"adam": 13, "rmsprop": 6}            # per grid value
OPTIMIZER_PASSES = {"adam": 6, "rmsprop": 4}            # grid + state, read and written


def cells(res: Sequence[int]) -> int:
    x, y, z = (int(r) for r in res)
    return x * y * z


def grid_bytes(res: Sequence[int], channels: int) -> int:
    return cells(res) * channels * F32


def trilinear_bytes(n_points: int, channels: int) -> int:
    """A forward trilinear launch: the points read (3 floats), the values
    written (C floats) and the in-box flags written (1 byte). The grid rows
    the points need depend on the data and are left out, so the bound is a
    floor."""
    return n_points * (3 * F32 + channels * F32 + 1)


def scatter_bytes(n_points: int, channels: int, res: Sequence[int]) -> int:
    """The grid gradient of a trilinear sample: the cotangents (C floats)
    and points (3 floats) read once, the gradient grid written once."""
    return n_points * (channels + 3) * F32 + grid_bytes(res, channels)


def step_bytes(optimizer: str, res: Sequence[int], channels: int, batch: int) -> int:
    """A training step: the trained grid and the optimizer's state read
    once and written once, and the batch's rays read once."""
    return OPTIMIZER_PASSES[optimizer] * grid_bytes(res, channels) + batch * RAY_BYTES


def sample_flops(channels: int) -> int:
    return channels * TRILINEAR_FLOPS_PER_CHANNEL + TRILINEAR_SETUP_FLOPS


def step_flops(optimizer: str, res: Sequence[int], channels: int, batch: int,
               samples: int, coarse_samples: int = 0, grids: int = 1) -> int:
    """A training step: the forward pass at ``samples`` depths a ray (each
    reading ``grids`` grids), its backward at twice the forward, a
    forward-only coarse pass of density at ``coarse_samples`` depths, and
    the optimizer over every grid value."""
    per_sample = grids * sample_flops(channels) + SHADE_FLOPS + COMPOSITE_FLOPS
    coarse = batch * coarse_samples * (grids * sample_flops(1) + COMPOSITE_FLOPS)
    return (3 * batch * samples * per_sample + coarse
            + OPTIMIZER_FLOPS[optimizer] * cells(res) * channels)


def view_flops(n_rays: int, samples: int, channels: int) -> int:
    """A rendered view: every sample's trilinear read, shading and
    compositing."""
    return n_rays * samples * (sample_flops(channels) + SHADE_FLOPS + COMPOSITE_FLOPS)


def view_bytes(n_rays: int) -> int:
    """A rendered view: each ray's origin and direction read once, its
    colour written once. The grid rows the samples need depend on the data
    and are left out, so the bound is a floor."""
    return n_rays * 9 * F32


def least_seconds(nbytes: float, flops: float) -> float:
    """The roofline: the larger of the bytes over the memory's rate and the
    FLOPs over the float32 peak."""
    return max(nbytes / H100_BYTES_PER_S, flops / H100_FP32_FLOPS)
