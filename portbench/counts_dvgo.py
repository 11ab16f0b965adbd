"""The work that DVGO's training step cannot do without, from the
configuration's shapes and the samples its equations colour, beside
counts.py's (whose peaks, byte and trilinear counts it takes).

The colour MLP (39-128-128-3) counts only where DVGO's equations colour a
sample (w > tau: the program's counter ``dense.colour_samples``), whatever
rows an implementation runs through it, so that a later compaction of the
samples can never read above 100%: its forward, the weights' gradients, and
the inputs' gradients that the step needs (layers 2 and 3, and the 12 k0
columns of layer 1; the view encoding takes none).
"""
from __future__ import annotations

from typing import Sequence

from portbench import counts

CHANNELS = 13                    # density and the 12 k0 features in one grid
LAYERS = ((39, 128), (128, 128), (128, 3))
K0_DIM = 12
# A sample's march beyond its trilinear read: softplus, alpha, the filters,
# the log-transmittance sum, its exponential, the weight, the blend of three
# colours; the backward at twice that.
MARCH_FLOPS = 20
ADAM_FLOPS = counts.OPTIMIZER_FLOPS["adam"]
ADAM_PASSES = counts.OPTIMIZER_PASSES["adam"]


def rgbnet_forward_flops() -> int:
    """One row's forward: a multiply and an add per weight."""
    return sum(2 * i * o for i, o in LAYERS)


def rgbnet_flops(samples: float) -> float:
    """The MLP's least FLOPs over ``samples`` coloured samples: forward,
    weight gradients, and the input gradients the step needs."""
    (i1, o1), (i2, o2), (i3, o3) = LAYERS
    inputs = 2 * (o3 * i3 + o2 * i2 + o1 * K0_DIM)
    return samples * (2 * rgbnet_forward_flops() + inputs)


def rgbnet_params() -> int:
    return sum(i * o + o for i, o in LAYERS)


def step_bytes(res: Sequence[int], batch: int) -> int:
    """A step: the grid, its gradient's moments and the MLP read once and
    written once by the optimizer, and the batch's rays read once."""
    state = counts.grid_bytes(res, CHANNELS) + rgbnet_params() * counts.F32
    return ADAM_PASSES * state + batch * counts.RAY_BYTES


def step_flops(res: Sequence[int], batch: int, samples: int, coloured: float) -> float:
    """A step: every sample's trilinear read and march, both with their
    backward at twice the forward, the MLP over the coloured samples, and
    the optimizer over every grid value and MLP weight."""
    march = 3 * batch * samples * (counts.sample_flops(CHANNELS) + MARCH_FLOPS)
    optimizer = ADAM_FLOPS * (counts.cells(res) * CHANNELS + rgbnet_params())
    return march + rgbnet_flops(coloured) + optimizer


def scatter_bytes(batch: int, samples: int, res: Sequence[int]) -> int:
    """The scatter of a step's 13-channel cotangents into the grid's
    gradient (counts.scatter_bytes at 13 channels)."""
    return counts.scatter_bytes(batch * samples, CHANNELS, res)
