"""Radial scene contraction (mip-NeRF 360 style; tpu3d/dense/contract.py):
the unit ball stays linear and all of space beyond it maps into the shell
out to radius 2. Sample positions are warped at query time only."""
from __future__ import annotations

import torch


def contract(pts: torch.Tensor) -> torch.Tensor:
    """(..., 3) points -> contracted ball of radius 2."""
    n = torch.linalg.norm(pts, dim=-1, keepdim=True)
    n = torch.clamp(n, min=1e-9)
    warped = (2.0 - 1.0 / n) * (pts / n)
    return torch.where(n <= 1.0, pts, warped)


def contract_inv(y: torch.Tensor) -> torch.Tensor:
    """Inverse warp: contracted coordinates (||y|| < 2) -> world
    coordinates; ||y|| >= 2 is clamped just inside the shell."""
    n = torch.linalg.norm(y, dim=-1, keepdim=True)
    n = torch.clamp(n, 1e-9, 2.0 - 1e-4)
    unwarped = y / (n * (2.0 - n))
    return torch.where(n <= 1.0, y, unwarped)
