"""Two-view triangulation (tpu3d/geometry/triangulate.py). Only the
midpoint method is ported so far: pose recovery's cheirality vote needs
it. DLT and Gauss-Newton refinement come with the reconstruct stage."""
from __future__ import annotations

import torch


def triangulate_midpoint(R0, t0, R1, t1, x0, x1) -> torch.Tensor:
    """Midpoint triangulation of (..., N, 2) focal-normalized
    correspondences seen from world->camera poses (R0, t0), (R1, t1).
    Returns (..., N, 3) world points."""
    c0 = -torch.einsum("...ji,...j->...i", R0, t0)
    c1 = -torch.einsum("...ji,...j->...i", R1, t1)
    d0 = torch.cat([x0, torch.ones_like(x0[..., :1])], dim=-1)
    d1 = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    d0 = d0 @ R0
    d1 = d1 @ R1
    d0 = d0 / torch.linalg.vector_norm(d0, dim=-1, keepdim=True)
    d1 = d1 / torch.linalg.vector_norm(d1, dim=-1, keepdim=True)
    b = c1 - c0
    d01 = torch.sum(d0 * d1, dim=-1)
    denom = torch.clamp(1.0 - d01**2, min=1e-9)
    bd0 = torch.sum(b[..., None, :] * d0, dim=-1)
    bd1 = torch.sum(b[..., None, :] * d1, dim=-1)
    s0 = (bd0 - d01 * bd1) / denom
    s1 = (d01 * bd0 - bd1) / denom
    p0 = c0[..., None, :] + s0[..., None] * d0
    p1 = c1[..., None, :] + s1[..., None] * d1
    return 0.5 * (p0 + p1)
