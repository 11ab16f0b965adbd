"""Relative pose from an essential matrix + cheirality vote
(tpu3d/geometry/pose.py). The four (R, t) candidates of the SVD
decomposition triangulate every (masked) correspondence at once; the one
with the most points in front of both cameras wins."""
from __future__ import annotations

from typing import Tuple

import torch

from tpu3d_torch.geometry.ransac import pick
from tpu3d_torch.geometry.triangulate import triangulate_midpoint

_W = [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]


def decompose_essential(E: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """E (..., 3, 3) -> (Rs (..., 4, 3, 3), ts (..., 4, 3)): the four
    candidate world->cam1 poses (cam0 = [I|0]), unit-norm translation."""
    U, _, Vh = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vh = Vh * torch.sign(torch.linalg.det(Vh))[..., None, None]
    W = torch.tensor(_W, dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vh
    R2 = U @ W.T @ Vh
    t = U[..., :, 2]
    Rs = torch.stack([R1, R1, R2, R2], dim=-3)
    ts = torch.stack([t, -t, t, -t], dim=-2)
    return Rs, ts


def cheirality_counts(Rs, ts, x0, x1, valid):
    """Per candidate, triangulate all points and count those with positive
    depth in both views. Rs (..., 4, 3, 3), ts (..., 4, 3), x (..., N, 2),
    valid (..., N). Returns (counts (..., 4), front (..., 4, N))."""
    eye = torch.eye(3, dtype=Rs.dtype, device=Rs.device).expand(Rs.shape)
    zero = torch.zeros_like(ts)
    X = triangulate_midpoint(eye, zero, Rs, ts, x0[..., None, :, :],
                             x1[..., None, :, :])            # (..., 4, N, 3)
    z0 = X[..., 2]
    Xc1 = X @ Rs.transpose(-1, -2) + ts[..., None, :]
    z1 = Xc1[..., 2]
    front = (z0 > 0) & (z1 > 0) & (valid[..., None, :] > 0)
    return front.sum(dim=-1), front


def recover_pose(E, x0, x1, valid=None):
    """Cheirality-consistent (R, t) from E and focal-normalized
    correspondences (..., N, 2). Returns (R, t, front (..., N) bool)."""
    if valid is None:
        valid = torch.ones(x0.shape[:-1], dtype=x0.dtype, device=x0.device)
    Rs, ts = decompose_essential(E)
    counts, front = cheirality_counts(Rs, ts, x0, x1, valid)
    best = torch.argmax(counts, dim=-1)
    return pick(Rs, best), pick(ts, best), pick(front, best)
