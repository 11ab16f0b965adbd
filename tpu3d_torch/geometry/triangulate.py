"""Batched two-view triangulation (tpu3d/geometry/triangulate.py): the
homogeneous DLT as a per-point 4x4 symmetric eigenproblem, the midpoint
method for cheirality votes, and a damped Gauss-Newton polish. Everything
is batched over leading dimensions."""
from __future__ import annotations

import torch

from tpu3d_torch.core.linalg import eigh


def _projection_rows(P: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Two DLT rows per view: [u P3 - P1 ; v P3 - P2]. P (..., 3, 4),
    x (..., 2)."""
    u = x[..., 0:1]
    v = x[..., 1:2]
    return torch.stack([u * P[..., 2, :] - P[..., 0, :], v * P[..., 2, :] - P[..., 1, :]], -2)


def triangulate_dlt(R0, t0, R1, t1, x0, x1) -> torch.Tensor:
    """DLT triangulation of (..., N, 2) focal-normalized correspondences
    seen from world->camera poses (R0, t0), (R1, t1). Returns (..., N, 3)
    world points; padded inputs give garbage that callers mask."""
    P0 = torch.cat([R0, t0[..., :, None]], dim=-1)
    P1 = torch.cat([R1, t1[..., :, None]], dim=-1)
    A = torch.cat([_projection_rows(P0[..., None, :, :], x0),
                   _projection_rows(P1[..., None, :, :], x1)], dim=-2)   # (..., N, 4, 4)
    AtA = torch.einsum("...nij,...nik->...njk", A, A)
    _, V = eigh(AtA)
    Xh = V[..., :, 0]
    w = Xh[..., 3:4]
    w_safe = torch.where(w.abs() < 1e-12, torch.where(w < 0, -1e-12, 1e-12), w)
    return Xh[..., :3] / w_safe


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


def _solve33(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 solve by the adjugate (Cramer's rule)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c01 + a02 * c02
    det = torch.where(det.abs() < 1e-20, 1e-20, det)
    x0 = c00 * b[..., 0] + c01 * b[..., 1] + c02 * b[..., 2]
    x1 = c10 * b[..., 0] + c11 * b[..., 1] + c12 * b[..., 2]
    x2 = c20 * b[..., 0] + c21 * b[..., 1] + c22 * b[..., 2]
    return torch.stack([x0, x1, x2], dim=-1) / det[..., None]


def _two_view_residuals(R0, t0, R1, t1, x0, x1, X):
    """(r (..., N, 4), J (..., N, 4, 3)): the two views' reprojection
    residuals and their Jacobians in X."""
    rows, jacs = [], []
    for R, t, x in ((R0, t0, x0), (R1, t1, x1)):
        Xc = torch.einsum("...ij,...nj->...ni", R, X) + t[..., None, :]
        z = Xc[..., 2:3]
        z_safe = torch.where(z.abs() < 1e-8, torch.where(z < 0, -1e-8, 1e-8), z)
        pred = Xc[..., :2] / z_safe
        Rb = R[..., None, :, :].expand(*Xc.shape[:-1], 3, 3)
        rows.append(pred - x)
        jacs.append((Rb[..., :2, :] - pred[..., :, None] * Rb[..., 2:3, :]) / z_safe[..., None])
    return torch.cat(rows, dim=-1), torch.cat(jacs, dim=-2)


def refine_triangulation_gn(R0, t0, R1, t1, x0, x1, X, iters: int = 2) -> torch.Tensor:
    """Damped Gauss-Newton polish of (..., N, 3) points against the
    two-view reprojection error; a step that does not lower a point's cost
    is rejected, so the result is never worse than the start."""
    eye = torch.eye(3, dtype=X.dtype, device=X.device)
    for _ in range(iters):
        r, J = _two_view_residuals(R0, t0, R1, t1, x0, x1, X)
        JtJ = torch.einsum("...nki,...nkj->...nij", J, J)
        Jtr = torch.einsum("...nki,...nk->...ni", J, r)
        damp = 1e-9 + 1e-6 * torch.diagonal(JtJ, dim1=-2, dim2=-1).sum(-1)
        X_new = X - _solve33(JtJ + damp[..., None, None] * eye, Jtr)
        r_new, _ = _two_view_residuals(R0, t0, R1, t1, x0, x1, X_new)
        better = ((r_new**2).sum(-1) < (r**2).sum(-1)) & torch.isfinite(X_new).all(-1)
        X = torch.where(better[..., None], X_new, X)
    return X
