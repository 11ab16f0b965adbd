"""Essential-matrix estimation (tpu3d/geometry/epipolar.py): the batched
normalized 8-point solver, the essential-manifold projection and Sampson
scoring. Points are focal-normalized (K = I)."""
from __future__ import annotations

import math

import torch


def _hartley_normalize(x: torch.Tensor, w: torch.Tensor):
    """Weighted isotropic (Hartley) normalization of (..., N, 2) points with
    a (..., N) 0/1 mask. Returns (x_norm, T), x_norm_h = T @ x_h."""
    wsum = torch.clamp(w.sum(dim=-1, keepdim=True), min=1.0)
    mean = torch.sum(x * w[..., None], dim=-2, keepdim=True) / wsum[..., None]
    d = torch.linalg.vector_norm(x - mean, dim=-1)
    scale = math.sqrt(2.0) / torch.clamp(
        torch.sum(d * w, dim=-1, keepdim=True) / wsum, min=1e-9)
    xn = (x - mean) * scale[..., None]
    s = scale[..., 0]
    mx = mean[..., 0, 0]
    my = mean[..., 0, 1]
    zeros = torch.zeros_like(s)
    ones = torch.ones_like(s)
    T = torch.stack([
        torch.stack([s, zeros, -s * mx], dim=-1),
        torch.stack([zeros, s, -s * my], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1),
    ], dim=-2)
    return xn, T


def _nullvec9_mgs(A: torch.Tensor) -> torch.Tensor:
    """Unit null vector of a batched (..., 8, 9) design matrix: twice-
    iterated modified Gram-Schmidt on the rows, then the most represented
    column of the orthogonal-complement projector. Ported operation for
    operation, so hypotheses agree with tpu3d's."""
    qs = []
    for k in range(A.shape[-2]):
        r = A[..., k, :]
        for _ in range(2):
            for q in qs:
                r = r - torch.sum(r * q, dim=-1, keepdim=True) * q
        n = torch.linalg.vector_norm(r, dim=-1, keepdim=True)
        qs.append(r / torch.clamp(n, min=1e-12))
    Q = torch.stack(qs, dim=-2)                                   # (..., 8, 9)
    P = torch.eye(9, dtype=A.dtype, device=A.device) - Q.transpose(-1, -2) @ Q
    norms = torch.linalg.vector_norm(P, dim=-2)                   # (..., 9)
    j = torch.argmax(norms, dim=-1)
    v = torch.gather(P, -1, j[..., None, None].expand(*P.shape[:-1], 1))[..., 0]
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)


def essential_eight_point(x0: torch.Tensor, x1: torch.Tensor,
                          weights: torch.Tensor | None = None,
                          project: bool = True) -> torch.Tensor:
    """Normalized 8-point essential matrix from (..., N, 2) focal-normalized
    correspondences, N >= 8, with an optional (..., N) mask. N == 8 takes the
    MGS null vector; more points the smallest eigenvector of AᵀA. Returns
    E (..., 3, 3) with x1ᵀ E x0 = 0, projected to the essential manifold
    unless ``project`` is False."""
    if weights is None:
        weights = torch.ones(x0.shape[:-1], dtype=x0.dtype, device=x0.device)
    x0n, T0 = _hartley_normalize(x0, weights)
    x1n, T1 = _hartley_normalize(x1, weights)
    u0, v0 = x0n[..., 0], x0n[..., 1]
    u1, v1 = x1n[..., 0], x1n[..., 1]
    ones = torch.ones_like(u0)
    A = torch.stack([u1 * u0, u1 * v0, u1, v1 * u0, v1 * v0, v1, u0, v0, ones], dim=-1)
    wsum = torch.clamp(weights.sum(dim=-1, keepdim=True), min=1.0)
    A = A * (weights / torch.sqrt(wsum))[..., None]
    if A.shape[-2] == 8:
        f = _nullvec9_mgs(A)
    else:
        AtA = A.transpose(-1, -2) @ A
        _, V = torch.linalg.eigh(AtA)
        f = V[..., :, 0]
    F = f.reshape(*f.shape[:-1], 3, 3)
    F = T1.transpose(-1, -2) @ F @ T0
    if not project:
        return F
    return project_to_essential(F)


def project_to_essential(F: torch.Tensor) -> torch.Tensor:
    """Nearest essential matrix: singular values -> (1, 1, 0)."""
    U, S, Vh = torch.linalg.svd(F)
    d = torch.ones_like(S)
    d[..., 2] = 0.0
    return U @ (d[..., :, None] * Vh)


def _epipolar_terms(E, x0, x1):
    e = [[E[..., i, j, None] for j in range(3)] for i in range(3)]
    x, y = x0[..., 0], x0[..., 1]
    xp, yp = x1[..., 0], x1[..., 1]
    ex0 = [e[i][0] * x + e[i][1] * y + e[i][2] for i in range(3)]
    alg = xp * ex0[0] + yp * ex0[1] + ex0[2]
    return e, ex0, alg, xp, yp


def epipolar_residual(E: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """Algebraic residual x1ᵀ E x0 for (..., N, 2) normalized points."""
    return _epipolar_terms(E, x0, x1)[2]


def sampson_error(E: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) distance², in normalized units.

    E (..., 3, 3) and points (..., N, 2) broadcast over leading dims (a
    block of hypotheses against one point set). Written component-wise, so
    scoring M hypotheses against N points holds only (..., M, N) temporaries."""
    e, ex0, alg, xp, yp = _epipolar_terms(E, x0, x1)
    etx0 = e[0][0] * xp + e[1][0] * yp + e[2][0]
    etx1 = e[0][1] * xp + e[1][1] * yp + e[2][1]
    den = ex0[0] ** 2 + ex0[1] ** 2 + etx0 ** 2 + etx1 ** 2
    return alg ** 2 / torch.clamp(den, min=1e-12)
