"""Perspective-n-Point (tpu3d/geometry/pnp.py): batched 10-point DLT
hypotheses, each polished by three LM steps, scored in one batch, and the
winner polished on its inliers. Batched over leading dimensions (the
images of a registration chunk).

Samples come from Gumbel noise the caller passes in (see
geometry/ransac.py): tpu3d's ``jax.random.gumbel(key, (M, N))`` gives its
own indices, a ``torch.Generator`` the port's.
"""
from __future__ import annotations

from typing import Tuple

import torch

from tpu3d_torch.core.lie import so3_exp, so3_exp_jacobian, so3_log
from tpu3d_torch.core.linalg import eigh
from tpu3d_torch.geometry.ransac import _sample_indices, ransac, take_points

# Minimal DLT needs 6 points; a few extra steady each hypothesis under noise.
PNP_SAMPLE_SIZE = 10


def pnp_dlt(X: torch.Tensor, x: torch.Tensor, weights=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Direct linear transform PnP. X (..., N, 3) world points, x (..., N, 2)
    focal-normalized observations, weights (..., N) mask. Returns world->cam
    (R (..., 3, 3), t (..., 3)). The points are normalized (centroid, RMS
    radius) before the solve and the pose mapped back."""
    if weights is None:
        weights = torch.ones(X.shape[:-1], dtype=X.dtype, device=X.device)
    wsum = torch.clamp(weights.sum(-1), min=1.0)
    c = (X * weights[..., None]).sum(-2) / wsum[..., None]
    s = torch.sqrt(((X - c[..., None, :]) ** 2).sum(-1).mul(weights).sum(-1) / wsum) + 1e-9
    Xn = (X - c[..., None, :]) / s[..., None, None]
    Xh = torch.cat([Xn, torch.ones_like(Xn[..., :1])], dim=-1)
    zeros = torch.zeros_like(Xh)
    u = x[..., 0:1]
    v = x[..., 1:2]
    row0 = torch.cat([Xh, zeros, -u * Xh], dim=-1)
    row1 = torch.cat([zeros, Xh, -v * Xh], dim=-1)
    w = weights[..., None]
    A = torch.cat([row0 * w, row1 * w], dim=-2)
    _, V = eigh(A.transpose(-1, -2) @ A)
    P = V[..., :, 0].reshape(*V.shape[:-2], 3, 4)
    # Sign by cheirality: most points at positive projective depth.
    depth = torch.einsum("...j,...nj->...n", P[..., 2, :], Xh)
    P = P * torch.sign((torch.sign(depth) * weights).sum(-1) + 0.5)[..., None, None]
    U, S, Vt = torch.linalg.svd(P[..., :, :3])
    d = torch.sign(torch.linalg.det(U @ Vt))
    flip = torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)
    R = (U * flip[..., None, :]) @ Vt
    t_norm = P[..., :, 3] / torch.clamp(S.mean(-1), min=1e-12)[..., None]
    t = s[..., None] * t_norm - torch.einsum("...ij,...j->...i", R, c)
    return R, t


def _safe_z(z):
    return torch.where(z.abs() < 1e-8, torch.where(z < 0, -1e-8, 1e-8), z)


def _reproj_residual(params, X, x, w):
    """Masked reprojection residual (..., 2N). params (..., 6) = [rvec, t]."""
    Xc = torch.einsum("...ij,...nj->...ni", so3_exp(params[..., :3]), X) + params[..., None, 3:6]
    r = (Xc[..., :2] / _safe_z(Xc[..., 2:3]) - x) * w[..., None]
    return r.reshape(*r.shape[:-2], -1)


def _reproj_jacobian(params, X, w):
    """(..., 2N, 6) Jacobian of :func:`_reproj_residual` in closed form:
    dpred/dXc chained through dXc/drvec = dR/drvec X and dXc/dt = I."""
    R = so3_exp(params[..., :3])
    dR = so3_exp_jacobian(params[..., :3])                    # (..., 3, 3, 3)
    Xc = torch.einsum("...ij,...nj->...ni", R, X) + params[..., None, 3:6]
    inv_z = 1.0 / _safe_z(Xc[..., 2])
    zero = torch.zeros_like(inv_z)
    dp = torch.stack([torch.stack([inv_z, zero, -Xc[..., 0] * inv_z * inv_z], -1),
                      torch.stack([zero, inv_z, -Xc[..., 1] * inv_z * inv_z], -1)], -2)
    dp = dp * w[..., None, None]                              # (..., N, 2, 3)
    dXc = torch.einsum("...ajk,...nj->...nak", dR, X)         # (..., N, 3, 3)
    J = torch.cat([dp @ dXc, dp], dim=-1)                     # (..., N, 2, 6)
    return J.reshape(*J.shape[:-3], -1, 6)


def refine_pose(R, t, X, x, weights, iters: int = 10, lm_lambda: float = 1e-4):
    """Fixed-iteration Levenberg-Marquardt polish of world->cam poses on
    focal-normalized observations, masked by ``weights`` (..., N)."""
    params = torch.cat([so3_log(R), t], dim=-1)
    lam = torch.full(params.shape[:-1], lm_lambda, dtype=X.dtype, device=X.device)
    for _ in range(iters):
        r = _reproj_residual(params, X, x, weights)
        J = _reproj_jacobian(params, X, weights)
        JtJ = J.transpose(-1, -2) @ J
        g = (J.transpose(-1, -2) @ r[..., None])[..., 0]
        diag = torch.diagonal(JtJ, dim1=-2, dim2=-1)
        H = JtJ + torch.diag_embed(lam[..., None] * (diag + 1e-8))
        new = params - torch.linalg.solve(H, g)
        improved = (_reproj_residual(new, X, x, weights) ** 2).sum(-1) < (r**2).sum(-1)
        params = torch.where(improved[..., None], new, params)
        lam = torch.where(improved, lam * 0.3, lam * 3.0)
    return so3_exp(params[..., :3]), params[..., 3:6]


def _pose_errors(R, t, X, x):
    """(..., N) squared reprojection errors of every point under each
    pose, inf behind the camera. R (..., 3, 3), t (..., 3), X (..., N, 3)."""
    Xc = torch.einsum("...ij,...nj->...ni", R, X) + t[..., None, :]
    err = ((Xc[..., :2] / _safe_z(Xc[..., 2:3]) - x) ** 2).sum(-1)
    return torch.where(Xc[..., 2] <= 1e-6, torch.full_like(err, float("inf")), err)


def pnp_ransac(noise: torch.Tensor, X: torch.Tensor, x: torch.Tensor, valid: torch.Tensor,
               threshold_norm_sq, refine_iters: int = 10):
    """RANSAC PnP. noise: (..., M, N) Gumbel draws (M hypotheses); X
    (..., N, 3), x (..., N, 2) focal-normalized, valid (..., N) mask;
    threshold_norm_sq: squared inlier gate in normalized units. Returns
    (R, t, inliers (..., N) bool, count (...))."""
    idx = _sample_indices(noise, valid, PNP_SAMPLE_SIZE)     # (..., M, s)
    Xs = take_points(X, idx)
    xs = take_points(x, idx)

    def solver(_):
        # Each hypothesis polished to its sample's optimum before scoring
        # (tpu3d: backend-independent winner selection).
        ones = torch.ones(Xs.shape[:-1], dtype=X.dtype, device=X.device)
        Rh, th = refine_pose(*pnp_dlt(Xs, xs, ones), Xs, xs, ones, iters=3)
        return torch.cat([Rh.reshape(*Rh.shape[:-2], 9), th], dim=-1)

    def scorer(models):
        R = models[..., :9].reshape(*models.shape[:-1], 3, 3)
        return _pose_errors(R, models[..., 9:12], X[..., None, :, :], x[..., None, :, :])

    model, inliers, _ = ransac(idx, solver, scorer, valid, threshold_norm_sq)
    R = model[..., :9].reshape(*model.shape[:-1], 3, 3)
    R, t = refine_pose(R, model[..., 9:12], X, x, inliers.to(X.dtype), iters=refine_iters)
    inliers = (_pose_errors(R, t, X, x) < threshold_norm_sq) & (valid > 0)
    return R, t, inliers, inliers.sum(-1)
