"""Batched five-point essential-matrix solver (Nistér's minimal problem),
the default path of tpu3d/geometry/fivepoint.py, batched over any leading
dimensions (pairs x hypotheses):

  1. a Gram-Schmidt null-space basis E(x, y, z) = xW + yX + zY + Z;
  2. M(z), the 10x10 matrix of the cubic constraints, recovered by
     evaluating them at 10 fixed (x, y) samples;
  3. q(u) = cos^10(u) det M(tan u), an 11-coefficient trig polynomial
     rebuilt from 11 determinants; sign changes on a 256-point grid,
     refined by 30 bisection steps;
  4. per root, (x, y) from M(z)'s null vector (Cholesky inverse iteration)
     and a closed-form projection onto the essential manifold.

Each sample yields up to MAX_ROOTS models with a validity mask.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tpu3d_torch.geometry.epipolar import sampson_error
from tpu3d_torch.geometry.ransac import _sample_indices, pick, take_points

MAX_ROOTS = 10
GRID = 256
BISECT_ITERS = 30

# Constant xy-interpolation machinery, identical to tpu3d's (same seed).
# monomial order: [x^3, x^2 y, x y^2, y^3, x^2, x y, y^2, x, y, 1]
_RNG = np.random.default_rng(12345)
_XY = _RNG.uniform(-1.5, 1.5, (10, 2))


def _monomials_xy(x, y):
    return np.stack([x**3, x**2 * y, x * y**2, y**3, x**2, x * y, y**2, x, y, np.ones_like(x)], -1)


_VXY_INV_T = np.linalg.inv(_monomials_xy(_XY[:, 0], _XY[:, 1])).T.astype(np.float32)

_N_COEF = 11
_U_MAX = 1.3
_U_NODES = _U_MAX * np.cos(np.pi * (2 * np.arange(_N_COEF) + 1) / (2 * _N_COEF))


def _trig_basis_np(u: np.ndarray) -> np.ndarray:
    m = np.arange(1, _N_COEF // 2 + 1)
    return np.concatenate([
        np.ones((*u.shape, 1)),
        np.cos(2.0 * u[..., None] * m),
        np.sin(2.0 * u[..., None] * m),
    ], axis=-1)


_BASIS_INV = np.linalg.inv(_trig_basis_np(_U_NODES)).astype(np.float32)
_U_GRID = np.linspace(-np.pi / 2, np.pi / 2, GRID)
_GRID_BASIS = _trig_basis_np(_U_GRID).astype(np.float32)
_M_RANGE = np.arange(1, _N_COEF // 2 + 1, dtype=np.float32)


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=like.device)


def _constraints_flat(e):
    """The 10 Demazure constraints, component-wise: e is a sequence of the
    9 entries of E ([a b c; d f g; h i j]), each an array of one shape.
    Returns a list of 10 arrays: [det E, (2 E Eᵀ E − tr(E Eᵀ) E) row-major]."""
    a, b, c, d, f, g, h, i, j = e
    det = a * (f * j - g * i) - b * (d * j - g * h) + c * (d * i - f * h)
    m00 = a * a + b * b + c * c
    m01 = a * d + b * f + c * g
    m02 = a * h + b * i + c * j
    m11 = d * d + f * f + g * g
    m12 = d * h + f * i + g * j
    m22 = h * h + i * i + j * j
    tr = m00 + m11 + m22
    return [
        det,
        2.0 * (m00 * a + m01 * d + m02 * h) - tr * a,
        2.0 * (m00 * b + m01 * f + m02 * i) - tr * b,
        2.0 * (m00 * c + m01 * g + m02 * j) - tr * c,
        2.0 * (m01 * a + m11 * d + m12 * h) - tr * d,
        2.0 * (m01 * b + m11 * f + m12 * i) - tr * f,
        2.0 * (m01 * c + m11 * g + m12 * j) - tr * g,
        2.0 * (m02 * a + m12 * d + m22 * h) - tr * h,
        2.0 * (m02 * b + m12 * f + m22 * i) - tr * i,
        2.0 * (m02 * c + m12 * g + m22 * j) - tr * j,
    ]


def _mgs(rows, n_out):
    """Twice-iterated modified Gram-Schmidt over a list of (..., 9) rows."""
    qs = []
    for k in range(n_out):
        r = rows[k]
        for _ in range(2):
            for q in qs:
                r = r - torch.sum(r * q, dim=-1, keepdim=True) * q
        qs.append(r / torch.clamp(torch.linalg.vector_norm(r, dim=-1, keepdim=True), min=1e-12))
    return qs


def _nullspace_basis(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """(..., 5, 2) correspondences -> (..., 4, 3, 3) orthonormal basis of
    the E null space: Gram-Schmidt on the 5 design rows, the complement
    projector, then Gram-Schmidt on its 4 most independent columns."""
    u0, v0 = x0[..., 0], x0[..., 1]
    u1, v1 = x1[..., 0], x1[..., 1]
    ones = torch.ones_like(u0)
    Q = torch.stack([u1 * u0, u1 * v0, u1, v1 * u0, v1 * v0, v1, u0, v0, ones], dim=-1)
    Qo = torch.stack(_mgs([Q[..., k, :] for k in range(5)], 5), dim=-2)   # (..., 5, 9)
    P = torch.eye(9, dtype=Q.dtype, device=Q.device) - Qo.transpose(-1, -2) @ Qo
    order = torch.argsort(-torch.linalg.vector_norm(P, dim=-2), dim=-1, stable=True)
    Pt = P.transpose(-1, -2)                     # rows of Pt = columns of P
    cols = torch.gather(Pt, -2, order[..., :, None].expand(*Pt.shape))
    basis = _mgs([cols[..., k, :] for k in range(4)], 4)
    return torch.stack(basis, dim=-2).reshape(*x0.shape[:-2], 4, 3, 3)


def _M_of_z(basis: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Numeric M(z): basis (..., 4, 3, 3) and z (..., R) (or (R,)) ->
    (..., R, 10, 10)."""
    bflat = basis.reshape(*basis.shape[:-3], 4, 9)
    xs = _const(_XY[:, 0], basis)
    ys = _const(_XY[:, 1], basis)
    stat = (bflat[..., 0, :, None] * xs + bflat[..., 1, :, None] * ys
            + bflat[..., 3, :, None])                          # (..., 9, S)
    zz = z[..., :, None]                                       # (..., R, 1)
    e = [stat[..., k, None, :] + bflat[..., 2, k, None, None] * zz
         for k in range(9)]                                    # (..., R, S)
    C = torch.stack(_constraints_flat(e), dim=-2)              # (..., R, 10, S)
    return C @ _const(_VXY_INV_T, basis)


def _det10_ge(A: torch.Tensor) -> torch.Tensor:
    """Batched determinant by unrolled Gaussian elimination with partial
    pivoting (ported step for step, so determinants agree with tpu3d's)."""
    n = A.shape[-1]
    det = torch.ones(A.shape[:-2], dtype=A.dtype, device=A.device)
    rows = torch.arange(n, device=A.device)
    for k in range(n - 1):
        col = torch.where(rows >= k, A[..., :, k].abs(), torch.full_like(A[..., :, k], -1.0))
        p = torch.argmax(col, dim=-1)
        pr = torch.gather(A, -2, p[..., None, None].expand(*A.shape[:-2], 1, n))[..., 0, :]
        kr = A[..., k, :]
        det = torch.where(p != k, -det, det)
        onehot_k = (rows == k).to(A.dtype)[:, None]
        onehot_p = (rows == p[..., None]).to(A.dtype)[..., None]
        A = (A + onehot_k * (pr - kr)[..., None, :]
             + onehot_p * (kr - pr)[..., None, :])
        piv = A[..., k, k]
        det = det * piv
        piv_safe = torch.where(piv.abs() < 1e-30, torch.full_like(piv, 1e-30), piv)
        factors = A[..., :, k] / piv_safe[..., None]
        factors = torch.where(rows > k, factors, torch.zeros_like(factors))
        A = A - factors[..., None] * A[..., k, :][..., None, :]
    return det * A[..., n - 1, n - 1]


def _project_essential_fast(E: torch.Tensor) -> torch.Tensor:
    """Closed-form projection onto the essential manifold (singular values
    -> (1, 1, 0)) without a batched 3x3 SVD: closed-form eigenvalues of EᵀE,
    the smallest eigenvector by cross products, and the top-2 inverse
    square root as a linear spectral interpolant."""
    a_, b_, c_ = E[..., 0, 0], E[..., 0, 1], E[..., 0, 2]
    d_, f_, g_ = E[..., 1, 0], E[..., 1, 1], E[..., 1, 2]
    h_, i_, j_ = E[..., 2, 0], E[..., 2, 1], E[..., 2, 2]
    m00 = a_ * a_ + d_ * d_ + h_ * h_
    m01 = a_ * b_ + d_ * f_ + h_ * i_
    m02 = a_ * c_ + d_ * g_ + h_ * j_
    m11 = b_ * b_ + f_ * f_ + i_ * i_
    m12 = b_ * c_ + f_ * g_ + i_ * j_
    m22 = c_ * c_ + g_ * g_ + j_ * j_
    q = (m00 + m11 + m22) / 3.0
    a00, a11, a22 = m00 - q, m11 - q, m22 - q
    p2 = (a00 * a00 + a11 * a11 + a22 * a22
          + 2.0 * (m01 * m01 + m02 * m02 + m12 * m12)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    detB = (a00 * (a11 * a22 - m12 * m12)
            - m01 * (m01 * a22 - m12 * m02)
            + m02 * (m01 * m12 - a11 * m02)) / (p * p * p)
    phi = torch.arccos(torch.clamp(detB / 2.0, -1.0, 1.0)) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * np.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    c00, c11, c22 = m00 - e3, m11 - e3, m22 - e3
    r0 = (c00, m01, m02)
    r1 = (m01, c11, m12)
    r2 = (m02, m12, c22)

    def cross(u, v):
        return (u[1] * v[2] - u[2] * v[1],
                u[2] * v[0] - u[0] * v[2],
                u[0] * v[1] - u[1] * v[0])

    x01, x02, x12 = cross(r0, r1), cross(r0, r2), cross(r1, r2)
    n01 = x01[0] ** 2 + x01[1] ** 2 + x01[2] ** 2
    n02 = x02[0] ** 2 + x02[1] ** 2 + x02[2] ** 2
    n12 = x12[0] ** 2 + x12[1] ** 2 + x12[2] ** 2
    use02 = n02 > n01
    nbest = torch.where(use02, n02, n01)
    use12 = n12 > nbest
    v3 = [torch.where(use12, x12[k], torch.where(use02, x02[k], x01[k]))
          for k in range(3)]
    nv = torch.sqrt(torch.clamp(v3[0] ** 2 + v3[1] ** 2 + v3[2] ** 2, min=1e-30))
    v3 = [vk / nv for vk in v3]
    s1 = torch.sqrt(torch.clamp(e1, min=1e-30))
    s2 = torch.sqrt(torch.clamp(e2, min=1e-30))
    av = -1.0 / (s1 * s2 * (s1 + s2))
    bv = 1.0 / s1 - av * e1
    T = [[av * m00 + bv, av * m01, av * m02],
         [av * m01, av * m11 + bv, av * m12],
         [av * m02, av * m12, av * m22 + bv]]
    Tv3 = [T[r][0] * v3[0] + T[r][1] * v3[1] + T[r][2] * v3[2] for r in range(3)]
    M = [[T[r][c] - Tv3[r] * v3[c] for c in range(3)] for r in range(3)]
    Erows = [(a_, b_, c_), (d_, f_, g_), (h_, i_, j_)]
    out = [[Erows[r][0] * M[0][c] + Erows[r][1] * M[1][c]
            + Erows[r][2] * M[2][c] for c in range(3)] for r in range(3)]
    return torch.stack([torch.stack(row, dim=-1) for row in out], dim=-2)


def _trig_eval(coeffs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Evaluate q at u. coeffs (..., 11), u (..., R) -> (..., R)."""
    ang = 2.0 * u[..., None] * _const(_M_RANGE, u)
    basis = torch.cat([torch.ones_like(u)[..., None], torch.cos(ang), torch.sin(ang)], dim=-1)
    return torch.sum(basis * coeffs[..., None, :], dim=-1)


def _det_coeffs(basis: torch.Tensor) -> torch.Tensor:
    """11 trig coefficients of q(u) = cos^10(u) det M(tan u): (..., 11)."""
    u = _const(_U_NODES, basis)
    M = _M_of_z(basis, torch.tan(u))                   # (..., 11, 10, 10)
    N = torch.cos(u)[:, None, None] * M
    lam = torch.clamp(N.abs().amax(dim=(-3, -2, -1)), min=1e-12)
    q = _det10_ge(N / lam[..., None, None, None])      # (..., 11)
    return q @ _const(_BASIS_INV, basis).T


def essential_five_point(x0: torch.Tensor, x1: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve the 5-point problem for (..., 5, 2) focal-normalized samples.
    Returns (E (..., MAX_ROOTS, 3, 3), valid (..., MAX_ROOTS))."""
    basis = _nullspace_basis(x0, x1)
    coeffs = _det_coeffs(basis)
    d = coeffs @ _const(_GRID_BASIS, basis).T          # (..., GRID)
    us = _const(_U_GRID, basis)
    sign = torch.sign(d)
    change = (sign[..., :-1] * sign[..., 1:]) < 0      # (..., GRID-1)
    idx = torch.argsort(torch.where(change, 0.0, 1.0), dim=-1, stable=True)[..., :MAX_ROOTS]
    have = torch.gather(change, -1, idx)
    lo = us[idx]
    hi = us[idx + 1]
    d_lo = torch.gather(d, -1, idx)
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        d_mid = _trig_eval(coeffs, mid)
        go_left = (d_lo * d_mid) < 0
        lo, hi, d_lo = (torch.where(go_left, lo, mid), torch.where(go_left, mid, hi),
                        torch.where(go_left, d_lo, d_mid))
    roots = torch.tan(0.5 * (lo + hi))                 # (..., R)

    M = _M_of_z(basis, roots)                          # (..., R, 10, 10)
    MtM = M.transpose(-1, -2) @ M
    eps = 1e-7 * torch.diagonal(MtM, dim1=-2, dim2=-1).sum(-1)[..., None, None] + 1e-30
    L, info = torch.linalg.cholesky_ex(MtM + eps * torch.eye(10, dtype=M.dtype, device=M.device))
    # A failed factorization gives NaN models (they then score no inliers),
    # as jnp.linalg.cholesky does.
    L = torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))
    v = torch.ones(M.shape[:-1], dtype=M.dtype, device=M.device) / np.float32(np.sqrt(10.0))
    for _ in range(3):
        v = torch.cholesky_solve(v[..., None], L)[..., 0]
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-30)
    w = v[..., 9]
    w_safe = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    x = v[..., 7] / w_safe
    y = v[..., 8] / w_safe
    b = basis[..., None, :, :, :]                      # (..., 1, 4, 3, 3)
    E = (x[..., None, None] * b[..., 0, :, :] + y[..., None, None] * b[..., 1, :, :]
         + roots[..., None, None] * b[..., 2, :, :] + b[..., 3, :, :])
    E = _project_essential_fast(E)
    return E, have & (w.abs() > 1e-9)


def five_point_ransac(
    uv0: torch.Tensor,
    uv1: torch.Tensor,
    valid: torch.Tensor,
    focal: float,
    noise: torch.Tensor,
    threshold_px: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RANSAC over 5-point minimal samples for (..., N, 2) centered pixel
    matches; every hypothesis contributes up to MAX_ROOTS models, scored in
    one (..., H*MAX_ROOTS, N) batch. ``noise`` holds the (..., H, N) Gumbel
    draws that pick the H samples (tpu3d draws them from its key).
    Returns (E, inliers, count)."""
    x0 = uv0 / focal
    x1 = uv1 / focal
    thr = torch.tensor(threshold_px, dtype=torch.float32) / torch.tensor(focal, dtype=torch.float32)
    thr_sq = float(thr * thr)
    idx = _sample_indices(noise, valid, 5)             # (..., H, 5)
    Es, ok = essential_five_point(take_points(x0, idx), take_points(x1, idx))
    Es = Es.reshape(*Es.shape[:-4], -1, 3, 3)          # (..., H*R, 3, 3)
    ok = ok.reshape(*ok.shape[:-2], -1)
    errors = sampson_error(Es, x0[..., None, :, :], x1[..., None, :, :])
    inl = (errors < thr_sq) & (valid[..., None, :] > 0) & ok[..., None]
    counts = inl.sum(dim=-1)
    best = torch.argmax(counts, dim=-1)
    return pick(Es, best), pick(inl, best), pick(counts, best)
