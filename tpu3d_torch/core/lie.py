"""SO(3)/SE(3) closed-form exp/log maps (tpu3d/core/lie.py): the torch
half, batched over leading dimensions, and numpy twins for host-side
bookkeeping. Small-angle branches are ``torch.where`` on guarded inputs, so
forward-mode derivatives (``torch.func.jacfwd``) stay finite at 0."""
from __future__ import annotations

import numpy as np
import torch


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle vector -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], -1),
                        torch.stack([wz, z, -wx], -1),
                        torch.stack([-wy, wx, z], -1)], -2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation (..., 3, 3):
    R = I + sinc(θ)[w]x + cosc(θ)[w]x², θ = |w|, with the Taylor branch
    below θ² = 1e-8 (tpu3d's double-where). θ² keeps a trailing axis: under
    forward-mode AD an op between a 0-dim tensor and a Python number
    promotes the tangent to float64."""
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    small = theta_sq < 1e-8
    theta_sq_safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(theta_sq_safe)
    sinc = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    cosc = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / theta_sq_safe)
    K = so3_hat(w)
    KK = K @ K
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + sinc[..., None] * K + cosc[..., None] * KK


def so3_exp_jacobian(w: torch.Tensor) -> torch.Tensor:
    """dR/dw of :func:`so3_exp`: (..., 3) -> (..., 3, 3, 3) indexed [row,
    column, parameter], in closed form (tpu3d takes ``jax.jacfwd`` of
    so3_exp; forward-mode AD through ``torch.func`` costs ~10 s of set-up on
    its first CUDA call). With a = sinc(θ), b = cosc(θ), K = [w]x and
    E_k = [e_k]x:
        dR/dw_k = w_k a'/θ K + a E_k + w_k b'/θ K² + b (E_k K + K E_k),
    a'/θ = (θ cos θ - sin θ)/θ³, b'/θ = (θ sin θ - 2(1 - cos θ))/θ⁴, and
    their Taylor limits -1/3, -1/12 below θ² = 1e-8."""
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    small = theta_sq < 1e-8
    tsq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    th = torch.sqrt(tsq)
    s, c = torch.sin(th), torch.cos(th)
    a = torch.where(small, 1.0 - theta_sq / 6.0, s / th)
    b = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - c) / tsq)
    da = torch.where(small, torch.full_like(th, -1.0 / 3.0), (th * c - s) / (tsq * th))
    db = torch.where(small, torch.full_like(th, -1.0 / 12.0), (th * s - 2.0 * (1.0 - c)) / (tsq * tsq))
    K = so3_hat(w)
    KK = K @ K
    E = so3_hat(torch.eye(3, dtype=w.dtype, device=w.device))          # (3, 3, 3): E[k]
    Kb = K[..., None, :, :]
    dR = ((da * w)[..., None, None] * Kb + a[..., None, None] * E
          + (db * w)[..., None, None] * KK[..., None, :, :]
          + b[..., None, None] * (E @ Kb + Kb @ E))                     # (..., k, 3, 3)
    return dR.movedim(-3, -1)


def rotation_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> unit quaternion (..., 4) as (w, x, y, z), w >= 0, by
    branch-free Shepperd's method."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qs = torch.stack([
        torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], -1),
        torch.stack([m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21], -1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11], -1),
    ], -2)
    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 + m11 - m00 - m22,
                          1.0 + m22 - m00 - m11], -1)
    best = torch.argmax(pivots, dim=-1)
    q = torch.gather(qs, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
    return torch.where(q[..., 0:1] < 0, -q, q)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) -> axis-angle (..., 3), by the quaternion route
    (stable near θ = π)."""
    q = rotation_to_quaternion(R)
    qw = torch.clamp(q[..., 0], -1.0, 1.0)
    qv = q[..., 1:]
    nv = torch.linalg.vector_norm(qv, dim=-1)
    theta = 2.0 * torch.atan2(nv, qw)
    small = nv < 1e-8
    scale = torch.where(small, 2.0 / torch.clamp(qw, min=1e-8),
                        theta / torch.where(small, torch.ones_like(nv), nv))
    return qv * scale[..., None]


def se3_apply(R: torch.Tensor, t: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """World -> camera: R X + t. R (..., 3, 3), t (..., 3), X (..., N, 3)
    or (..., 3)."""
    if X.dim() == R.dim() - 1:
        return torch.einsum("...ij,...j->...i", R, X) + t
    return torch.einsum("...ij,...nj->...ni", R, X) + t[..., None, :]


def se3_inverse(R: torch.Tensor, t: torch.Tensor):
    Rt = R.transpose(-1, -2)
    return Rt, -torch.einsum("...ij,...j->...i", Rt, t)


def so3_exp_np(w) -> np.ndarray:
    """Rodrigues: axis-angle (3,) -> rotation (3, 3) float32."""
    w = np.asarray(w, np.float64)
    theta = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if theta < 1e-8:
        return (np.eye(3) + K + 0.5 * K @ K).astype(np.float32)
    a = np.sin(theta) / theta
    b = (1 - np.cos(theta)) / theta**2
    return (np.eye(3) + a * K + b * K @ K).astype(np.float32)


def so3_log_np(R) -> np.ndarray:
    """Rotation (3, 3) -> axis-angle (3,) float32, by the quaternion route."""
    R = np.asarray(R, np.float64)
    tr = np.trace(R)
    q = np.empty(4)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q[:] = [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s]
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12)) * 2
        qv = np.empty(3)
        qv[i] = 0.25 * s
        qv[j] = (R[j, i] + R[i, j]) / s
        qv[k] = (R[k, i] + R[i, k]) / s
        q[:] = [(R[k, j] - R[j, k]) / s, *qv]
    if q[0] < 0:
        q = -q
    nv = np.linalg.norm(q[1:])
    if nv < 1e-12:
        return np.zeros(3, np.float32)
    theta = 2.0 * np.arctan2(nv, q[0])
    return (q[1:] / nv * theta).astype(np.float32)
