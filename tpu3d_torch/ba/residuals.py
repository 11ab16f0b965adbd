"""Reprojection residuals and per-observation Jacobian blocks
(tpu3d/ba/residuals.py).

Observation layout (the BA problem, one row per observation):
  cam_idx (O,) int  camera id;   pt_idx (O,) int  point id
  uv      (O, 2)    focal-normalized centered observation
  w       (O,)      0/1 weight
Camera parametrization (6,) = [so3_log(R), t], world -> camera.
"""
from __future__ import annotations

from typing import Tuple

import torch

from tpu3d_torch.core.lie import so3_exp, so3_exp_jacobian


def _safe_z(z: torch.Tensor) -> torch.Tensor:
    eps = torch.full_like(z, 1e-8)
    return torch.where(z.abs() < 1e-8, torch.where(z < 0, -eps, eps), z)


def _residual_one(cam: torch.Tensor, X: torch.Tensor, uv: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """One observation's (2,) masked residual; ``torch.func.jacfwd`` of it
    is the test oracle of :func:`observation_jacobians`."""
    Xc = so3_exp(cam[:3]) @ X + cam[3:6]
    return (Xc[:2] / _safe_z(Xc[2]) - uv) * w


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M (..., a, b) times v (..., b): an elementwise product summed over
    its last axis. cuBLAS's batched matrix-vector kernels round a row
    differently with the batch's size; this reduction's order depends on
    the length of the summed axis alone, so a bundle adjustment solved in a
    batch gives the bits it gives alone."""
    return (M * v[..., None, :]).sum(-1)


def reprojection_residuals(cams, points, cam_idx, pt_idx, uv, w) -> torch.Tensor:
    """(O, 2) masked residuals."""
    R = so3_exp(cams[:, :3])[cam_idx]
    Xc = _mv(R, points[pt_idx]) + cams[cam_idx, 3:6]
    return (Xc[:, :2] / _safe_z(Xc[:, 2:3]) - uv) * w[:, None]


def observation_jacobians(cams, points, cam_idx, pt_idx, uv, w
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Residuals and exact Jacobian blocks: (r (O, 2), Jc (O, 2, 6),
    Jp (O, 2, 3)). R and dR/drvec are computed once per camera and
    gathered; per observation the closed-form pinhole chain rule:
        Xc = R X + t,  p = Xc[:2] / z,
        dp/dXc = [[1/z, 0, -x/z^2], [0, 1/z, -y/z^2]],
        Jp = dp/dXc R,  Jc_t = dp/dXc,  Jc_rvec[k] = dp/dXc (dR/drvec_k X)."""
    R = so3_exp(cams[:, :3])[cam_idx]
    dR = so3_exp_jacobian(cams[:, :3])[cam_idx]                 # (O, 3, 3, 3)
    X = points[pt_idx]
    Xc = _mv(R, X) + cams[cam_idx, 3:6]
    z_safe = _safe_z(Xc[:, 2])
    r = (Xc[:, :2] / z_safe[:, None] - uv) * w[:, None]
    inv_z = 1.0 / z_safe
    zero = torch.zeros_like(inv_z)
    dp = torch.stack([torch.stack([inv_z, zero, -Xc[:, 0] * inv_z * inv_z], -1),
                      torch.stack([zero, inv_z, -Xc[:, 1] * inv_z * inv_z], -1)], -2)
    dp = dp * w[:, None, None]
    Jp = _mv(R.transpose(-1, -2)[:, None], dp)                                  # dp R
    dXc = _mv(dR.transpose(-1, -2), X[:, None, :])                              # [a, k]
    Jc = torch.cat([_mv(dXc.transpose(-1, -2)[:, None], dp), dp], dim=-1)
    return r, Jc, Jp
