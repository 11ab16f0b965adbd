"""Levenberg-Marquardt bundle adjustment with a camera-reduced Schur
complement, solved matrix-free by block-Jacobi preconditioned conjugate
gradients (tpu3d/ba/lm.py).

The normal equations have the arrow structure [[U, W], [Wᵀ, V]] with U
block-diagonal over cameras (6x6) and V over points (3x3). CG runs on
S = U - W V⁻¹ Wᵀ without forming it: one S·x is two segment sums over the
observations and two batched block products. Segment sums are
``index_add_``. The LM loop and CG stop early as tpu3d's while loops do
(the loop conditions read back one scalar each); a rejected step reuses
the previous blocks, since the state did not move.

tpu3d's ``seg_matmul`` (cam-axis sums as one-hot matmuls) and
``flat_layout`` (component-packed blocks) are variants it measured and
rejected on the TPU (tpu3d/ba/lm.py:177-199); they are not ported and
raise if asked for.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tpu3d_torch import f32_scope
from tpu3d_torch.ba.residuals import observation_jacobians, reprojection_residuals


class BAState(NamedTuple):
    cams: torch.Tensor     # (C, 6) [rvec | t]
    points: torch.Tensor   # (P, 3)
    cost: torch.Tensor     # final (robustified) cost
    lam: torch.Tensor      # final damping
    n_iters: int           # LM iterations run


def ba_cost(cams, points, cam_idx, pt_idx, uv, w) -> torch.Tensor:
    r = reprojection_residuals(cams, points, cam_idx, pt_idx, uv, w)
    return torch.sum(r * r)


def _seg_sum(x: torch.Tensor, idx: torch.Tensor, num: int) -> torch.Tensor:
    return torch.zeros((num, *x.shape[1:]), dtype=x.dtype, device=x.device).index_add_(0, idx, x)


def _spd_inv3(V: torch.Tensor, damp: torch.Tensor) -> torch.Tensor:
    """Batched inverse of damped 3x3 SPD blocks (adjugate closed form)."""
    A = V + damp[..., None, None] * torch.eye(3, dtype=V.dtype, device=V.device)
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    det = a * co00 + b * co01 + c * co02
    det = torch.where(det.abs() < 1e-12, 1e-12, det)
    inv = torch.stack([torch.stack([co00, co01, co02], -1),
                       torch.stack([co01, co11, co12], -1),
                       torch.stack([co02, co12, co22], -1)], -2)
    return inv / det[..., None, None]


def bundle_adjust(
    cams0: torch.Tensor,
    points0: torch.Tensor,
    cam_idx: torch.Tensor,
    pt_idx: torch.Tensor,
    uv: torch.Tensor,
    w: torch.Tensor,
    cam_fixed: torch.Tensor,
    pt_fixed: Optional[torch.Tensor] = None,
    max_iters: int = 20,
    cg_iters: int = 32,
    lam0: float = 1e-3,
    robust_delta: Optional[float] = None,
    cg_tol: float = 1e-3,
    stall_tol: float = 1e-5,
    pt_sorted: bool = False,
    reuse_blocks: bool = True,
    seg_matmul: Optional[bool] = None,
    flat_layout: Optional[bool] = None,
) -> BAState:
    """Joint pose + structure refinement of cams0 (C, 6) and points0
    (P, 3) over the observations (cam_idx, pt_idx, uv, w), with cam_fixed
    (C,) and pt_fixed (P,) 1 where frozen. robust_delta turns on Huber IRLS
    (in focal-normalized units). Stops after max_iters LM iterations or 3
    in a row without a relative cost drop beyond stall_tol; CG stops at
    cg_iters or at a preconditioned residual below cg_tol of the start.
    ``pt_sorted`` is accepted for tpu3d's signature (a gather hint there)."""
    if seg_matmul or flat_layout:
        raise NotImplementedError(
            "bundle_adjust: seg_matmul and flat_layout are tpu3d's measured-and-rejected "
            "TPU variants (tpu3d/ba/lm.py:177-199); the port has only the default path")
    del pt_sorted
    with f32_scope():
        return _bundle_adjust(cams0, points0, cam_idx.long(), pt_idx.long(), uv, w, cam_fixed,
                              pt_fixed, max_iters, cg_iters, lam0, robust_delta, cg_tol,
                              stall_tol, reuse_blocks)


def _bundle_adjust(cams0, points0, cam_idx, pt_idx, uv, w, cam_fixed, pt_fixed, max_iters,
                   cg_iters, lam0, robust_delta, cg_tol, stall_tol, reuse_blocks) -> BAState:
    C = cams0.shape[0]
    P = points0.shape[0]
    dtype, dev = points0.dtype, points0.device
    if pt_fixed is None:
        pt_fixed = torch.zeros((P,), dtype=dtype, device=dev)
    cam_free = (1.0 - cam_fixed.to(dtype))[:, None]
    # A point with no valid observation must not move (its V block is
    # singular): freeze it too.
    pt_free = (1.0 - pt_fixed.to(dtype))[:, None] * (_seg_sum(w, pt_idx, P) > 0).to(dtype)[:, None]
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    def seg_cam(x):
        return _seg_sum(x, cam_idx, C)

    def seg_pt(x):
        return _seg_sum(x, pt_idx, P)

    def compute_blocks(cams, points):
        r, Jc, Jp = observation_jacobians(cams, points, cam_idx, pt_idx, uv, w)
        if robust_delta is not None:
            rn = torch.linalg.vector_norm(r, dim=-1)
            w_rob = torch.sqrt(torch.clamp(robust_delta / torch.clamp(rn, min=1e-12), max=1.0))
            r = r * w_rob[:, None]
            Jc = Jc * w_rob[:, None, None]
            Jp = Jp * w_rob[:, None, None]
        Jc = Jc * cam_free[cam_idx][:, None, :]
        Jp = Jp * pt_free[pt_idx][:, None, :]
        return (seg_cam(torch.einsum("oia,oib->oab", Jc, Jc)),
                seg_pt(torch.einsum("oia,oib->oab", Jp, Jp)),
                torch.einsum("oia,oib->oab", Jc, Jp),
                seg_cam(torch.einsum("oia,oi->oa", Jc, r)),
                seg_pt(torch.einsum("oia,oi->oa", Jp, r)))

    def cost_of(cams, points):
        """The robustified objective when IRLS is on: a step down the Huber
        cost may raise the raw SSE."""
        r = reprojection_residuals(cams, points, cam_idx, pt_idx, uv, w)
        if robust_delta is None:
            return torch.sum(r * r)
        rn = torch.linalg.vector_norm(r, dim=-1)
        return torch.sum(torch.where(rn <= robust_delta, rn * rn,
                                     2 * robust_delta * rn - robust_delta ** 2))

    def lm_step(cams, points, lam, cost, blocks):
        Ucc, Vpp, Wcp, gc, gp = blocks
        damp_c = lam * (torch.diagonal(Ucc, dim1=-2, dim2=-1) + 1e-8)
        Vinv = _spd_inv3(Vpp, lam * (torch.diagonal(Vpp, dim1=-2, dim2=-1).mean(-1) + 1e-8))
        Vinv_gp = torch.einsum("pab,pb->pa", Vinv, gp)
        b = gc - seg_cam(torch.einsum("oab,ob->oa", Wcp, Vinv_gp[pt_idx]))

        def schur_matvec(x):
            a = torch.einsum("oab,oa->ob", Wcp, x[cam_idx])
            cp = torch.einsum("pab,pb->pa", Vinv, seg_pt(a))
            d = torch.einsum("oab,ob->oa", Wcp, cp[pt_idx])
            return torch.einsum("cab,cb->ca", Ucc, x) + damp_c * x - seg_cam(d)

        # Block-Jacobi preconditioner (U + damp)⁻¹, frozen cameras identity.
        Ud = Ucc + damp_c[..., None] * eye6
        Ud = Ud * cam_free[:, :, None] + eye6 * (1.0 - cam_free[:, :, None])
        Uinv = torch.linalg.inv(Ud)

        def precond(v):
            return torch.einsum("cab,cb->ca", Uinv, v) * cam_free

        # Preconditioned CG on S dc = b, stopping at ||r||_M <= cg_tol ||b||_M.
        x = torch.zeros_like(b)
        rr = b
        z = precond(b)
        p = z
        rz = torch.sum(b * z)
        stop = cg_tol * cg_tol * rz
        for _ in range(cg_iters):
            if not bool(rz > stop):
                break
            Ap = schur_matvec(p)
            pAp = torch.sum(p * Ap)
            alpha = rz / torch.where(pAp.abs() < 1e-20, 1e-20, pAp)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z = precond(rr)
            rz_new = torch.sum(rr * z)
            beta = rz_new / torch.where(rz.abs() < 1e-20, 1e-20, rz)
            p = z + beta * p
            rz = rz_new
        dc = x * cam_free
        # Back-substitute the points: dp = V⁻¹ (gp - Wᵀ dc).
        a = seg_pt(torch.einsum("oab,oa->ob", Wcp, dc[cam_idx]))
        dp = torch.einsum("pab,pb->pa", Vinv, gp - a) * pt_free
        new_cams = cams - dc
        new_points = points - dp
        new_cost = cost_of(new_cams, new_points)
        accept = bool(new_cost < cost)
        if accept:
            return new_cams, new_points, torch.clamp(lam / 3.0, min=1e-9), new_cost, True
        return cams, points, torch.clamp(lam * 4.0, max=1e6), cost, False

    cams, points = cams0, points0
    lam = torch.tensor(lam0, dtype=dtype, device=dev)
    cost = cost_of(cams, points)
    blocks = compute_blocks(cams, points)
    keep = 1.0 - torch.tensor(stall_tol, dtype=dtype, device=dev)
    stale = False
    it = stall = 0
    while it < max_iters and stall < 3:
        if stale or not reuse_blocks:
            blocks = compute_blocks(cams, points)
        prev = cost
        cams, points, lam, cost, stale = lm_step(cams, points, lam, cost, blocks)
        stall = 0 if bool(cost < prev * keep) else stall + 1
        it += 1
    return BAState(cams, points, cost, lam, it)
