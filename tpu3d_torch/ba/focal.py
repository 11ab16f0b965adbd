"""Shared-focal refinement (tpu3d/ba/focal.py).

The focal enters the problem only through the observation normalization
uv_norm = uv_px / f, so at fixed geometry the optimal f has a closed form,

    min_f Σ w ‖π(X_c) − uv_px / f‖²  ⇒  f* = Σ w ‖uv_px‖² / Σ w ⟨π, uv_px⟩.

Alternating BA at fixed f with that update stalls: BA absorbs most of a
focal error into a depth deformation. What stays observable is the
converged BA cost as a function of f, so the refinement is a golden-section
search of f ↦ min over the geometry of cost(f) on log f, each probe one
``bundle_adjust``, finished by the closed-form polish.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from tpu3d_torch import f32_scope
from tpu3d_torch.ba.lm import BAState, bundle_adjust
from tpu3d_torch.core.lie import so3_exp


def _optimal_focal(cams, points, cam_idx, pt_idx, uv_px, w) -> torch.Tensor:
    """Closed-form shared focal at fixed geometry. Observations behind
    their camera get zero weight: they would vote with inverted signs."""
    with f32_scope(), torch.no_grad():
        c = cams[cam_idx]
        R = so3_exp(c[:, :3])
        Xc = torch.einsum("oij,oj->oi", R, points[pt_idx]) + c[:, 3:6]
        z = Xc[:, 2]
        w_eff = w * (z > 1e-6)
        z_safe = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
        a = Xc[:, :2] / z_safe[:, None]
        num = torch.sum(w_eff * torch.sum(uv_px * uv_px, -1))
        den = torch.sum(w_eff * torch.sum(a * uv_px, -1))
        return num / torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12), den)


def refine_focal(
    cams0: torch.Tensor,
    points0: torch.Tensor,
    cam_idx: torch.Tensor,
    pt_idx: torch.Tensor,
    uv_px: torch.Tensor,
    w: torch.Tensor,
    cam_fixed: torch.Tensor,
    focal0: float,
    pt_fixed: Optional[torch.Tensor] = None,
    search_span: float = 0.5,
    iters: int = 24,
    max_iters: int = 12,
    cg_iters: int = 24,
) -> Tuple[float, BAState]:
    """Golden-section shared-focal refinement over log f in focal0 ×
    [1/(1+span), 1+span], ``iters`` section steps, then the closed-form
    polish: iters + 4 bundle_adjust solves in all. The observation layout
    is bundle_adjust's, except that uv_px is in pixels (centred). Returns
    (refined focal, the BAState at it)."""

    def solve(f: float) -> BAState:
        return bundle_adjust(cams0, points0, cam_idx, pt_idx, uv_px / f, w, cam_fixed,
                             pt_fixed, max_iters=max_iters, cg_iters=cg_iters)

    lo = math.log(focal0 / (1.0 + search_span))
    hi = math.log(focal0 * (1.0 + search_span))
    invphi = (5.0 ** 0.5 - 1.0) / 2.0
    a = hi - invphi * (hi - lo)
    b = lo + invphi * (hi - lo)
    fa = float(solve(math.exp(a)).cost)
    fb = float(solve(math.exp(b)).cost)
    for _ in range(iters):
        if fa < fb:
            hi, b, fb = b, a, fa
            a = hi - invphi * (hi - lo)
            fa = float(solve(math.exp(a)).cost)
        else:
            lo, a, fa = a, b, fb
            b = lo + invphi * (hi - lo)
            fb = float(solve(math.exp(b)).cost)
    st = solve(math.exp((lo + hi) / 2.0))
    f = float(_optimal_focal(st.cams, st.points, cam_idx, pt_idx, uv_px, w))
    return f, solve(f)
