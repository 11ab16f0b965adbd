"""Robust essential-matrix estimation (tpu3d/geometry/estimators.py):
hypothesis sampling, batched 8-point solves, Sampson scoring, a LO-RANSAC
round, guarded least-squares refits, pose decomposition and the cheirality
vote, batched over any leading dimensions (the pairs of a match block)."""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from tpu3d_torch.geometry.epipolar import (essential_eight_point,
                                           project_to_essential, sampson_error)
from tpu3d_torch.geometry.fivepoint import _project_essential_fast
from tpu3d_torch.geometry.pose import recover_pose
from tpu3d_torch.geometry.ransac import _sample_indices, ransac, take_points

E_SAMPLE_SIZE = 8


class EssentialResult(NamedTuple):
    E: torch.Tensor            # (..., 3, 3)
    R: torch.Tensor            # (..., 3, 3) world->cam1 (cam0 = I)
    t: torch.Tensor            # (..., 3) unit translation
    inliers: torch.Tensor      # (..., N) bool — Sampson inliers of the refit E
    front: torch.Tensor        # (..., N) bool — cheirality-positive subset
    num_inliers: torch.Tensor  # (...) int


def lo_hypotheses(num_hypotheses: int) -> int:
    """Hypotheses of the LO-RANSAC round."""
    return max(num_hypotheses // 2, 64)


def find_essential_ransac(
    uv0: torch.Tensor,
    uv1: torch.Tensor,
    valid: torch.Tensor,
    focal: float,
    noise: Tuple[torch.Tensor, torch.Tensor],
    threshold_px: float = 1.0,
) -> EssentialResult:
    """Essential matrix + relative pose from (..., N, 2) centered pixel
    matches with a (..., N) mask. ``noise`` holds the Gumbel draws that
    pick the minimal samples (tpu3d draws them from its key): the main
    round's (..., M, N) and the LO round's (..., lo_hypotheses(M), N)."""
    x0 = uv0 / focal
    x1 = uv1 / focal
    thr = torch.tensor(threshold_px, dtype=torch.float32) / torch.tensor(focal, dtype=torch.float32)
    thr_sq = float(thr * thr)

    def solver(idx):
        # Hypotheses are projected onto the essential manifold before
        # scoring (closed form); winners keep the exact SVD below.
        F = essential_eight_point(take_points(x0, idx), take_points(x1, idx), project=False)
        return _project_essential_fast(F)

    def scorer(E):
        return sampson_error(E, x0[..., None, :, :], x1[..., None, :, :])

    def where(c, a, b):
        return torch.where(c.reshape(*c.shape, *([1] * (a.dim() - c.dim()))), a, b)

    E, inliers, count = ransac(_sample_indices(noise[0], valid, E_SAMPLE_SIZE),
                               solver, scorer, valid, thr_sq)
    # LO-RANSAC round: minimal samples drawn from the inlier set only.
    linl = inliers.to(x0.dtype)
    E2, inliers2, count2 = ransac(_sample_indices(noise[1], linl, E_SAMPLE_SIZE),
                                  solver, scorer, linl, thr_sq)
    better = count2 > count
    E = where(better, E2, E)
    inliers = where(better, inliers2, inliers)
    count = torch.maximum(count, count2)
    # Guarded least-squares refit over the whole inlier set.
    E3 = essential_eight_point(x0, x1, inliers.to(x0.dtype))
    inliers3 = (sampson_error(E3, x0, x1) < thr_sq) & (valid > 0)
    better3 = inliers3.sum(dim=-1) >= count
    E = where(better3, E3, E)
    inliers = where(better3, inliers3, inliers)
    # Project the winner exactly and refresh its consensus set.
    E = project_to_essential(E)
    inliers = (sampson_error(E, x0, x1) < thr_sq) & (valid > 0)
    count = inliers.sum(dim=-1)
    E4 = essential_eight_point(x0, x1, inliers.to(x0.dtype))
    inliers4 = (sampson_error(E4, x0, x1) < thr_sq) & (valid > 0)
    better4 = inliers4.sum(dim=-1) >= count
    E = where(better4, E4, E)
    inliers = where(better4, inliers4, inliers)
    R, t, front = recover_pose(E, x0, x1, inliers.to(x0.dtype))
    return EssentialResult(E, R, t, inliers, front & inliers, inliers.sum(dim=-1))
