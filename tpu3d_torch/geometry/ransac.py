"""Batched-hypothesis RANSAC (tpu3d/geometry/ransac.py).

A fixed budget of minimal samples is drawn up front, every hypothesis is
solved and scored in one batch, and the inlier count's argmax wins. Leading
batch dimensions (the pairs of a match block) ride along everywhere.

Samples are drawn with the Gumbel-top-k trick from noise that the caller
passes in: :func:`gumbel` makes it from a ``torch.Generator`` (the
pipeline, one generator per edge), and a test can pass tpu3d's
``jax.random.gumbel`` draws instead, which gives tpu3d's indices.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch


def gumbel(generator: torch.Generator, shape: Sequence[int],
           device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(U)) with U in [tiny, 1)."""
    u = torch.rand(tuple(shape), generator=generator, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _sample_indices(noise: torch.Tensor, valid: torch.Tensor,
                    sample_size: int) -> torch.Tensor:
    """(..., M, s) indices without replacement from the valid set: the
    top-s of (..., M, N) Gumbel noise with invalid entries at -inf, in
    descending-noise order as tpu3d's ``lax.top_k``."""
    g = torch.where(valid[..., None, :] > 0, noise,
                    torch.full_like(noise, float("-inf")))
    return torch.topk(g, sample_size, dim=-1).indices


def pick(x: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """x[..., best, ...]: select one entry along the axis after best's
    dimensions. x: (*lead, M, *rest), best: lead-shaped int."""
    lead = best.shape
    xf = x.reshape(-1, *x.shape[len(lead):])
    out = xf[torch.arange(xf.shape[0], device=x.device), best.reshape(-1)]
    return out.reshape((*lead, *x.shape[len(lead) + 1:]))


def take_points(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather points: x (..., N, C), idx (..., M, s) -> (..., M, s, C)."""
    lead = x.shape[:-2]
    M, s = idx.shape[-2:]
    C = x.shape[-1]
    flat = idx.reshape(*lead, M * s, 1).expand(*lead, M * s, C)
    return torch.gather(x, -2, flat).reshape(*lead, M, s, C)


def ransac(
    idx: torch.Tensor,
    solver: Callable[[torch.Tensor], torch.Tensor],
    scorer: Callable[[torch.Tensor], torch.Tensor],
    valid: torch.Tensor,
    threshold_sq,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Generic batched RANSAC over given sample indices.

    idx: (..., M, s) minimal-sample indices; solver maps them to models
    (..., M, *model); scorer maps models to (..., M, N) squared errors;
    valid: (..., N) 0/1 mask. Returns (best_model, inliers (..., N) bool,
    count (...))."""
    models = solver(idx)
    errors = scorer(models)
    inliers = (errors < threshold_sq) & (valid[..., None, :] > 0)
    counts = inliers.sum(dim=-1)
    best = torch.argmax(counts, dim=-1)
    return pick(models, best), pick(inliers, best), pick(counts, best)
