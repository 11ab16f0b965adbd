"""Mutual-nearest-neighbor descriptor matching with the Lowe ratio test
(tpu3d/matching/mnn.py), batched over a leading pair axis.

The similarity statistics come from ``descriptor_top2``: on the card the
``top2_kernel`` runs twice per block, once as is and once with the roles
swapped for the column argmax; the ratio, mutual and ``s1 > neg + 1`` tests
then run in torch exactly as mnn.py:54-69 does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from tpu3d_torch.kernels.distance import NEG, descriptor_top2


class MatchResult(NamedTuple):
    idx0: torch.Tensor     # (..., K) index into set 0 for each slot
    idx1: torch.Tensor     # (..., K) matched index into set 1
    valid: torch.Tensor    # (..., K) bool
    score: torch.Tensor    # (..., K) cosine similarity of the match


def match_descriptors(
    d0: torch.Tensor,
    d1: torch.Tensor,
    valid0: torch.Tensor,
    valid1: torch.Tensor,
    ratio: float = 0.95,
) -> MatchResult:
    """Mutual-NN + ratio-test matching of L2-normalized descriptors.

    d0: (B, K0, D) or (K0, D), d1: (B, K1, D) or (K1, D); valid masks gate
    padded slots. Slot i of the output is keypoint i of set 0."""
    single = d0.dim() == 2
    if single:
        d0, d1, valid0, valid1 = d0[None], d1[None], valid0[None], valid1[None]
    d0 = d0.float().contiguous()
    d1 = d1.float().contiguous()
    v0 = valid0.float().contiguous()
    v1 = valid1.float().contiguous()
    s1, s2, best1 = descriptor_top2(d0, d1, v0, v1)
    _, _, best0_of_1 = descriptor_top2(d1, d0, v1, v0)
    best1 = best1.long()
    dist1 = torch.clamp(2.0 - 2.0 * s1, min=0.0)
    dist2 = torch.clamp(2.0 - 2.0 * s2, min=0.0)
    ratio_ok = dist1 < (ratio * ratio) * dist2
    K0 = d0.shape[1]
    idx0 = torch.arange(K0, device=d0.device)
    mutual = torch.gather(best0_of_1.long(), 1, best1) == idx0[None, :]
    valid = (v0 > 0) & mutual & ratio_ok & (s1 > NEG + 1.0)
    res = MatchResult(
        idx0=idx0.to(torch.int32).expand(d0.shape[0], K0),
        idx1=best1.to(torch.int32),
        valid=valid,
        score=s1,
    )
    if single:
        res = MatchResult(*(t[0] for t in res))
    return res
