"""DoG keypoint detection: batched extrema, NMS, sub-pixel refinement
(tpu3d/features/detector.py).

Fixed-shape and mask-based: each octave yields exactly k candidate slots
(scored 0 if absent). tpu3d refines every interior voxel densely and then
gathers the winners (``_dense_subpixel_offsets``); the port refines only the
k winners, fetching their 3x3x3 neighbourhoods in ONE ``patch_sample_kernel``
launch per octave at integer coordinates, where bilinear sampling is exact.
The arithmetic of the solve is the same, so the offsets agree.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from tpu3d_torch.kernels.patch_sample import sample_gradient_patches

_OFFS27 = [(ds, dy, dx) for ds in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


class OctaveKeypoints(NamedTuple):
    x: torch.Tensor        # (B, K) octave-local x (subpixel)
    y: torch.Tensor        # (B, K)
    scale: torch.Tensor    # (B, K) continuous scale index within octave
    score: torch.Tensor    # (B, K) |DoG| response, 0 for empty slots
    valid: torch.Tensor    # (B, K) bool


def _maxpool3d(x: torch.Tensor) -> torch.Tensor:
    """3x3x3 max over (S, H, W) of (B, S, H, W), -inf beyond the edges."""
    return F.max_pool3d(x[:, None], 3, stride=1, padding=1)[:, 0]


def _minpool3d(x: torch.Tensor) -> torch.Tensor:
    return -_maxpool3d(-x)


def _edge_mask(d: torch.Tensor, edge_threshold: float) -> torch.Tensor:
    """Reject edge-like responses via the 2x2 spatial Hessian ratio test.
    d: (B, S, H, W) DoG levels."""
    r_ = torch.roll
    dxx = r_(d, -1, -1) + r_(d, 1, -1) - 2 * d
    dyy = r_(d, -1, -2) + r_(d, 1, -2) - 2 * d
    dxy = 0.25 * (
        r_(r_(d, -1, -1), -1, -2)
        + r_(r_(d, 1, -1), 1, -2)
        - r_(r_(d, -1, -1), 1, -2)
        - r_(r_(d, 1, -1), -1, -2)
    )
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_threshold
    return (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)


def _neighbors27(dog: torch.Tensor, s: torch.Tensor, y: torch.Tensor,
                 x: torch.Tensor) -> dict:
    """3x3x3 DoG neighbourhoods of keypoints in one sampling call.

    dog: (L, H, W) level stack; s, y, x: (K,) integer level and pixel.
    Returns {(ds, dy, dx): (K,)}. Integer coordinates make the bilinear
    sample exact: the value is dog[s+ds, y+dy, x+dx] inside the stack."""
    dev = dog.device
    dys = torch.tensor([o[1] for o in _OFFS27], dtype=torch.float32, device=dev)
    dxs = torch.tensor([o[2] for o in _OFFS27], dtype=torch.float32, device=dev)
    dls = torch.tensor([o[0] for o in _OFFS27], dtype=torch.int32, device=dev)
    ys = (y.to(torch.float32)[:, None] + dys[None, :]).contiguous()
    xs = (x.to(torch.float32)[:, None] + dxs[None, :]).contiguous()
    vals = sample_gradient_patches(dog, None, ys, xs,
                                   s.to(torch.int32).contiguous(), dls)[:, 0]
    return {o: vals[:, i] for i, o in enumerate(_OFFS27)}


def _subpixel_offsets(dog, s, y, x) -> torch.Tensor:
    """3D quadratic refinement at integer extrema (s, y, x) of a DoG level
    stack. Returns (K, 3) offsets (s, y, x) clamped to ±0.6: a damped 3x3
    Newton solve in closed adjugate form."""
    nb = _neighbors27(dog, s, y, x)

    def at(ds, dy, dx):
        return nb[(ds, dy, dx)]

    c = at(0, 0, 0)
    gs = 0.5 * (at(1, 0, 0) - at(-1, 0, 0))
    gy = 0.5 * (at(0, 1, 0) - at(0, -1, 0))
    gx = 0.5 * (at(0, 0, 1) - at(0, 0, -1))
    hss = at(1, 0, 0) + at(-1, 0, 0) - 2 * c
    hyy = at(0, 1, 0) + at(0, -1, 0) - 2 * c
    hxx = at(0, 0, 1) + at(0, 0, -1) - 2 * c
    hsy = 0.25 * (at(1, 1, 0) - at(1, -1, 0) - at(-1, 1, 0) + at(-1, -1, 0))
    hsx = 0.25 * (at(1, 0, 1) - at(1, 0, -1) - at(-1, 0, 1) + at(-1, 0, -1))
    hyx = 0.25 * (at(0, 1, 1) - at(0, 1, -1) - at(0, -1, 1) + at(0, -1, -1))

    d = 1e-6
    a, b_, c_ = hss + d, hsy, hsx
    e, f = hyy + d, hyx
    i = hxx + d
    co00 = e * i - f * f
    co01 = c_ * f - b_ * i
    co02 = b_ * f - c_ * e
    co11 = a * i - c_ * c_
    co12 = b_ * c_ - a * f
    co22 = a * e - b_ * b_
    det = a * co00 + b_ * co01 + c_ * co02
    small = torch.where(det < 0, torch.full_like(det, -1e-12), torch.full_like(det, 1e-12))
    det = torch.where(det.abs() < 1e-12, small, det)
    off_s = -(co00 * gs + co01 * gy + co02 * gx) / det
    off_y = -(co01 * gs + co11 * gy + co12 * gx) / det
    off_x = -(co02 * gs + co12 * gy + co22 * gx) / det
    return torch.clamp(torch.stack([off_s, off_y, off_x], dim=-1), -0.6, 0.6)


def detect_octave(
    dog: torch.Tensor,
    k: int,
    contrast_threshold: float = 0.015,
    edge_threshold: float = 10.0,
    nms_radius: int = 2,
) -> OctaveKeypoints:
    """Top-k DoG extrema of one octave. dog: (B, S+2, H, W)."""
    B, Sp2, H, W = dog.shape
    S = Sp2 - 2
    interior = dog[:, 1: S + 1]
    is_max = interior >= _maxpool3d(dog)[:, 1: S + 1] - 1e-12
    is_min = interior <= _minpool3d(dog)[:, 1: S + 1] + 1e-12
    strong = interior.abs() > contrast_threshold
    not_edge = _edge_mask(interior, edge_threshold)
    mask = (is_max | is_min) & strong & not_edge
    score = interior.abs() * mask

    if nms_radius > 1:
        win = 2 * nms_radius + 1
        pooled = F.max_pool2d(score.reshape(B * S, 1, H, W), win, stride=1,
                              padding=nms_radius).reshape(B, S, H, W)
        score = torch.where(score >= pooled, score, torch.zeros_like(score))

    border = 8   # descriptor support must fit
    bm = torch.zeros((H, W), dtype=torch.bool, device=dog.device)
    bm[border: H - border, border: W - border] = True
    score = score * bm[None, None]

    # Exact top-k. tpu3d segments the sort (_topk_segmented) around a TPU
    # lowering problem; the set is the same. Order among ties is unspecified.
    vals, idx = torch.topk(score.reshape(B, -1), k, dim=1)
    s_idx = idx // (H * W)
    rem = idx % (H * W)
    y_idx = rem // W
    x_idx = rem % W

    # Refine the winners: one 27-point fetch over the (B*(S+2), H, W) stack.
    lvl = (torch.arange(B, device=dog.device)[:, None] * Sp2 + s_idx + 1).reshape(-1)
    off = _subpixel_offsets(dog.reshape(B * Sp2, H, W), lvl,
                            y_idx.reshape(-1), x_idx.reshape(-1)).reshape(B, k, 3)
    valid = vals > 0
    return OctaveKeypoints(
        x=x_idx.to(torch.float32) + off[..., 2],
        y=y_idx.to(torch.float32) + off[..., 1],
        scale=s_idx.to(torch.float32) + 1.0 + off[..., 0],
        score=torch.where(valid, vals, torch.zeros_like(vals)),
        valid=valid,
    )
