"""SuperPoint, the second learned detector/descriptor
(tpu3d/features/superpoint.py), as a torch module.

A VGG-style backbone (64-64 / 64-64 / 128-128 / 128-128 with 2x2 max
pools), a 65-channel cell-softmax detection head unfolded to full
resolution, iterative max-pool NMS, and a 256-D descriptor head sampled
bilinearly at the keypoints with tpu3d's own formula. The module is NCHW;
``extract_superpoint`` takes tpu3d's (B, H, W) images.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch
from torch import nn

from tpu3d_torch.features.disk import top_k_stable
from tpu3d_torch.features.learned import state_dict_from_tree

_CONVS = (("conv1a", 1, 64, 3), ("conv1b", 64, 64, 3), ("conv2a", 64, 64, 3),
          ("conv2b", 64, 64, 3), ("conv3a", 64, 128, 3), ("conv3b", 128, 128, 3),
          ("conv4a", 128, 128, 3), ("conv4b", 128, 128, 3), ("convPa", 128, 256, 3),
          ("convPb", 256, 65, 1), ("convDa", 128, 256, 3), ("convDb", 256, 256, 1))


class SuperPointNet(nn.Module):
    """Backbone + heads. (B, 1, H, W) in [0, 1], H and W multiples of 8 ->
    (scores (B, H, W), desc_map (B, 256, H/8, W/8), unit per cell)."""

    def __init__(self):
        super().__init__()
        for name, cin, cout, k in _CONVS:
            self.add_module(name, nn.Conv2d(cin, cout, k, padding=k // 2))

    def forward(self, x: torch.Tensor):
        relu = torch.relu
        for i, pair in enumerate((("conv1a", "conv1b"), ("conv2a", "conv2b"),
                                  ("conv3a", "conv3b"), ("conv4a", "conv4b"))):
            for name in pair:
                x = relu(getattr(self, name)(x))
            if i < 3:
                x = nn.functional.max_pool2d(x, 2)
        logits = self.convPb(relu(self.convPa(x)))          # (B, 65, h, w)
        probs = torch.softmax(logits, dim=1)[:, :64]
        b, _, h, w = probs.shape
        scores = probs.reshape(b, 8, 8, h, w).permute(0, 3, 1, 4, 2).reshape(b, h * 8, w * 8)
        desc = self.convDb(relu(self.convDa(x)))
        desc = desc / torch.clamp(torch.linalg.norm(desc, dim=1, keepdim=True), min=1e-9)
        return scores, desc


def simple_nms(scores: torch.Tensor, radius: int) -> torch.Tensor:
    """Iterative max-pool NMS (the torch reference's superpoint.py:50-65),
    on (B, H, W)."""
    win = 2 * radius + 1

    def maxpool(x):
        return nn.functional.max_pool2d(x[:, None], win, stride=1, padding=radius)[:, 0]

    zeros = torch.zeros_like(scores)
    max_mask = scores == maxpool(scores)
    for _ in range(2):
        supp_mask = maxpool(max_mask.to(scores.dtype)) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == maxpool(supp_scores)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask, scores, zeros)


class SuperPointFeatures(NamedTuple):
    keypoints: torch.Tensor    # (B, K, 2) pixel (x, y)
    scores: torch.Tensor       # (B, K)
    descriptors: torch.Tensor  # (B, K, 256)
    valid: torch.Tensor        # (B, K)


def _sample_desc(desc_map: torch.Tensor, kpts: torch.Tensor, s: int = 8) -> torch.Tensor:
    """Bilinear descriptors at pixel keypoints, tpu3d's formula
    (superpoint.py:82-102: align-corners cell coordinates, the lower corner
    clipped to [0, size - 2]). desc_map: (B, h, w, C); kpts: (B, K, 2) ->
    (B, K, C), unit."""
    B, h, w, C = desc_map.shape
    kp = kpts - s / 2 + 0.5
    gx = kp[..., 0] / (w * s - s / 2 - 0.5) * (w - 1)
    gy = kp[..., 1] / (h * s - s / 2 - 0.5) * (h - 1)
    x0 = torch.clamp(torch.floor(gx).to(torch.int64), 0, w - 2)
    y0 = torch.clamp(torch.floor(gy).to(torch.int64), 0, h - 2)
    fx = (gx - x0)[..., None]
    fy = (gy - y0)[..., None]
    flat = desc_map.reshape(B, h * w, C)

    def at(y, x):
        return torch.gather(flat, 1, (y * w + x)[..., None].expand(-1, -1, C))

    d = (at(y0, x0) * (1 - fy) * (1 - fx) + at(y0, x0 + 1) * (1 - fy) * fx
         + at(y0 + 1, x0) * fy * (1 - fx) + at(y0 + 1, x0 + 1) * fy * fx)
    return d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-9)


def extract_superpoint(net: SuperPointNet, images_gray: torch.Tensor,
                       max_keypoints: int = 2048, nms_radius: int = 4,
                       detection_threshold: float = 0.0005,
                       remove_borders: int = 4) -> SuperPointFeatures:
    """(B, H, W) grey images in [0, 1] -> fixed-K SuperPoint features."""
    B, H, W = images_gray.shape
    scores, desc_map = net(images_gray[:, None])
    scores = simple_nms(scores, nms_radius)
    if remove_borders:
        p = remove_borders
        mask = torch.zeros((H, W), dtype=torch.bool, device=scores.device)
        mask[p:H - p, p:W - p] = True
        scores = torch.where(mask[None], scores, torch.zeros_like(scores))
    vals, idx = top_k_stable(scores.reshape(B, -1), max_keypoints)
    kpts = torch.stack([(idx % W).to(torch.float32), (idx // W).to(torch.float32)], dim=-1)
    valid = vals > detection_threshold
    desc = _sample_desc(desc_map.permute(0, 2, 3, 1), kpts)
    return SuperPointFeatures(kpts, torch.where(valid, vals, torch.zeros_like(vals)),
                              desc * valid[..., None], valid)


# tpu3d's SuperPointNet param tree (numpy) as SuperPointNet's state_dict
superpoint_params_from_tpu3d = state_dict_from_tree


def convert_torch_state_dict(sd: Dict[str, Any]) -> Dict[str, Any]:
    """The torch SuperPoint state_dict (conv1a..conv4b, convPa/Pb/Da/Db) as
    tpu3d's SuperPointNet param tree (OIHW -> HWIO)."""

    def t(k):
        v = sd[k]
        return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)

    return {"params": {name: {"kernel": np.transpose(t(f"{name}.weight"), (2, 3, 1, 0)),
                              "bias": t(f"{name}.bias")} for name, *_ in _CONVS}}
