"""DISK, the learned feature extractor (tpu3d/features/disk.py), as torch
modules.

A thin U-Net over RGB (the kornia/DISK 'depth' network the reference loads,
feature_extraction.py:10): down channels [16, 32, 64, 64, 64], up channels
[64, 64, 64, 129], 5x5 convolutions, instance norm (biased variance, eps
1e-5, no affine) and per-channel PReLU, 2x2 average pooling down, nearest
x2 up, the skip concatenated after the upsampled map, a last 1x1
convolution to 128 descriptor channels + 1 heatmap. Keypoints: 5x5 window
NMS on the heatmap and the top K, descriptors read at the keypoints and
L2-normalised. The modules are NCHW; ``extract_disk`` takes tpu3d's
(B, H, W, 3) images.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from tpu3d_torch.features.learned import state_dict_from_tree


class ConvGN(nn.Module):
    """5x5 convolution + instance norm + per-channel PReLU (one block)."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, 5, padding=2)
        self.prelu_alpha = nn.Parameter(torch.full((features,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(2, 3), keepdim=True)
        x = (x - mean) * torch.rsqrt(var + 1e-5)
        return torch.where(x >= 0, x, self.prelu_alpha[:, None, None] * x)


class DiskUNet(nn.Module):
    """Thin U-Net: (B, 3, H, W) in [0, 1], H and W multiples of 16 ->
    (B, 129, H, W). Submodules carry tpu3d's parameter names (down_i,
    up_i, up_3_conv)."""

    def __init__(self, down_channels: Tuple[int, ...] = (16, 32, 64, 64, 64),
                 up_channels: Tuple[int, ...] = (64, 64, 64, 129)):
        super().__init__()
        self.n_down, self.n_up = len(down_channels), len(up_channels)
        ch = 3
        for i, c in enumerate(down_channels):
            self.add_module(f"down_{i}", ConvGN(ch, c))
            ch = c
        for i, c in enumerate(up_channels):
            ch += down_channels[self.n_down - 2 - i]
            if i == self.n_up - 1:
                self.add_module(f"up_{i}_conv", nn.Conv2d(ch, c, 1))
            else:
                self.add_module(f"up_{i}", ConvGN(ch, c))
            ch = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for i in range(self.n_down):
            if i > 0:
                x = nn.functional.avg_pool2d(x, 2)
            x = getattr(self, f"down_{i}")(x)
            skips.append(x)
        for i in range(self.n_up):
            x = nn.functional.interpolate(x, scale_factor=2, mode="nearest")
            x = torch.cat([x, skips[self.n_down - 2 - i]], dim=1)
            x = getattr(self, f"up_{i}_conv" if i == self.n_up - 1 else f"up_{i}")(x)
        return x


class DiskFeatures(NamedTuple):
    keypoints: torch.Tensor    # (B, K, 2) pixel (x, y)
    scores: torch.Tensor       # (B, K)
    descriptors: torch.Tensor  # (B, K, 128)
    valid: torch.Tensor        # (B, K)


def top_k_stable(flat: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest of each row, equal values in
    ascending index order, as jax.lax.top_k orders them (torch.topk
    promises no order among ties, and every suppressed slot ties at the
    same value)."""
    vals, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def detect_from_heatmap(heatmap: torch.Tensor, desc_map: torch.Tensor,
                        max_keypoints: int = 2048, window: int = 5,
                        threshold: float = 0.0) -> DiskFeatures:
    """Window NMS + top K on the heatmap (kornia's heatmap_to_keypoints,
    fixed-shape). heatmap: (B, H, W); desc_map: (B, C, H, W). A keypoint
    is valid where its score is finite, that is a window maximum above
    ``threshold``."""
    B, H, W = heatmap.shape
    pooled = nn.functional.max_pool2d(heatmap[:, None], window, stride=1,
                                      padding=window // 2)[:, 0]
    score = torch.where((heatmap >= pooled) & (heatmap > threshold), heatmap,
                        torch.full_like(heatmap, float("-inf")))
    vals, idx = top_k_stable(score.reshape(B, -1), max_keypoints)
    ys, xs = idx // W, idx % W
    valid = torch.isfinite(vals)
    C = desc_map.shape[1]
    desc = torch.gather(desc_map.reshape(B, C, H * W), 2, idx[:, None, :].expand(B, C, -1))
    desc = desc.transpose(1, 2)
    desc = desc / torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True), min=1e-9)
    kp = torch.stack([xs, ys], dim=-1).to(torch.float32)
    return DiskFeatures(kp, torch.where(valid, vals, torch.zeros_like(vals)),
                        desc * valid[..., None], valid)


def extract_disk(net: DiskUNet, images_rgb: torch.Tensor, max_keypoints: int = 2048,
                 window: int = 5) -> DiskFeatures:
    """DISK on (B, H, W, 3) float images in [0, 1], H and W multiples of 16
    (pad beforehand, as the reference's DISK does)."""
    out = net(images_rgb.permute(0, 3, 1, 2))
    return detect_from_heatmap(out[:, 128], out[:, :128], max_keypoints, window)


# tpu3d's DiskUNet param tree (numpy) as DiskUNet's state_dict
disk_params_from_tpu3d = state_dict_from_tree


def convert_kornia_state_dict(sd: Dict[str, Any]) -> Dict[str, Any]:
    """A kornia.feature.DISK state_dict as tpu3d's DiskUNet param tree
    (tpu3d/features/disk.py:125-176): unet.path_down.{i}... /
    unet.path_up.{i}... convolutions (OIHW -> HWIO) and PReLU gates, under
    kornia >= 0.7's thin-unet naming or the older one."""

    def t(k):
        v = sd[k]
        return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)

    def conv(k):
        return np.transpose(t(k + ".weight"), (2, 3, 1, 0)), t(k + ".bias")

    def alpha(base, n):
        gate = base.rsplit(".conv", 1)[0] + ".gate"
        a = t(gate + ".weight") if gate + ".weight" in sd else np.full(n, 0.25, np.float32)
        return a.reshape(-1)

    keys = list(sd.keys())

    def find(prefix_opts):
        for pre in prefix_opts:
            if any(k.startswith(pre) for k in keys):
                return pre
        raise KeyError(f"none of {prefix_opts} in checkpoint")

    p: Dict[str, Any] = {}
    down_pre = find(["unet.path_down", "unet.down"])
    up_pre = find(["unet.path_up", "unet.up"])
    for i in range(5):
        cands = [f"{down_pre}.{i}.1.conv", f"{down_pre}.{i}.0.conv", f"{down_pre}.{i}.conv"]
        base = next(c for c in cands if c + ".weight" in sd)
        w, b = conv(base)
        p[f"down_{i}"] = {"conv": {"kernel": w, "bias": b}, "prelu_alpha": alpha(base, w.shape[-1])}
    for i in range(4):
        cands = [f"{up_pre}.{i}.1.conv", f"{up_pre}.{i}.conv", f"{up_pre}.{i}.0.conv"]
        base = next((c for c in cands if c + ".weight" in sd), None)
        if base is None:  # the last 1x1 projection
            base = next(c for c in [f"{up_pre}.{i}.1", f"{up_pre}.{i}"] if c + ".weight" in sd)
            w, b = conv(base)
            p[f"up_{i}_conv"] = {"kernel": w, "bias": b}
            continue
        w, b = conv(base)
        if i == 3:
            p[f"up_{i}_conv"] = {"kernel": w, "bias": b}
        else:
            p[f"up_{i}"] = {"conv": {"kernel": w, "bias": b}, "prelu_alpha": alpha(base, w.shape[-1])}
    return {"params": p}
