"""Classical feature front-end (tpu3d/features/frontend.py): batched
grayscale images in, a fixed-capacity :class:`FeatureSet` out — keypoints
in the centered y-up convention, pixel keypoints, L2-normalized 128-D
descriptors, scores, scales and validity."""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from tpu3d_torch import f32_scope, resolve_device
from tpu3d_torch.config import FrontendConfig
from tpu3d_torch.core.camera import pixel_to_centered
from tpu3d_torch.features.descriptor import (gradients, orient_and_describe,
                                             sift_descriptors)
from tpu3d_torch.features.detector import detect_octave
from tpu3d_torch.features.pyramid import build_pyramid


class FeatureSet(NamedTuple):
    keypoints: torch.Tensor     # (B, K, 2) centered y-up coords
    keypoints_px: torch.Tensor  # (B, K, 2) pixel coords (x, y)
    descriptors: torch.Tensor   # (B, K, 128)
    scores: torch.Tensor        # (B, K)
    scales: torch.Tensor        # (B, K) absolute sigma in full-res pixels
    valid: torch.Tensor         # (B, K) bool
    image_size: torch.Tensor    # (B, 2) = (W, H)


def _extract_f32(images, max_keypoints, num_octaves, scales_per_octave,
                 sigma0, contrast_threshold, edge_threshold, nms_radius,
                 upright=False, fused=None):
    """Detect per octave, merge the global top-K by score, then run
    orientation + descriptors once for the K winners against a gradient
    stack of every (image, octave, level)."""
    B, H, W = images.shape
    dev = images.device
    O = num_octaves
    S = scales_per_octave
    K = max_keypoints
    gauss, dogs = build_pyramid(images, O, S, sigma0)

    kps = [detect_octave(dogs[o], K, contrast_threshold, edge_threshold,
                         nms_radius) for o in range(O)]
    x = torch.cat([kp.x for kp in kps], dim=1)       # (B, O*K) octave-local
    y = torch.cat([kp.y for kp in kps], dim=1)
    score = torch.cat([kp.score for kp in kps], dim=1)
    scale_l = torch.cat([kp.scale for kp in kps], dim=1)
    valid = torch.cat([kp.valid for kp in kps], dim=1)
    oct_id = torch.arange(O, device=dev).repeat_interleave(K)

    top_score, top_idx = torch.topk(torch.where(valid, score, torch.zeros_like(score)), K, dim=1)
    x = torch.gather(x, 1, top_idx)
    y = torch.gather(y, 1, top_idx)
    scale_l = torch.gather(scale_l, 1, top_idx)
    oct = oct_id[top_idx]
    valid = top_score > 0

    # Gradient stack of levels 1..S of every (image, octave), each octave
    # zero-padded into the octave-0 frame. The padding is never sampled:
    # coordinates are clamped into the keypoint's own octave rectangle.
    gx_u = torch.zeros((B, O, S, H, W), dtype=torch.float32, device=dev)
    gy_u = torch.zeros_like(gx_u)
    for o in range(O):
        g = gauss[o][:, 1: S + 1]
        gx_o, gy_o = gradients(g)
        Ho, Wo = g.shape[-2:]
        gx_u[:, o, :, :Ho, :Wo] = gx_o
        gy_u[:, o, :, :Ho, :Wo] = gy_o
    gx_u = gx_u.reshape(B * O * S, H, W)
    gy_u = gy_u.reshape(B * O * S, H, W)

    lvl = torch.clamp(torch.round(scale_l).to(torch.int32), 1, S)
    sigma_local = sigma0 * (2.0 ** (scale_l / S))
    b_idx = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
    lvl_glob = ((b_idx * O + oct) * S + (lvl - 1)).reshape(-1).to(torch.int32)

    kx = x.reshape(-1)
    ky = y.reshape(-1)
    sig = sigma_local.reshape(-1)
    hs, ws = [float(H)], [float(W)]
    for _ in range(1, O):
        hs.append(float(-(-hs[-1] // 2)))
        ws.append(float(-(-ws[-1] // 2)))
    ymax = (torch.tensor(hs, dtype=torch.float32, device=dev)[oct] - 1.001).reshape(-1)
    xmax = (torch.tensor(ws, dtype=torch.float32, device=dev)[oct] - 1.001).reshape(-1)
    if upright:
        desc = sift_descriptors(gx_u, gy_u, kx, ky, lvl_glob, sig,
                                torch.zeros_like(sig), ymax, xmax)
    else:
        desc, _ = orient_and_describe(gx_u, gy_u, kx, ky, lvl_glob, sig,
                                      ymax, xmax, fused=fused)
    desc = desc.reshape(B, K, -1)

    factor = torch.exp2(oct.to(torch.float32))
    x = x * factor
    y = y * factor
    scale = sigma_local * factor

    kp_px = torch.stack([x, y], dim=-1)
    size = torch.tensor([W, H], dtype=torch.float32, device=dev).expand(B, 2)
    kp_centered = pixel_to_centered(kp_px, size[:, None, :])
    return FeatureSet(
        keypoints=kp_centered,
        keypoints_px=kp_px,
        descriptors=desc,
        scores=top_score,
        scales=scale,
        valid=valid,
        image_size=size.contiguous(),
    )


def extract_features(images, config: Optional[FrontendConfig] = None,
                     device="cuda") -> FeatureSet:
    """Extract features from a (B, H, W) batch: uint8, or float32 in [0, 1].
    ``patch_precision``/``orient_precision`` are accepted in the config and
    ignored: they select MXU passes on the TPU, and the port always samples
    in exact f32. ``fused_descriptor=True`` takes the fused orientation +
    descriptor pass (``orient_desc_kernel`` on the card);
    ``approx_topk_recall`` is not ported and raises."""
    cfg = config or FrontendConfig()
    if cfg.approx_topk_recall > 0.0:
        raise NotImplementedError("approx_topk_recall > 0 (lax.approx_max_k) is not "
                                  "ported; the port's detector takes the exact top-k")
    dev = resolve_device(device)
    images = torch.as_tensor(images).to(dev)
    if images.dtype == torch.uint8:
        images = images.to(torch.float32) / 255.0
    with f32_scope(), torch.no_grad():
        return _extract_f32(images.to(torch.float32).contiguous(),
                            cfg.max_keypoints, cfg.num_octaves,
                            cfg.scales_per_octave, cfg.sigma0,
                            cfg.contrast_threshold, cfg.edge_threshold,
                            cfg.nms_radius, cfg.upright, cfg.fused_descriptor)


def sample_colors(images_rgb, keypoints_px):
    """Per-keypoint color at the keypoint pixel, host-side numpy.
    images_rgb: (B, H, W, 3) uint8; keypoints_px: (B, K, 2)."""
    imgs = np.asarray(images_rgb)
    kp = np.asarray(keypoints_px)
    B, H, W, _ = imgs.shape
    xi = np.clip(np.round(kp[..., 0]).astype(np.int64), 0, W - 1)
    yi = np.clip(np.round(kp[..., 1]).astype(np.int64), 0, H - 1)
    return np.stack([imgs[b, yi[b], xi[b]] for b in range(B)])
