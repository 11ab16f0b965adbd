"""LightGlue, the attention matcher (tpu3d/matching/lightglue.py), as torch
modules.

Alternating self and cross attention layers (9 at the released depth, 4
heads, width 256) with rotary positional encoding from a learnable Fourier
projection of the normalised keypoints, then the dual-softmax +
matchability assignment. As in tpu3d every layer runs over a batch of
pairs (no early exit, no point pruning: fixed shapes), and padded
keypoints are masked out of the attention with -1e9, not -inf, so that a
fully masked row is a uniform softmax. The products run in full f32 inside
``f32_scope``. Submodules carry tpu3d's parameter names, so its param tree
loads through ``features.learned.state_dict_from_tree``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tpu3d_torch import resolve_device
from tpu3d_torch.features.learned import state_dict_from_tree

NEG = -1e9


def normalize_keypoints(kpts: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """Pixel keypoints (B, N, 2) into [-1, 1] by the image's larger half
    side; size (B, 2) = (W, H)."""
    shift = size / 2.0
    scale = size.amax(dim=-1, keepdim=True) / 2.0
    return (kpts - shift[..., None, :]) / scale[..., None]


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x = x.reshape(*x.shape[:-1], -1, 2)
    return torch.stack([-x[..., 1], x[..., 0]], dim=-1).reshape(*x.shape[:-2], -1)


def apply_rotary(freqs: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return t * freqs[0] + rotate_half(t) * freqs[1]


def _layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-6)      # Flax's default epsilon


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return nn.functional.gelu(x, approximate="none")


def _mask_keys(logits: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Logits (B, h, N, M) with the keys that ``mask`` (B, M) marks
    invalid set to -1e9."""
    if mask is None:
        return logits
    return torch.where(mask[:, None, None, :] > 0, logits, torch.full_like(logits, NEG))


class FourierPosEnc(nn.Module):
    """Learnable Fourier positional encoding: x (B, N, 2) -> (2, B, 1, N,
    f_dim), the cos / sin pair repeated by 2 along the last axis."""

    def __init__(self, f_dim: int):
        super().__init__()
        self.Wr = nn.Linear(2, f_dim // 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        proj = self.Wr(x)
        emb = torch.stack([torch.cos(proj), torch.sin(proj)], dim=0)[..., None, :, :]
        return torch.repeat_interleave(emb, 2, dim=-1)


class SelfBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.Wqkv = nn.Linear(dim, 3 * dim)
        self.out_proj = nn.Linear(dim, dim)
        self.ffn_0 = nn.Linear(2 * dim, 2 * dim)
        self.ffn_1 = _layer_norm(2 * dim)
        self.ffn_3 = nn.Linear(2 * dim, dim)

    def forward(self, x: torch.Tensor, enc: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, N, d = x.shape
        h = self.heads
        hd = d // h
        # the torch reference's layout: per head, (hd, 3) interleaved
        qkv = self.Wqkv(x).reshape(B, N, h, hd, 3).transpose(1, 2)   # (B, h, N, hd, 3)
        q, k, v = qkv[..., 0], qkv[..., 1], qkv[..., 2]
        q = apply_rotary(enc, q)
        k = apply_rotary(enc, k)
        logits = _mask_keys(torch.matmul(q, k.transpose(-1, -2)) / float(np.sqrt(hd)), mask)
        ctx = torch.matmul(torch.softmax(logits, dim=-1), v)          # (B, h, N, hd)
        msg = self.out_proj(ctx.transpose(1, 2).reshape(B, N, d))
        y = self.ffn_3(_gelu(self.ffn_1(self.ffn_0(torch.cat([x, msg], dim=-1)))))
        return x + y


class CrossBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_qk = nn.Linear(dim, dim)
        self.to_v = nn.Linear(dim, dim)
        self.to_out = nn.Linear(dim, dim)
        self.ffn_0 = nn.Linear(2 * dim, 2 * dim)
        self.ffn_1 = _layer_norm(2 * dim)
        self.ffn_3 = nn.Linear(2 * dim, dim)

    def forward(self, x0: torch.Tensor, x1: torch.Tensor,
                mask0: Optional[torch.Tensor] = None,
                mask1: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.heads
        d = x0.shape[-1]
        hd = d // h

        def split(t):
            return t.reshape(*t.shape[:-1], h, hd).transpose(1, 2)    # (B, h, N, hd)

        def merge(t):
            return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], d)

        qk0, qk1 = split(self.to_qk(x0)), split(self.to_qk(x1))
        v0, v1 = split(self.to_v(x0)), split(self.to_v(x1))
        s = (hd ** -0.5) ** 0.5
        sim = torch.matmul(qk0 * s, (qk1 * s).transpose(-1, -2))      # (B, h, M, N)
        attn01 = torch.softmax(_mask_keys(sim, mask1), dim=-1)
        attn10 = torch.softmax(_mask_keys(sim.transpose(-1, -2), mask0), dim=-1)
        m0 = self.to_out(merge(torch.matmul(attn01, v1)))
        m1 = self.to_out(merge(torch.matmul(attn10, v0)))

        def ffn(x, m):
            return x + self.ffn_3(_gelu(self.ffn_1(self.ffn_0(torch.cat([x, m], dim=-1)))))

        return ffn(x0, m0), ffn(x1, m1)


class MatchAssignment(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.final_proj = nn.Linear(dim, dim)
        self.matchability = nn.Linear(dim, 1)

    def forward(self, d0: torch.Tensor, d1: torch.Tensor,
                mask0: Optional[torch.Tensor] = None,
                mask1: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Log assignment (B, M+1, N+1); the last row and column are the
        log-probabilities of no match."""
        md0 = self.final_proj(d0) / self.dim ** 0.25
        md1 = self.final_proj(d1) / self.dim ** 0.25
        sim = torch.matmul(md0, md1.transpose(-1, -2))
        neg = torch.full_like(sim, NEG)
        if mask0 is not None:
            sim = torch.where(mask0[..., :, None] > 0, sim, neg)
        if mask1 is not None:
            sim = torch.where(mask1[..., None, :] > 0, sim, neg)
        z0, z1 = self.matchability(d0), self.matchability(d1)          # (B, M, 1)
        logsig = nn.functional.logsigmoid
        cert = logsig(z0) + logsig(z1).transpose(-1, -2)
        s0 = torch.log_softmax(sim, dim=2)
        s1 = torch.log_softmax(sim.transpose(-1, -2), dim=2).transpose(-1, -2)
        inner = s0 + s1 + cert
        # padded slots can carry high matchability: hard-mask them
        if mask0 is not None:
            inner = torch.where(mask0[..., :, None] > 0, inner, neg)
        if mask1 is not None:
            inner = torch.where(mask1[..., None, :] > 0, inner, neg)
        b, m, n = sim.shape
        scores = torch.zeros((b, m + 1, n + 1), dtype=sim.dtype, device=sim.device)
        scores[:, :m, :n] = inner
        scores[:, :-1, -1] = logsig(-z0[..., 0])
        scores[:, -1, :-1] = logsig(-z1[..., 0])
        return scores


class LightGlue(nn.Module):
    """The matcher: descriptors (B, N, input_dim), pixel keypoints and image
    sizes (W, H) of both images, optional validity masks -> log assignment
    (B, M+1, N+1)."""

    def __init__(self, input_dim: int = 128, dim: int = 256, n_layers: int = 9,
                 heads: int = 4):
        super().__init__()
        self.n_layers = n_layers
        if input_dim != dim:
            self.input_proj = nn.Linear(input_dim, dim)
        self.posenc = FourierPosEnc(dim // heads)
        for i in range(n_layers):
            self.add_module(f"self_attn_{i}", SelfBlock(dim, heads))
            self.add_module(f"cross_attn_{i}", CrossBlock(dim, heads))
        self.add_module(f"log_assignment_{n_layers - 1}", MatchAssignment(dim))

    def forward(self, kpts0, desc0, size0, kpts1, desc1, size1,
                mask0: Optional[torch.Tensor] = None, mask1: Optional[torch.Tensor] = None):
        k0 = normalize_keypoints(kpts0, size0)
        k1 = normalize_keypoints(kpts1, size1)
        proj = getattr(self, "input_proj", None)
        x0, x1 = (desc0, desc1) if proj is None else (proj(desc0), proj(desc1))
        enc0, enc1 = self.posenc(k0), self.posenc(k1)
        for i in range(self.n_layers):
            sb = getattr(self, f"self_attn_{i}")          # shared by both images
            x0, x1 = sb(x0, enc0, mask0), sb(x1, enc1, mask1)
            x0, x1 = getattr(self, f"cross_attn_{i}")(x0, x1, mask0, mask1)
        return getattr(self, f"log_assignment_{self.n_layers - 1}")(x0, x1, mask0, mask1)


def filter_matches(scores: torch.Tensor, threshold: float = 0.1):
    """Mutual argmax + threshold decoding of the (B, M+1, N+1) log
    assignment. Returns (m0 (B, M), m1 (B, N), mscores0, mscores1), -1
    where unmatched; equal maxima resolve to the lowest index."""
    inner = scores[:, :-1, :-1]
    max0 = inner.amax(dim=2)
    m0 = torch.argmax(inner, dim=2)
    m1 = torch.argmax(inner, dim=1)
    idx0 = torch.arange(inner.shape[1], device=scores.device)[None]
    idx1 = torch.arange(inner.shape[2], device=scores.device)[None]
    mutual0 = idx0 == torch.gather(m1, 1, m0)
    mutual1 = idx1 == torch.gather(m0, 1, m1)
    mscores0 = torch.where(mutual0, torch.exp(max0), torch.zeros_like(max0))
    mscores1 = torch.where(mutual1, torch.gather(mscores0, 1, m1),
                           torch.zeros_like(m1, dtype=mscores0.dtype))
    valid0 = mutual0 & (mscores0 > threshold)
    valid1 = mutual1 & torch.gather(valid0, 1, m1)
    return (torch.where(valid0, m0, torch.full_like(m0, -1)),
            torch.where(valid1, m1, torch.full_like(m1, -1)), mscores0, mscores1)


# tpu3d's LightGlue param tree (numpy) as LightGlue's state_dict
lightglue_params_from_tpu3d = state_dict_from_tree


def lightglue_hparams(params: Dict[str, Any]) -> Dict[str, int]:
    """LightGlue's depth, width and input width read off a param tree, as
    tpu3d's pipeline reads them (pipeline.py:_lightglue_module)."""
    p = params["params"]
    n_layers = 1 + max(int(k.rsplit("_", 1)[1]) for k in p if k.startswith("self_attn_"))
    dim = np.asarray(p[f"log_assignment_{n_layers - 1}"]["final_proj"]["kernel"]).shape[1]
    input_dim = np.asarray(p["input_proj"]["kernel"]).shape[0] if "input_proj" in p else dim
    return dict(input_dim=int(input_dim), dim=int(dim), n_layers=n_layers)


def lightglue_from_tpu3d(params: Dict[str, Any], device="cuda") -> LightGlue:
    """The LightGlue module of a param tree, in eval mode on ``device``."""
    net = LightGlue(**lightglue_hparams(params))
    net.load_state_dict(lightglue_params_from_tpu3d(params))
    return net.to(resolve_device(device)).eval()


def _dense(w, b=None) -> Dict[str, np.ndarray]:
    out = {"kernel": np.asarray(w).T}
    if b is not None:
        out["bias"] = np.asarray(b)
    return out


def convert_torch_state_dict(sd: Dict[str, Any], n_layers: int = 9) -> Dict[str, Any]:
    """A torch LightGlue state_dict (a released checkpoint or the reference
    implementation's) as tpu3d's LightGlue param tree
    (tpu3d/matching/lightglue.py:263-295)."""
    def g(k):
        v = sd[k]
        return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)

    def ffn(pre):
        return {"ffn_0": _dense(g(f"{pre}.ffn.0.weight"), g(f"{pre}.ffn.0.bias")),
                "ffn_1": {"scale": g(f"{pre}.ffn.1.weight"), "bias": g(f"{pre}.ffn.1.bias")},
                "ffn_3": _dense(g(f"{pre}.ffn.3.weight"), g(f"{pre}.ffn.3.bias"))}

    p: Dict[str, Any] = {}
    if "input_proj.weight" in sd:
        p["input_proj"] = _dense(g("input_proj.weight"), g("input_proj.bias"))
    p["posenc"] = {"Wr": _dense(g("posenc.Wr.weight"))}
    for i in range(n_layers):
        sa, ca = f"self_attn.{i}", f"cross_attn.{i}"
        p[f"self_attn_{i}"] = {
            "Wqkv": _dense(g(f"{sa}.Wqkv.weight"), g(f"{sa}.Wqkv.bias")),
            "out_proj": _dense(g(f"{sa}.out_proj.weight"), g(f"{sa}.out_proj.bias")),
            **ffn(sa)}
        p[f"cross_attn_{i}"] = {
            "to_qk": _dense(g(f"{ca}.to_qk.weight"), g(f"{ca}.to_qk.bias")),
            "to_v": _dense(g(f"{ca}.to_v.weight"), g(f"{ca}.to_v.bias")),
            "to_out": _dense(g(f"{ca}.to_out.weight"), g(f"{ca}.to_out.bias")),
            **ffn(ca)}
    la = f"log_assignment.{n_layers - 1}"
    p[f"log_assignment_{n_layers - 1}"] = {
        "final_proj": _dense(g(f"{la}.final_proj.weight"), g(f"{la}.final_proj.bias")),
        "matchability": _dense(g(f"{la}.matchability.weight"), g(f"{la}.matchability.bias")),
    }
    return {"params": p}


def load_torch_checkpoint(path: str, n_layers: int = 9) -> Dict[str, Any]:
    return convert_torch_state_dict(torch.load(path, map_location="cpu"), n_layers)
