"""Bag-of-visual-words retrieval: k-means codebook, vector quantization,
tf-idf scoring and top-k similarity (tpu3d/matching/bow.py).

tpu3d draws the k-means initial rows and the fill rows for invalid slots
from ``jax.random`` inside build_codebook (bow.py:36, :66); here
:func:`codebook_draws` makes them from a ``torch.Generator`` and
build_codebook takes them as arguments, so a test can pass tpu3d's.
The k-means update is a one-hot product rather than a scatter-add, so its
sums are deterministic on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _assign(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest codeword per row of x. (N, D) x (K, D) -> (N,) int64."""
    dots = x @ codebook.T
    c2 = torch.sum(codebook * codebook, dim=-1)
    return torch.argmin(c2[None, :] - 2.0 * dots, dim=-1)


def kmeans(x: torch.Tensor, init_idx: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Lloyd's k-means. x: (N, D) -> codebook (k, D), starting from the k
    distinct rows ``init_idx``; empty clusters keep their previous
    centroid."""
    k = init_idx.shape[0]
    codebook = x[init_idx.to(x.device).long()]
    ar = torch.arange(k, device=x.device)
    for _ in range(iters):
        a = _assign(x, codebook)
        onehot = (a[:, None] == ar[None, :]).to(x.dtype)       # (N, k)
        sums = onehot.T @ x
        counts = onehot.sum(dim=0)
        new = sums / torch.clamp(counts[:, None], min=1.0)
        codebook = torch.where(counts[:, None] > 0, new, codebook)
    return codebook


def vector_quantize(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest codeword ids of (..., N, D) rows."""
    shp = x.shape[:-1]
    return _assign(x.reshape(-1, x.shape[-1]), codebook).reshape(shp)


def codebook_draws(valid: torch.Tensor, k: int, generator: torch.Generator
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """build_codebook's random rows for a (B, K) validity mask: fill_idx
    (B*K,) drawn with replacement from the valid slots, and init_idx (k,)
    distinct rows."""
    p = valid.reshape(-1).to(torch.float32)
    n = p.numel()
    fill_idx = torch.multinomial(p / p.sum(), n, replacement=True, generator=generator)
    init_idx = torch.randperm(n, generator=generator, device=valid.device)[:k]
    return fill_idx, init_idx


def build_codebook(descriptors: torch.Tensor, valid: torch.Tensor,
                   fill_idx: torch.Tensor, init_idx: torch.Tensor,
                   iters: int = 10) -> torch.Tensor:
    """Codebook of len(init_idx) words from a (B, K, D) descriptor tensor
    with validity masks. Invalid rows are replaced by the valid rows
    ``fill_idx`` names, so they cannot capture centroids."""
    d = descriptors.reshape(-1, descriptors.shape[-1])
    v = valid.reshape(-1)
    d = torch.where(v[:, None] > 0, d, d[fill_idx.to(d.device).long()])
    return kmeans(d, init_idx, iters)


def tfidf_vectors(words: torch.Tensor, valid: torch.Tensor, k: int) -> torch.Tensor:
    """Per-image tf-idf vectors. words: (B, K) visual word ids."""
    oh = (words[..., None] == torch.arange(k, device=words.device)).to(torch.float32)
    tf = torch.sum(oh * valid[..., None].to(torch.float32), dim=1)   # (B, k)
    df = torch.sum(tf > 0, dim=0).to(torch.float32)
    n = tf.shape[0]
    idf = torch.log(n / torch.clamp(df, min=1.0))
    return tf * idf[None, :]


def topk_similar(tfidf: torch.Tensor, top_k: int = 10
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-pairs cosine similarity + per-image top-k neighbours (excluding
    self). Returns (idx (B, top_k) int32, sim)."""
    norm = torch.clamp(torch.linalg.vector_norm(tfidf, dim=-1, keepdim=True), min=1e-9)
    x = tfidf / norm
    sim = x @ x.T
    sim = sim - 2.0 * torch.eye(sim.shape[0], dtype=sim.dtype, device=sim.device)
    vals, idx = torch.topk(sim, min(top_k, sim.shape[0] - 1), dim=1)
    return idx.to(torch.int32), vals
