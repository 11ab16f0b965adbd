"""Batched small-matrix linear algebra that works around cuSOLVER's limits."""
from __future__ import annotations

import torch

# cusolverDnXsyevBatched, which torch.linalg.eigh calls for a batch of CUDA
# matrices, refuses large batches (its buffer-size query returns
# CUSOLVER_STATUS_INVALID_VALUE): on an H100 with CUDA 12.8 and torch 2.11,
# 24,576 4x4 matrices pass and 32,767 fail (scripts/torch_eigh_batch_probe.py).
EIGH_CHUNK = 16384


def eigh(A: torch.Tensor):
    """torch.linalg.eigh of (..., n, n), in chunks of at most EIGH_CHUNK
    matrices on a CUDA device. Each matrix is solved on its own, so the
    chunking does not change the result."""
    batch = A.shape[:-2]
    n = A.shape[-1]
    flat = A.reshape(-1, n, n)
    if A.device.type != "cuda" or flat.shape[0] <= EIGH_CHUNK:
        return torch.linalg.eigh(A)
    parts = [torch.linalg.eigh(flat[s: s + EIGH_CHUNK]) for s in range(0, flat.shape[0], EIGH_CHUNK)]
    w = torch.cat([p[0] for p in parts]).reshape(*batch, n)
    V = torch.cat([p[1] for p in parts]).reshape(*batch, n, n)
    return w, V
