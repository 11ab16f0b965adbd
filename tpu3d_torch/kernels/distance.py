"""Per-row best, second best and argmax of q · kᵀ, batched over pairs.

Counterpart of tpu3d/kernels/distance.py::descriptor_top2. On a CUDA tensor
the wrapper launches ``top2_kernel`` (csrc/top2.cu), which streams key tiles
and never materialises the similarity matrix; on a CPU tensor it runs the
plain version (``torch.bmm`` plus masked max/argmax, as matching/mnn.py).
An invalid row or column scores -2.0 (mnn.py:43-45); ties go to the lowest
index; products are full f32.
"""
from __future__ import annotations

from typing import Tuple

import torch

from tpu3d_torch.kernels import LAUNCHES
from tpu3d_torch.kernels._build import check, library

NEG = -2.0


def descriptor_top2_plain(q: torch.Tensor, k: torch.Tensor, vq: torch.Tensor,
                          vk: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version. q: (B, K0, D), k: (B, K1, D) f32; vq: (B, K0),
    vk: (B, K1) validity (> 0 valid). Returns best, second (B, K0) f32 and
    arg (B, K0) int32."""
    sim = torch.bmm(q, k.transpose(1, 2))
    neg = torch.tensor(NEG, dtype=sim.dtype, device=sim.device)
    sim = torch.where(vq[:, :, None] > 0, sim, neg)
    sim = torch.where(vk[:, None, :] > 0, sim, neg)
    best = sim.amax(dim=2)
    arg = torch.argmax(sim, dim=2)   # first maximal index, as jnp.argmax
    cols = torch.arange(sim.shape[2], device=sim.device)
    second = torch.where(cols[None, None, :] == arg[:, :, None], neg, sim).amax(dim=2)
    return best, second, arg.to(torch.int32)


def descriptor_top2(q: torch.Tensor, k: torch.Tensor, vq: torch.Tensor,
                    vk: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(best, second, arg) per query row; see :func:`descriptor_top2_plain`.
    A CPU tensor takes the plain version; a CUDA tensor launches
    ``top2_kernel``."""
    if q.device.type == "cpu":
        return descriptor_top2_plain(q, k, vq, vk)
    if q.device.type != "cuda":
        raise ValueError(f"descriptor_top2: unsupported device {q.device}")
    if q.dim() != 3 or k.dim() != 3 or q.shape[0] != k.shape[0] \
            or q.shape[2] != k.shape[2]:
        raise ValueError(f"descriptor_top2: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)}")
    B, K0, D = q.shape
    K1 = k.shape[1]
    if vq.shape != (B, K0) or vk.shape != (B, K1) or not 0 < D <= 384:
        raise ValueError("descriptor_top2: masks must be (B, K0) and (B, K1), "
                         "and D in [1, 384] (the tiles live in shared memory)")
    for name, t in (("q", q), ("k", k), ("vq", vq), ("vk", vk)):
        if t.device != q.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"descriptor_top2: {name} must be a contiguous "
                             f"float32 tensor on {q.device}")
    best = torch.empty((B, K0), dtype=torch.float32, device=q.device)
    second = torch.empty_like(best)
    arg = torch.empty((B, K0), dtype=torch.int32, device=q.device)
    err = library().tpu3d_top2(
        q.data_ptr(), k.data_ptr(), vq.data_ptr(), vk.data_ptr(),
        best.data_ptr(), second.data_ptr(), arg.data_ptr(), B, K0, K1, D,
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "top2_kernel")
    LAUNCHES["top2_kernel"] += 1
    return best, second, arg
