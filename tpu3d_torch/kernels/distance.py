"""Per-row best, second best and argmax of q · kᵀ, batched over pairs, and
per column the argmax over the rows: both directions of a mutual match.

Counterpart of tpu3d/kernels/distance.py::descriptor_top2 and its matcher
``mutual_nn_pallas``. On a CUDA tensor the wrappers launch ``top2_kernel``
(csrc/top2.cu), which streams key tiles and never materialises the
similarity matrix; ``mutual_top2`` gets the column argmax from the same
launch. On a CPU tensor they run the plain version (``torch.bmm`` plus
masked max/argmax, as matching/mnn.py). An invalid row or column scores
-2.0 (mnn.py:43-45); ties go to the lowest index; products are full f32.
"""
from __future__ import annotations

import struct
from typing import Optional, Tuple

import torch

from tpu3d_torch.kernels import LAUNCHES
from tpu3d_torch.kernels._build import check, function, stream

NEG = -2.0
# csrc/top2.cu's Top2Args: q, k, vq, vk, best, second, arg, colkey, stream;
# B, K0, K1, D
_ARGS = struct.Struct("9Q4i")


def _masked_similarity(q, k, vq, vk) -> torch.Tensor:
    sim = torch.bmm(q, k.transpose(1, 2))
    neg = torch.tensor(NEG, dtype=sim.dtype, device=sim.device)
    sim = torch.where(vq[:, :, None] > 0, sim, neg)
    return torch.where(vk[:, None, :] > 0, sim, neg)


def _row_top2(sim: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    best = sim.amax(dim=2)
    arg = torch.argmax(sim, dim=2)   # first maximal index, as jnp.argmax
    cols = torch.arange(sim.shape[2], device=sim.device)
    neg = torch.tensor(NEG, dtype=sim.dtype, device=sim.device)
    second = torch.where(cols[None, None, :] == arg[:, :, None], neg, sim).amax(dim=2)
    return best, second, arg.to(torch.int32)


def descriptor_top2_plain(q: torch.Tensor, k: torch.Tensor, vq: torch.Tensor,
                          vk: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version. q: (B, K0, D), k: (B, K1, D) f32; vq: (B, K0),
    vk: (B, K1) validity (> 0 valid). Returns best, second (B, K0) f32 and
    arg (B, K0) int32."""
    return _row_top2(_masked_similarity(q, k, vq, vk))


def mutual_top2_plain(q: torch.Tensor, k: torch.Tensor, vq: torch.Tensor, vk: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`mutual_top2`: :func:`descriptor_top2_plain`
    and col_arg (B, K1) int32, the first row of each column's maximum of
    the same masked matrix (a masked column gives row 0)."""
    sim = _masked_similarity(q, k, vq, vk)
    return (*_row_top2(sim), torch.argmax(sim, dim=1).to(torch.int32))


def _launch(name: str, q, k, vq, vk, columns: bool):
    """One ``top2_kernel`` launch; the checks run in one pass over plain
    attributes, and the arguments cross ctypes as one packed block."""
    if not q.is_cuda:
        raise ValueError(f"{name}: unsupported device {q.device}")
    dev = q.get_device()
    if q.dim() != 3 or k.dim() != 3 or q.shape[0] != k.shape[0] \
            or q.shape[2] != k.shape[2] or q.shape[2] < 1:
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    B, K0, D = q.shape
    K1 = k.shape[1]
    if vq.shape != (B, K0) or vk.shape != (B, K1):
        raise ValueError(f"{name}: masks must be (B, K0) and (B, K1), got "
                         f"{tuple(vq.shape)} and {tuple(vk.shape)}")
    f32 = torch.float32
    if ((q.dtype, k.dtype, vq.dtype, vk.dtype) != (f32, f32, f32, f32)
            or not (q.is_contiguous() and k.is_contiguous() and vq.is_contiguous()
                    and vk.is_contiguous())
            or not dev == k.get_device() == vq.get_device() == vk.get_device()):
        for n, t in (("q", q), ("k", k), ("vq", vq), ("vk", vk)):
            if t.dtype is not f32 or t.get_device() != dev or not t.is_contiguous():
                raise ValueError(f"{name}: {n} must be a contiguous float32 tensor "
                                 f"on {q.device}")
    best = q.new_empty((B, K0))
    second = q.new_empty((B, K0))
    arg = torch.empty((B, K0), dtype=torch.int32, device=q.device)
    # filled with all ones on the stream by tpu3d_top2 before the launch
    keys = torch.empty((B, K1), dtype=torch.int64, device=q.device) if columns else None
    err = function("tpu3d_top2")(_ARGS.pack(
        q.data_ptr(), k.data_ptr(), vq.data_ptr(), vk.data_ptr(), best.data_ptr(),
        second.data_ptr(), arg.data_ptr(), 0 if keys is None else keys.data_ptr(),
        stream(dev), B, K0, K1, D))
    check(err, "top2_kernel")
    LAUNCHES["top2_kernel"] += 1
    # a key's low word (the first int32 of each int64) is the column's row
    col_arg: Optional[torch.Tensor] = None if keys is None else keys.view(torch.int32)[:, ::2]
    return best, second, arg, col_arg


def descriptor_top2(q: torch.Tensor, k: torch.Tensor, vq: torch.Tensor,
                    vk: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(best, second, arg) per query row; see :func:`descriptor_top2_plain`.
    A CPU tensor takes the plain version; a CUDA tensor launches
    ``top2_kernel`` with the column output off."""
    if q.device.type == "cpu":
        return descriptor_top2_plain(q, k, vq, vk)
    return _launch("descriptor_top2", q, k, vq, vk, columns=False)[:3]


def mutual_top2(q: torch.Tensor, k: torch.Tensor, vq: torch.Tensor, vk: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(best, second, arg, col_arg); see :func:`mutual_top2_plain`. A CPU
    tensor takes the plain version; a CUDA tensor launches ``top2_kernel``
    once for both directions (col_arg is then a strided int32 view of the
    kernel's (B, K1) int64 column keys)."""
    if q.device.type == "cpu":
        return mutual_top2_plain(q, k, vq, vk)
    return _launch("mutual_top2", q, k, vq, vk, columns=True)
