"""optax.rmsprop's update of one parameter tensor, in place.

The grid optimizer of the cascade's detail phase and of ``--dense-optimizer
rmsprop`` (dense/train.py::RMSprop): nu <- decay nu + (1 - decay) g^2, then
p <- p - lr g / sqrt(nu + eps), eps inside the root. On a CUDA tensor
``rmsprop_update`` launches ``rmsprop_kernel`` (csrc/rmsprop.cu), which
reads g, nu and p once and writes nu and p once; on a CPU tensor it runs the
plain version, three torch lines that the kernel repeats operation by
operation. Both update every element: a zero gradient still decays nu.

The kernel rounds each product and sum on its own (no FMA), as the plain
version's separate operations do; nu equals the plain version's on the same
inputs bit for bit, p within one ulp (torch's ``addcmul`` on the card may
contract its multiply-add; on an H100 with torch 2.11 p is bit for bit
too). The lr is a 0-d f32 tensor on the parameter's device, read by the
kernel on the device (so that a CUDA graph replay applies its current
value), or a Python number (``dist/``'s steps).
"""
from __future__ import annotations

from typing import Union

import torch

from tpu3d_torch.kernels import LAUNCHES
from tpu3d_torch.kernels._build import check, function, stream
from tpu3d_torch.utils.trace import launch_span


def rmsprop_update_plain(p: torch.Tensor, g: torch.Tensor, nu: torch.Tensor,
                         lr: Union[torch.Tensor, float], decay: float, eps: float) -> None:
    """Plain version: updates ``nu`` and ``p`` in place."""
    nu.mul_(decay).add_((1 - decay) * (g * g))
    p.addcmul_(torch.add(nu, eps).rsqrt_().mul_(lr), g, value=-1.0)


def rmsprop_update(p: torch.Tensor, g: torch.Tensor, nu: torch.Tensor,
                   lr: Union[torch.Tensor, float], decay: float, eps: float) -> None:
    """Update ``nu`` and ``p`` in place from the gradient ``g`` (see the
    module's note). A CPU tensor takes :func:`rmsprop_update_plain`; a
    CUDA tensor launches ``rmsprop_kernel`` on the current stream, with no
    host read (capturable), and raises on what the kernel does not take."""
    if g.shape != p.shape or nu.shape != p.shape:
        raise ValueError(f"rmsprop_update: p, g and nu must have one shape, got "
                         f"{tuple(p.shape)}, {tuple(g.shape)}, {tuple(nu.shape)}")
    if g.dtype != p.dtype or nu.dtype != p.dtype or g.device != p.device or nu.device != p.device:
        raise ValueError(f"rmsprop_update: p, g and nu must have one dtype and device, got "
                         f"{p.dtype} / {g.dtype} / {nu.dtype} on {p.device} / {g.device} / "
                         f"{nu.device}")
    if p.device.type == "cpu":
        rmsprop_update_plain(p, g, nu, lr, decay, eps)
        return
    if p.device.type != "cuda":
        raise ValueError(f"rmsprop_update: unsupported device {p.device}")
    if p.dtype != torch.float32 or not all(t.is_contiguous() for t in (p, g, nu)):
        raise ValueError(f"rmsprop_update: p, g and nu must be contiguous f32 tensors, got "
                         f"{p.dtype}, contiguous {[t.is_contiguous() for t in (p, g, nu)]}")
    if isinstance(lr, torch.Tensor):
        if lr.device != p.device or lr.dtype != torch.float32 or lr.numel() != 1:
            raise ValueError(f"rmsprop_update: a tensor lr must be one f32 on {p.device}, got "
                             f"{tuple(lr.shape)} {lr.dtype} on {lr.device}")
        lr_ptr, lr_value = lr.data_ptr(), 0.0
    else:
        lr_ptr, lr_value = None, float(lr)
    n = p.numel()
    if n == 0:
        return
    with launch_span("kernels.rmsprop"):
        err = function("tpu3d_rmsprop")(p.data_ptr(), g.data_ptr(), nu.data_ptr(), lr_ptr,
                                        lr_value, decay, 1.0 - decay, eps, n,
                                        stream(p.get_device()))
    check(err, "rmsprop_kernel")
    LAUNCHES["rmsprop_kernel"] += 1
