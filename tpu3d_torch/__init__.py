"""tpu3d_torch — the PyTorch + CUDA port of tpu3d for NVIDIA Hopper.

The package mirrors ``tpu3d``'s module paths and function names, so each
function has an obvious counterpart there. It imports ``torch`` and never
``jax``, and nothing of ``tpu3d``: modules that tpu3d keeps in numpy
(config, view-graph and track bookkeeping, image loading) have their own
copies here.

Every entry point takes ``device="cuda"`` and runs on the card unless the
caller passes ``device="cpu"``; asking for the card where there is none
raises. The kernels of the ported paths (extract → retrieve → match →
reconstruct, and the dense stage's training and render/eval) are CUDA C++
(``csrc/``), one for each of tpu3d's Pallas kernels, built at first use; on
a CPU tensor their wrappers use the plain PyTorch version of the same
function. The learned models (DISK, SuperPoint, LightGlue) are plain jnp /
Flax in tpu3d, so here they are torch modules (cuDNN convolutions and
full-f32 products inside ``f32_scope``). ``utils`` holds the trace spans
and the dispatch counts; ``native`` the C++ track store, host code built
by g++ at first use.
"""
from __future__ import annotations

import contextlib

import torch

__version__ = "0.1.0"


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on. A CUDA device where
    ``torch.cuda.is_available()`` is False raises: the port never falls
    back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpu3d_torch: a CUDA device was requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU")
    return dev


@contextlib.contextmanager
def f32_scope():
    """Full-f32 products: TF32 off for matmuls and cuDNN while the body
    runs (tpu3d scopes the same for the frontend and the geometry gate,
    frontend.py:76-86, estimators.py:48). The flags are restored after."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
