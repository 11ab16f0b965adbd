"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a wrapper
adds one where it launches its kernel and nowhere else, so a run can show
that it went through the kernels."""
from __future__ import annotations

LAUNCHES = {"patch_sample_kernel": 0, "top2_kernel": 0, "trilinear_kernel": 0,
            "trilinear_grad_kernel": 0, "orient_desc_kernel": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
