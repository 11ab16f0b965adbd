"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a wrapper
adds one where it launches its kernel and nowhere else, so a run can show
that it went through the kernels."""
from __future__ import annotations

LAUNCHES = {"patch_sample_kernel": 0, "top2_kernel": 0, "trilinear_kernel": 0,
            "trilinear_grad_kernel": 0, "orient_desc_kernel": 0, "rmsprop_kernel": 0,
            "shade_composite_kernel": 0, "view_rays_kernel": 0, "rgbnet_count_kernel": 0,
            "rgbnet_compact_kernel": 0, "rgbnet_forward_kernel": 0, "rgbnet_backward_kernel": 0,
            "rgbnet_reduce_kernel": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


from tpu3d_torch.kernels.distance import descriptor_top2, mutual_nn  # noqa: E402

__all__ = ["LAUNCHES", "reset_launches", "descriptor_top2", "mutual_nn"]
