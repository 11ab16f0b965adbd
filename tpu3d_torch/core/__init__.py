"""SO(3)/SE(3) maps and the pinhole camera model (tpu3d/core)."""
from tpu3d_torch.core.camera import (camera_center, camera_rays, centered_to_pixel,
                                     intrinsics_matrix, pixel_to_centered, project,
                                     project_extrinsic)
from tpu3d_torch.core.lie import (se3_apply, se3_compose, se3_inverse, so3_exp, so3_hat,
                                  so3_log)

__all__ = [
    "so3_exp", "so3_log", "so3_hat", "se3_apply", "se3_compose", "se3_inverse",
    "intrinsics_matrix", "project", "project_extrinsic", "pixel_to_centered",
    "centered_to_pixel", "camera_rays", "camera_center",
]
