"""Two-view geometry: essential matrices, RANSAC, pose recovery."""
from tpu3d_torch.geometry.epipolar import (epipolar_residual,
                                           essential_eight_point, sampson_error)
from tpu3d_torch.geometry.estimators import EssentialResult, find_essential_ransac
from tpu3d_torch.geometry.pose import decompose_essential, recover_pose
from tpu3d_torch.geometry.ransac import ransac
from tpu3d_torch.geometry.triangulate import triangulate_midpoint

__all__ = [
    "essential_eight_point", "sampson_error", "epipolar_residual", "ransac",
    "decompose_essential", "recover_pose", "triangulate_midpoint",
    "find_essential_ransac", "EssentialResult",
]
