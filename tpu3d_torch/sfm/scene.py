"""The sparse reconstruction's container (tpu3d/sfm/scene.py), in numpy."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from tpu3d_torch.core.lie import so3_exp_np


@dataclasses.dataclass
class Reconstruction:
    """Final sparse reconstruction: registered cameras, points, colours."""

    image_names: List[str]
    registered: np.ndarray          # (M,) image indices with cameras
    cams: np.ndarray                # (M, 6) [rvec|t] world->cam
    points: np.ndarray              # (P, 3)
    colors_bgr: np.ndarray          # (P, 3) uint8
    track_ids: np.ndarray           # (P,) global track id per point
    mean_reproj_px: float
    num_obs: int
    # Images placed by the --register-all low-confidence pass (not ported:
    # always empty here).
    low_confidence: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    # Mean reprojection error (px) per registered image.
    per_cam_reproj_px: Dict[int, float] = dataclasses.field(default_factory=dict)

    def extrinsics(self) -> np.ndarray:
        """(M, 3, 4) [R|t] matrices."""
        R = np.stack([so3_exp_np(c) for c in self.cams[:, :3]])
        return np.concatenate([R, self.cams[:, 3:6][..., None]], axis=-1)

    def registered_names(self) -> List[str]:
        return [self.image_names[i] for i in self.registered]
