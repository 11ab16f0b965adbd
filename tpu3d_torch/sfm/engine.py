"""Hand-off types between the match stage and the incremental engine
(tpu3d/sfm/engine.py). Only the types are ported so far: the engine itself
(``IncrementalSfM``) comes with the reconstruct stage."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

MAX_REFS = 3      # reference views per image


@dataclasses.dataclass
class EdgeObservations:
    """Inlier matches of one (registered_ref, new) image edge, produced by
    the matching stage. Variable-length host arrays (M,)."""

    ref_img: int
    idx_ref: np.ndarray
    idx_new: np.ndarray
    track: np.ndarray       # resolved global track ids
    uv_ref: np.ndarray      # (M, 2) centered coords
    uv_new: np.ndarray
    colors_ref: np.ndarray  # (M, 3) uint8 BGR sampled at ref keypoints
    rel_R: Optional[np.ndarray] = None  # world->new given ref=I (from E)
    rel_t: Optional[np.ndarray] = None


@dataclasses.dataclass
class ImageRegistration:
    img: int
    edges: List[EdgeObservations]


@dataclasses.dataclass
class PairObservations:
    """One matched pair in flat form; ``to_registration`` converts it."""

    img0: int
    img1: int
    idx0: np.ndarray
    idx1: np.ndarray
    track: np.ndarray
    uv0: np.ndarray
    uv1: np.ndarray
    valid: np.ndarray
    colors0: np.ndarray
    rel_R: Optional[np.ndarray] = None
    rel_t: Optional[np.ndarray] = None

    def to_registration(self) -> ImageRegistration:
        sel = self.valid
        return ImageRegistration(
            img=self.img1,
            edges=[EdgeObservations(
                ref_img=self.img0,
                idx_ref=self.idx0[sel], idx_new=self.idx1[sel],
                track=self.track[sel],
                uv_ref=self.uv0[sel], uv_new=self.uv1[sel],
                colors_ref=self.colors0[sel],
                rel_R=self.rel_R, rel_t=self.rel_t,
            )],
        )
