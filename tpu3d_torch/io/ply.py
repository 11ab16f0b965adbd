"""Point-cloud outlier filter (tpu3d/io/ply.py::filter_point_cloud). The PLY
writers come with the reconstruct stage."""
from __future__ import annotations

import numpy as np


def filter_point_cloud(points: np.ndarray, extra_margin: float = 300.0,
                       scale: float = 200.0) -> np.ndarray:
    """The reference's outlier filter: after scaling by ``scale``, drop
    points farther than mean distance + ``extra_margin`` from the centroid.
    Returns a boolean keep-mask over the input points."""
    p = points * scale
    mean = p.mean(axis=0)
    dist = np.linalg.norm(p - mean, axis=1)
    return dist < dist.mean() + extra_margin
