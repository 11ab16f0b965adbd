"""PLY export and the reference's outlier filter (tpu3d/io/ply.py)."""
from __future__ import annotations

import os

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


def write_ply(path: str, points: np.ndarray, colors_bgr: np.ndarray, scale: float = 200.0,
              apply_filter: bool = True) -> int:
    """ASCII PLY with BGR colour columns, x``scale`` coordinates and the
    outlier filter, as tpu3d writes it. Returns the vertex count."""
    pts = points.reshape(-1, 3) * scale
    cols = colors_bgr.reshape(-1, 3)
    if apply_filter and len(pts) > 0:
        keep = filter_point_cloud(points, scale=scale)
        pts = pts[keep]
        cols = cols[keep]
    header = ("ply\nformat ascii 1.0\n"
              f"element vertex {len(pts)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property uchar blue\nproperty uchar green\nproperty uchar red\n"
              "end_header\n")
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        f.write(header)
        for p, c in zip(pts, cols):
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {int(c[0])} {int(c[1])} {int(c[2])}\n")
    return len(pts)
