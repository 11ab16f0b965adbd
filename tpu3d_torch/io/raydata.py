"""The reference's ray-dataset files (tpu3d/io/raydata.py): an (N, 9)
numpy array of [origin, direction, rgb] rows saved with ``np.save`` and
read with ``np.load(path, allow_pickle=True)``, the input of ``densify
--rays-pkl``. The port reads and writes tpu3d's files unchanged."""
from __future__ import annotations

import numpy as np

from tpu3d_torch.dense.train import RayDataset


def load_ray_dataset(path: str) -> RayDataset:
    """An (N, 9) [origin, dir, rgb] array as a RayDataset: directions made
    unit, colours in 0-255 scaled to [0, 1], then clipped to [0, 1]."""
    arr = np.asarray(np.load(path, allow_pickle=True), np.float32)
    if arr.ndim != 2 or arr.shape[1] < 9:
        raise ValueError(f"{path}: expected an (N, 9) array of [origin, dir, rgb] rows, "
                         f"got {arr.shape}")
    dirs = arr[:, 3:6]
    dirs = dirs / np.maximum(np.linalg.norm(dirs, axis=-1, keepdims=True), 1e-12)
    rgb = arr[:, 6:9]
    if rgb.max() > 1.5:
        rgb = rgb / 255.0
    return RayDataset(origins=arr[:, :3].copy(), dirs=dirs.astype(np.float32),
                      rgb=np.clip(rgb, 0.0, 1.0).astype(np.float32))


def save_ray_dataset(path: str, ds: RayDataset) -> None:
    """Write ``ds`` as an (N, 9) f32 array in that format."""
    arr = np.concatenate([np.asarray(ds.origins, np.float32), np.asarray(ds.dirs, np.float32),
                          np.asarray(ds.rgb, np.float32)], axis=1)
    with open(path, "wb") as f:
        np.save(f, arr, allow_pickle=True)
