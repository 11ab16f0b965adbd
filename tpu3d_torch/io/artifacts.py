"""Artifact store (tpu3d/io/artifacts.py::ArtifactStore): one directory of
``<name>.npz`` arrays and ``<name>.json`` metadata. The port reads and
writes tpu3d's files unchanged; they are the hand-off between the two."""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np


class ArtifactStore:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.root, f"{name}.npz")

    def save(self, name: str, **arrays: np.ndarray) -> None:
        # Compress only small artifacts: zlib on a voxel grid of hundreds of
        # MB costs minutes of CPU for almost no ratio.
        total = sum(getattr(a, "nbytes", 0) for a in arrays.values())
        if total > 64 * 1024 * 1024:
            np.savez(self._path(name), **arrays)
        else:
            np.savez_compressed(self._path(name), **arrays)

    def load(self, name: str) -> Optional[Dict[str, np.ndarray]]:
        p = self._path(name)
        if not os.path.exists(p):
            return None
        with np.load(p, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    def has(self, name: str) -> bool:
        return os.path.exists(self._path(name))

    def save_json(self, name: str, obj: Any) -> None:
        with open(os.path.join(self.root, f"{name}.json"), "w") as f:
            json.dump(obj, f, indent=2)

    def load_json(self, name: str) -> Any:
        p = os.path.join(self.root, f"{name}.json")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)
