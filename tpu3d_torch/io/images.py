"""Host-side image loading (tpu3d/io/images.py). Pillow is imported inside
the loader, so importing this module needs no Pillow."""
from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".tif", ".tiff", ".raw"}


def list_images(img_dir: str) -> List[str]:
    """Sorted image filenames in a directory."""
    out = []
    for f in sorted(os.listdir(img_dir)):
        p = os.path.join(img_dir, f)
        if os.path.isfile(p) and os.path.splitext(f)[1].lower() in IMAGE_EXTS:
            out.append(f)
    return out


def load_images(
    img_dir: str,
    names: Sequence[str],
    downscale: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Load images as (N, H, W) float32 gray in [0,1] and (N, H, W, 3) uint8
    RGB. All images must share one size."""
    from PIL import Image

    def _load_one(name):
        img = Image.open(os.path.join(img_dir, name))
        target = (img.width // downscale, img.height // downscale)
        if downscale > 1:
            # JPEG draft mode decodes at the nearest DCT scale directly.
            img.draft("RGB", target)
        img = img.convert("RGB")
        if img.size != target:
            img = img.resize(target, Image.BILINEAR)
        rgb = np.asarray(img, np.uint8)
        gray = np.asarray(img.convert("L"), np.float32) / 255.0
        return gray, rgb

    from concurrent.futures import ThreadPoolExecutor

    if len(names) > 1:
        with ThreadPoolExecutor(max_workers=min(4, (os.cpu_count() or 2) * 2)) as ex:
            results = list(ex.map(_load_one, names))
    else:
        results = [_load_one(n) for n in names]
    return np.stack([g for g, _ in results]), np.stack([c for _, c in results])


def load_image_batch(img_dir: str, names: Sequence[str], start: int, batch: int,
                     downscale: int = 1):
    """One batch of images for streaming extraction: (gray, rgb, names) of
    names[start:start + batch], or (None, None, []) past the end."""
    chunk = list(names[start: start + batch])
    if not chunk:
        return None, None, []
    g, c = load_images(img_dir, chunk, downscale)
    return g, c, chunk
