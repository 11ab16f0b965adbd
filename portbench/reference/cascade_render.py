"""Plain PyTorch renders of a cascade: the reference that the benchmark
holds the program's cascade views against.

A view is reference/render.py's ``render_rays`` over the two grids of
``Grids`` (the frozen base over its box, the detail grid counting only
inside its own, their raw channels summed before the activations), with
contracted sample positions and no box clipping, at every ``stride``-th
row and column of the camera, in chunks of rays.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.render import Grids, eval_sh, render_rays, view_rays


def render_view(detail, detail_lo, detail_hi, base, base_lo, base_hi, cam: np.ndarray,
                height: int, width: int, focal: float, center, scale, near: float, far: float,
                n: int, bg_sh: torch.Tensor, dtype=torch.float32, chunk: int = 4096,
                stride: int = 1) -> np.ndarray:
    """One whole view of the cascade in ``dtype``, with the SH background
    ``bg_sh`` (3, 9): (h, w, 3) float32 on the host."""
    o_np, d_np = view_rays(cam, height, width, focal, center, scale, stride)
    dev = detail.device
    g = Grids(detail.to(dtype), detail_lo.to(dtype), detail_hi.to(dtype), base.to(dtype),
              base_lo.to(dtype), base_hi.to(dtype))
    bgk = bg_sh.to(dtype)
    out = []
    with torch.no_grad():
        for s in range(0, len(o_np), chunk):
            o = torch.from_numpy(o_np[s:s + chunk]).to(dev).to(dtype)
            d = torch.from_numpy(d_np[s:s + chunk]).to(dev).to(dtype)
            bg = eval_sh(bgk.expand(d.shape[0], 3, 9), d)
            out.append(render_rays(g, o, d, near, far, n, False, contracted=True,
                                   bg=bg).float().cpu())
    return torch.cat(out).numpy().reshape(len(range(0, height, stride)),
                                          len(range(0, width, stride)), 3)
