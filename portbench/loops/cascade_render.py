"""Render traffic on a cascade: loops/render.py's closed loop of whole views
along a flythrough, each view through ``render_view`` with its base grid
(``dense/eval.py::render_view(..., base_grid=)``), as ``render`` and
``densify --eval-only`` draw a cascade.

Set-up makes the scene of the seed on the device and, in the frame of the
contracted normalization, voxelizes its planes into the base grid over
[-2, 2]^3 (as recipe-256.detail's set-up does) and into the detail grid
over the cascade's detail box at the detail's voxel budget. Every sample of
a view reads both grids and adds their raw channels; samples are
contracted, the band is not clipped to a box, and the disparity tail takes
a quarter of the samples. The window, the traced sub-window and the
compared number are loops/render.py's; the reference is
reference/cascade_render.py on the same two grids.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import counts, scene as scn
from portbench.loops import render
from portbench.reference import cascade_render as ref


class Run(render.Run):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, warm: bool = True):
        from portbench import profiling
        from tpu3d_torch.config import DenseConfig
        from tpu3d_torch.dense import eval as deval
        from tpu3d_torch.dense.grid import VoxelGrid
        from tpu3d_torch.dense.train import SceneNormalization

        self.cfg, self.traffic, self.dev, self.seed = cfg, traffic, torch.device(device), seed
        self.deval = deval
        self.stages = profiling.Stages(self.dev)
        with self.stages("scene"):
            sc = scn.Scene(cfg["scene"], seed, device)
        self.H, self.W, self.focal = sc.height, sc.width, sc.focal
        self.stride = int(traffic["stride"])
        self.pixels = len(range(0, self.H, self.stride)) * len(range(0, self.W, self.stride))
        pts = sc.points
        self.center, self.scale = scn.norm_contracted(pts, cfg["norm_core_q"],
                                                      cfg["norm_core_radius"])
        self.near, self.far = scn.auto_near_far(sc.cams, pts, self.center, self.scale)
        det, sigma = cfg["detail"], float(cfg["scene"]["sigma"])
        res = (int(cfg["grid_resolution"]),) * 3
        lo, hi = np.full(3, -2.0, np.float32), np.full(3, 2.0, np.float32)
        with self.stages("base"):
            base = sc.voxelize(res, lo, hi, self.center, self.scale, True, sigma)
        self.base = VoxelGrid(base, torch.as_tensor(lo, device=self.dev),
                              torch.as_tensor(hi, device=self.dev))
        dlo, dhi, dres = scn.detail_box(pts, self.center, self.scale, float(det["coremax_q"]),
                                        lo, hi, int(det["voxel_budget"]))
        with self.stages("grid"):
            detail = sc.voxelize(dres, dlo, dhi, self.center, self.scale, True, sigma)
        self.grid = VoxelGrid(detail, torch.as_tensor(dlo, device=self.dev),
                              torch.as_tensor(dhi, device=self.dev))
        self.bg_sh = torch.zeros((3, 9), dtype=torch.float32, device=self.dev)
        self.bg_sh[:, 0] = scn.BACKGROUND / scn.SH_C0
        self.n = int(cfg["num_samples"])
        self.dcfg = DenseConfig(near=self.near, far=self.far, num_samples=self.n,
                                per_ray_aabb=False, contraction=True)
        self.norm = SceneNormalization(self.center, self.scale)
        self.poses = scn.interpolate_poses(sc.cams, int(traffic["path_frames"]))
        self.chunk = int(traffic["chunk"])
        self.images = {}
        if warm:
            with self.stages("warm_view"):       # the last pose: the window starts at the first
                self._view(len(self.poses) - 1)

    def _view(self, frame: int) -> np.ndarray:
        return self.deval.render_view(self.grid, self.poses[frame], self.H, self.W, self.focal,
                                      self.dcfg, self.norm, stride=self.stride, chunk=self.chunk,
                                      bg_sh=self.bg_sh, base_grid=self.base)

    def layer_context(self) -> dict:
        """loops/render.py's context with both grids' lookups: two trilinear
        reads a sample (detail, then base), so twice the lookup bytes and
        one more sample's FLOPs a sample."""
        rays, n = self.pixels, self.n
        return {"trace": self.trace, "views": render.TRACE_VIEWS,
                "trilinear_bytes": render.TRACE_VIEWS * 2 * counts.trilinear_bytes(rays * n, 28),
                "view_bytes": counts.view_bytes(rays),
                "view_flops": (counts.view_flops(rays, n, 28)
                               + rays * n * counts.sample_flops(28))}

    def reference_image(self, frame: int, dtype=torch.float32) -> np.ndarray:
        g, b = self.grid, self.base
        return ref.render_view(g.grid, g.min_bound, g.max_bound, b.grid, b.min_bound,
                               b.max_bound, self.poses[frame], self.H, self.W, self.focal,
                               self.center, self.scale, self.near, self.far, self.n, self.bg_sh,
                               dtype, stride=self.stride)
