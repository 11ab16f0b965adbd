"""Render traffic: a closed loop of whole views along a flythrough, as the
program's ``render`` command draws them (``dense/eval.py::render_view``).

Set-up makes the scene of the seed on the device and voxelizes its planes
into the configuration's grid (the frame ``densify`` would train in: the
cloud's coremax normalization, the box [-s, s]^3), with a grey SH
background; the poses are a flythrough interpolated along the cameras,
cycled. Each view is rendered at every ``stride``-th pixel of the camera's
rows and columns (``render --render-stride``). One view (the last pose)
warms the path. In the window each view is requested when the previous one
has returned, and is done when its (h, w, 3) image is a host array.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import counts, profiling, scene as scn
from portbench.reference import render as ref

TRACE_AFTER = 0.25        # the traced sub-window starts this far into the window
TRACE_VIEWS = 3           # whole views in the traced sub-window


class Run:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, warm: bool = True):
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
        self.center, self.scale = scn.norm_coremax(sc.points, cfg["coremax_q"])
        self.near, self.far = scn.auto_near_far(sc.cams, sc.points, self.center, self.scale)
        s = float(cfg["scene_scale"])
        res = (int(cfg["grid_resolution"]),) * 3
        lo, hi = np.full(3, -s, np.float32), np.full(3, s, np.float32)
        with self.stages("grid"):
            grid = sc.voxelize(res, lo, hi, self.center, self.scale, False,
                               float(cfg["scene"]["sigma"]))
        self.grid = VoxelGrid(grid, torch.as_tensor(lo, device=self.dev),
                              torch.as_tensor(hi, device=self.dev))
        self.bg_sh = torch.zeros((3, 9), dtype=torch.float32, device=self.dev)
        self.bg_sh[:, 0] = scn.BACKGROUND / scn.SH_C0
        self.n = int(cfg["num_samples"])
        self.dcfg = DenseConfig(near=self.near, far=self.far, num_samples=self.n,
                                per_ray_aabb=bool(cfg["per_ray_aabb"]))
        self.norm = SceneNormalization(self.center, self.scale)
        self.poses = scn.interpolate_poses(sc.cams, int(traffic["path_frames"]))
        self.chunk = int(traffic["chunk"])
        self.images: Dict[int, np.ndarray] = {}
        if warm:
            with self.stages("warm_view"):       # the last pose: the window starts at the first
                self._view(len(self.poses) - 1)

    def _view(self, frame: int) -> np.ndarray:
        return self.deval.render_view(self.grid, self.poses[frame], self.H, self.W, self.focal,
                                      self.dcfg, self.norm, stride=self.stride, chunk=self.chunk,
                                      bg_sh=self.bg_sh)

    def window(self, seconds: float, trace: bool) -> dict:
        """Views back to back for ``seconds``; with ``trace`` a profiled
        sub-window of TRACE_VIEWS views a quarter in. The first image of
        each pose is kept for the check."""
        latencies: List[float] = []
        failed, frame = 0, 0
        sub = profiling.SubWindow(trace, TRACE_AFTER * seconds, TRACE_VIEWS, self.dev)
        sub.sync()
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter()
            sub.before(now - t0)
            if now >= t0 + seconds and not sub.open:
                break
            f = frame % len(self.poses)
            t_req = time.perf_counter()
            try:
                with profiling.span("render_view", sub.open):
                    img = self._view(f)
                ok = math.isfinite(float(img.sum()))
            except RuntimeError:
                img, ok = None, False
            latencies.append(time.perf_counter() - t_req)
            failed += not ok
            if ok and f not in self.images:
                self.images[f] = img
            frame += 1
            sub.after()
        seconds_taken = time.perf_counter() - t0
        self.trace = sub.trace
        lat_ms = [x * 1e3 for x in latencies]
        return {"metrics": {"render_rays_per_s": len(latencies) * self.pixels / seconds_taken,
                            "render_view_p95_ms": percentile(lat_ms, 95.0)},
                "attempted": len(latencies), "failed": failed,
                "note": f"{len(lat_ms)} views in {seconds_taken:.3f} s; ms a view p50/p95/max "
                        f"{np.round(np.percentile(lat_ms, [50, 95, 100]), 3).tolist()}"}

    def layer_context(self) -> dict:
        rays = self.pixels
        return {"trace": self.trace, "views": TRACE_VIEWS,
                "trilinear_bytes": TRACE_VIEWS * counts.trilinear_bytes(rays * self.n, 28),
                "view_bytes": counts.view_bytes(rays),
                "view_flops": counts.view_flops(rays, self.n, 28)}

    def reference_image(self, frame: int, dtype=torch.float32) -> np.ndarray:
        return ref.render_view(self.grid.grid, self.grid.min_bound, self.grid.max_bound,
                               self.poses[frame], self.H, self.W, self.focal, self.center,
                               self.scale, self.near, self.far, self.n, self.bg_sh, dtype,
                               stride=self.stride)

    def sample(self) -> List[int]:
        """The poses checked: a sample drawn from the seed among those
        rendered in the window."""
        done = sorted(self.images)
        k = min(int(self.traffic["check_views"]), len(done))
        rng = np.random.default_rng(self.seed)
        return sorted(int(f) for f in rng.choice(done, k, replace=False))

    def check(self) -> Dict[str, float]:
        """The largest gap of any pixel channel between a checked view of
        the window and the reference's render of the same pose."""
        frames = self.sample()
        if not frames:
            return {"max_abs_px": float("inf")}
        worst = max(float(np.abs(self.images[f] - self.reference_image(f)).max())
                    for f in frames)
        return {"max_abs_px": worst if math.isfinite(worst) else float("inf")}


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile of all values, linear between order statistics
    (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))
