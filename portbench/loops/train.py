"""Training traffic: a closed loop of chunks of training steps, as the
program's ``train_plenoxel`` drives them.

Set-up makes the scene of the seed on the device, every training ray of the
training views (ray stride from the traffic), the trained grid (a constant,
as ``densify`` starts it) and, for a cascade's detail phase, the frozen base
grid (the planes voxelized into the contracted frame). It builds one training
state and one ``make_multi_step`` object and drives that object through its
first 1 + 3 K steps on the first batches of the seed's ray order: step 1 as
a chunk of one step, then three chunks of the window's length K (scan_chunk):
the first eager, the second captured and replayed, the third replayed. The
window goes on replaying that same graph. What those steps leave (each loss,
the gradient that the optimizer's state holds after step 1, the grid after
the last) is what the check compares, and they are the window's warm-up. The
window replays chunks back to back, each a block of batches drawn without
replacement, reading one loss back every ``log_every`` steps.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import counts, profiling, scene as scn
from portbench.reference import train as ref

CHECKED_CHUNKS = 3        # chunks of K after step 1: eager, captured and replayed, replayed
TRACE_AFTER = 0.25        # the traced sub-window starts this far into the window
TRACE_CHUNKS = 11         # chunks in the traced sub-window (a loss read-back among them)


class Run:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from tpu3d_torch import f32_scope
        from tpu3d_torch.config import DenseConfig
        from tpu3d_torch.dense import train as dtrain
        from tpu3d_torch.dense.grid import VoxelGrid

        self.cfg, self.traffic, self.dev = cfg, traffic, torch.device(device)
        self.dtrain, self.f32_scope = dtrain, f32_scope
        self.stages = profiling.Stages(self.dev)
        with self.stages("scene"):
            sc = scn.Scene(cfg["scene"], seed, device)
        pts = sc.points
        if cfg["contraction"]:
            center, scale = scn.norm_contracted(pts, cfg["norm_core_q"], cfg["norm_core_radius"])
            box = 2.0
        else:
            center, scale = scn.norm_coremax(pts, cfg["coremax_q"])
            box = float(cfg["scene_scale"])
        near, far = scn.auto_near_far(sc.cams, pts, center, scale)
        with self.stages("rays"):
            self.rays = sc.train_rays(center, scale, int(traffic["ray_stride"]))
        self.B = int(cfg["batch_size"])
        self.K = int(cfg["scan_chunk"])
        self.n_rays = self.rays[0].shape[0]
        self.steps_per_epoch = self.n_rays // self.B
        dcfg = DenseConfig(
            grid_resolution=int(cfg["grid_resolution"]), num_samples=int(cfg["num_samples"]),
            near=near, far=far, scene_scale=box, batch_size=self.B,
            learning_rate=float(cfg["learning_rate"]), optimizer=cfg["optimizer"],
            lr_milestones=tuple(cfg["lr_milestones"]), lr_gamma=float(cfg["lr_gamma"]),
            white_background=bool(cfg["white_background"]),
            hierarchical=bool(cfg["hierarchical"]), contraction=bool(cfg["contraction"]),
            n_coarse=int(cfg.get("n_coarse", 64)), n_fine=int(cfg.get("n_fine", 64)),
            per_ray_aabb=bool(cfg["per_ray_aabb"]), scan_chunk=self.K)
        res = (int(cfg["grid_resolution"]),) * 3
        lo, hi = np.full(3, -box, np.float32), np.full(3, box, np.float32)
        self.base = None
        self.opt = dict(name=cfg["optimizer"], lr=float(cfg["learning_rate"]),
                        betas=tuple(cfg.get("adam_betas", (0.9, 0.999))),
                        eps=float(cfg.get("adam_eps", 1e-8)))
        init = float(cfg["init"])
        if traffic["grid"] == "detail":
            det = cfg["detail"]
            with self.stages("base"):
                base = sc.voxelize(res, lo, hi, center, scale, True, float(cfg["scene"]["sigma"]))
            self.base = VoxelGrid(base, torch.as_tensor(lo, device=self.dev),
                                  torch.as_tensor(hi, device=self.dev))
            lo, hi, res = scn.detail_box(pts, center, scale, float(det["coremax_q"]), lo, hi,
                                         int(det["voxel_budget"]))
            dcfg = dataclasses.replace(dcfg, optimizer="rmsprop")
            self.opt = dict(name="rmsprop", lr=float(cfg["learning_rate"]),
                            decay=float(det["decay"]), eps=float(det["eps"]))
            init = float(det["init"])
        self.dcfg, self.init, self.res, self.near, self.far = dcfg, init, tuple(res), near, far
        self.lo = torch.as_tensor(lo, device=self.dev)
        self.hi = torch.as_tensor(hi, device=self.dev)
        with self.stages("state"):
            grid = torch.full((*res, 28), init, dtype=torch.float32, device=self.dev)
            self.state = dtrain.init_state(dcfg, VoxelGrid(grid, self.lo, self.hi),
                                           self.steps_per_epoch)
            del grid
            self.multi = dtrain.make_multi_step(dtrain.train_step, with_occ=True)
        self.step_seed = seed
        self.gen = torch.Generator(device=self.dev)
        self.gen.manual_seed(self.step_seed)
        self.order = torch.Generator(device=self.dev)
        self.order.manual_seed(seed + 1)
        self.perm = torch.randperm(self.n_rays, generator=self.order, device=self.dev)
        self.next_batch = 0
        self.program = self._checked_steps()

    # ----------------------------------------------------------------- program

    def _chunk(self, k: int) -> torch.Tensor:
        """One call of the multi-step object over the next k batches of
        the ray order (a new order when the epoch runs out)."""
        if self.next_batch + k > self.steps_per_epoch:
            self.perm = torch.randperm(self.n_rays, generator=self.order, device=self.dev)
            self.next_batch = 0
        b, B = self.next_batch, self.B
        idx = self.perm[b * B:(b + k) * B].view(k, B)
        o, d, c = self.rays
        with self.f32_scope():
            lc = self.multi(self.state, self.dcfg, idx, o, d, c, occ=None, base=self.base,
                            generator=self.gen)
        self.next_batch += k
        return lc

    def _state_tensor(self) -> Optional[torch.Tensor]:
        """The optimizer's first moment (Adam) or second (RMSprop); None
        when it holds none (it never stepped)."""
        st = self.state.optimizer.state.get(self.state.grid.grid, {})
        return st.get("exp_avg", st.get("nu"))

    def _checked_steps(self) -> dict:
        """Step 1 as a chunk of one step, then CHECKED_CHUNKS chunks of K
        steps (eager; captured and replayed; replayed); the losses, the
        first gradient as the optimizer's state holds it after step 1
        (Adam: exp_avg / (1 - beta1); RMSprop: |g| = sqrt(nu / (1 -
        decay))), and the grid's change after the last step."""
        B, K = self.B, self.K
        n = 1 + CHECKED_CHUNKS * K
        self.groups = [1 + K] + [K] * (CHECKED_CHUNKS - 1)   # step 1 with the eager chunk
        self.batches = [tuple(t[self.perm[i * B:(i + 1) * B]] for t in self.rays)
                        for i in range(n)]
        with self.stages("step_1"):
            losses = [float(self._chunk(1)[0])]
        s = self._state_tensor()
        if s is None:
            sq = [0.0] * 28
        elif self.opt["name"] == "adam":
            sq = [v / (1 - self.opt["betas"][0]) ** 2 for v in ref.channel_sq_sums(s)]
        else:
            sq = [v / (1 - self.opt["decay"]) for v in ref.channel_sums(s)]
        grad = ref.leaf_norms(sq)
        for name in ("eager_chunk", "captured_chunk", "replayed_chunk")[:CHECKED_CHUNKS]:
            with self.stages(name):
                losses += [float(x) for x in self._chunk(K).tolist()]
        change = ref.leaf_norms(ref.channel_sq_sums(self.state.grid.grid.detach(), self.init))
        return {"losses": losses, "grad": grad, "change": change}

    # ------------------------------------------------------------------ window

    def window(self, seconds: float, trace: bool) -> dict:
        """Chunks back to back for ``seconds``; with ``trace`` a profiled
        sub-window of TRACE_CHUNKS chunks a quarter in. Every loss stays on
        the device until the window closes, except the one read back every
        ``log_every`` steps."""
        K, B, log_every = self.K, self.B, int(self.traffic["log_every"])
        losses: List[torch.Tensor] = []
        self.chunk_ms: List[float] = []
        sub = profiling.SubWindow(trace, TRACE_AFTER * seconds, TRACE_CHUNKS, self.dev)
        sub.sync()
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter()
            sub.before(now - t0)
            if now >= t0 + seconds and not sub.open:
                break
            with profiling.span("chunk_enqueue", sub.open):
                h0 = time.perf_counter()
                lc = self._chunk(K)
                if not sub.open and sub.done == 0:   # the profiler slows the host's launches
                    self.chunk_ms.append((time.perf_counter() - h0) * 1e3)
            losses.append(lc)
            first = self.next_batch - K
            for j in range(first, first + K):
                if j % log_every == 0:
                    with profiling.span("loss_readback", sub.open):
                        float(lc[j - first])
            sub.after()
        sub.sync()
        seconds_taken = time.perf_counter() - t0
        self.trace, self.traced_steps = sub.trace, TRACE_CHUNKS * K
        steps = len(losses) * K
        all_losses = torch.cat(losses) if losses else torch.zeros(0)
        failed = int((~torch.isfinite(all_losses)).sum())
        q = np.percentile(self.chunk_ms, [10, 50, 90, 100]) if self.chunk_ms else []
        return {"metrics": {"train_rays_per_s": steps * B / seconds_taken},
                "attempted": steps, "failed": failed,
                "note": f"{len(losses)} chunks in {seconds_taken:.3f} s; host ms per chunk call "
                        f"p10/p50/p90/max {np.round(q, 3).tolist()}"}

    # ------------------------------------------------------------------- trace

    def layer_context(self) -> dict:
        """What the per-layer readers read: the steady sub-window's trace,
        the host's ms per chunk over the window, the optimizer's device time
        per step in an eager chunk of the same shapes, and the counts."""
        optimizer_us = self._eager_optimizer_us()
        cfg = self.cfg
        C = 28
        fine = int(cfg.get("n_coarse", 64)) + int(cfg.get("n_fine", 64))
        samples = fine if cfg["hierarchical"] else int(cfg["num_samples"])
        coarse = int(cfg.get("n_coarse", 64)) if cfg["hierarchical"] else 0
        grids = 2 if self.base is not None else 1
        return {
            "trace": self.trace, "steps": self.traced_steps,
            "chunk_ms": self.chunk_ms, "optimizer_us_per_step": optimizer_us,
            "scatter_bytes": counts.scatter_bytes(self.B * samples, C, self.res),
            "step_bytes": counts.step_bytes(self.opt["name"], self.res, C, self.B),
            "step_flops": counts.step_flops(self.opt["name"], self.res, C, self.B, samples,
                                            coarse, grids),
        }

    def _eager_optimizer_us(self) -> Optional[float]:
        """Device us per step of the kernels launched inside the
        optimizer's step, from one eager chunk of K steps."""
        o, d, c = self.rays
        idx = self.perm[:self.K * self.B].view(self.K, self.B)
        torch.cuda.synchronize(self.dev)
        with profiling.profiler() as prof:
            with self.f32_scope():
                for ix in idx:
                    self.dtrain.train_step(self.state, self.dcfg, o[ix], d[ix], c[ix],
                                           generator=self.gen, occ=None, base=self.base)
            torch.cuda.synchronize(self.dev)
        us = profiling.range_device_us(prof.events(), "Optimizer.step#")
        return us / self.K if us > 0 else None

    # ------------------------------------------------------------------- check

    def release(self) -> None:
        """Free the program's training state."""
        self.multi.release()
        del self.state, self.multi
        self.rays = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def draws(self) -> list:
        """The checked steps' uniforms, drawn again from a generator of the
        step seed in the order the step draws them: per step a (B, W)
        stratified jitter, W = S (or under contraction the stratified three
        quarters of S), then under hierarchical sampling (B, n_fine)."""
        cfg = self.cfg
        n = int(cfg.get("n_coarse", 64)) if cfg["hierarchical"] else int(cfg["num_samples"])
        width = n - n // 4 if cfg["contraction"] else n
        g = torch.Generator(device=self.dev)
        g.manual_seed(self.step_seed)
        out = []
        for _ in self.batches:
            u = torch.rand((self.B, width), generator=g, device=self.dev)
            uf = (torch.rand((self.B, int(cfg.get("n_fine", 64))), generator=g, device=self.dev)
                  if cfg["hierarchical"] else None)
            out.append((u, uf))
        return out

    def reference(self, dtype=torch.float32, half_batch: bool = False,
                  batches: Optional[list] = None) -> dict:
        """The reference's steps over the checked batches (or ``batches``)
        and draws, in ``dtype``."""
        sc = ref.StepConfig(self.cfg, self.near, self.far)
        base = None if self.base is None else (self.base.grid, self.base.min_bound,
                                               self.base.max_bound)
        return ref.train_steps(sc, self.opt, (*self.res, 28), self.init, self.lo, self.hi,
                               batches or self.batches, self.draws(), base, dtype, half_batch)

    def check(self) -> Dict[str, float]:
        """The program's checked steps against the reference's."""
        self.release()
        return gaps(self.program, self.reference(), self.groups)


def gaps(got: dict, want: dict, groups: List[int]) -> Dict[str, float]:
    """The compared numbers: the loss, the median relative gap of the
    losses within each group of consecutive checked steps (``groups``: the
    chunk calls, step 1 with the first), the worst group; and, leaf by leaf,
    the gap between the two norms of the first gradient and of the grid's
    change after the last step, over the reference's norm of that leaf or of
    the median leaf, whichever is larger, the worst leaf. A leaf whose
    reference gradient is under a thousandth of the median leaf's moves by
    rounding alone and is left out of the change.

    The median, not the largest: Adam moves a voxel whose gradient is
    rounding noise by the whole learning rate, with the noise's sign, so
    the two sides' grids part by 2 lr at a few voxels; where a later ray's
    last sample (depth step 1e10) reads such a voxel's density across zero,
    relu makes it opaque on one side and clear on the other, and that one
    step's loss parts by up to a few thousandths. The steps around it agree."""
    rel = [abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])]
    ends = np.cumsum(groups)
    loss = max(float(np.median(rel[e - n:e])) for e, n in zip(ends, groups))
    med_g = float(np.median(list(want["grad"].values())))
    med_c = float(np.median(list(want["change"].values())))

    def worst(key, med, names):
        return max(abs(got[key][n] - want[key][n]) / max(want[key][n], med, 1e-30)
                   for n in names)

    names = list(want["grad"])
    moving = [n for n in names if want["grad"][n] >= 1e-3 * med_g]
    out = {"loss_gap": loss, "grad_gap": worst("grad", med_g, names),
           "change_gap": worst("change", med_c, moving)}
    return {k: (v if math.isfinite(v) else float("inf")) for k, v in out.items()}
