"""DVGO training traffic: loops/train.py's closed loop of chunks of training
steps, on DVGO's fine stage as ``densify --model dvgo`` trains it
(tpu3d_torch/dense/dvgo.py): a (X, Y, Z, 13) grid of density and k0 features
at the configuration's ``init`` (DVGO's zero), the colour MLP of the seed, MaskedAdam, 558 half-voxel samples a
ray at 160^3.

Set-up makes the scene of the seed on the device and every training ray,
builds one training state and one ``make_multi_step`` object over
``dvgo_train_step`` and drives it through step 1 and three chunks of K
(eager; captured and replayed; replayed) on the first batches of the
seed's ray order, as loops/train.py does. The check holds those steps
against reference/dvgo.py with the same batches, uniforms (one a ray) and
first MLP weights: the losses, the first gradient by leaf (the density,
k0, each linear layer) as MaskedAdam's first moment holds it after step 1,
and the model's change after the last step by leaf. The window replays
chunks back to back and reads one loss back every ``log_every`` steps; at
each read-back the step's device tallies (``dense.rgbnet_rows``,
``dense.colour_samples``) are folded into the program's tracer.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from portbench import counts_dvgo, profiling, scene as scn
from portbench.loops import train
from portbench.loops.train import CHECKED_CHUNKS, TRACE_AFTER, TRACE_CHUNKS, gaps  # noqa: F401
from portbench.reference import dvgo as ref

B1 = ref.BETAS[0]


class Run(train.Run):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from tpu3d_torch import f32_scope
        from tpu3d_torch.config import DenseConfig
        from tpu3d_torch.dense import dvgo
        from tpu3d_torch.dense import train as dtrain

        self.cfg, self.traffic, self.dev = cfg, traffic, torch.device(device)
        self.dtrain, self.f32_scope, self.fold = dtrain, f32_scope, dtrain.fold_tallies
        self.stages = profiling.Stages(self.dev)
        with self.stages("scene"):
            sc = scn.Scene(cfg["scene"], seed, device)
        center, scale = scn.norm_coremax(sc.points, cfg["coremax_q"])
        self.near, self.far = scn.auto_near_far(sc.cams, sc.points, center, scale)
        with self.stages("rays"):
            self.rays = sc.train_rays(center, scale, int(traffic["ray_stride"]))
        self.B, self.K = int(cfg["batch_size"]), int(cfg["scan_chunk"])
        self.n_rays = self.rays[0].shape[0]
        self.steps_per_epoch = self.n_rays // self.B
        self.res = (int(cfg["grid_resolution"]),) * 3
        self.spec = ref.Spec(self.res, float(cfg["scene_scale"]), self.near, self.far)
        self.dcfg = DenseConfig(grid_resolution=self.res[0], near=self.near, far=self.far,
                                scene_scale=float(cfg["scene_scale"]), batch_size=self.B,
                                scan_chunk=self.K)
        self.base, self.init = None, float(cfg["init"])
        with self.stages("state"):
            grid = dvgo.new_grid(self.dcfg, self.dev)
            grid.grid.fill_(self.init)
            self.lo, self.hi = grid.min_bound, grid.max_bound
            self.state = dvgo.init_state(self.dcfg, grid, self.steps_per_epoch, seed=seed)
            del grid
            self.params0 = [p.detach().clone() for p in self.state.params]
            self.multi = dtrain.make_multi_step(dvgo.dvgo_train_step, with_occ=False)
        self.step_seed = seed
        self.gen = torch.Generator(device=self.dev)
        self.gen.manual_seed(self.step_seed)
        self.order = torch.Generator(device=self.dev)
        self.order.manual_seed(seed + 1)
        self.perm = torch.randperm(self.n_rays, generator=self.order, device=self.dev)
        self.next_batch = 0
        self.program = self._checked_steps()

    def _checked_steps(self) -> dict:
        """Step 1 as a chunk of one step, then CHECKED_CHUNKS chunks of K
        steps (eager; captured and replayed; replayed); the losses, the
        first gradient by leaf as MaskedAdam's first moment holds it after
        step 1 (exp_avg / (1 - beta1)), and the model's change by leaf
        after the last step."""
        B, K = self.B, self.K
        n = 1 + CHECKED_CHUNKS * K
        self.groups = [1 + K] + [K] * (CHECKED_CHUNKS - 1)
        self.batches = [tuple(t[self.perm[i * B:(i + 1) * B]] for t in self.rays)
                        for i in range(n)]
        with self.stages("step_1"):
            losses = [float(self._chunk(1)[0])]
        st = self.state
        m = [st.optimizer.state[q]["exp_avg"] / (1 - B1) for q in (st.grid.grid, *st.params)]
        grad = ref.leaf_norms(ref.leaf_sq_sums(m[0], m[1:]))
        del m
        for name in ("eager_chunk", "captured_chunk", "replayed_chunk")[:CHECKED_CHUNKS]:
            with self.stages(name):
                losses += [float(x) for x in self._chunk(K).tolist()]
        grid = st.grid.grid.detach()
        change = ref.leaf_norms(ref.leaf_sq_sums(grid, [p.detach() for p in st.params],
                                                 torch.full_like(grid, self.init), self.params0))
        return {"losses": losses, "grad": grad, "change": change}

    def window(self, seconds: float, trace: bool) -> dict:
        """loops/train.py's window, folding the step's tallies into the
        program's tracer at each loss read-back."""
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
                if not sub.open and sub.done == 0:
                    self.chunk_ms.append((time.perf_counter() - h0) * 1e3)
            losses.append(lc)
            first = self.next_batch - K
            for j in range(first, first + K):
                if j % log_every == 0:
                    with profiling.span("loss_readback", sub.open):
                        float(lc[j - first])
                        self.fold(self.state)
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

    def layer_context(self) -> dict:
        """What the per-layer readers read: the steady sub-window's trace,
        the host's ms per chunk, the coloured samples a step (the program's
        counters ``dense.colour_samples`` over ``dense.rgbnet_rows``, times
        the rows a step; None without them) and counts_dvgo.py's counts."""
        from tpu3d_torch.utils.trace import get_tracer

        counters = get_tracer().summary().get("counters", {})
        rows, coloured = counters.get("dense.rgbnet_rows"), counters.get("dense.colour_samples")
        per_step: Optional[float] = (coloured / rows * self.B * self.spec.n
                                     if rows and coloured is not None else None)
        return {
            "trace": self.trace, "steps": self.traced_steps, "chunk_ms": self.chunk_ms,
            "colour_samples_per_step": per_step,
            "scatter_bytes": counts_dvgo.scatter_bytes(self.B, self.spec.n, self.res),
            "step_bytes": counts_dvgo.step_bytes(self.res, self.B),
            "step_flops": counts_dvgo.step_flops(self.res, self.B, self.spec.n, per_step or 0),
        }

    def draws(self) -> list:
        """The checked steps' uniforms, one a ray ((B, 1)), drawn again
        from a generator of the step seed in the order the step draws
        them."""
        g = torch.Generator(device=self.dev)
        g.manual_seed(self.step_seed)
        return [torch.rand((self.B, 1), generator=g, device=self.dev) for _ in self.batches]

    def reference(self, dtype=torch.float32, half_batch: bool = False,
                  batches: Optional[list] = None, **faults) -> dict:
        """reference/dvgo.py's steps over the checked batches (or
        ``batches``) and draws from the same first model, in ``dtype``,
        with reference/dvgo.py's ``faults``."""
        grid0 = torch.full((*self.res, counts_dvgo.CHANNELS), self.init, device=self.dev)
        return ref.train_steps(self.spec, grid0, self.params0, self.lo, self.hi,
                               batches or self.batches, self.draws(), dtype, half_batch,
                               **faults)
