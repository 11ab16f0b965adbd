"""Training traffic under the crop priors: loops/train.py's closed loop of
chunks of training steps, on a configuration whose ``tv_sigma``, ``tv_sh``
(and ``sparsity_sigma``) turn on the TV (and sparsity) priors that
``densify --tv-sigma --tv-sh`` trains with, and whose ``optimizer`` is
RMSprop (``rmsprop_decay``, ``rmsprop_eps``) on the main grid.

Each step then also draws its priors' block origins from the step's
generator, after its depth jitter, and the check holds the steps against
reference/train_priors.py with those draws. The window, the traced
sub-window and the compared numbers are loops/train.py's; before the
per-layer readers' eager chunk the window's graphs are released, since a
grid that fills the card leaves no room for a second gradient beside them.
"""
from __future__ import annotations

import dataclasses

import torch

from portbench.loops import train
from portbench.loops.train import gaps  # noqa: F401  (the compared numbers, as train's)
from portbench.reference import train as ref
from portbench.reference import train_priors as ref_priors


def priors(cfg: dict) -> dict:
    """The configuration's priors, as reference/train_priors.py takes them."""
    return {"tv_sigma": float(cfg.get("tv_sigma", 0.0)), "tv_sh": float(cfg.get("tv_sh", 0.0)),
            "tv_crop": int(cfg.get("tv_crop", 32)),
            "sparsity_sigma": float(cfg.get("sparsity_sigma", 0.0))}


class Run(train.Run):
    def _checked_steps(self) -> dict:
        """The program's configuration with the priors on, and the
        optimizer's settings, before loops/train.py's checked steps (its
        set-up calls this last, after building the training state: the
        priors change the step, not the state)."""
        pri = priors(self.cfg)
        self.priors = pri
        self.dcfg = dataclasses.replace(self.dcfg, tv_sigma=pri["tv_sigma"], tv_sh=pri["tv_sh"],
                                        tv_crop=pri["tv_crop"],
                                        sparsity_sigma=pri["sparsity_sigma"])
        if self.dcfg.optimizer == "rmsprop":
            self.opt = dict(name="rmsprop", lr=float(self.cfg["learning_rate"]),
                            decay=float(self.cfg["rmsprop_decay"]),
                            eps=float(self.cfg["rmsprop_eps"]))
        return super()._checked_steps()

    def layer_context(self) -> dict:
        self.multi.release()
        return super().layer_context()

    def draws(self) -> list:
        """The checked steps' draws, from a generator of the step seed in
        the order the step draws them: loops/train.py's uniforms (and fine
        uniforms), then the TV block's origin (one integer per axis below
        X - crop, Y - crop, Z - crop), then the sparsity block's (below
        X - crop + 1, ...)."""
        cfg, pri, X = self.cfg, self.priors, self.res
        g = torch.Generator(device=self.dev)
        g.manual_seed(self.step_seed)
        n = int(cfg.get("n_coarse", 64)) if cfg["hierarchical"] else int(cfg["num_samples"])
        width = n - n // 4 if cfg["contraction"] else n

        def origin(highs):
            return torch.stack([torch.randint(0, h, (), generator=g, device=self.dev)
                                for h in highs])

        out = []
        for _ in self.batches:
            u = torch.rand((self.B, width), generator=g, device=self.dev)
            uf = (torch.rand((self.B, int(cfg.get("n_fine", 64))), generator=g, device=self.dev)
                  if cfg["hierarchical"] else None)
            tv = (origin([d - min(pri["tv_crop"], d - 1) for d in X])
                  if pri["tv_sigma"] or pri["tv_sh"] else None)
            sp = (origin([d - min(pri["tv_crop"], d) + 1 for d in X])
                  if pri["sparsity_sigma"] else None)
            out.append((u, uf, tv, sp))
        return out

    def reference(self, dtype=torch.float32, half_batch: bool = False,
                  batches=None) -> dict:
        sc = ref.StepConfig(self.cfg, self.near, self.far)
        base = None if self.base is None else (self.base.grid, self.base.min_bound,
                                               self.base.max_bound)
        return ref_priors.train_steps(sc, self.opt, self.priors, (*self.res, 28), self.init,
                                      self.lo, self.hi, batches or self.batches, self.draws(),
                                      base, dtype, half_batch)
