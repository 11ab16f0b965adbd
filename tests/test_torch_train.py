"""The port's dense training path (tpu3d_torch/kernels/trilinear_grad,
dense/{sdf,render,train}, cli.densify) against tpu3d's, on the CPU.

On the CPU the scatter wrapper runs its plain PyTorch version; it is held
against jax.grad through tpu3d's gather and against tpu3d's Pallas scatter
in interpret mode. Training steps take tpu3d's random draws (``StepNoise``)
and are held against both of tpu3d's step routes: the XLA one
(make_train_step) and the Pallas kernel pair in interpret mode
(make_train_step_packed). The CUDA kernel itself is compared with the plain
version by tests/test_torch_gpu.py and chip_smoke.py.

Run as a script, it prints tpu3d's held-out PSNR after train_plenoxel +
evaluate_views on the CPU, for seeds 0, 1, 2, on chip_smoke.py's
full-size training artifacts (what chip_smoke.TPU3D_CPU_TRAIN_PSNR and its
tolerance record) or, with ``small``, on this file's whole-slice scene:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_train.py [small]
"""
import dataclasses
import json
import os
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

import chip_smoke
import tpu3d.dense.eval as JE
import tpu3d.dense.train as JT
from tpu3d.config import DenseConfig as JaxDenseConfig
from tpu3d.dense.grid import VoxelGrid as JaxGrid
from tpu3d.dense.grid import trilinear_sample as jax_trilinear
from tpu3d.dense.sdf import sample_pdf as jax_sample_pdf
from tpu3d.dense.sdf import sample_stratified as jax_sample_stratified
from tpu3d.io.artifacts import ArtifactStore as JaxStore
from tpu3d.kernels.trilinear import CPAD, pack_grid, unpack_grid
from tpu3d.kernels.trilinear_grad import sample_packed_diff, scatter_grad
from tpu3d_torch.cli import densify
from tpu3d_torch.config import DenseConfig
from tpu3d_torch.dense import train as TT
from tpu3d_torch.dense.grid import VoxelGrid
from tpu3d_torch.dense.sdf import sample_pdf, sample_stratified
from tpu3d_torch.io.artifacts import ArtifactStore
from tpu3d_torch.kernels import LAUNCHES
from tpu3d_torch.kernels.trilinear import _corner_setup
from tpu3d_torch.kernels.trilinear_grad import (bins, trilinear_sample_diff,
                                                trilinear_scatter_grad,
                                                trilinear_scatter_grad_plain)

# The whole-slice scene: 8 views at 96x64, a 32^3 grid, 2 epochs, 64 samples.
N_VIEWS, W, H, RES, EPOCHS, SAMPLES = 8, 96, 64, 32, 2, 64
# tpu3d's held-out PSNR there varies by 0.3098 dB over seeds 0, 1, 2
# (6.6714 / 6.3616 / 6.5985 dB on the CPU, as `JAX_PLATFORMS=cpu
# PYTHONPATH=. python tests/test_torch_train.py small` prints); the port's
# random streams differ from tpu3d's, so it is held to twice that spread.
SLICE_PSNR_TOL_DB = 0.62


def t(a):
    return torch.from_numpy(np.array(a))


def n(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --------------------------------------------------------------------------
# The scatter and the autograd Function (tests/test_trilinear_grad.py's cases).

GRES, C = (8, 16, 16), 28
MINB, MAXB = np.full(3, -1.0, np.float32), np.full(3, 1.0, np.float32)


def _expected_grad(grid, pts, ct):
    """d/d grid of sum(ct * trilinear_sample(grid)(pts)) by XLA autodiff."""
    def f(g):
        vals, _ = jax_trilinear(g, jnp.asarray(MINB), jnp.asarray(MAXB), jnp.asarray(pts))
        return jnp.sum(vals * ct[:, :C])
    return np.asarray(jax.grad(f)(jnp.asarray(grid)))


def _scatter_case(seed):
    if seed == "cluster":
        rng = np.random.RandomState(11)
        pts = (np.float32([0.1, 0.2, -0.3]) + rng.uniform(-0.02, 0.02, (1500, 3))).astype(np.float32)
        return rng.randn(*GRES, C).astype(np.float32), pts, rng, 1e-4
    rng = np.random.RandomState(seed)
    grid = rng.randn(*GRES, C).astype(np.float32)
    pts = rng.uniform(-1.3, 1.3, size=(700, 3)).astype(np.float32)
    pts[:5] = [[-1, -1, -1], [1, 1, 1], [0, 1, -1], [1, 0, 0], [-1, 1, 1]]
    return grid, pts, np.random.RandomState(seed + 100), 1e-5


@pytest.mark.parametrize("seed", [0, 3, "cluster"])
def test_scatter_plain_matches_tpu3d(seed):
    """The plain scatter against jax.grad through tpu3d's gather and against
    tpu3d's Pallas scatter (interpret mode, unpacked): points inside, on
    and outside the box, and 1,500 in one cell; tolerances as tpu3d's own
    tests (1e-5, 1e-4 for the cluster)."""
    grid, pts, rng, tol = _scatter_case(seed)
    ct = rng.randn(len(pts), CPAD).astype(np.float32)
    ct[:, C:] = 0.0
    before = LAUNCHES["trilinear_grad_kernel"]
    got = trilinear_scatter_grad(t(ct[:, :C]), t(MINB), t(MAXB), GRES, t(pts))
    assert LAUNCHES["trilinear_grad_kernel"] == before     # a CPU tensor: plain version
    assert torch.equal(got, trilinear_scatter_grad_plain(t(ct[:, :C]), t(MINB), t(MAXB),
                                                         GRES, t(pts)))
    assert got.shape == (*GRES, C)
    want = _expected_grad(grid, pts, jnp.asarray(ct))
    pal = unpack_grid(scatter_grad(jnp.asarray(ct), jnp.asarray(MINB), jnp.asarray(MAXB), GRES,
                                   jnp.asarray(pts), interpret=True), (*GRES, C))
    for ref in (want, np.asarray(pal)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=tol, atol=tol)


def test_autograd_function_matches_sample_packed_diff():
    """Value and gradient of an MSE through trilinear_sample_diff against
    tpu3d's sample_packed_diff (interpret mode)."""
    grid, pts = _scatter_case(7)[:2]
    pts = pts[:300]
    target = np.random.RandomState(8).randn(len(pts), C).astype(np.float32)

    def loss_packed(p):
        vals, _ = sample_packed_diff(GRES, True, p, jnp.asarray(MINB), jnp.asarray(MAXB),
                                     jnp.asarray(pts))
        return jnp.mean((vals[:, :C] - target) ** 2)

    lp, gp = jax.value_and_grad(loss_packed)(pack_grid(jnp.asarray(grid)))
    g = t(grid).clone().requires_grad_()
    vals, inb = trilinear_sample_diff(g, t(MINB), t(MAXB), t(pts))
    assert not inb.requires_grad
    loss = ((vals - t(target)) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(lp), rtol=1e-6)
    np.testing.assert_allclose(g.grad.numpy(), np.asarray(unpack_grid(gp, (*GRES, C))),
                               rtol=1e-5, atol=1e-6)


def test_autograd_function_gradcheck():
    """torch.autograd.gradcheck in f64 on a 4^3 grid, on the plain versions:
    the scatter is the exact adjoint of the gather."""
    rng = np.random.default_rng(5)
    grid = t(rng.normal(0, 1, (4, 4, 4, 3))).requires_grad_()
    mn, mx = torch.full((3,), -1.0, dtype=torch.float64), torch.full((3,), 1.0, dtype=torch.float64)
    pts = t(rng.uniform(-1.2, 1.2, (40, 3)))
    assert torch.autograd.gradcheck(lambda g: trilinear_sample_diff(g, mn, mx, pts)[0], (grid,))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _numpy_scatter(ct, pts):
    """The scatter by np.add.at, which adds in index order, over the rows
    in (corner k = 4a + 2b + c, sample n) order, from numpy's own float32
    corner setup (tpu3d's _corner_setup arithmetic)."""
    X, Y, Z = GRES
    res = np.float32(GRES)
    u = (pts - MINB) / (MAXB - MINB)
    inb = ((u >= 0) & (u <= 1)).all(-1)
    v = u * (res - np.float32(1))
    i0 = np.minimum(np.maximum(np.floor(v), np.float32(0)), res - np.float32(2))
    f = v - i0
    i0 = i0.astype(np.int64)
    base = (i0[:, 0] * Y + i0[:, 1]) * Z + i0[:, 2]
    w = [(1 - f[:, a:a + 1], f[:, a:a + 1]) for a in range(3)]
    gv = ct * inb[:, None]
    rows = np.concatenate([base + (k >> 2) * Y * Z + ((k >> 1) & 1) * Z + (k & 1)
                           for k in range(8)])
    vals = np.concatenate([w[0][k >> 2] * w[1][(k >> 1) & 1] * w[2][k & 1] * gv
                           for k in range(8)])
    out = np.zeros((X * Y * Z, ct.shape[1]), np.float32)
    np.add.at(out, rows, vals)
    return out.reshape(*GRES, -1)


@pytest.mark.parametrize("seed", [0, 3, "cluster"])
def test_scatter_plain_sums_in_corner_then_sample_order(seed):
    """The plain scatter on the CPU equals np.add.at over (corner, sample)
    ordered rows bit for bit: the order trilinear_grad_kernel follows on the
    card (csrc/trilinear_grad.cu), pinned."""
    _, pts, rng, _ = _scatter_case(seed)
    ct = rng.randn(len(pts), C).astype(np.float32)
    got = trilinear_scatter_grad_plain(t(ct), t(MINB), t(MAXB), GRES, t(pts))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(_numpy_scatter(ct, pts)))


def _kernel_order_scatter(ct, mn, mx, pts):
    """trilinear_grad_kernel's sums on the CPU from the wrapper's binning:
    the keys and corner weights as trilinear_grad_keys computes them, then
    ``bins`` (the stable sort and the column starts); each output row adds,
    corner by corner, the run of its base cell (x-a, y-b, z-c), from the
    first sorted positions of the clamped cells z - c and z - c + 1 inside
    the column's range, in sorted order, from +0.0."""
    X, Y, Z = GRES
    i0, frac, inb = _corner_setup(GRES, mn, mx, pts)
    keys = torch.where(inb, (i0[:, 0] * Y + i0[:, 1]) * Z + i0[:, 2], X * Y * Z).int()
    w = [(1 - frac[:, a:a + 1], frac[:, a:a + 1]) for a in range(3)]
    weights = torch.cat([w[0][k >> 2] * w[1][(k >> 1) & 1] * w[2][k & 1] for k in range(8)], 1)
    sorted_keys, perm, col_start = bins(keys, GRES)
    g_sorted, w_sorted = ct.index_select(0, perm), weights.index_select(0, perm)
    x, y, z = (a.reshape(-1) for a in torch.meshgrid(
        torch.arange(X), torch.arange(Y), torch.arange(Z), indexing="ij"))
    out = torch.zeros((X * Y * Z, ct.shape[1]))
    for k in range(8):
        cx, cy, zb = x - (k >> 2), y - ((k >> 1) & 1), z - (k & 1)
        ok = (cx >= 0) & (cy >= 0)
        col = cx.clamp(min=0) * Y + cy.clamp(min=0)

        def first(zq):
            want = (col * Z + zq.clamp(0, Z - 1)).int()
            pos = torch.searchsorted(sorted_keys, want).int()
            return torch.where(ok, pos.clamp(col_start[col], col_start[col + 1]), 0)

        lo, hi = first(zb), first(zb + 1)
        for j in range(int((hi - lo).max())):
            m = hi - lo > j
            out[m] = out[m] + w_sorted[lo[m] + j, k:k + 1] * g_sorted[lo[m] + j]
    return out.reshape(*GRES, -1), sorted_keys, perm


@pytest.mark.parametrize("seed", [0, 3, "cluster"])
def test_scatter_kernel_order_matches_plain(seed):
    """The kernel's order, from the wrapper's own binning, equals the plain
    version bit for bit on points inside, on and outside the box, and on
    1,500 points in one cell: samples outside the box sort past every
    cell, and the stable sort keeps each cell's samples in sample order."""
    _, pts, rng, _ = _scatter_case(seed)
    ct = t(rng.randn(len(pts), C).astype(np.float32))
    got, sorted_keys, perm = _kernel_order_scatter(ct, t(MINB), t(MAXB), t(pts))
    want = trilinear_scatter_grad_plain(ct, t(MINB), t(MAXB), GRES, t(pts))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))
    assert bool((sorted_keys[1:] >= sorted_keys[:-1]).all())
    same = sorted_keys[1:] == sorted_keys[:-1]
    assert bool((perm[1:][same] > perm[:-1][same]).all())


# --------------------------------------------------------------------------
# Samplers with injected uniforms.


def test_samplers_match_tpu3d(rng):
    """Jittered stratified depths and inverse-CDF importance samples, with
    tpu3d's uniforms, and sample_pdf's deterministic quantiles."""
    tn = rng.uniform(0.1, 1, 30).astype(np.float32)
    tf = tn + rng.uniform(0.5, 4, 30).astype(np.float32)
    u = rng.uniform(0, 1, (30, 12)).astype(np.float32)
    got = sample_stratified(t(tn), t(tf), 12, perturb=True, u=t(u))
    ref = jax_sample_stratified(None, jnp.asarray(tn), jnp.asarray(tf), 12, True, u=jnp.asarray(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    bins = np.sort(rng.uniform(0.5, 3, (30, 16)), axis=1).astype(np.float32)
    w = rng.uniform(0, 1, (30, 16)).astype(np.float32) ** 4
    u = rng.uniform(0, 1, (30, 9)).astype(np.float32)
    for det, uu in ((False, u), (True, None)):
        got = sample_pdf(t(bins), t(w), 9, det=det, u=None if uu is None else t(uu))
        ref = jax_sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), 9, det=det,
                             u=None if uu is None else jnp.asarray(uu))
        # det's last quantile, u = 1, lands on the CDF's end, which the two
        # cumsums round to 1 or to 1 - 2^-24: the bin it picks is rounding's
        cols = slice(None, -1 if det else None)
        np.testing.assert_allclose(got.numpy()[:, cols], np.asarray(ref)[:, cols],
                                   rtol=1e-5, atol=1e-5)
    g = torch.Generator().manual_seed(0)
    z = sample_stratified(t(tn), t(tf), 12, perturb=True, generator=g)
    assert bool(((z >= t(tn)[:, None]) & (z <= t(tf)[:, None])).all())
    with pytest.raises(ValueError, match="uniforms"):
        sample_stratified(t(tn), t(tf), 12, perturb=True, u=t(u))


# --------------------------------------------------------------------------
# Training steps against both of tpu3d's routes.

SRES, BATCH, N_RAYS, N_CAMS = 16, 64, 320, 4
LO, HI = np.full(3, -1.5, np.float32), np.full(3, 1.5, np.float32)
# The cascade case's detail layer: a non-cubic grid over part of the base's box.
DETAIL_RES = (8, 16, 16)
DETAIL_LO, DETAIL_HI = np.float32([-0.6, -0.8, -0.7]), np.float32([0.9, 0.8, 0.6])


def _step_cfg(case, **kw):
    base = dict(grid_resolution=SRES, batch_size=BATCH, num_samples=8, near=0.5, far=4.0,
                n_coarse=6, n_fine=6, scan_chunk=1,
                hierarchical=case in ("hierarchical", "contracted", "cascade"))
    if case == "regularized":
        base.update(tv_sigma=0.3, tv_sh=0.05, sparsity_sigma=0.02, exposure=True,
                    sh_background=True)
    elif case == "contracted":
        base.update(contraction=True, per_ray_aabb=False, n_coarse=8, optimizer="rmsprop")
    elif case == "occupancy":
        base.update(occupancy_prune=True, occupancy_probes=12, optimizer="rmsprop")
    elif case == "cascade":
        base.update(optimizer="rmsprop")
    base.update(kw)
    return JaxDenseConfig(**base), DenseConfig(**base)


def _rays(seed=0):
    rng = np.random.RandomState(seed)
    o = np.zeros((N_RAYS, 3), np.float32)
    o[:, 0] = -2.0
    o[:, 1:] = rng.uniform(-0.3, 0.3, (N_RAYS, 2))
    d = rng.randn(N_RAYS, 3).astype(np.float32) * 0.4
    d[:, 0] = np.abs(d[:, 0]) + 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (o, d, rng.rand(N_RAYS, 3).astype(np.float32),
            rng.randint(0, N_CAMS, N_RAYS).astype(np.int32))


def _grid0(seed=1):
    rng = np.random.RandomState(seed)
    g = (rng.randn(SRES, SRES, SRES, 28) * 0.3).astype(np.float32)
    g[..., 0] = rng.randn(SRES, SRES, SRES) * 2.0   # relu-0 cells let light reach the background
    return g


def _occupancy():
    """A (4, 4, 4) occupancy of the 16^3 grid at factor 4 with the middle
    cells occupied and every face cell empty (a band's first and last
    probes lie on the box's faces, where rounding decides whether they are
    inside; an empty face cell gives the same answer either way)."""
    occ = np.zeros((4, 4, 4), bool)
    occ[1:3, 1:3, 1:3] = True
    occ[1, 2, 1] = False
    return occ


def _jax_noise(cfg, key, grid_shape):
    """tpu3d's draws for step key ``key``, as the port's StepNoise."""
    n = cfg.n_coarse if cfg.hierarchical else cfg.num_samples
    n = n - n // 4 if cfg.contraction else n
    if cfg.hierarchical:
        k1, k2 = jax.random.split(key)
        u = jax.random.uniform(k1, (BATCH, n), jnp.float32)
        u_fine = jax.random.uniform(k2, (BATCH, cfg.n_fine), jnp.float32)
    else:
        u, u_fine = jax.random.uniform(key, (BATCH, n), jnp.float32), None

    def origin(fold, extra):
        ks = jax.random.split(jax.random.fold_in(key, fold), 3)
        return t(np.array([int(jax.random.randint(k, (), 0, d - min(cfg.tv_crop, d - 1 + extra)
                                                  + extra))
                           for k, d in zip(ks, grid_shape[:3])], np.int64))

    tv = origin(7, 0) if cfg.tv_sigma or cfg.tv_sh else None
    sp = origin(11, 1) if cfg.sparsity_sigma else None
    return TT.StepNoise(t(np.asarray(u)), None if u_fine is None else t(np.asarray(u_fine)),
                        tv, sp)


class _Runs:
    """The same injected steps through the port and one of tpu3d's routes.
    The contracted case's grid spans [-2, 2]^3; the cascade case trains a
    zero detail layer against the frozen 16^3 grid as its base; the
    occupancy case guides the depths by :func:`_occupancy`."""

    def __init__(self, case, route, optimizer=None):
        self.jcfg, self.cfg = _step_cfg(case, **({} if optimizer is None
                                                 else {"optimizer": optimizer}))
        self.route = route
        g0, lo, hi = _grid0(), LO, HI
        self.base = self.jbase = None
        if case == "contracted":
            lo, hi = np.full(3, -2.0, np.float32), np.full(3, 2.0, np.float32)
        elif case == "cascade":
            self.base = VoxelGrid(t(g0), t(LO), t(HI))
            self.jbase = (pack_grid(jnp.asarray(g0)), jnp.asarray(LO), jnp.asarray(HI))
            g0, lo, hi = np.zeros(DETAIL_RES + (28,), np.float32), DETAIL_LO, DETAIL_HI
        self.g0, self.res = g0, g0.shape[:3]
        self.occ = t(_occupancy()) if case == "occupancy" else None
        self.rays = _rays()
        jopt = JT.make_optimizer(self.jcfg, 5)
        garr = pack_grid(jnp.asarray(g0)) if route == "packed" else jnp.asarray(g0)
        exp0 = JT.init_exposure(N_CAMS) if self.jcfg.exposure else None
        bg0 = JT.init_background() if self.jcfg.sh_background else None
        self.jstate = JT.TrainState(JaxGrid(garr, jnp.asarray(lo), jnp.asarray(hi)),
                                    jopt.init(garr), jnp.asarray(0), exp0, bg0)
        self.jstep = (JT.make_train_step_packed(self.jcfg, jopt, self.res, interpret=True,
                                                base_res=None if self.base is None
                                                else (SRES,) * 3)
                      if route == "packed" else JT.make_train_step(self.jcfg, jopt))
        self.state = TT.init_state(self.cfg, VoxelGrid(t(g0.copy()), t(lo), t(hi)), 5,
                                   N_CAMS if self.cfg.exposure else None)

    def step(self, i):
        o, d, rgb, cid = self.rays
        sel = np.random.RandomState(100 + i).choice(N_RAYS, BATCH, replace=False)
        key = jax.random.fold_in(jax.random.PRNGKey(3), i)
        jc = jnp.asarray(cid[sel]) if self.jcfg.exposure else None
        kw = {} if self.jbase is None else {"base": self.jbase}
        self.jstate, jl = self.jstep(self.jstate, key, jnp.asarray(o[sel]), jnp.asarray(d[sel]),
                                     jnp.asarray(rgb[sel]),
                                     occ=None if self.occ is None else jnp.asarray(self.occ),
                                     cid=jc, **kw)
        loss = TT.train_step(self.state, self.cfg, t(o[sel]), t(d[sel]), t(rgb[sel]),
                             t(cid[sel].astype(np.int64)) if self.cfg.exposure else None,
                             noise=_jax_noise(self.jcfg, key, self.res), occ=self.occ,
                             base=self.base)
        return float(loss), float(jl)

    def _unpacked(self, a):
        return np.asarray(unpack_grid(a, self.res + (28,))) if self.route == "packed" \
            else np.asarray(a)

    def pairs(self):
        """(name, port array, tpu3d array) of everything a step updates."""
        p = self.state.grid.grid
        st = self.state.optimizer.state[p]
        out = [("grid", n(p), self._unpacked(self.jstate.grid.grid))]
        if self.cfg.optimizer == "rmsprop":
            out.append(("nu", n(st["nu"]), self._unpacked(self.jstate.opt_state[0].nu)))
        else:
            adam = self.jstate.opt_state[0]
            out += [("mu", n(st["exp_avg"]), self._unpacked(adam.mu)),
                    ("nu", n(st["exp_avg_sq"]), self._unpacked(adam.nu))]
        for k in ("exposure", "background"):
            if getattr(self.state, k) is not None:
                out.append((k, n(getattr(self.state, k)), np.asarray(getattr(self.jstate, k))))
        assert self.state.step == int(self.jstate.step)
        return out


@pytest.mark.parametrize("case, route", [
    ("plain", "xla"), ("plain", "packed"), ("hierarchical", "xla"), ("hierarchical", "packed"),
    ("regularized", "xla"), ("regularized", "packed"), ("contracted", "xla"),
    ("contracted", "packed"), ("occupancy", "xla"), ("occupancy", "packed"),
    ("cascade", "packed")])
def test_train_step_matches_tpu3d(case, route):
    """One step, then four more chained, with tpu3d's draws injected: loss,
    grid, Adam moments, exposure and background within 1e-5 after one step,
    and within tpu3d's own tolerance between its two routes after five
    (rtol 2e-4, atol 5e-4: Adam's sqrt(v) amplifies rounding on near-zero
    gradients, tests/test_trilinear_grad.py:106-110). The regularized case
    turns on TV, sparsity, exposure and the SH background; its 32^3 crop
    covers the 16^3 grid, where tpu3d's two routes crop alike. The
    contracted case is hierarchical under contraction, unclipped; the
    occupancy case samples its depths by an occupancy grid; the cascade
    case (hierarchical) trains a detail layer against a frozen base, on the
    Pallas route that tpu3d forces for a cascade. These three step with
    rmsprop (the cascade's own optimizer): their far samples leave voxels
    whose gradient is near Adam's 1e-8 epsilon, where Adam's first step
    lr g / (|g| + 1e-8) turns a rounding-sized change of g into a share of
    lr (with Adam, 2 of 114,688 voxels 3.6e-5 apart after one contracted
    step and 1 voxel 9.2e-4 apart after five occupancy steps, the moments
    within tolerance)."""
    runs = _Runs(case, route)
    loss, jloss = runs.step(0)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=1e-6)
    for name, got, ref in runs.pairs():
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5, err_msg=name)
    assert np.abs(runs.pairs()[0][1] - runs.g0).max() > 1e-3     # the grid moved
    for i in range(1, 5):
        loss, jloss = runs.step(i)
        np.testing.assert_allclose(loss, jloss, rtol=2e-4, atol=5e-4)
    for name, got, ref in runs.pairs():
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=5e-4, err_msg=name)


def test_rmsprop_step_matches_optax():
    """One rmsprop step against optax.rmsprop(decay 0.95, eps 1e-8 inside
    the root): within 1e-5 (torch.optim.RMSprop's eps outside the root would
    move near-zero-gradient voxels by up to lr instead)."""
    runs = _Runs("plain", "xla", optimizer="rmsprop")
    assert isinstance(runs.state.optimizer, TT.RMSprop)
    loss, jloss = runs.step(0)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=1e-6)
    for name, got, ref in runs.pairs():
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5, err_msg=name)


def test_crop_priors_match_tpu3d(rng):
    """The TV and sparsity priors on a crop smaller than the grid, at
    origins drawn by tpu3d's keys, against tpu3d's on the XLA layout: value
    and grid gradient."""
    g = rng.normal(0, 1, (12, 10, 14, 28)).astype(np.float32)
    jcfg, _ = _step_cfg("plain", tv_crop=5, tv_sigma=1.0, sparsity_sigma=1.0)
    key = jax.random.PRNGKey(9)
    noise = _jax_noise(jcfg, key, g.shape)
    for fn, jfn, origin, fold in ((TT._tv_crop_loss, JT._tv_crop_loss, noise.tv_origin, 7),
                                  (TT._sparsity_crop_loss, JT._sparsity_crop_loss,
                                   noise.sparsity_origin, 11)):
        def jtotal(a):
            out = jfn(a, jax.random.fold_in(key, fold), 5)
            return sum(out) if isinstance(out, tuple) else out
        gt = t(g).clone().requires_grad_()
        out = fn(gt, origin, 5)
        total = sum(out) if isinstance(out, tuple) else out
        total.backward()
        jval, jgrad = jax.value_and_grad(jtotal)(jnp.asarray(g))
        np.testing.assert_allclose(float(total.detach()), float(jval), rtol=1e-5)
        np.testing.assert_allclose(gt.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-7)
        assert 0 < np.count_nonzero(gt.grad.numpy()) < g.size


def test_lr_schedule_matches_optax():
    cfg = DenseConfig()
    jcfg = JaxDenseConfig()
    for spe in (1, 7, 100):
        ours, ref = TT._lr_schedule(cfg, spe), JT._lr_schedule(jcfg, spe)
        for m in (0, 2, 4, 8):
            for k in (m * spe - 1, m * spe, m * spe + 1):
                if k >= 0:
                    np.testing.assert_allclose(ours(k), float(ref(k)), rtol=1e-6, err_msg=(spe, k))


# --------------------------------------------------------------------------
# The dense_ckpt carry-over, both ways, and resume.


def _ckpt_dataset():
    o, d, rgb, cid = _rays(4)
    return JT.RayDataset(o, d, rgb, cid), TT.RayDataset(o, d, rgb, cid)


@pytest.mark.parametrize("packed", [False, True])
def test_tpu3d_checkpoint_loads_into_the_port(tmp_path, packed):
    """tpu3d's train_plenoxel checkpoint (its XLA route's (X, Y, Z, C) arrays,
    or the packed layout its accelerator route writes) loads into the port
    with identical arrays, and one injected step from it agrees with
    tpu3d's from its own load."""
    jcfg, cfg = _step_cfg("regularized", epochs=1)
    jds, _ = _ckpt_dataset()
    JT.train_plenoxel(jds, jcfg, verbose=False, packed=packed, grid=JaxGrid(
        jnp.asarray(_grid0()), jnp.asarray(LO), jnp.asarray(HI)),
        checkpoint_store=JaxStore(str(tmp_path)))
    spe = N_RAYS // BATCH
    state, epoch, losses = TT.load_checkpoint(ArtifactStore(str(tmp_path)), cfg, spe, "cpu")
    jopt = JT.make_optimizer(jcfg, spe)
    jstate, jepoch, jlosses = JT.load_checkpoint(JaxStore(str(tmp_path)), jopt)
    assert (epoch, losses, state.step) == (jepoch, jlosses, int(jstate.step)) == (0, jlosses, spe)
    runs = _Runs("regularized", "packed" if packed else "xla")
    runs.state, runs.jstate = state, jstate
    if packed:
        runs.jstep = JT.make_train_step_packed(jcfg, jopt, (SRES,) * 3, interpret=True)
    else:
        runs.jstep = JT.make_train_step(jcfg, jopt)
    for name, got, ref in runs.pairs():
        np.testing.assert_array_equal(got, ref, err_msg=name)
    assert int(state.optimizer.state[state.grid.grid]["step"]) == spe
    loss, jloss = runs.step(0)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=1e-6)
    for name, got, ref in runs.pairs():
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5, err_msg=name)


def test_port_checkpoint_loads_in_tpu3d_and_resumes(tmp_path):
    """The port's checkpoint loads in tpu3d's load_checkpoint with identical
    arrays (optax's leaves in order), one injected step from each load
    agrees, and resume continues after the saved epoch."""
    jcfg, cfg = _step_cfg("regularized", epochs=1)
    _, ds = _ckpt_dataset()
    store = ArtifactStore(str(tmp_path))
    TT.train_plenoxel(ds, cfg, verbose=False, log_every=1, checkpoint_store=store,
                      device="cpu", grid=VoxelGrid(t(_grid0()), t(LO), t(HI)))
    spe = N_RAYS // BATCH
    losses1 = list(TT.LAST_TRAIN_AUX["log"])
    jstate, jepoch, jlosses = JT.load_checkpoint(JaxStore(str(tmp_path)),
                                                 JT.make_optimizer(jcfg, spe))
    state, epoch, losses = TT.load_checkpoint(store, cfg, spe, "cpu")
    assert (jepoch, int(jstate.step)) == (epoch, state.step) == (0, spe)
    np.testing.assert_array_equal(np.asarray(jlosses), np.asarray(losses, np.float32))
    runs = _Runs("regularized", "xla")
    runs.state, runs.jstate = state, jstate
    runs.jstep = JT.make_train_step(jcfg, JT.make_optimizer(jcfg, spe))
    adam = jstate.opt_state[0]
    assert int(adam.count) == int(jstate.opt_state[1].count) == spe
    for name, got, ref in runs.pairs():
        np.testing.assert_array_equal(got, ref, err_msg=name)
    loss, jloss = runs.step(0)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=1e-6)
    for name, got, ref in runs.pairs():
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5, err_msg=name)
    # resume: epoch 0 is in the store, so only epoch 1 runs
    _, losses2 = TT.train_plenoxel(ds, dataclasses.replace(cfg, epochs=2),
                                   verbose=False, log_every=1, checkpoint_store=store,
                                   resume=True, device="cpu")
    assert TT.LAST_TRAIN_AUX["steps"] == 2 * spe
    assert [e["epoch"] for e in TT.LAST_TRAIN_AUX["log"]] == [1] * spe
    assert len(losses2) == 2 * spe and losses2[:spe] == [e["loss"] for e in losses1]
    assert int(store.load("dense_ckpt")["epoch"]) == 1


def test_unported_training_options_refuse(tmp_path, capsys):
    """What a device mesh does not take refuses before it reads anything:
    the cascade's --detail-only, as tpu3d's. The mesh itself (item 10) and
    the SDF model (item 7d), once refused, now run: train_sdf on a small
    ray set trains and logs (the mesh's runs are in test_torch_dist*.py)."""
    from tpu3d_torch.cli import main

    base = ["densify", "--images", str(tmp_path / "none"), "--artifacts", str(tmp_path / "a"),
            "--device", "cpu"]
    for extra in (["--mesh", "auto", "--detail-only"],
                  ["--mesh", "2x4", "--contraction", "--detail-only"]):
        with pytest.raises(SystemExit) as e:
            main(base + extra)
        assert e.value.code == 1
        assert "single-device path" in capsys.readouterr().err
    o, d, rgb, _ = _rays()
    cfg = DenseConfig(grid_resolution=SRES, batch_size=BATCH, num_samples=8, epochs=1)
    grid, losses = TT.train_sdf(TT.RayDataset(o, d, rgb), cfg, verbose=False, log_every=1,
                                device="cpu")
    assert grid.resolution == (SRES,) * 3 and len(losses) == N_RAYS // BATCH
    assert np.all(np.isfinite(losses))


# --------------------------------------------------------------------------
# The whole slice: densify against tpu3d's cmd_densify.


def tpu3d_args(images, artifacts, **kw):
    """The argparse namespace of tpu3d's `densify` with its defaults."""
    a = dict(images=images, artifacts=artifacts, downscale=1, dense_downscale=1, focal=0.0,
             max_keypoints=2048, min_raw_matches=100, max_tracks=400_000,
             ransac_hypotheses=512, global_ba_every=8, epochs=1, ray_stride=2,
             model="plenoxel", contraction=False, norm="coremax", norm_core_q=92.0,
             norm_margin=1.15, norm_core_radius=0.9, occupancy=False, sparsity_sigma=0.0,
             sh_background=False, exposure=False, coarse_epochs=0, hierarchical=False,
             holdout_every=8, max_eval_views=8, tv_sigma=0.0, tv_sh=0.0,
             grid_resolution=256, aniso_grid=False, coremax_q=80.0, detail_epochs=0,
             detail_res=0, camera_gate=False, camera_gate_epoch=2,
             include_low_confidence=False, mesh="", dense_optimizer="adam", scene_scale=0.0,
             num_samples=192, rays_pkl="", resume=False, no_checkpoint=False,
             final_grid=False, band_core_radius=0.0, detail_only=False, eval_only=False,
             quiet=True)
    a.update(kw)
    return types.SimpleNamespace(**a)


def test_densify_matches_tpu3d(tmp_path):
    """densify on the CPU against tpu3d's cmd_densify with the same flags on
    the same artifact directory (8 views at 96x64, a 32^3 grid, 2 epochs,
    64 samples per ray): dense_meta equal, mesh_grid's channels and dtype
    equal, the same dense_result keys and held-out views, PSNR within
    SLICE_PSNR_TOL_DB; and tpu3d's --eval-only reads the port's artifacts
    and scores the port's grid within 0.01 dB of the port's own score."""
    from tpu3d.cli import cmd_densify

    scene = chip_smoke.make_scene(0, n_views=N_VIEWS, width=W, height=H)
    images = tmp_path / "images"
    images.mkdir()
    names = [f"img_{i:03d}.png" for i in range(N_VIEWS)]
    for name, rgb in zip(names, scene["rgb"]):
        Image.fromarray(rgb).save(images / name)
    ours, ref = tmp_path / "port", tmp_path / "tpu3d"
    for d in (ours, ref):
        chip_smoke.make_reconstruction_artifacts(str(d), scene)
    cmd_densify(tpu3d_args(str(images), str(ref), focal=scene["focal"], epochs=EPOCHS,
                           grid_resolution=RES, num_samples=SAMPLES))
    out = densify(str(ours), scene["rgb"], names, scene["focal"], epochs=EPOCHS,
                  grid_resolution=RES, num_samples=SAMPLES, device="cpu")
    js, ps = JaxStore(str(ref)), ArtifactStore(str(ours))
    assert json.dumps(ps.load_json("dense_result"), sort_keys=True) == json.dumps(out, sort_keys=True)
    jm, pm = js.load_json("dense_meta"), ps.load_json("dense_meta")
    assert jm.keys() == pm.keys()
    for k, v in jm.items():
        if isinstance(v, (float, list)):
            np.testing.assert_allclose(pm[k], v, rtol=1e-6, err_msg=k)
        else:
            assert pm[k] == v, k
    jg, pg = js.load("mesh_grid"), ps.load("mesh_grid")
    assert jg.keys() == pg.keys()
    for k in jg:
        assert jg[k].dtype == pg[k].dtype and jg[k].shape == pg[k].shape, k
    np.testing.assert_array_equal(pg["min_bound"], jg["min_bound"])
    jd, pd = js.load("dense_grid"), ps.load("dense_grid")
    assert jd.keys() == pd.keys() and jd["grid"].shape == pd["grid"].shape == (RES,) * 3 + (28,)
    np.testing.assert_array_equal(
        pg["grid"], pd["grid"][..., [0, 1, 10, 19]].astype(np.float16))
    jr = js.load_json("dense_result")
    assert jr.keys() == out.keys()
    assert out["test_view_names"] == jr["test_view_names"] == ["img_004.png"]
    assert out["recipe"] == jr["recipe"]
    assert abs(out["test_psnr"] - jr["test_psnr"]) <= SLICE_PSNR_TOL_DB
    assert np.isfinite(out["final_loss"]) and out["dropped_cameras"] == []
    assert ps.has("dense_ckpt") and int(ps.load("dense_ckpt")["epoch"]) == EPOCHS - 1
    # tpu3d's --eval-only reads the port's artifacts and scores its grid alike
    from tpu3d.cli import _densify_eval_only
    from tpu3d.config import PipelineConfig as JaxPipelineConfig

    jps = JaxStore(str(ours))
    _densify_eval_only(types.SimpleNamespace(holdout_every=8, max_eval_views=8),
                       JaxPipelineConfig(), jps, jps.load("reconstruction"),
                       jps.load_json("reconstruction_meta"), names, scene["rgb"],
                       scene["focal"])
    np.testing.assert_allclose(jps.load_json("dense_result")["test_psnr"], out["test_psnr"],
                               atol=0.01)


# --------------------------------------------------------------------------
# tpu3d's reference numbers.


def tpu3d_train_psnr(root, scene, seed, res, ray_stride, epochs, num_samples=192,
                     log_every=170):
    """tpu3d's densify with its default flags (coremax normalization, the
    scene-derived band, the name-keyed holdout every 8 views, scene scale
    1.0) through train_plenoxel(seed) and evaluate_views; returns
    (evaluate_views' dict, losses)."""
    store = JaxStore(root)
    rec = store.load("reconstruction")
    names = store.load_json("reconstruction_meta")["registered_names"]
    norm = JT.normalize_scene_coremax(rec["points"])
    near, far = JT.auto_near_far(rec["cams"], rec["points"], norm)
    cfg = JaxDenseConfig(epochs=epochs, grid_resolution=res, scene_scale=1.0,
                         near=near, far=far, num_samples=num_samples)
    train_idx, test_idx = JE.split_views_by_name(names, 8)
    ds = JE.dataset_from_views(rec["cams"], scene["rgb"], scene["focal"], train_idx, norm,
                               stride=ray_stride)
    grid, losses = JT.train_plenoxel(ds, cfg, seed=seed, verbose=False, log_every=log_every)
    ev = JE.evaluate_views(grid, rec["cams"][test_idx], scene["rgb"][test_idx],
                           scene["focal"], cfg, norm, stride=2, max_views=8)
    return ev, losses


if __name__ == "__main__":
    import shutil

    jax.config.update("jax_platforms", "cpu")
    small = sys.argv[1:] == ["small"]
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "build",
                        "tpu3d_train_reference")
    if small:
        sc = chip_smoke.make_scene(0, n_views=N_VIEWS, width=W, height=H)
        res, stride, epochs, samples = RES, 2, EPOCHS, SAMPLES
    else:
        sc = chip_smoke.make_scene(chip_smoke.SCENE_SEED)
        res, stride, epochs, samples = chip_smoke.DENSE_RES, chip_smoke.TRAIN_RAY_STRIDE, 1, 192
    chip_smoke.make_reconstruction_artifacts(root, sc)
    means = []
    for seed in (0, 1, 2):
        t0 = time.time()
        ev, losses = tpu3d_train_psnr(root, sc, seed, res, stride, epochs, samples,
                                      log_every=10)
        means.append(ev["mean_psnr"])
        print(f"tpu3d on the CPU, {res}^3 x 28, ray stride {stride}, {epochs} epoch(s), "
              f"{samples} samples, "
              f"seed {seed}: held-out PSNR {ev['per_view']} mean {ev['mean_psnr']!r} dB; "
              f"losses {losses}; {time.time() - t0:.1f} s", flush=True)
    print(f"mean PSNR over seeds {means}; spread (max - min) {max(means) - min(means)!r} dB")
    shutil.rmtree(root)
