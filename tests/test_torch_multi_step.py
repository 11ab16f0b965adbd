"""make_multi_step (tpu3d_torch/dense/train.py), the port of tpu3d's scanned
training steps, on the CPU.

On the card a chunk of steps is a CUDA graph of the same ``train_step`` or
``sdf_train_step`` calls; on the CPU the chunk runs those calls eagerly.
So the chunk is held (a) against the per-step loop, bit for bit, for each
option a step takes, (b) against tpu3d's make_multi_step with tpu3d's
draws injected, (c) inside train_plenoxel and train_sdf, scan_chunk 16
against 1 (the same loop, each step one eager chunk), and (d) its
device-side lr and bias corrections against the host's. Chunks of K = 4
with a tail of 2. The graph itself is held against
the eager steps by tests/test_torch_gpu.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu3d.dense.train as JT
from tpu3d.config import DenseConfig as JaxDenseConfig
from tpu3d.dense.grid import VoxelGrid as JaxGrid
from tpu3d.kernels.trilinear import pack_grid, unpack_grid
from tpu3d_torch.config import DenseConfig
from tpu3d_torch.dense import train as TT
from tpu3d_torch.dense.grid import VoxelGrid

RES, BATCH, N_RAYS, N_CAMS = 16, 32, 320, 3
LO, HI = np.full(3, -1.5, np.float32), np.full(3, 1.5, np.float32)
DETAIL_RES = (8, 16, 16)
DETAIL_LO, DETAIL_HI = np.float32([-0.6, -0.8, -0.7]), np.float32([0.9, 0.8, 0.6])
PLAN = [(0, 4), (4, 2)]          # K = 4, then a tail of 2
CASES = {
    "plain": dict(),
    "hierarchical_occupancy": dict(hierarchical=True, occupancy_prune=True,
                                   occupancy_probes=12),
    "contracted": dict(hierarchical=True, contraction=True, per_ray_aabb=False, n_coarse=8,
                       optimizer="rmsprop"),
    "regularized": dict(tv_sigma=0.3, tv_sh=0.05, sparsity_sigma=0.02, exposure=True,
                        sh_background=True),
    "occupancy": dict(occupancy_prune=True, occupancy_probes=12, optimizer="rmsprop"),
    "cascade": dict(hierarchical=True, optimizer="rmsprop"),
    "sdf": dict(tv_sigma=0.3, sparsity_sigma=0.02, exposure=True, sh_background=True),
}


def t(a):
    return torch.from_numpy(np.array(a))


def n(x):
    return x.detach().cpu().numpy()


def _cfg(case):
    kw = dict(grid_resolution=RES, batch_size=BATCH, num_samples=8, near=0.5, far=4.0,
              n_coarse=6, n_fine=6, scan_chunk=4)
    kw.update(CASES[case])
    return JaxDenseConfig(**kw), DenseConfig(**kw)


def _rays(seed=0):
    rng = np.random.RandomState(seed)
    o = np.zeros((N_RAYS, 3), np.float32)
    o[:, 0] = -2.0
    o[:, 1:] = rng.uniform(-0.3, 0.3, (N_RAYS, 2))
    d = rng.randn(N_RAYS, 3).astype(np.float32) * 0.4
    d[:, 0] = np.abs(d[:, 0]) + 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (o, d, rng.rand(N_RAYS, 3).astype(np.float32),
            rng.randint(0, N_CAMS, N_RAYS).astype(np.int32),
            rng.permutation(N_RAYS).astype(np.int64))


def _grid0(seed=1):
    rng = np.random.RandomState(seed)
    g = (rng.randn(RES, RES, RES, 28) * 0.3).astype(np.float32)
    g[..., 0] = rng.randn(RES, RES, RES) * 2.0
    return g


def _occupancy():
    """(4, 4, 4) at factor 4 with the middle cells occupied but one, and
    every cell on the box's faces empty, where rounding decides whether a
    band's first and last probes lie inside (tests/test_torch_train.py)."""
    occ = np.zeros((4, 4, 4), bool)
    occ[1:3, 1:3, 1:3] = True
    occ[1, 2, 1] = False
    return occ


class _Setup:
    """One case's starting grid, box, cascade base and occupancy grid."""

    def __init__(self, case):
        self.case = case
        self.jcfg, self.cfg = _cfg(case)
        self.g0, self.lo, self.hi = _grid0(), LO, HI
        self.base = None
        if case == "contracted":
            self.lo, self.hi = np.full(3, -2.0, np.float32), np.full(3, 2.0, np.float32)
        elif case == "cascade":
            self.base = (self.g0, LO, HI)
            self.g0 = np.zeros(DETAIL_RES + (28,), np.float32)
            self.lo, self.hi = DETAIL_LO, DETAIL_HI
        self.occ = _occupancy() if self.cfg.occupancy_prune else None
        self.rays = _rays()
        self.step_fn = TT.sdf_train_step if case == "sdf" else TT.train_step

    def state(self):
        return TT.init_state(self.cfg, VoxelGrid(t(self.g0.copy()), t(self.lo), t(self.hi)), 2,
                             N_CAMS if self.cfg.exposure else None)

    def step_kw(self):
        if self.case == "sdf":
            return {}
        return dict(occ=None if self.occ is None else t(self.occ),
                    base=None if self.base is None else VoxelGrid(*map(t, self.base)))

    def tensors(self, state):
        """Everything a step updates, by name."""
        out = {"grid": state.grid.grid, "count": state.count}
        out.update({f"opt_{k}": v for k, v in state.optimizer.state[state.grid.grid].items()})
        for k in ("exposure", "background"):
            if getattr(state, k) is not None:
                out[k] = getattr(state, k)
        return out


@pytest.mark.parametrize("case", ["plain", "hierarchical_occupancy", "contracted", "regularized",
                                  "cascade", "sdf"])
def test_multi_step_equals_the_per_step_loop(case):
    """A chunk of 4 steps and a tail of 2 through make_multi_step against 6
    calls of the step function, from one seed: losses and every updated
    tensor equal bit for bit, and the host's and the device's update counts
    agree."""
    s = _Setup(case)
    o, d, rgb, cid, perm = (t(a) for a in s.rays)
    cid = cid.long() if s.cfg.exposure else None
    kw = s.step_kw()
    chunked, looped = s.state(), s.state()
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(4)
    g2.manual_seed(4)
    multi = TT.make_multi_step(s.step_fn, with_occ=case != "sdf")
    for b, k in PLAN:
        got = multi(chunked, s.cfg, perm[b * BATCH:(b + k) * BATCH].view(k, BATCH), o, d, rgb,
                    cid_all=cid, generator=g1, **kw)
        want = []
        for j in range(b, b + k):
            ix = perm[j * BATCH:(j + 1) * BATCH]
            want.append(s.step_fn(looped, s.cfg, o[ix], d[ix], rgb[ix],
                                  None if cid is None else cid[ix], generator=g2, **kw))
        assert got.shape == (k,) and torch.equal(got, torch.stack(want))
    a, b_ = s.tensors(chunked), s.tensors(looped)
    assert a.keys() == b_.keys()
    for name in a:
        assert torch.equal(a[name], b_[name]), name
    assert chunked.step == looped.step == int(chunked.count) == 6
    assert (multi.replays, multi.eager_chunks, multi.capture_seconds) == (0, 2, [])
    assert np.abs(n(chunked.grid.grid) - s.g0).max() > 1e-3


def _jax_noise(cfg, key, grid_shape):
    """tpu3d's draws for step key ``key`` as the port's StepNoise: the
    jittered depths (split for the hierarchical passes, three quarters of
    them under contraction), the TV and sparsity crop origins."""
    n_u = cfg.n_coarse if cfg.hierarchical else cfg.num_samples
    n_u = n_u - n_u // 4 if cfg.contraction else n_u
    if cfg.hierarchical:
        k1, k2 = jax.random.split(key)
        u = jax.random.uniform(k1, (BATCH, n_u), jnp.float32)
        u_fine = t(np.asarray(jax.random.uniform(k2, (BATCH, cfg.n_fine), jnp.float32)))
    else:
        u, u_fine = jax.random.uniform(key, (BATCH, n_u), jnp.float32), None

    def origin(fold, extra):
        ks = jax.random.split(jax.random.fold_in(key, fold), 3)
        return t(np.array([int(jax.random.randint(k, (), 0, dim - min(cfg.tv_crop, dim - 1 + extra)
                                                  + extra))
                           for k, dim in zip(ks, grid_shape[:3])], np.int64))

    return TT.StepNoise(t(np.asarray(u)), u_fine,
                        origin(7, 0) if cfg.tv_sigma or cfg.tv_sh else None,
                        origin(11, 1) if cfg.sparsity_sigma else None)


@pytest.mark.parametrize("case", ["plain", "regularized", "occupancy", "contracted", "cascade",
                                  "sdf"])
def test_multi_step_matches_tpu3d(case):
    """The port's chunks against tpu3d's make_multi_step (its lax.scan over
    the XLA step; over the Pallas pair in interpret mode for the cascade,
    the route tpu3d forces there) on the same (K, B) index blocks, with
    tpu3d's per-step keys fold_in(epoch_key, step) drawn and injected:
    losses, grid, moments and latents within tpu3d's tolerance between its
    own two routes after five steps (rtol 2e-4, atol 5e-4). The occupancy,
    contracted and cascade cases step with rmsprop, as
    tests/test_torch_train.py's step parity does (Adam's first step turns
    rounding on a near-zero gradient into a share of lr)."""
    s = _Setup(case)
    jcfg, cfg = s.jcfg, s.cfg
    o, d, rgb, cid, perm = s.rays
    packed = case == "cascade"
    jopt = JT.make_optimizer(jcfg, 2)
    garr = pack_grid(jnp.asarray(s.g0)) if packed else jnp.asarray(s.g0)
    jstate = JT.TrainState(JaxGrid(garr, jnp.asarray(s.lo), jnp.asarray(s.hi)), jopt.init(garr),
                           jnp.asarray(0), JT.init_exposure(N_CAMS) if jcfg.exposure else None,
                           JT.init_background() if jcfg.sh_background else None)
    res = s.g0.shape[:3]
    if case == "sdf":
        jstep = JT.make_sdf_train_step(jcfg, jopt)
    elif packed:
        jstep = JT.make_train_step_packed(jcfg, jopt, res, interpret=True, base_res=(RES,) * 3)
    else:
        jstep = JT.make_train_step(jcfg, jopt)
    jmulti = JT.make_multi_step(jstep, with_occ=case != "sdf")
    jkw = {} if case == "sdf" else dict(occ=None if s.occ is None else jnp.asarray(s.occ))
    if packed:
        g, lo, hi = s.base
        jkw["base"] = (pack_grid(jnp.asarray(g)), jnp.asarray(lo), jnp.asarray(hi))
    jcid = jnp.asarray(cid) if jcfg.exposure else None
    ekey = jax.random.PRNGKey(5)
    state = s.state()
    multi = TT.make_multi_step(s.step_fn, with_occ=case != "sdf")
    tcid = t(cid).long() if cfg.exposure else None
    noise_cfg = TT.sdf_noise_config(jcfg) if case == "sdf" else jcfg
    for b, k in PLAN:
        block = perm[b * BATCH:(b + k) * BATCH].reshape(k, BATCH)
        jstate, jl = jmulti(jstate, ekey, np.uint32(b), jnp.asarray(block), jnp.asarray(o),
                            jnp.asarray(d), jnp.asarray(rgb), cid_all=jcid, **jkw)
        lc = multi(state, cfg, t(block), t(o), t(d), t(rgb), cid_all=tcid,
                   noise=lambda j, b=b: _jax_noise(noise_cfg, jax.random.fold_in(
                       ekey, np.uint32(b + j)), res), **s.step_kw())
        np.testing.assert_allclose(n(lc), np.asarray(jl), rtol=2e-4, atol=5e-4)

    def host(a):
        return np.asarray(unpack_grid(a, res + (28,))) if packed else np.asarray(a)

    p = state.grid.grid
    st = state.optimizer.state[p]
    pairs = [("grid", n(p), host(jstate.grid.grid))]
    opt = jstate.opt_state[0]
    if cfg.optimizer == "rmsprop":
        pairs.append(("nu", n(st["nu"]), host(opt.nu)))
    else:
        pairs += [("mu", n(st["exp_avg"]), host(opt.mu)), ("nu", n(st["exp_avg_sq"]),
                                                            host(opt.nu))]
    for name in ("exposure", "background"):
        if getattr(state, name) is not None:
            pairs.append((name, n(getattr(state, name)), np.asarray(getattr(jstate, name))))
    for name, got, ref in pairs:
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=5e-4, err_msg=name)
    assert state.step == int(jstate.step) == int(state.count) == 6
    assert np.abs(n(p) - s.g0).max() > 1e-3


def _chunk_dataset():
    """7 cameras x 24 random rays into a [-1, 1]^3 box: 21 steps of 8 rays
    an epoch, a chunk of 16 and a tail of 5."""
    rng = np.random.RandomState(3)
    o = rng.normal(size=(168, 3)).astype(np.float32)
    o = 2.5 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o + rng.normal(scale=0.3, size=o.shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return TT.RayDataset(o, d, rng.uniform(0.2, 0.8, (168, 3)).astype(np.float32),
                         np.repeat(np.arange(7, dtype=np.int32), 24))


@pytest.mark.parametrize("run", ["plenoxel", "plenoxel_coarse", "sdf"])
def test_chunked_loop_matches_per_step(run):
    """train_plenoxel (TV, sparsity, exposure, SH background; with a coarse
    phase) and train_sdf at scan_chunk 16 against scan_chunk 1, 2 epochs of
    21 steps: the same logged losses and the same grid, bit for bit (the
    port's form of tpu3d's test_chunked_loop_matches_per_step, which allows
    its scan's fusion rtol 1e-4: here the chunk runs the same calls)."""
    ds = _chunk_dataset()
    kw = dict(grid_resolution=8, batch_size=8, num_samples=8, near=0.5, far=4.0, epochs=2,
              scene_scale=1.0, tv_sigma=0.1, sparsity_sigma=0.01, exposure=True,
              sh_background=True, coarse_epochs=1 if run == "plenoxel_coarse" else 0)
    fn = TT.train_sdf if run == "sdf" else TT.train_plenoxel
    out = {}
    for chunk in (16, 1):
        g, losses = fn(ds, DenseConfig(scan_chunk=chunk, **kw), seed=2, verbose=False,
                       log_every=1, device="cpu")
        out[chunk] = (g.grid, losses, TT.LAST_TRAIN_AUX["phases"])
    (g16, l16, p16), (g1, l1, p1) = out[16], out[1]
    assert len(l16) == len(l1) == 42
    np.testing.assert_array_equal(l16, l1)
    assert torch.equal(g16, g1)

    def logs(phases):
        return [[(e["epoch"], e["step"], e["update"], e["loss"]) for e in p["log"]]
                for p in phases]

    assert logs(p16) == logs(p1)
    # every chunk (16 and a tail of 5) runs eagerly on the CPU; at scan_chunk
    # 1 each step is one eager chunk
    assert [(p["replays"], p["eager_chunks"]) for p in p16] == [
        (0, 2 * len(p["log"]) // 21) for p in p16]
    assert [(p["replays"], p["eager_chunks"]) for p in p1] == [(0, p["steps"]) for p in p1]


@pytest.mark.parametrize("steps_per_epoch", [1, 7, 100])
def test_device_lr_and_bias_correction_match_the_host(steps_per_epoch):
    """The lr a step reads on the device equals _lr_schedule's host value
    rounded to f32, at and around each milestone; the latents' Adam from a
    device count equals it from an int and the host formula it replaced
    (the bias corrections 1 - b^t from a CPU scalar t), bit for bit; and
    after training steps the optimizer holds the scheduled lr of the last
    update."""
    cfg = DenseConfig()
    sched = TT._lr_schedule(cfg, steps_per_epoch)
    counts = sorted({k for m in (0,) + cfg.lr_milestones
                     for k in (m * steps_per_epoch - 1, m * steps_per_epoch,
                               m * steps_per_epoch + 1) if k >= 0})
    for k in counts:
        got = sched.on_device(torch.tensor(k))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert got.item() == np.float32(sched(k)), k

    rng = np.random.RandomState(steps_per_epoch)
    lat = t(rng.normal(size=(3, 5, 3)).astype(np.float32) * 0.1)
    lat[2] = lat[2].abs()
    g = t(rng.normal(size=(5, 3)).astype(np.float32))

    def host_formula(exposure, step, lr):
        b1, b2, eps = 0.9, 0.999, 1e-8
        gains, m, v = exposure[0], exposure[1], exposure[2]
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        tt = torch.tensor(step + 1.0, dtype=torch.float32)
        mhat = m / (1 - torch.tensor(b1, dtype=torch.float32) ** tt)
        vhat = v / (1 - torch.tensor(b2, dtype=torch.float32) ** tt)
        return torch.stack([gains - lr * mhat / (torch.sqrt(vhat) + eps), m, v])

    for k in counts:
        dev_count = TT._exposure_adam(lat.clone(), g, torch.tensor(k), 0.01)
        host_count = TT._exposure_adam(lat.clone(), g, k, 0.01)
        assert torch.equal(dev_count, host_count) and torch.equal(dev_count,
                                                                  host_formula(lat, k, 0.01)), k

    ds = _chunk_dataset()
    small = DenseConfig(grid_resolution=8, batch_size=8, num_samples=8, near=0.5, far=4.0,
                        lr_milestones=(1, 2), exposure=True)
    state = TT.init_state(small, VoxelGrid(torch.full((8, 8, 8, 28), 0.01),
                                           torch.full((3,), -1.0), torch.full((3,), 1.0)),
                          steps_per_epoch, 7)
    gen = torch.Generator()
    gen.manual_seed(0)
    o, d, rgb = (t(a[:8]) for a in (ds.origins, ds.dirs, ds.rgb))
    for k in range(2 * steps_per_epoch + 1 if steps_per_epoch < 100 else 3):
        TT.train_step(state, small, o, d, rgb, t(ds.cam_ids[:8]).long(), generator=gen)
        lr = state.optimizer.param_groups[0]["lr"]
        assert torch.is_tensor(lr) and lr.item() == np.float32(state.lr(k)), k
    assert state.step == int(state.count) == k + 1


def test_transmittance_cumprod_gradient_equals_torchs():
    """render._CumProd, the transmittance's product without cumprod_backward's
    host read (a CUDA graph could not capture it): the same products and
    the same gradient as torch.cumprod, bit for bit, factors as small as
    1e-10 (1 - alpha + 1e-10 where alpha is 1) included."""
    from tpu3d_torch.dense.render import _CumProd

    rng = np.random.RandomState(0)
    x = t((rng.rand(64, 40) * 0.99 + 1e-10).astype(np.float32))
    x[::3, 5] = 1e-10
    up = t(rng.normal(size=(64, 40)).astype(np.float32))
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    (torch.cumprod(a, -1) * up).sum().backward()
    (_CumProd.apply(b) * up).sum().backward()
    assert torch.equal(_CumProd.apply(x), torch.cumprod(x, -1))
    assert torch.equal(b.grad, a.grad)
