"""The port's dense training options (tpu3d_torch/dense/{contract,grid,
occupancy,render,train}.py, io/raydata.py, cli.densify) against tpu3d's, on
the CPU: the contraction's inverse, the coarse-to-fine resample, the
occupancy grid and its samplers, hierarchical rendering under contraction,
with a cascade base and with occupancy, the camera gate, the training
loop's cadence (occupancy refreshes, loss logs, the gate), the reference's
ray files, and densify at tpu3d's recipe (contraction, coarse-to-fine, the
cascade).

Random draws are tpu3d's, injected as uniforms. tpu3d's cascade forces its
Pallas kernels (interpret mode on the CPU); the cascade is compared with
that route.

Run as a script, it prints tpu3d's held-out PSNR after its densify at
chip_smoke.RECIPE_FLAGS on the CPU, for seeds 0, 1, 2, on chip_smoke's
full-size artifacts: of the fine phase's grid alone and of the base +
detail pair (what chip_smoke.TPU3D_CPU_RECIPE_PSNR, TPU3D_CPU_CASCADE_PSNR
and their tolerances record; ~20 min and ~18 GB a seed) or, with
``small``, at CASCADE_FLAGS on this file's 8-view scene:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_dense_options.py [small]
"""
import argparse
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
import tpu3d.dense.occupancy as JO
import tpu3d.dense.train as JT
from test_torch_train import tpu3d_args
from tpu3d.config import DenseConfig as JaxDenseConfig
from tpu3d.dense.contract import contract as jax_contract
from tpu3d.dense.contract import contract_inv as jax_contract_inv
from tpu3d.dense.grid import VoxelGrid as JaxGrid
from tpu3d.dense.grid import resample_grid as jax_resample_grid
from tpu3d.dense.render import render_image as jax_render_image
from tpu3d.dense.render import render_rays_hierarchical as jax_render_hierarchical
from tpu3d.dense.render import render_rays_hierarchical_packed as jax_render_hierarchical_packed
from tpu3d.io.artifacts import ArtifactStore as JaxStore
from tpu3d.io.raydata import load_ray_dataset as jax_load_rays
from tpu3d.io.raydata import save_ray_dataset as jax_save_rays
from tpu3d.kernels.trilinear import pack_grid
from tpu3d_torch import cli as TC
from tpu3d_torch.config import DenseConfig
from tpu3d_torch.dense import occupancy as TO
from tpu3d_torch.dense import train as TT
from tpu3d_torch.dense.contract import contract, contract_inv
from tpu3d_torch.dense.grid import VoxelGrid, resample_grid
from tpu3d_torch.dense.render import render_image, render_rays_hierarchical
from tpu3d_torch.io.artifacts import ArtifactStore
from tpu3d_torch.io.raydata import load_ray_dataset, save_ray_dataset


def t(a):
    return torch.from_numpy(np.array(a))


def _rays(rng, n, radius=2.5):
    """Rays from a sphere of ``radius`` towards the origin, jittered."""
    o = rng.normal(0, 1, (n, 3)).astype(np.float32)
    o = (radius * o / np.linalg.norm(o, axis=1, keepdims=True)).astype(np.float32)
    d = (-o / radius + rng.normal(0, 0.25, (n, 3))).astype(np.float32)
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _grid(rng, res, sigma_scale=2.0):
    """A random (X, Y, Z, 28) grid, smoothed over ~2 voxels, with a density
    above 0.3 x sigma_scale inside and 0 in its two outer layers. The
    last sample of a ray has a 1e10 segment, so its colour is a step in
    that sample's density where the density crosses zero: on the box face,
    where a clipped ray's last sample lies, or between voxels of opposite
    sign. With independent voxels of either sign XLA's fused rounding alone
    moves tpu3d's jitted renders by up to 0.5 from its own op-by-op ones;
    this grid has no such crossing for a last sample to land on."""
    from scipy.ndimage import gaussian_filter

    g = gaussian_filter(rng.normal(0, 1.0, (*res, 28)), (1.5, 1.5, 1.5, 0), mode="wrap")
    g = g / g.std(axis=(0, 1, 2))
    g[..., 1:] *= 0.3
    g[..., 0] = sigma_scale * (0.3 + np.abs(g[..., 0]))
    for axis in range(3):
        g[(slice(None),) * axis + ([0, 1, -2, -1],) + (slice(None),) * (2 - axis) + (0,)] = 0.0
    return g.astype(np.float32)


def _blob_grid(rng, res):
    """:func:`_grid` with a density below the occupancy threshold (0.5)
    but for a blob of 3.0 in its middle, whose occupied cells (of 4^3
    voxels, dilated by one) stay off the faces. The band of a clipped ray
    starts and ends on the box's faces, where rounding decides whether its
    first and last probes count as inside (u >= 0, u < 1): tpu3d's jitted
    and op-by-op occupancy probes differ there, and a flipped probe moves
    the depths drawn over them by up to 0.7."""
    g = _grid(rng, res, sigma_scale=0.1)
    X, Y, Z = res
    g[X // 2 - 4:X // 2 + 3, Y // 2 - 3:Y // 2 + 4, Z // 2 - 2:Z // 2 + 2, 0] = 3.0
    return g


# --------------------------------------------------------------------------
# contract_inv, resample_grid


def test_contract_inv_matches_tpu3d(rng):
    """contract_inv of contracted points, of points inside the unit ball
    and of radii at or beyond 2 (clamped into the shell), and contract
    itself: within 1e-6 of tpu3d's."""
    x = rng.normal(0, 1, (500, 3)).astype(np.float32)
    x *= rng.uniform(0.05, 30.0, (500, 1)).astype(np.float32)
    y = np.asarray(jax_contract(jnp.asarray(x)))
    np.testing.assert_allclose(contract(t(x)).numpy(), y, rtol=1e-6, atol=1e-6)
    far = (x / np.linalg.norm(x, axis=1, keepdims=True) * rng.uniform(1.9, 2.5, (500, 1))
           ).astype(np.float32)
    for pts in (y, x[np.linalg.norm(x, axis=1) < 1], far):
        np.testing.assert_allclose(contract_inv(t(pts)).numpy(),
                                   np.asarray(jax_contract_inv(jnp.asarray(pts))),
                                   rtol=1e-6, atol=1e-6)
    inner = np.linalg.norm(x, axis=1) < 1.0
    np.testing.assert_allclose(contract_inv(contract(t(x[inner]))).numpy(), x[inner], atol=1e-6)


@pytest.mark.parametrize("new_res", [(13, 5, 17), (4, 24, 9), (16, 8, 8), (2, 12, 40)],
                         ids=["up-down-up", "down-up-same", "down", "up"])
def test_resample_grid_matches_tpu3d(rng, new_res):
    """Align-corners resample of a (7, 12, 9, 5) grid up and down, per axis,
    against tpu3d's (1e-6); every old node keeps its value where the new
    grid has one at the same place."""
    g = rng.normal(0, 1, (7, 12, 9, 5)).astype(np.float32)
    got = resample_grid(t(g), new_res).numpy()
    ref = np.asarray(jax_resample_grid(jnp.asarray(g), new_res))
    assert got.shape == ref.shape == (*new_res, 5)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(resample_grid(t(g), (13, 23, 17)).numpy()[::2, ::2, ::2], g)


# --------------------------------------------------------------------------
# occupancy


def _occupancy_grid(rng):
    g = _grid(rng, (18, 13, 16))
    g[..., 0] = np.where(rng.uniform(size=g.shape[:3]) < 0.02, 2.0, -1.0)
    g[0, 5, 5, 0] = g[17, 0, 15, 0] = 3.0          # on the faces: the dilation wraps
    return g


@pytest.mark.parametrize("factor", [1, 3, 4])
def test_occupancy_from_grid_matches_tpu3d(rng, factor):
    """Max-pool, threshold and the 6-neighbour dilation (with tpu3d's
    wrap-around at the faces), on a grid whose sides are not multiples of
    the factor: exactly tpu3d's booleans, with and without dilation."""
    g = _occupancy_grid(rng)
    for dilate in (False, True):
        got = TO.occupancy_from_grid(t(g), factor, 0.5, dilate).numpy()
        ref = np.asarray(JO.occupancy_from_grid(jnp.asarray(g), factor, 0.5, dilate))
        assert got.dtype == ref.dtype == np.bool_ and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    if factor == 1:        # a face cell's neighbour across the opposite face
        assert got[17, 5, 5] and got[0, 0, 15] and got[17, 12, 15]


def _probe_inputs(rng, n=200):
    occ = rng.uniform(size=(5, 4, 4)) < 0.4
    o, d = _rays(rng, n)
    tn = rng.uniform(0.1, 1.0, n).astype(np.float32)
    tf = (tn + rng.uniform(1.0, 4.0, n)).astype(np.float32)
    mn, mx = np.float32([-1.0, -1.2, -0.8]), np.float32([1.1, 1.0, 1.0])
    return occ, mn, mx, o, d, tn, tf


def test_probe_occupancy_and_tighten_bands_match_tpu3d(rng):
    """The probes' depths and occupancy, and the tightened bands, exactly
    as tpu3d's."""
    args = _probe_inputs(rng)
    ts, o = TO.probe_occupancy(*map(t, args), 16)
    jts, jo = JO.probe_occupancy(*map(jnp.asarray, args), 16)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(jts))
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    assert 0.1 < o.float().mean() < 0.9
    for got, ref in zip(TO.tighten_bands(*map(t, args), 16),
                        JO.tighten_bands(*map(jnp.asarray, args), 16)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _cdf_slack(ts, o, u, empty_weight=1e-2):
    """What a 2e-6 rounding of the occupancy CDF can move each of the
    sorted depths drawn at the quantiles ``u`` by: 2e-6 times the depth per
    unit of CDF of the bin it lies in. tpu3d sums
    the CDF in f32 in order; torch's CPU cumsum accumulates in f64; where
    empty probes make a bin's CDF step ~100x smaller than its depth step,
    their rounding difference (~1e-6) moves the depth by up to ~1e-4."""
    w = o.astype(np.float32) + empty_weight + 1e-5
    cdf = np.concatenate([np.zeros((len(w), 1)), np.cumsum(w / w.sum(1, keepdims=True), 1)], 1)
    bins = np.concatenate([ts[:, :1], ts], 1)
    u = np.sort(u, axis=1)               # the sorted depths' quantiles
    k = np.clip(np.array([np.searchsorted(c, q, side="right") for c, q in zip(cdf, u)]), 1,
                cdf.shape[1] - 1)
    slope = np.take_along_axis(bins, k, 1) - np.take_along_axis(bins, k - 1, 1)
    slope /= np.maximum(np.take_along_axis(cdf, k, 1) - np.take_along_axis(cdf, k - 1, 1), 1e-5)
    return 2e-6 * slope


def test_sample_occupied_matches_tpu3d(rng):
    """Depths drawn by inverse CDF over the probes' occupancy with tpu3d's
    uniforms (key 3), and at its evenly spaced quantiles: within 1e-5 plus
    what the CDF's f32 rounding can move a depth by (:func:`_cdf_slack`);
    sorted, inside each band."""
    args = _probe_inputs(rng)
    n, S = len(args[3]), 10
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, (n, S), jnp.float32))
    jts, jo = JO.probe_occupancy(*map(jnp.asarray, args), 16)
    for perturb in (True, False):
        got = TO.sample_occupied(*map(t, args), 16, S, perturb, u=t(u) if perturb else None)
        ref = np.asarray(JO.sample_occupied(key, *map(jnp.asarray, args), 16, S, perturb))
        q = u if perturb else np.broadcast_to(np.linspace(0, 1, S, dtype=np.float32), (n, S))
        slack = _cdf_slack(np.asarray(jts), np.asarray(jo), q)
        cols = slice(None) if perturb else slice(None, -1)   # u = 1: the CDF's end
        assert (np.abs(got.numpy() - ref)[:, cols] <= (1e-5 + slack)[:, cols]).all()
        assert (np.diff(got.numpy(), axis=1) >= 0).all()
        assert (got.numpy() >= args[5][:, None] - 1e-6).all()
        assert (got.numpy() <= args[6][:, None] + 1e-5).all()


# --------------------------------------------------------------------------
# Hierarchical rendering under contraction, with a cascade base, with occupancy


NC, NF = 8, 6


def _hier_uniforms(key, n, n_coarse):
    k1, k2 = jax.random.split(key)
    return (np.asarray(jax.random.uniform(k1, (n, n_coarse), jnp.float32)),
            np.asarray(jax.random.uniform(k2, (n, NF), jnp.float32)))


@pytest.mark.parametrize("option", ["contract", "occupancy", "base"])
def test_render_rays_hierarchical_matches_tpu3d(rng, option):
    """render_rays_hierarchical with tpu3d's draws (key 5) against the route
    tpu3d takes: its XLA render_rays_hierarchical under contraction (a
    [-2, 2]^3 grid, no box clipping, the disparity tail) and with an
    occupancy grid (96 rays); render_rays_hierarchical_packed (interpret
    mode) with a frozen cascade base, composed in both passes, its box
    setting the band. Within 1e-5."""
    n = 96
    o, d = _rays(rng, n, radius=3.0 if option == "contract" else 2.5)
    key = jax.random.PRNGKey(5)
    if option == "contract":
        vg = (_grid(rng, (16, 12, 8)), np.full(3, -2.0, np.float32), np.full(3, 2.0, np.float32))
        uc, uf = _hier_uniforms(key, n, NC - NC // 4)
        ref = jax_render_hierarchical(JaxGrid(*map(jnp.asarray, vg)), key, jnp.asarray(o),
                                      jnp.asarray(d), 0.3, 3.0, NC, NF, contract=True)
        got = render_rays_hierarchical(VoxelGrid(*map(t, vg)), t(o), t(d), 0.3, 3.0, NC, NF,
                                       u_coarse=t(uc), u_fine=t(uf), contract=True)
    elif option == "occupancy":
        g = _blob_grid(rng, (32, 24, 24))
        vg = (g, np.float32([-1.2, -1.0, -0.9]), np.float32([1.0, 1.1, 1.2]))
        occ = TO.occupancy_from_grid(t(g), 4, 0.5)
        assert 0.05 < occ.float().mean() < 0.5
        uc, uf = _hier_uniforms(key, n, NC)
        ref = jax_render_hierarchical(JaxGrid(*map(jnp.asarray, vg)), key, jnp.asarray(o),
                                      jnp.asarray(d), 0.5, 4.5, NC, NF, clip_aabb=True,
                                      occ=jnp.asarray(occ.numpy()), occ_probes=12)
        got = render_rays_hierarchical(VoxelGrid(*map(t, vg)), t(o), t(d), 0.5, 4.5, NC, NF,
                                       clip_aabb=True, u_coarse=t(uc), u_fine=t(uf), occ=occ,
                                       occ_probes=12)
    else:
        base = (_grid(rng, (16, 16, 16)), np.full(3, -1.5, np.float32),
                np.full(3, 1.5, np.float32))
        det = (_grid(rng, (8, 16, 16)) * 0.5, np.float32([-0.5, -0.8, -0.6]),
               np.float32([0.7, 0.8, 0.9]))
        uc, uf = _hier_uniforms(key, n, NC)
        ref = jax_render_hierarchical_packed(
            pack_grid(jnp.asarray(det[0])), jnp.asarray(det[1]), jnp.asarray(det[2]),
            (8, 16, 16), key, jnp.asarray(o), jnp.asarray(d), 0.5, 4.5, NC, NF,
            clip_aabb=True, interpret=True, base_packed=pack_grid(jnp.asarray(base[0])),
            base_mb=jnp.asarray(base[1]), base_xb=jnp.asarray(base[2]),
            base_res=(16, 16, 16))
        got = render_rays_hierarchical(VoxelGrid(*map(t, det)), t(o), t(d), 0.5, 4.5, NC, NF,
                                       clip_aabb=True, u_coarse=t(uc), u_fine=t(uf),
                                       base_vg=VoxelGrid(*map(t, base)))
    ref = np.asarray(ref)
    assert np.isfinite(ref).all() and ref.std() > 0.01
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_render_image_occupancy_pruned_matches_tpu3d(rng):
    """render_image(occ_prune=True) against tpu3d's (XLA route): the
    occupancy computed once from the grid, depths at its quantiles."""
    g = _blob_grid(rng, (32, 32, 32))
    vg = (t(g), t(np.full(3, -1.0, np.float32)), t(np.full(3, 1.0, np.float32)))
    o, d = _rays(rng, 150)
    bg = rng.normal(0, 1, (3, 9)).astype(np.float32)
    got = render_image(VoxelGrid(*vg), t(o), t(d), 0.5, 4.5, 24, chunk=64, clip_aabb=True,
                       occ_prune=True, bg_sh=t(bg))
    ref = np.asarray(jax_render_image(JaxGrid(*map(jnp.asarray, vg)), jax.random.PRNGKey(0),
                                      jnp.asarray(o), jnp.asarray(d), 0.5, 4.5, 24, chunk=64,
                                      use_pallas=False, clip_aabb=True, occ_prune=True,
                                      bg_sh=jnp.asarray(bg)))
    plain = render_image(VoxelGrid(*vg), t(o), t(d), 0.5, 4.5, 24, chunk=64, clip_aabb=True,
                         bg_sh=t(bg))
    assert np.abs(plain.numpy() - ref).max() > 1e-3          # the pruning moved the depths
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# The camera gate


def test_camera_gate_matches_tpu3d(tmp_path):
    """apply_camera_gate where the photographs are tpu3d's renders of
    make_scene's analytic 32^3 grid from the true poses (8 views at 96x64,
    every 2nd pixel) and view 2's rays come from its pose turned 3 degrees
    about the vertical: the port's probe MSE per camera within 1e-5 of
    tpu3d's (XLA route, the same default_rng(12345) probe rays), the same
    dropped camera (view 2) and the same keep mask."""
    from tpu3d_torch.core.lie import so3_exp_np, so3_log_np
    from tpu3d_torch.dense.eval import dataset_from_views, split_views_by_name
    from tpu3d_torch.dense.train import SceneNormalization

    scene = chip_smoke.make_scene(0, n_views=8, width=96, height=64)
    dense = chip_smoke.make_dense_artifacts(str(tmp_path), scene, res=32)
    meta = dense["meta"]
    norm = SceneNormalization(np.asarray(meta["norm_center"], np.float32), meta["norm_scale"])
    train_idx, _ = split_views_by_name([f"img_{i:03d}.png" for i in range(8)], 8)
    cfg_kw = dict(near=meta["near"], far=meta["far"], num_samples=48, per_ray_aabb=True,
                  camera_gate_probe_rays=512)
    grid = (dense["grid"], dense["min_bound"], dense["max_bound"])
    true = dataset_from_views(dense["cams"], scene["rgb"], scene["focal"], train_idx, norm,
                              stride=2)
    photos = np.asarray(jax_render_image(
        JaxGrid(*map(jnp.asarray, grid)), jax.random.PRNGKey(0), jnp.asarray(true.origins),
        jnp.asarray(true.dirs), meta["near"], meta["far"], 48, chunk=8192, use_pallas=False,
        clip_aabb=True))
    cams = dense["cams"].copy()
    a = np.radians(3.0)
    turn = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    cams[2, :3] = so3_log_np(turn @ so3_exp_np(cams[2, :3]))
    cams[2, 3:] = turn @ cams[2, 3:]                     # the same centre, turned
    rays = dataset_from_views(cams, scene["rgb"], scene["focal"], train_idx, norm, stride=2)
    ds = TT.RayDataset(rays.origins, rays.dirs, photos.astype(np.float32), rays.cam_ids)
    jcfg = JaxDenseConfig(**cfg_kw)
    jstate = JT.TrainState(JaxGrid(*map(jnp.asarray, grid)), None, jnp.asarray(0))
    jds = JT.RayDataset(*ds)
    jmse = JT._camera_gate_probe(jstate, jds, jcfg, False, grid[0].shape,
                                 np.random.default_rng(12345))
    jkeep, jdropped = JT.apply_camera_gate(jstate, jds, jcfg, False, grid[0].shape, False)
    state = TT.init_state(DenseConfig(**cfg_kw), VoxelGrid(*map(t, grid)), 1)
    keep, dropped, mse, thr = TT.apply_camera_gate(state, ds, DenseConfig(**cfg_kw), False,
                                                   "cpu")
    np.testing.assert_allclose(mse, jmse, rtol=1e-5, atol=1e-5)
    assert dropped == jdropped == [int(np.flatnonzero(train_idx == 2)[0])]
    np.testing.assert_array_equal(keep, jkeep)
    assert mse[dropped[0]] > 10 * np.median(mse) and mse[dropped[0]] > thr


# --------------------------------------------------------------------------
# The training loop's cadence


def _cadence_dataset(rng):
    """5 cameras x 35 random rays through a [-1, 1]^3 box: 21 steps of 8
    rays per epoch, 17 once camera 3 is dropped."""
    o, d = _rays(rng, 175, radius=2.0)
    return TT.RayDataset(o, d, rng.uniform(0, 1, (175, 3)).astype(np.float32),
                         np.repeat(np.arange(5, dtype=np.int32), 35))


def test_refresh_log_and_gate_cadence_matches_tpu3d(rng, monkeypatch, capsys):
    """train_plenoxel's occupancy refreshes, loss logs and camera gate land
    on tpu3d's global steps (scan chunks of 16 over 21 steps per epoch,
    refreshes due every 10 steps, the gate at epoch 1 dropping camera 3 and
    the plan rebuilt over the kept rays), recorded by wrapping tpu3d's
    scan and its occupancy and gate functions. The gate's decision is
    injected in both, so that the trained grids need not agree."""
    ds = _cadence_dataset(rng)
    kw = dict(grid_resolution=8, num_samples=4, batch_size=8, epochs=4, near=0.5, far=3.5,
              scene_scale=1.0, occupancy_prune=True, occupancy_every=10, camera_gate=True,
              camera_gate_epoch=1)
    done = {"steps": 0, "chunks": [], "refresh": [], "gate": []}
    real_multi = JT.make_multi_step

    def make_multi(step_fn, with_occ):
        multi = real_multi(step_fn, with_occ)

        def run(state, ekey, step0, idx, *a, **k):
            done["chunks"].append((int(step0), idx.shape[0]))
            out = multi(state, ekey, step0, idx, *a, **k)
            done["steps"] += idx.shape[0]
            return out
        return run

    real_occ = JO.occupancy_from_grid

    def occ_at(*a, **k):
        done["refresh"].append(done["steps"])
        return real_occ(*a, **k)

    def gate_at(state, dataset, *a, **k):
        done["gate"].append(done["steps"])
        return dataset.cam_ids != 3, [3]

    monkeypatch.setattr(JT, "make_multi_step", make_multi)
    monkeypatch.setattr(JO, "occupancy_from_grid", occ_at)
    monkeypatch.setattr(JT, "apply_camera_gate", gate_at)
    capsys.readouterr()
    _, jlosses = JT.train_plenoxel(JT.RayDataset(*ds), JaxDenseConfig(**kw), log_every=4,
                                   packed=False)
    jlog = [(int(w[2]), int(w[4].split("/")[0])) for w in
            (line.split() for line in capsys.readouterr().out.splitlines())
            if w[:2] == ["[dense]", "epoch"]]
    assert JT.LAST_TRAIN_AUX["dropped_cameras"] == [3]

    def port_gate(state, dataset, cfg, verbose, dev):
        return dataset.cam_ids != 3, [3], np.zeros(5), 0.0

    monkeypatch.setattr(TT, "apply_camera_gate", port_gate)
    _, losses = TT.train_plenoxel(ds, DenseConfig(**kw), verbose=False, log_every=4,
                                  device="cpu")
    aux = TT.LAST_TRAIN_AUX
    assert ([r["step"] for r in aux["occupancy_refreshes"]] == done["refresh"]
            == [16, 21, 37, 54, 55, 71])
    assert [aux["camera_gate"]["step"]] == done["gate"] == [21]
    assert aux["steps"] == done["steps"] == 21 + 3 * 17
    assert [(e["epoch"], e["step"]) for e in aux["log"]] == jlog
    assert len(losses) == len(jlosses) == len(jlog)
    assert [c for c in done["chunks"]] == [(0, 16), (16, 5)] + [(0, 16), (16, 1)] * 3


# --------------------------------------------------------------------------
# The reference's ray files


def test_ray_files_round_trip_across_packages(tmp_path, rng):
    """save_ray_dataset / load_ray_dataset both ways between the port and
    tpu3d: the same (N, 9) file and the same arrays; unit directions and
    0-255 colours are normalized on load as tpu3d's."""
    o, d = _rays(rng, 50)
    rgb = rng.uniform(0, 1, (50, 3)).astype(np.float32)
    save_ray_dataset(str(tmp_path / "port.npy"), TT.RayDataset(o, d * 2.0, rgb))
    jax_save_rays(str(tmp_path / "tpu3d.npy"), JT.RayDataset(o, d * 2.0, rgb))
    assert (tmp_path / "port.npy").read_bytes() == (tmp_path / "tpu3d.npy").read_bytes()
    for path in ("port.npy", "tpu3d.npy"):
        got, ref = load_ray_dataset(str(tmp_path / path)), jax_load_rays(str(tmp_path / path))
        for a, b in zip(got[:3], ref[:3]):
            np.testing.assert_array_equal(a, b)
        assert got.cam_ids is None and ref.cam_ids is None
        np.testing.assert_allclose(got.dirs, d, rtol=1e-6, atol=1e-6)
    np.save(tmp_path / "bytes.npy", np.concatenate([o, d, rgb * 255.0], 1))
    got, ref = load_ray_dataset(str(tmp_path / "bytes.npy")), jax_load_rays(str(tmp_path / "bytes.npy"))
    np.testing.assert_array_equal(got.rgb, ref.rgb)
    np.save(tmp_path / "bad.npy", np.zeros((4, 6), np.float32))
    with pytest.raises(ValueError, match="N, 9"):
        load_ray_dataset(str(tmp_path / "bad.npy"))


# --------------------------------------------------------------------------
# The command line


def _parser_flags(main):
    """The option strings of the argparse parser that ``main`` builds."""
    seen = {}

    def grab(self, *a, **k):
        seen["parser"] = self
        raise SystemExit(0)

    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        main([])
    except SystemExit:
        pass
    finally:
        argparse.ArgumentParser.parse_args = real
    return {o for a in seen["parser"]._actions for o in a.option_strings}


# tpu3d flags that are not densify's: other commands' (--iso: mesh, item 7d;
# --from-matches: reconstruct and --overlap: extract, item 11) and the
# process-wide --trace / --xprof (item 12) and --distributed (dist/, item 10).
NOT_DENSIFY = {"--iso", "--from-matches", "--overlap", "--trace", "--xprof", "--distributed"}


def test_cli_takes_every_densify_flag_of_tpu3d():
    """The port's parser defines every flag of tpu3d's that densify reads,
    with tpu3d's defaults; its own are --device and --dense-batch (the
    rays a step, tpu3d's fixed batch by default)."""
    import tpu3d.cli as JC

    jflags, flags = _parser_flags(JC.main), _parser_flags(TC.main)
    assert jflags - NOT_DENSIFY <= flags, sorted(jflags - NOT_DENSIFY - flags)
    assert flags - jflags == {"--device", "--dense-batch"}


# test_densify_cascade_matches_tpu3d's flags. tpu3d's held-out PSNR there is
# 7.3097 / 7.2440 / 7.2585 dB over seeds 0, 1, 2 (a spread of 0.0657 dB), as
# `JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_dense_options.py
# small` prints; the port's random streams differ from tpu3d's, so it is
# held to twice that spread.
CASCADE_FLAGS = dict(epochs=2, grid_resolution=32, num_samples=64, ray_stride=4,
                     contraction=True, hierarchical=True, coarse_epochs=1, detail_epochs=1)
CASCADE_PSNR_TOL_DB = 0.132


def test_densify_cascade_matches_tpu3d(tmp_path):
    """densify at tpu3d's recipe, cut to the 8-view 96x64 scene, a 32^3
    grid and every 4th pixel (--contraction --hierarchical --coarse-epochs 1
    --epochs 2 --detail-epochs 1 --num-samples 64), against tpu3d's
    cmd_densify (its detail phase on its Pallas kernels in interpret mode):
    dense_meta equal (contraction, the cascade's detail grid and box),
    dense_grid_detail of the same shape and bounds, the recipe equal, PSNR
    within CASCADE_PSNR_TOL_DB; and tpu3d's --eval-only scores the port's
    base + detail pair within 0.01 dB of the port's own score."""
    from tpu3d.cli import _densify_eval_only, cmd_densify
    from tpu3d.config import PipelineConfig as JaxPipelineConfig

    scene = chip_smoke.make_scene(0, n_views=8, width=96, height=64)
    images = tmp_path / "images"
    images.mkdir()
    names = [f"img_{i:03d}.png" for i in range(8)]
    for name, rgb in zip(names, scene["rgb"]):
        Image.fromarray(rgb).save(images / name)
    ours, ref = tmp_path / "port", tmp_path / "tpu3d"
    for d in (ours, ref):
        chip_smoke.make_reconstruction_artifacts(str(d), scene)
    cmd_densify(tpu3d_args(str(images), str(ref), focal=scene["focal"], **CASCADE_FLAGS))
    out = TC.densify(str(ours), scene["rgb"], names, scene["focal"], device="cpu",
                     **CASCADE_FLAGS)
    js, ps = JaxStore(str(ref)), ArtifactStore(str(ours))
    jm, pm = js.load_json("dense_meta"), ps.load_json("dense_meta")
    assert jm.keys() == pm.keys() and pm["contraction"] is True and pm["per_ray_aabb"] is False
    jd, pd = jm.pop("cascade_detail"), pm.pop("cascade_detail")
    assert pd["res"] == jd["res"]
    for k in ("min_bound", "max_bound"):
        np.testing.assert_allclose(pd[k], jd[k], rtol=1e-6, atol=1e-6)
    for k, v in jm.items():
        if isinstance(v, (float, list)):
            np.testing.assert_allclose(pm[k], v, rtol=1e-6, err_msg=k)
        else:
            assert pm[k] == v, k
    jdd, pdd = js.load("dense_grid_detail"), ps.load("dense_grid_detail")
    assert pdd["grid"].shape == jdd["grid"].shape == tuple(jd["res"]) + (28,)
    for k in ("min_bound", "max_bound"):
        np.testing.assert_allclose(pdd[k], jdd[k], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(pdd[k], np.float32(pd[k]))
    assert bool(ps.load("mesh_grid")["contraction"]) and bool(js.load("mesh_grid")["contraction"])
    jr = js.load_json("dense_result")
    assert jr.keys() == out.keys() and out["recipe"] == jr["recipe"]
    assert out["recipe"]["coarse_epochs"] == 1 and out["recipe"]["detail_epochs"] == 1
    assert abs(out["test_psnr"] - jr["test_psnr"]) <= CASCADE_PSNR_TOL_DB
    assert np.isfinite(out["final_loss"])
    jps = JaxStore(str(ours))
    _densify_eval_only(types.SimpleNamespace(holdout_every=8, max_eval_views=8),
                       JaxPipelineConfig(), jps, jps.load("reconstruction"),
                       jps.load_json("reconstruction_meta"), names, scene["rgb"],
                       scene["focal"])
    assert jps.load_json("dense_result")["cascade"] is True
    np.testing.assert_allclose(jps.load_json("dense_result")["test_psnr"], out["test_psnr"],
                               atol=0.01)


def test_densify_detail_only_matches_tpu3d(tmp_path):
    """--detail-only: the port's base densify (contraction, hierarchical, 2
    epochs) saved into two stores, then the detail phase alone in each, the
    port's and tpu3d's cmd_densify with the same flags. The port reads the
    normalization, band, box clipping and contraction from dense_meta (tpu3d
    recomputes them from its flags; with the same flags they agree):
    dense_meta equal, dense_grid_detail of the same shape and bounds, the
    base's dense_grid untouched, no held-out eval in either, the recipe
    equal with tpu3d's default of 4 detail epochs."""
    import shutil

    from tpu3d.cli import cmd_densify

    scene = chip_smoke.make_scene(0, n_views=8, width=96, height=64)
    images = tmp_path / "images"
    images.mkdir()
    names = [f"img_{i:03d}.png" for i in range(8)]
    for name, rgb in zip(names, scene["rgb"]):
        Image.fromarray(rgb).save(images / name)
    ours, ref = tmp_path / "port", tmp_path / "tpu3d"
    flags = dict(CASCADE_FLAGS, detail_epochs=0, coarse_epochs=0, ray_stride=8)
    chip_smoke.make_reconstruction_artifacts(str(ours), scene)
    TC.densify(str(ours), scene["rgb"], names, scene["focal"], device="cpu", **flags)
    shutil.copytree(ours, ref)
    base = ArtifactStore(str(ours)).load("dense_grid")["grid"]
    cmd_densify(tpu3d_args(str(images), str(ref), focal=scene["focal"], detail_only=True,
                           **flags))
    out = TC.densify(str(ours), scene["rgb"], names, scene["focal"], device="cpu",
                     detail_only=True, **flags)
    js, ps = JaxStore(str(ref)), ArtifactStore(str(ours))
    jm, pm = js.load_json("dense_meta"), ps.load_json("dense_meta")
    jd, pd = jm.pop("cascade_detail"), pm.pop("cascade_detail")
    assert pd["res"] == jd["res"]
    for k in ("min_bound", "max_bound"):
        np.testing.assert_allclose(pd[k], jd[k], rtol=1e-6, atol=1e-6)
    for k, v in jm.items():
        if isinstance(v, (float, list)):
            np.testing.assert_allclose(pm[k], v, rtol=1e-6, err_msg=k)
        else:
            assert pm[k] == v, k
    assert ps.load("dense_grid_detail")["grid"].shape == js.load("dense_grid_detail")["grid"].shape
    np.testing.assert_array_equal(ps.load("dense_grid")["grid"], base)
    jr = js.load_json("dense_result")
    assert jr.keys() == out.keys() and "test_psnr" not in out
    assert out["recipe"] == jr["recipe"] and out["recipe"]["detail_epochs"] == 4
    assert np.isfinite(out["final_loss"])


# --------------------------------------------------------------------------
# tpu3d's reference numbers.


def tpu3d_densify(root, images, scene, seed, flags, **kw):
    """tpu3d's cmd_densify over ``root`` (reconstruction artifacts written
    afresh) with ``flags`` and train_plenoxel's seed set to ``seed``;
    returns its dense_result."""
    import functools

    from tpu3d.cli import cmd_densify

    real = JT.train_plenoxel
    JT.train_plenoxel = functools.partial(real, seed=seed)
    try:
        chip_smoke.make_reconstruction_artifacts(root, scene)
        cmd_densify(tpu3d_args(images, root, focal=scene["focal"], **flags, **kw))
    finally:
        JT.train_plenoxel = real
    return JaxStore(root).load_json("dense_result")


def tpu3d_grid_psnr(root, scene):
    """evaluate_views of the saved dense_grid alone (a cascade's base),
    with the normalization and band that dense_meta recorded."""
    import dataclasses as dc

    import tpu3d.dense.eval as JE
    from tpu3d.dense.grid import VoxelGrid as JG

    store = JaxStore(root)
    dm, d = store.load_json("dense_meta"), store.load("dense_grid")
    rec = store.load("reconstruction")
    _, test_idx = JE.split_views_by_name(store.load_json("reconstruction_meta")
                                         ["registered_names"], 8)
    norm = JT.SceneNormalization(np.asarray(dm["norm_center"], np.float32), dm["norm_scale"])
    cfg = dc.replace(JaxDenseConfig(), near=dm["near"], far=dm["far"],
                     num_samples=dm["num_samples"], per_ray_aabb=dm["per_ray_aabb"],
                     contraction=dm["contraction"])
    grid = JG(*(jnp.asarray(d[k]) for k in ("grid", "min_bound", "max_bound")))
    return JE.evaluate_views(grid, rec["cams"][test_idx], scene["rgb"][test_idx],
                             scene["focal"], cfg, norm, stride=2, max_views=8)


if __name__ == "__main__":
    import os
    import shutil
    import sys
    import time

    jax.config.update("jax_platforms", "cpu")
    small = sys.argv[1:] == ["small"]
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "build",
                        "tpu3d_recipe_reference")
    shutil.rmtree(root, ignore_errors=True)
    sc = (chip_smoke.make_scene(0, n_views=8, width=96, height=64) if small
          else chip_smoke.make_scene(chip_smoke.SCENE_SEED))
    images = os.path.join(root, "images")
    os.makedirs(images)
    for i, rgb in enumerate(sc["rgb"]):
        Image.fromarray(rgb).save(os.path.join(images, f"img_{i:03d}.png"))
    flags = CASCADE_FLAGS if small else dict(chip_smoke.RECIPE_FLAGS)
    fine, pair = [], []
    for seed in (0, 1, 2):
        t0 = time.time()
        out = tpu3d_densify(os.path.join(root, f"seed{seed}"), images, sc, seed, flags,
                            no_checkpoint=True, final_grid=True)
        pair.append(out["test_psnr"])
        if not small:
            fine.append(tpu3d_grid_psnr(os.path.join(root, f"seed{seed}"), sc)["mean_psnr"])
        print(f"tpu3d on the CPU, densify {flags}, seed {seed}: held-out PSNR of the base + "
              f"detail pair {out['test_psnr_per_view']} mean {pair[-1]!r} dB"
              + ("" if small else f"; of the fine phase's grid alone {fine[-1]!r} dB")
              + f"; {time.time() - t0:.1f} s", flush=True)
    for name, means in (("pair", pair), ("fine grid", fine)):
        if means:
            print(f"{name}: mean PSNR over seeds {means}; spread (max - min) "
                  f"{max(means) - min(means)!r} dB")
    shutil.rmtree(root)
