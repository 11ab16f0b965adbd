"""The port's SDF model, voxel traversal and meshing (tpu3d_torch/dense/
{sdf,render,train,traversal,mesh}.py, io/ply.py, cli densify --model sdf and
cli mesh) against tpu3d's, on the CPU.

Inputs come from numpy seeds and go through the tpu3d function and its
port. On the CPU the trilinear and scatter wrappers run their plain PyTorch
versions; the CUDA kernels are compared with them by
tests/test_torch_gpu.py and chip_smoke.py. Training steps take tpu3d's
random draws (``StepNoise``, and the epoch permutations through
``train._permutation`` / ``train._sdf_step_noise``), which torch cannot
reproduce.
"""
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
import tpu3d.dense.train as JT
from tpu3d.config import DenseConfig as JaxDenseConfig
from tpu3d.dense.grid import VoxelGrid as JaxGrid
from tpu3d.dense.mesh import dedup_mesh as jax_dedup_mesh
from tpu3d.dense.mesh import marching_tetrahedra as jax_marching_tetrahedra
from tpu3d.dense.render import render_rays_aabb as jax_render_rays_aabb
from tpu3d.dense.sdf import SDFGrid as JaxSDFGrid
from tpu3d.dense.sdf import get_sdf as jax_get_sdf
from tpu3d.dense.sdf import get_sdf_gradient as jax_get_sdf_gradient
from tpu3d.dense.sdf import gradient_softmax_weights as jax_gradient_softmax_weights
from tpu3d.dense.sdf import grid_bounds_from_cloud as jax_grid_bounds_from_cloud
from tpu3d.dense.sdf import query_sdf_sh as jax_query_sdf_sh
from tpu3d.dense.traversal import voxel_traversal as jax_voxel_traversal
from tpu3d.io.artifacts import ArtifactStore as JaxStore
from tpu3d_torch.cli import main
from tpu3d_torch.config import DenseConfig
from tpu3d_torch.dense import train as TT
from tpu3d_torch.dense import voxel_traversal
from tpu3d_torch.dense.grid import VoxelGrid
from tpu3d_torch.dense.mesh import dedup_mesh, marching_tetrahedra
from tpu3d_torch.dense.render import render_rays_aabb
from tpu3d_torch.dense.sdf import (SDFGrid, get_sdf, get_sdf_gradient,
                                   gradient_softmax_weights, grid_bounds_from_cloud,
                                   query_sdf_sh)
from tpu3d_torch.io.artifacts import ArtifactStore
from tpu3d_torch.io.ply import write_ply_mesh

LO = np.float32([-1.0, -0.9, -1.1])
HI = np.float32([1.0, 1.2, 0.8])
RES = (9, 10, 11)
SRES, BATCH, N_RAYS, N_CAMS = 12, 48, 160, 3


def t(a):
    return torch.from_numpy(np.array(a))


def n(x):
    return x.detach().cpu().numpy()


def _sdf_grid(seed=0, res=RES):
    """A random SDF grid whose SDF is negative (no density) on the box's
    faces: a box-clipped band ends on a face, where rounding decides whether
    its last sample (whose segment is 1e10) is inside, so a density there
    would be a step (ROADMAP Queue 3, limits of parity)."""
    rng = np.random.RandomState(seed)
    g = (rng.randn(*res, 28) * 0.4).astype(np.float32)
    g[..., 0] = rng.randn(*res) * 1.5
    s = g[..., 0]
    for face in (s[0], s[-1], s[:, 0], s[:, -1], s[:, :, 0], s[:, :, -1]):
        face[...] = -np.abs(face) - 0.1
    return g


def _points(seed, n_pts, margin=1.3):
    rng = np.random.RandomState(seed)
    return rng.uniform(LO * margin, HI * margin, (n_pts, 3)).astype(np.float32)


def test_sdf_queries_match_tpu3d():
    """get_sdf, get_sdf_gradient (torch.autograd against jax.grad through
    the plain interpolant), gradient_softmax_weights and query_sdf_sh on
    points inside and outside the box: within atol 1e-5."""
    g = _sdf_grid()
    sg, jsg = (SDFGrid(t(g), t(LO), t(HI)),
               JaxSDFGrid(jnp.asarray(g), jnp.asarray(LO), jnp.asarray(HI)))
    assert sg.as_voxel_grid().grid is sg.grid
    pts = _points(1, 300)
    d = np.random.RandomState(2).randn(300, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    np.testing.assert_allclose(n(get_sdf(sg, t(pts))), np.asarray(jax_get_sdf(jsg, pts)),
                               atol=1e-5)
    np.testing.assert_allclose(n(get_sdf_gradient(sg, t(pts))),
                               np.asarray(jax_get_sdf_gradient(jsg, jnp.asarray(pts))), atol=1e-5)
    ray_pts = pts.reshape(30, 10, 3)
    np.testing.assert_allclose(n(gradient_softmax_weights(sg, t(ray_pts))),
                               np.asarray(jax_gradient_softmax_weights(jsg, jnp.asarray(ray_pts))),
                               atol=1e-5)
    sigma, rgb = query_sdf_sh(sg, t(pts), t(d))
    js, jr = jax_query_sdf_sh(jsg, jnp.asarray(pts), jnp.asarray(d))
    np.testing.assert_allclose(n(sigma), np.asarray(js), atol=1e-5)
    np.testing.assert_allclose(n(rgb), np.asarray(jr), atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_grid_bounds_from_cloud_matches_tpu3d(seed):
    cloud = np.random.RandomState(seed).randn(500, 3) * [3.0, 1.0, 0.5] + [0.2, -1.0, 4.0]
    got, ref = grid_bounds_from_cloud(cloud, 64), jax_grid_bounds_from_cloud(cloud, 64)
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == np.float32
    assert got[2] == ref[2]


def _rays(seed, n_rays, miss_every=5):
    """Rays from x = -3 towards +x through the box, every ``miss_every``-th
    one pointed away from it (invalid)."""
    rng = np.random.RandomState(seed)
    o = np.zeros((n_rays, 3), np.float32)
    o[:, 0] = -3.0
    o[:, 1:] = rng.uniform(-0.5, 0.5, (n_rays, 2))
    d = rng.randn(n_rays, 3).astype(np.float32) * 0.25
    d[:, 0] = np.abs(d[:, 0]) + 1.0
    d[::miss_every, 0] *= -1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.mark.parametrize("perturb", [False, True])
def test_render_rays_aabb_matches_tpu3d(perturb):
    """render_rays_aabb with per-ray box bounds, unjittered and with tpu3d's
    uniforms injected: colours within 1e-5 per channel, ``valid`` exact
    (a fifth of the rays miss the box)."""
    g = _sdf_grid(3)
    o, d = _rays(4, 64)
    S = 24
    key = jax.random.PRNGKey(5)
    ref, jvalid = jax_render_rays_aabb(JaxSDFGrid(jnp.asarray(g), jnp.asarray(LO), jnp.asarray(HI)),
                                       key, jnp.asarray(o), jnp.asarray(d), S, True, perturb)
    u = t(np.asarray(jax.random.uniform(key, (64, S), jnp.float32))) if perturb else None
    got, valid = render_rays_aabb(SDFGrid(t(g), t(LO), t(HI)), t(o), t(d), S, True, perturb, u=u)
    np.testing.assert_array_equal(n(valid), np.asarray(jvalid))
    assert 0 < int(valid.sum()) < 64
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=1e-5)


def _sdf_cfg(case):
    base = dict(grid_resolution=SRES, batch_size=BATCH, num_samples=12, scan_chunk=1)
    if case == "regularized":
        base.update(tv_sigma=0.3, tv_sh=0.05, sparsity_sigma=0.02, exposure=True,
                    sh_background=True)
    return JaxDenseConfig(**base), DenseConfig(**base)


def _jax_sdf_noise(cfg, key, grid_shape, n_rays):
    """tpu3d's draws for SDF step key ``key`` (render_rays_aabb's stratified
    uniforms, the crops' fold_in(key, 7) / (key, 11)) as a StepNoise."""
    u = t(np.asarray(jax.random.uniform(key, (n_rays, cfg.num_samples), jnp.float32)))

    def origin(fold, extra):
        ks = jax.random.split(jax.random.fold_in(key, fold), 3)
        return t(np.array([int(jax.random.randint(k, (), 0, dim - min(cfg.tv_crop, dim - 1 + extra)
                                                  + extra))
                           for k, dim in zip(ks, grid_shape[:3])], np.int64))

    return TT.StepNoise(u, None, origin(7, 0) if cfg.tv_sigma or cfg.tv_sh else None,
                        origin(11, 1) if cfg.sparsity_sigma else None)


@pytest.mark.parametrize("case", ["plain", "regularized"])
def test_sdf_step_matches_tpu3d(case):
    """One SDF step, then four more chained, with tpu3d's draws injected,
    against tpu3d's XLA step (make_sdf_train_step): loss, grid, Adam moments
    and the latents within 1e-5 after one step and within rtol 2e-4 / atol
    5e-4 after five (the plenoxel step's limits, tests/test_torch_train.py).
    The port's step renders as tpu3d's packed SDF step does (near 0, far
    1e6, box-clipped); a fifth of the rays miss the box and are masked out
    of the loss. The regularized case adds TV, sparsity, exposure and the
    SH background."""
    jcfg, cfg = _sdf_cfg(case)
    g0 = _sdf_grid(6, (SRES,) * 3)
    o, d = _rays(7, N_RAYS)
    rng = np.random.RandomState(8)
    rgb = rng.rand(N_RAYS, 3).astype(np.float32)
    cid = rng.randint(0, N_CAMS, N_RAYS).astype(np.int32)
    jopt = JT.make_optimizer(jcfg, 5)
    jstate = JT.TrainState(JaxGrid(jnp.asarray(g0), jnp.asarray(LO), jnp.asarray(HI)),
                           jopt.init(jnp.asarray(g0)), jnp.asarray(0),
                           JT.init_exposure(N_CAMS) if jcfg.exposure else None,
                           JT.init_background() if jcfg.sh_background else None)
    jstep = JT.make_sdf_train_step(jcfg, jopt)
    state = TT.init_state(cfg, VoxelGrid(t(g0.copy()), t(LO), t(HI)), 5,
                          N_CAMS if cfg.exposure else None)

    def pairs():
        st = state.optimizer.state[state.grid.grid]
        adam = jstate.opt_state[0]
        out = [("grid", n(state.grid.grid), jstate.grid.grid), ("mu", n(st["exp_avg"]), adam.mu),
               ("nu", n(st["exp_avg_sq"]), adam.nu)]
        for k in ("exposure", "background"):
            if getattr(state, k) is not None:
                out.append((k, n(getattr(state, k)), getattr(jstate, k)))
        return [(name, a, np.asarray(b)) for name, a, b in out]

    for i in range(5):
        sel = np.random.RandomState(100 + i).choice(N_RAYS, BATCH, replace=False)
        key = jax.random.fold_in(jax.random.PRNGKey(3), i)
        jc = jnp.asarray(cid[sel]) if jcfg.exposure else None
        jstate, jl = jstep(jstate, key, jnp.asarray(o[sel]), jnp.asarray(d[sel]),
                           jnp.asarray(rgb[sel]), cid=jc)
        loss = TT.sdf_train_step(state, cfg, t(o[sel]), t(d[sel]), t(rgb[sel]),
                                 t(cid[sel].astype(np.int64)) if cfg.exposure else None,
                                 noise=_jax_sdf_noise(jcfg, key, g0.shape, BATCH))
        tol = dict(rtol=1e-5, atol=1e-5) if i == 0 else dict(rtol=2e-4, atol=5e-4)
        np.testing.assert_allclose(float(loss), float(jl), **tol)
        if i in (0, 4):
            for name, got, ref in pairs():
                np.testing.assert_allclose(got, ref, err_msg=name, **tol)
    assert state.step == int(jstate.step) == 5
    assert np.abs(n(state.grid.grid) - g0).max() > 1e-3


@pytest.mark.parametrize("coarse", [False, True])
def test_train_sdf_losses_match_tpu3d(monkeypatch, coarse):
    """train_sdf's logged losses against tpu3d's train_sdf (XLA route) at
    scan_chunk=1 with tpu3d's permutations and step draws injected: rtol
    1e-3 / atol 1e-5, the limit tpu3d holds its own two routes to
    (tests/test_dense.py::test_sdf_packed_training_matches_xla). The coarse
    case trains a coarse 8^3 epoch first (_coarse_stage) and returns the
    16^3 grid. The grid starts at tpu3d's 0.01 with an SDF of -0.5 on the
    box's faces: a ray's last jittered sample can land on its exit face
    (a draw of u = 1 - 2^-24 does here), where rounding decides whether it
    is inside, and its 1e10 segment turns that into a step of the colour
    (0.96 on one ray with density on the faces; ROADMAP Queue 3, limits of
    parity)."""
    from tpu3d.config import DenseConfig as JDC
    from tpu3d.dense.train import RayDataset as JRayDataset
    from tpu3d.dense.train import train_sdf as jax_train_sdf

    rng = np.random.default_rng(42)
    n_rays = 1024
    o = rng.normal(size=(n_rays, 3)).astype(np.float32)
    o = 3.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True)
    rgb = rng.uniform(0.2, 0.8, size=(n_rays, 3)).astype(np.float32)
    kw = dict(grid_resolution=16, num_samples=16, epochs=2 if coarse else 1, batch_size=256,
              scene_scale=1.0, scan_chunk=1, coarse_epochs=1 if coarse else 0)
    g0 = np.full((16, 16, 16, 28), 0.01, np.float32)
    s = g0[..., 0]
    for face in (s[0], s[-1], s[:, 0], s[:, -1], s[:, :, 0], s[:, :, -1]):
        face[...] = -0.5
    box = (np.full(3, -1.0, np.float32), np.full(3, 1.0, np.float32))
    _, jl = jax_train_sdf(JRayDataset(o, d, rgb), JDC(**kw), verbose=False, log_every=1,
                          packed=False, grid=JaxGrid(jnp.asarray(g0), *map(jnp.asarray, box)))

    def epoch_keys(epoch):
        key = jax.random.PRNGKey(0)
        for _ in range(epoch + 1):
            key, pkey, ekey = jax.random.split(key, 3)
        return pkey, ekey

    def perm(n_, gen, dev, epoch):
        return t(np.asarray(jax.random.permutation(epoch_keys(epoch)[0], n_)).astype(np.int64))

    def noise(cfg, shape, n_r, gen, dev, epoch, step):
        k = jax.random.fold_in(epoch_keys(epoch)[1], np.uint32(step))
        return _jax_sdf_noise(cfg, k, shape, n_r)

    monkeypatch.setattr(TT, "_permutation", perm)
    monkeypatch.setattr(TT, "_sdf_step_noise", noise)
    g, losses = TT.train_sdf(TT.RayDataset(o, d, rgb), DenseConfig(**kw), verbose=False,
                             log_every=1, grid=VoxelGrid(t(g0), *map(t, box)), device="cpu")
    assert g.resolution == (16, 16, 16) and len(losses) == len(jl) == 4 * kw["epochs"]
    np.testing.assert_allclose(losses, jl, rtol=1e-3, atol=1e-5)
    assert [p["phase"] for p in TT.LAST_TRAIN_AUX["phases"]] == (
        ["coarse", "fine"] if coarse else ["train"])


def test_train_sdf_ignores_occupancy_and_the_camera_gate():
    """train_sdf with occupancy pruning (a refresh due every 4 steps) and the
    camera gate (at epoch 1, MAD 0: a plenoxel loop drops a camera) against
    both off, 2 epochs of 21 steps: the same logged losses and grid, bit for
    bit, no occupancy refresh and no gate recorded (tpu3d's SDF loop has
    neither)."""
    rng = np.random.RandomState(3)
    o = rng.normal(size=(168, 3)).astype(np.float32)
    o = 2.5 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o + rng.normal(scale=0.3, size=o.shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ds = TT.RayDataset(o, d, rng.uniform(0.2, 0.8, (168, 3)).astype(np.float32),
                       np.repeat(np.arange(7, dtype=np.int32), 24))
    kw = dict(grid_resolution=8, batch_size=8, num_samples=8, epochs=2, scene_scale=1.0,
              tv_sigma=0.1, exposure=True, sh_background=True, occupancy_every=4,
              occupancy_threshold=0.5, camera_gate_epoch=1, camera_gate_mad=0.0)
    out = {}
    for on in (True, False):
        g, losses = TT.train_sdf(ds, DenseConfig(occupancy_prune=on, camera_gate=on, **kw),
                                 seed=2, verbose=False, log_every=1, device="cpu")
        aux = TT.LAST_TRAIN_AUX
        assert aux["occupancy_refreshes"] == [] and aux["camera_gate"] is None
        assert aux["dropped_cameras"] == []
        out[on] = (g.grid, losses)
    assert len(out[True][1]) == 42
    np.testing.assert_array_equal(out[True][1], out[False][1])
    assert torch.equal(out[True][0], out[False][0])


def test_train_sdf_refuses_a_device_mesh():
    """train_sdf(mesh=) trains through the brick-sharded step (item 10, once
    refused here), which refuses what tpu3d's refuses: occupancy pruning,
    and a batch the data axis does not divide."""
    from tpu3d_torch.dist.mesh import Mesh

    ds = TT.RayDataset(*(np.zeros((4, 3), np.float32),) * 3)
    with pytest.raises(ValueError, match="occupancy_prune"):
        TT.train_sdf(ds, DenseConfig(occupancy_prune=True), mesh=Mesh(1, 1), device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        TT.train_sdf(ds, DenseConfig(batch_size=3), mesh=Mesh(2, 1), device="cpu")
    o, d, rgb = (np.random.RandomState(0).rand(64, 3).astype(np.float32) for _ in range(3))
    g, losses = TT.train_sdf(TT.RayDataset(o, d / np.linalg.norm(d, axis=1, keepdims=True),
                                           rgb),
                             DenseConfig(grid_resolution=8, batch_size=16, num_samples=8),
                             mesh=Mesh(1, 1), verbose=False, log_every=1, device="cpu")
    assert g.resolution == (8, 8, 8) and len(losses) == 4 and np.all(np.isfinite(losses))
    assert TT.LAST_TRAIN_AUX["mesh"] == {"data": 1, "model": 1}


def test_voxel_traversal_matches_tpu3d():
    """voxel_traversal against tpu3d's on random rays and on rays along,
    and grazing, the axes: the visited indices equal, -1 in the unused
    slots, the finished and the empty rays included."""
    rng = np.random.RandomState(9)
    res = (7, 8, 9)
    mn, vs = np.float32([-1.0, -1.0, -1.0]), np.float32(0.25)
    o = rng.uniform(-2.5, -1.5, (40, 3)).astype(np.float32)
    d = rng.uniform(0.2, 1.0, (40, 3)).astype(np.float32)
    d[:8] = np.eye(3, dtype=np.float32)[np.arange(8) % 3]           # axis-aligned
    o[:8] = [np.roll(np.float32([-1.6, -0.4, 0.1]), i % 3) for i in range(8)]
    d[8:12] = np.float32([[1, 1, 0], [0, 1, 1], [1, 0, 1], [-1, 1, 0]])
    o[11] = [1.6, -1.6, 0.3]
    d[12:16] *= -1.0                                                 # pointing away
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lo, hi = mn, mn + vs * np.float32(res)
    inv = 1.0 / np.where(np.abs(d) < 1e-9, 1e-9, d)
    t0, t1 = (lo - o) * inv, (hi - o) * inv
    t_near = np.maximum(np.minimum(t0, t1).max(-1), 0.0).astype(np.float32)
    t_far = np.maximum(t0, t1).min(-1).astype(np.float32)
    ref = np.asarray(jax_voxel_traversal(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_near),
                                         jnp.asarray(t_far), jnp.asarray(mn), vs, res, 32))
    got = n(voxel_traversal(t(o), t(d), t(t_near), t(t_far), t(mn), float(vs), res, 32))
    assert got.shape == (40, 32, 3) and got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    assert (got[12:16] == -1).all() and (got[:8, 0] >= 0).all()


def _sphere():
    ax = np.linspace(-1, 1, 33, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    r = np.sqrt(x ** 2 + y ** 2 + z ** 2)
    colors = np.stack([np.full_like(r, 0.8), y * 0.5 + 0.5, np.full_like(r, 0.1)], -1)
    return 10.0 * (0.6 - r), colors


def test_marching_tetrahedra_matches_tpu3d(tmp_path):
    """tpu3d's sphere case (tests/test_dense.py:427): marching_tetrahedra and
    dedup_mesh equal tpu3d's array for array, and write_ply_mesh writes
    tpu3d's bytes."""
    sigma, colors = _sphere()
    got = marching_tetrahedra(sigma, 0.0, (-1, -1, -1), (1, 1, 1), colors)
    ref = jax_marching_tetrahedra(sigma, 0.0, (-1, -1, -1), (1, 1, 1), colors)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    got, ref = dedup_mesh(*got), jax_dedup_mesh(*ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert len(got[0]) > 500
    from tpu3d.io.ply import write_ply_mesh as jax_write_ply_mesh

    assert write_ply_mesh(str(tmp_path / "a.ply"), *got) == \
        jax_write_ply_mesh(str(tmp_path / "b.ply"), *ref)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()


def test_densify_sdf_then_mesh_on_the_cpu(tmp_path, capsys):
    """cli densify --model sdf on 8 views at 96x64 and a 16^3 grid, then cli
    mesh: dense_meta records the SDF model with its training band (near
    1e-3, far 1e3, box-clipped), the held-out view is scored, the mesh is
    non-empty, and tpu3d's cmd_mesh on the port's mesh_grid gives the same
    vertex and face counts and iso level."""
    from tpu3d.cli import cmd_mesh

    scene = chip_smoke.make_scene(0, n_views=8, width=96, height=64)
    images, art = tmp_path / "images", tmp_path / "art"
    images.mkdir()
    for i, rgb in enumerate(scene["rgb"]):
        Image.fromarray(rgb).save(images / f"img_{i:03d}.png")
    chip_smoke.make_reconstruction_artifacts(str(art), scene)
    common = ["--images", str(images), "--artifacts", str(art), "--dense-downscale", "1",
              "--focal", str(scene["focal"]), "--device", "cpu"]
    main(["densify", *common, "--model", "sdf", "--grid-resolution", "16", "--ray-stride", "4",
          "--num-samples", "16", "--quiet"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["test_view_names"] == ["img_004.png"] and np.isfinite(out["test_psnr"])
    assert out["recipe"]["model"] == "sdf" and np.isfinite(out["final_loss"])
    store = ArtifactStore(str(art))
    meta = store.load_json("dense_meta")
    assert (meta["model"], meta["near"], meta["far"], meta["per_ray_aabb"]) == \
        ("sdf", 1e-3, 1e3, True)
    assert store.load("dense_grid")["grid"].shape == (16, 16, 16, 28)
    main(["mesh", *common, "--out", str(tmp_path / "port.ply")])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cmd_mesh(types.SimpleNamespace(artifacts=str(art), iso=0.0, out=str(tmp_path / "jax.ply")))
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["vertices"] > 0 and got["faces"] > 0
    assert (got["vertices"], got["faces"], got["iso"]) == (ref["vertices"], ref["faces"],
                                                           ref["iso"])
    assert JaxStore(str(art)).load("mesh_grid")["grid"].dtype == np.float16


def test_train_sdf_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.train_sdf(TT.RayDataset(*(np.zeros((4, 3), np.float32),) * 3))


# --------------------------------------------------------------------------
# tpu3d's reference numbers.


def tpu3d_sdf_psnr(root, scene, seed, res, ray_stride, num_samples=192, log_every=10):
    """tpu3d's densify --model sdf with its default flags (coremax
    normalization, the name-keyed holdout every 8 views, scene scale 1.0,
    one epoch) through train_sdf(seed) on the CPU, then scored with the
    SDF's training band (near 1e-3, far 1e3, box-clipped) by tpu3d's
    evaluate_views and by the port's on the same grid; returns (tpu3d's
    evaluate_views dict, the port's, losses).

    The band ends on the box's exit face, so every ray's last sample (whose
    segment is 1e10) lies on the face, and whether it counts as inside
    depends on how o + t d rounds: XLA fuses some of those products into
    FMAs and not others, eager torch never does. The two scorers therefore
    differ on the same grid (ROADMAP Queue 3); the port's scorer on tpu3d's
    grid is what a port-trained grid is held to."""
    import dataclasses

    import tpu3d.dense.eval as JE
    from tpu3d_torch.dense import eval as PE

    store = JaxStore(root)
    rec = store.load("reconstruction")
    names = store.load_json("reconstruction_meta")["registered_names"]
    norm = JT.normalize_scene_coremax(rec["points"])
    near, far = JT.auto_near_far(rec["cams"], rec["points"], norm)
    cfg = JaxDenseConfig(epochs=1, grid_resolution=res, scene_scale=1.0, near=near, far=far,
                         num_samples=num_samples)
    train_idx, test_idx = JE.split_views_by_name(names, 8)
    ds = JE.dataset_from_views(rec["cams"], scene["rgb"], scene["focal"], train_idx, norm,
                               stride=ray_stride)
    grid, losses = JT.train_sdf(ds, cfg, seed=seed, verbose=False, log_every=log_every,
                                packed=False)
    band = dict(near=1e-3, far=1e3, per_ray_aabb=True)
    cams, rgb = rec["cams"][test_idx], scene["rgb"][test_idx]
    ev = JE.evaluate_views(grid, cams, rgb, scene["focal"], dataclasses.replace(cfg, **band),
                           norm, stride=2, max_views=8)
    pgrid = VoxelGrid(t(np.asarray(grid.grid)), t(np.asarray(grid.min_bound)),
                      t(np.asarray(grid.max_bound)))
    del grid
    pev = PE.evaluate_views(pgrid, cams, rgb, scene["focal"],
                            DenseConfig(num_samples=num_samples, **band),
                            TT.SceneNormalization(np.asarray(norm.center), norm.scale),
                            stride=2, max_views=8)
    return ev, pev, losses


if __name__ == "__main__":
    # tpu3d's held-out PSNR of chip_smoke.py's sdf phase (densify --model sdf
    # at the default width, 256^3 x 28, 192 samples, ray stride 8) on the
    # CPU, seeds 0, 1, 2, or with ``small`` the same at a 32^3 grid, 64
    # samples, on 8 views at 96x64:
    #     JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_sdf.py [small]
    import os
    import shutil
    import sys
    import time

    jax.config.update("jax_platforms", "cpu")
    small = sys.argv[1:] == ["small"]
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "build",
                        "tpu3d_sdf_reference")
    if small:
        sc = chip_smoke.make_scene(0, n_views=8, width=96, height=64)
        res, stride, samples = 32, 2, 64
    else:
        sc = chip_smoke.make_scene(chip_smoke.SCENE_SEED)
        res, stride, samples = chip_smoke.DENSE_RES, chip_smoke.TRAIN_RAY_STRIDE, 192
    chip_smoke.make_reconstruction_artifacts(root, sc)
    means, port_means = [], []
    for seed in (0, 1, 2):
        t0 = time.time()
        ev, pev, losses = tpu3d_sdf_psnr(root, sc, seed, res, stride, samples)
        means.append(ev["mean_psnr"])
        port_means.append(pev["mean_psnr"])
        print(f"tpu3d on the CPU, sdf, {res}^3 x 28, ray stride {stride}, {samples} samples, "
              f"seed {seed}: held-out PSNR {ev['per_view']} mean {ev['mean_psnr']!r} dB; "
              f"the port's scorer on the same grid {pev['per_view']} mean "
              f"{pev['mean_psnr']!r} dB; losses {losses}; {time.time() - t0:.1f} s", flush=True)
    for label, m in (("tpu3d's scorer", means), ("the port's scorer", port_means)):
        print(f"{label}: mean PSNR over seeds {m}; spread (max - min) {max(m) - min(m)!r} dB")
    shutil.rmtree(root)
