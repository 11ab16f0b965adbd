"""The port's reconstruct stage against tpu3d's, on the CPU: the torch half
of core/lie, DLT + Gauss-Newton triangulation, PnP, the BA residuals and
Jacobians, the Schur-CG bundle adjustment, the incremental engine with
tpu3d's own registrations and draws, and reconstruct / cli full end to end.

Tolerances, each with its reason, are stated where they are asserted.
"""
import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu3d.sfm.pipeline as JP
import tpu3d_torch.sfm.pipeline as TP
from tests.test_torch_slice import _scene_on_disk, _tpu3d_slice
from tpu3d.ba import bundle_adjust as jax_bundle_adjust
from tpu3d.ba.residuals import _observation_jacobians_jacfwd
from tpu3d.ba.residuals import observation_jacobians as jax_observation_jacobians
from tpu3d.core import lie as jlie
from tpu3d.geometry import pnp as jpnp
from tpu3d.config import CameraConfig
from tpu3d.geometry import triangulate as jtri
from tpu3d_torch.ba import bundle_adjust
from tpu3d_torch.ba.residuals import _residual_one, observation_jacobians
from tpu3d_torch.config import PipelineConfig
from tpu3d_torch.core.lie import so3_exp_np, so3_log_np
from tpu3d_torch.core import lie as tlie
from tpu3d_torch.geometry import pnp as tpnp
from tpu3d_torch.geometry import triangulate as ttri
from tpu3d_torch.matching.tracks import TrackStore
from tpu3d_torch.sfm import engine as TE


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(np.asarray(b)).max(), 1e-12)


# ----------------------------------------------------------------------------
# core/lie, triangulation, PnP


def test_lie_matches_tpu3d():
    """so3_exp / so3_log / its Jacobian within f32 rounding (1e-6), on
    random, tiny (Taylor branch) and near-pi rotations."""
    rng = np.random.default_rng(0)
    w = rng.normal(0, 1, (64, 3)).astype(np.float32)
    w[:8] *= 1e-5
    w[8:16] *= (np.pi - 1e-3) / np.linalg.norm(w[8:16], axis=1, keepdims=True)
    R = tlie.so3_exp(_t(w)).numpy()
    np.testing.assert_allclose(R, np.asarray(jlie.so3_exp(jnp.asarray(w))), atol=1e-6)
    np.testing.assert_allclose(tlie.so3_log(_t(R)).numpy(),
                               np.asarray(jlie.so3_log(jnp.asarray(R))), atol=1e-5)
    jac = np.asarray(jax.vmap(jax.jacfwd(jlie.so3_exp))(jnp.asarray(w)))
    np.testing.assert_allclose(tlie.so3_exp_jacobian(_t(w)).numpy(), jac, atol=1e-5)


def test_camera_and_se3_match_tpu3d():
    """project_extrinsic, project, camera_center, intrinsics_matrix and
    se3_apply on the same inputs: 1e-6 relative (the same f32 arithmetic)."""
    from tpu3d.core import camera as jcam
    from tpu3d_torch.core import camera as tcam

    rng = np.random.default_rng(9)
    w = rng.normal(0, 0.3, (4, 3)).astype(np.float32)
    t = rng.normal(0, 1, (4, 3)).astype(np.float32)
    X = (rng.normal(0, 1, (4, 50, 3)) + [0, 0, 6]).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    pairs = [
        (tcam.project_extrinsic(_t(X), _t(R), _t(t), 800.0),
         jcam.project_extrinsic(jnp.asarray(X), jnp.asarray(R), jnp.asarray(t), 800.0)),
        (tcam.project(_t(X), 800.0), jcam.project(jnp.asarray(X), 800.0)),
        (tcam.camera_center(_t(R), _t(t)), jcam.camera_center(jnp.asarray(R), jnp.asarray(t))),
        (tlie.se3_apply(_t(R), _t(t), _t(X)),
         jlie.se3_apply(jnp.asarray(R), jnp.asarray(t), jnp.asarray(X))),
        (tcam.intrinsics_matrix(800.0), jcam.intrinsics_matrix(800.0)),
    ]
    for got, ref in pairs:
        assert _rel(got.numpy(), np.asarray(ref)) < 1e-6


def test_sfm_backend_resolution():
    """"auto" is "default" on the port: the engine runs on the entry
    point's device; "cpu" and "hybrid" place it as tpu3d does."""
    cfg = PipelineConfig()
    dev = torch.device("meta")
    cpu = torch.device("cpu")
    for backend, want in (("auto", (dev, dev)), ("default", (dev, dev)),
                          ("cpu", (cpu, cpu)), ("hybrid", (cpu, dev))):
        c = dataclasses.replace(cfg, sfm=dataclasses.replace(cfg.sfm, backend=backend))
        assert TP._engine_devices(c, dev) == want
    with pytest.raises(ValueError, match="backend"):
        TP._engine_devices(dataclasses.replace(cfg, sfm=dataclasses.replace(
            cfg.sfm, backend="tpu")), dev)


def _two_views(rng, n=200):
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), rng.uniform(5, 9, n)],
                 -1).astype(np.float32)
    R1 = np.asarray(jlie.so3_exp(jnp.asarray([0.02, -0.1, 0.03], jnp.float32)))
    t1 = np.array([-0.8, 0.05, 0.02], np.float32)
    R0, t0 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    x0 = X[:, :2] / X[:, 2:]
    Xc1 = X @ R1.T + t1
    x1 = Xc1[:, :2] / Xc1[:, 2:]
    x0 = (x0 + rng.normal(0, 5e-4, x0.shape)).astype(np.float32)
    x1 = (x1 + rng.normal(0, 5e-4, x1.shape)).astype(np.float32)
    return R0, t0, R1, t1, x0, x1, X


def test_triangulation_matches_tpu3d():
    """DLT and the two damped GN steps: 1e-4 relative (f32 eigh and 3x3
    solves of two libraries)."""
    args = _two_views(np.random.default_rng(1))[:6]
    X = ttri.triangulate_dlt(*map(_t, args)).numpy()
    Xj = np.asarray(jtri.triangulate_dlt(*map(jnp.asarray, args)))
    assert _rel(X, Xj) < 1e-4
    Xg = ttri.refine_triangulation_gn(*map(_t, args), _t(X), iters=2).numpy()
    Xgj = np.asarray(jtri.refine_triangulation_gn(*map(jnp.asarray, args), jnp.asarray(Xj),
                                                  iters=2))
    assert _rel(Xg, Xgj) < 1e-4


def _pnp_problem(rng, n=300, outliers=60):
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), rng.uniform(5, 9, n)],
                 -1).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.05, 0.2, -0.04], jnp.float32)))
    t = np.array([0.3, -0.1, 0.5], np.float32)
    Xc = X @ R.T + t
    x = Xc[:, :2] / Xc[:, 2:] + rng.normal(0, 3e-4, (n, 2))
    x[:outliers] += rng.uniform(-0.05, 0.05, (outliers, 2))
    valid = np.ones(n, np.float32)
    valid[-20:] = 0.0
    return X, x.astype(np.float32), valid


def test_pnp_dlt_and_refine_match_tpu3d():
    """DLT on clean inliers and the LM polish: the pose within 1e-4."""
    X, x, valid = _pnp_problem(np.random.default_rng(2))
    sl = slice(60, 120)
    R, t = tpnp.pnp_dlt(_t(X[sl]), _t(x[sl]))
    Rj, tj = jpnp.pnp_dlt(jnp.asarray(X[sl]), jnp.asarray(x[sl]))
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=1e-4)
    w = (np.arange(len(X)) >= 60).astype(np.float32) * valid
    R2, t2 = tpnp.refine_pose(R, t, _t(X), _t(x), _t(w))
    Rj2, tj2 = jpnp.refine_pose(Rj, tj, jnp.asarray(X), jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(R2.numpy(), np.asarray(Rj2), atol=1e-4)
    np.testing.assert_allclose(t2.numpy(), np.asarray(tj2), atol=1e-4)


def test_pnp_ransac_with_tpu3d_draws():
    """tpu3d's sample indices, fed as its Gumbel draws: the same inlier
    mask and count, the pose within 1e-4; batched over a leading axis."""
    rng = np.random.default_rng(3)
    probs = [_pnp_problem(rng) for _ in range(2)]
    thr = (2.0 / 800.0) ** 2
    M = 64
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    ref = [jpnp.pnp_ransac(k, *map(jnp.asarray, p), thr, num_hypotheses=M)
           for k, p in zip(keys, probs)]
    noise = np.stack([np.asarray(jax.random.gumbel(k, (M, len(p[0])))) for k, p in zip(keys, probs)])
    R, t, inl, cnt = tpnp.pnp_ransac(_t(noise), *(_t(np.stack(a)) for a in zip(*probs)), thr)
    for b, (Rj, tj, inlj, cntj) in enumerate(ref):
        np.testing.assert_array_equal(inl[b].numpy(), np.asarray(inlj))
        assert int(cnt[b]) == int(cntj)
        np.testing.assert_allclose(R[b].numpy(), np.asarray(Rj), atol=1e-4)
        np.testing.assert_allclose(t[b].numpy(), np.asarray(tj), atol=1e-4)


# ----------------------------------------------------------------------------
# BA


def _ba_problem(rng, n_cams=6, n_pts=300, noise_px=0.3, focal=1000.0, perturb_cam=0.02,
                perturb_pt=0.05):
    """tests/test_ba.py::make_ba_problem's construction."""
    X = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-2, 2, n_pts),
                  rng.uniform(5, 9, n_pts)], -1).astype(np.float32)
    cams = np.stack([np.concatenate([rng.normal(0, 0.05, 3).astype(np.float32),
                                     np.array([0.4 * c - 0.8, 0.02 * c, 0.01 * c], np.float32)])
                     for c in range(n_cams)])
    ci, pi, uvs = [], [], []
    for c in range(n_cams):
        R = np.asarray(jlie.so3_exp(jnp.asarray(cams[c, :3])))
        Xc = X @ R.T + cams[c, 3:]
        uvs.append(Xc[:, :2] / Xc[:, 2:3] + rng.normal(0, noise_px / focal, (n_pts, 2)))
        ci.append(np.full(n_pts, c))
        pi.append(np.arange(n_pts))
    cams0 = cams.copy()
    cams0[1:] += rng.normal(0, perturb_cam, cams0[1:].shape).astype(np.float32)
    cam_fixed = np.zeros(n_cams, np.float32)
    cam_fixed[0] = 1.0
    return dict(X=X, cams=cams, cams0=cams0, X0=(X + rng.normal(0, perturb_pt, X.shape)).astype(np.float32),
                cam_idx=np.concatenate(ci).astype(np.int32),
                pt_idx=np.concatenate(pi).astype(np.int32),
                uv=np.concatenate(uvs).astype(np.float32), w=np.ones(n_cams * n_pts, np.float32),
                cam_fixed=cam_fixed, focal=focal)


def test_observation_jacobians_match_tpu3d_and_jacfwd():
    """Closed-form blocks against tpu3d's and against torch.func.jacfwd of
    the single-observation residual (rtol 1e-4, atol 1e-5: test_ba.py's
    own tolerance for the same equivalence)."""
    rng = np.random.default_rng(4)
    C, P, O = 7, 40, 200
    cams = rng.normal(0, 0.5, (C, 6)).astype(np.float32)
    pts = rng.normal(0, 1, (P, 3)).astype(np.float32)
    pts[:, 2] += 5.0
    args = (cams, pts, rng.integers(0, C, O).astype(np.int32),
            rng.integers(0, P, O).astype(np.int32), rng.normal(0, 0.2, (O, 2)).astype(np.float32),
            (rng.uniform(size=O) > 0.2).astype(np.float32))
    got = observation_jacobians(*(_t(a) for a in args[:2]), _t(args[2]).long(),
                                _t(args[3]).long(), *(_t(a) for a in args[4:]))
    for ref in (jax_observation_jacobians(*map(jnp.asarray, args)),
                _observation_jacobians_jacfwd(*map(jnp.asarray, args))):
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)
    c, X = _t(cams)[args[2]], _t(pts)[args[3]]
    uv, w = _t(args[4]), _t(args[5])
    jc = torch.func.vmap(torch.func.jacfwd(_residual_one, argnums=0))(c, X, uv, w)
    jp = torch.func.vmap(torch.func.jacfwd(_residual_one, argnums=1))(c, X, uv, w)
    np.testing.assert_allclose(got[1].numpy(), jc.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), jp.numpy(), rtol=1e-4, atol=1e-5)


def _run_ba(p, uv=None, **kw):
    args = (p["cams0"], p["X0"], p["cam_idx"], p["pt_idx"],
            p["uv"] if uv is None else uv, p["w"], p["cam_fixed"])
    ref = jax_bundle_adjust(*map(jnp.asarray, args), **kw)
    got = bundle_adjust(*(_t(a) for a in args), **kw)
    return got, ref


@pytest.mark.parametrize("max_iters", [5, 15])
@pytest.mark.parametrize("case", ["plain", "huber", "fixed_points", "cg_tol"])
def test_bundle_adjust_matches_tpu3d(case, max_iters):
    """test_ba.py's problems: final cost within 1e-4 relative, cameras and
    points as _compare_ba states (f32 sums in two orders). Stopped by max_iters=5,
    before convergence, the LM iterations are the same; run to its stall
    exit (max_iters=15) the last iterations change the cost by less than
    the stall tolerance's margin over rounding, which can move the exit by
    one iteration (measured: 8 vs 9 on the plain case, cameras 7e-7 apart),
    so the count must agree within one."""
    rng = np.random.default_rng(6)
    p = _ba_problem(rng, perturb_cam=0.05, perturb_pt=0.1)
    kw = dict(max_iters=max_iters)
    uv = None
    if case == "huber":
        uv = p["uv"].copy()
        idx = np.random.default_rng(7).choice(len(uv), len(uv) // 10, replace=False)
        uv[idx] += 0.05
        kw["robust_delta"] = 3.0 / p["focal"]
    elif case == "fixed_points":
        # every third point and camera 2 frozen at their true positions
        pt_fixed = np.zeros(len(p["X0"]), np.float32)
        pt_fixed[::3] = 1.0
        p["X0"][::3] = p["X"][::3]
        p["cams0"][2] = p["cams"][2]
        p["cam_fixed"][2] = 1.0
        args = (p["cams0"], p["X0"], p["cam_idx"], p["pt_idx"], p["uv"], p["w"],
                p["cam_fixed"], pt_fixed)
        ref = jax_bundle_adjust(*map(jnp.asarray, args), **kw)
        got = bundle_adjust(*(_t(a) for a in args), **kw)
        np.testing.assert_array_equal(got.cams[2].numpy(), p["cams0"][2])
        np.testing.assert_array_equal(got.points[::3].numpy(), p["X0"][::3])
        _compare_ba(got, ref, max_iters, gauge_fixed=True)
        return
    elif case == "cg_tol":
        kw.update(cg_iters=8, cg_tol=1e-2, stall_tol=1e-4, lam0=1e-2)
    got, ref = _run_ba(p, uv, **kw)
    _compare_ba(got, ref, max_iters)


def _compare_ba(got, ref, max_iters, gauge_fixed=False):
    """Iterations as stated above; cost within 1e-4 relative; cameras
    within 1e-4; points within 1e-4 where frozen points fix the scale, and
    within 1e-4 of their extent where only camera 0 is fixed: the scale
    gauge is then cost-flat, and the CG solves (stopped at cg_tol) leave a
    rounding-sized component along it that grows over the iterations
    (measured up to 5e-5 of the extent)."""
    ref_pts = np.asarray(ref.points)
    if max_iters == 5:
        assert got.n_iters == int(ref.n_iters) == 5
    else:
        assert abs(got.n_iters - int(ref.n_iters)) <= 1
    assert abs(float(got.cost) - float(ref.cost)) <= 1e-4 * float(ref.cost)
    np.testing.assert_allclose(got.cams.numpy(), np.asarray(ref.cams), atol=1e-4)
    pts_tol = 1e-4 if gauge_fixed else 1e-4 * np.abs(ref_pts).max()
    np.testing.assert_allclose(got.points.numpy(), ref_pts, atol=pts_tol)


@pytest.mark.parametrize("case", ["empty_segments", "single", "large", "no_observations"])
def test_seg_sum_matches_index_add(case):
    """BA's fixed-order segment sums against index_add_ on the CPU: within
    1e-6 of the sum of |x| over each segment (the two add in different
    orders), exact zeros for segments that nothing lands on, for vector
    and block-valued rows. Two calls give the same bits."""
    from tpu3d_torch.ba.lm import _seg_sum, _segments

    rng = np.random.default_rng(11)
    num = 40
    if case == "empty_segments":      # every third segment empty
        idx = rng.choice(np.arange(num)[np.arange(num) % 3 != 0], 500)
    elif case == "single":            # one observation each, shuffled
        idx = rng.permutation(num)
    elif case == "large":             # one segment holds most of them
        idx = np.where(rng.random(5000) < 0.8, 7, rng.integers(0, num, 5000))
    else:
        idx = np.zeros(0, np.int64)
    idx = torch.from_numpy(idx.astype(np.int64))
    rows = _segments(idx, num)
    assert rows.shape == (num, int(torch.bincount(idx, minlength=num).max()) if len(idx) else 0)
    for shape in ((len(idx),), (len(idx), 6), (len(idx), 6, 6)):
        x = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
        got = _seg_sum(x, rows)
        ref = torch.zeros((num, *shape[1:])).index_add_(0, idx, x)
        scale = torch.zeros((num, *shape[1:])).index_add_(0, idx, x.abs())
        assert got.shape == ref.shape
        assert bool(((got - ref).abs() <= 1e-6 * scale).all())
        assert bool((got[scale == 0] == 0).all())
        assert torch.equal(got, _seg_sum(x, rows))


def test_bundle_adjust_card_problem_has_clear_steps():
    """tests/test_torch_gpu.py's card problem, on the CPU: each of its four
    LM steps is accepted and cuts the cost by 1e-3 relative or more, far
    above what f32 sums taken in another order can move, so the card must
    take the same decisions."""
    from tests.test_torch_gpu import _BA_KW, _ba_problem

    arrays = [torch.from_numpy(a) for a in _ba_problem()]
    costs = [bundle_adjust(*arrays, **dict(_BA_KW, max_iters=m)).cost.item()
             for m in range(5)]
    assert all(b <= (1.0 - 1e-3) * a for a, b in zip(costs, costs[1:])), costs


def test_bundle_adjust_freezes_unobserved_points_and_refuses_variants():
    rng = np.random.default_rng(8)
    p = _ba_problem(rng, n_pts=50)
    w = p["w"].copy()
    w[p["pt_idx"] == 7] = 0.0
    args = [_t(a) for a in (p["cams0"], p["X0"], p["cam_idx"], p["pt_idx"], p["uv"], w,
                            p["cam_fixed"])]
    st = bundle_adjust(*args, max_iters=5)
    np.testing.assert_array_equal(st.points[7].numpy(), p["X0"][7])
    for kw in ({"seg_matmul": True}, {"flat_layout": True}):
        with pytest.raises(NotImplementedError, match="rejected"):
            bundle_adjust(*args, **kw)


# ----------------------------------------------------------------------------
# The engine and the stage, on chip_smoke.make_scene's views (8 of 320x240,
# 512 keypoints)

N_VIEWS, W, H, K = 8, 320, 240, 512


def _with_sfm_focal(jcfg, focal):
    """The engine reads the focal from cfg.sfm.camera; tpu3d's CLI sets it
    beside cfg.camera (tpu3d/cli.py:34-41), and so do these tests."""
    return dataclasses.replace(jcfg, sfm=dataclasses.replace(
        jcfg.sfm, camera=CameraConfig(focal_length=focal)))


@pytest.fixture(scope="module")
def sfm_scene(tmp_path_factory):
    sc = _scene_on_disk(tmp_path_factory.mktemp("sfm_views"), 0, N_VIEWS, W, H, K)
    sc["jcfg"] = _with_sfm_focal(sc["jcfg"], sc["focal"])
    sc["cfg"] = PipelineConfig.from_dict(dataclasses.asdict(sc["jcfg"]))
    return sc


@pytest.fixture(scope="module")
def tpu3d_sfm(sfm_scene):
    """tpu3d's slice and reconstruction on the scene's files, and untouched
    copies of the registrations and tracks it reconstructed from."""
    feats, adj, regs, ts = _tpu3d_slice(sfm_scene)
    regs_in, ts_in = copy.deepcopy(regs), _port_tracks(ts)
    rec = JP.run_reconstruction(feats, regs, ts, sfm_scene["jcfg"], verbose=False, adj=adj)
    return dict(feats=feats, adj=adj, regs=regs_in, ts=ts_in, rec=rec)


def _port_tracks(ts):
    """The port's TrackStore holding tpu3d's union-find state."""
    out = TrackStore(*ts.kp_track.shape, capacity=ts.capacity)
    out.kp_track = ts.kp_track.copy()
    out.parent = ts.parent.copy()
    out.next_track = ts.next_track
    return out


def _centers(cams):
    return np.stack([-so3_exp_np(c[:3]).T @ c[3:6] for c in np.asarray(cams, np.float64)])


def _aligned_center_error(cams, ref_cams):
    """Max distance between camera centres after the least-squares
    similarity (Umeyama) that maps ``cams``' centres onto ``ref_cams``',
    relative to the spread of the reference centres."""
    a, b = _centers(cams), _centers(ref_cams)
    ma, mb = a.mean(0), b.mean(0)
    A, B = a - ma, b - mb
    U, S, Vt = np.linalg.svd(B.T @ A)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    Rs = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / (A ** 2).sum()
    err = np.linalg.norm((s * A @ Rs.T + mb) - b, axis=1)
    return err.max() / np.linalg.norm(B, axis=1).max()


def _tpu3d_pnp_draws(monkeypatch, cfg):
    """Feed the port's engine tpu3d's PnP draws: its engine key
    PRNGKey(0), split once per prepared registration, gumbel (256,
    PNP_CAP)."""
    M = cfg.sfm.ransac.num_hypotheses // 2
    key = [jax.random.PRNGKey(0)]

    def tpu3d_draws(self, n):
        key[0], sub = jax.random.split(key[0])
        g = np.asarray(jax.random.gumbel(sub, (M, TE.PNP_CAP)))[:, :n]
        return torch.from_numpy(np.ascontiguousarray(g))

    monkeypatch.setattr(TE.IncrementalSfM, "_pnp_draws", tpu3d_draws)


def _port_inputs(tpu3d_sfm):
    """tpu3d's features, registrations and tracks as the port's objects."""
    jf = tpu3d_sfm["feats"]
    feats = TP.ExtractedFeatures.from_numpy(jf.names, jf.keypoints, jf.keypoints_px, jf.valid,
                                            jf.colors_bgr, jf.image_size, jf.descriptors,
                                            device="cpu")
    regs = [TE.ImageRegistration(img=r.img, edges=[TE.EdgeObservations(
        **{f.name: getattr(e, f.name) for f in dataclasses.fields(e)}) for e in r.edges])
        for r in copy.deepcopy(tpu3d_sfm["regs"])]
    return feats, regs, copy.deepcopy(tpu3d_sfm["ts"])


def _scene_cams(sfm_scene, registered):
    return np.stack([np.concatenate([so3_log_np(R), t]) for R, t in
                     zip(sfm_scene["R"], sfm_scene["t"])])[registered]


def test_engine_on_tpu3d_registrations(sfm_scene, tpu3d_sfm, monkeypatch):
    """run_reconstruction on tpu3d's own registrations and tracks, with
    tpu3d's PnP draws (its engine key PRNGKey(0), split once per prepared
    registration, gumbel (256, PNP_CAP)): the same registered set, the same
    number of points, the mean reprojection error within 2%, and the
    camera centres, after a similarity alignment, within 1e-3 of the
    centres' spread. The chain of f32 solves (PnP, triangulation, local and
    global BA, each from the previous result) can amplify rounding; here it
    measured 1.4e-7 (mean reprojection 0.2231344 vs 0.2231345 px), and 1e-3
    still separates a misplaced camera (the scene's neighbouring centres
    are ~0.08 of the spread apart)."""
    _tpu3d_pnp_draws(monkeypatch, sfm_scene["cfg"])
    feats, regs, ts = _port_inputs(tpu3d_sfm)
    rec = TP.run_reconstruction(feats, regs, ts, sfm_scene["cfg"], verbose=False,
                                adj=tpu3d_sfm["adj"], device="cpu")
    ref = tpu3d_sfm["rec"]
    np.testing.assert_array_equal(rec.registered, ref.registered)
    assert len(rec.points) == len(ref.points)
    assert abs(rec.mean_reproj_px - ref.mean_reproj_px) <= 0.02 * ref.mean_reproj_px
    assert _aligned_center_error(rec.cams, ref.cams) < 1e-3
    assert set(TP.LAST_SFM_TIMERS) >= {"pnp", "triangulate", "local_ba", "global_ba",
                                       "windowed_ba", "host", "calls", "edge_cap"}


def test_reconstruct_end_to_end(sfm_scene, tpu3d_sfm):
    """The port's whole pipeline from the files with its own draws, at the
    decision level: registered >= tpu3d's less one, mean reprojection
    error <= 1 px, and camera centres within 1% of their spread of the
    scene's after a similarity alignment."""
    rec, timings = TP.reconstruct(sfm_scene["dir"], sfm_scene["cfg"], verbose=False,
                                  device="cpu")
    assert len(rec.registered) >= len(tpu3d_sfm["rec"].registered) - 1
    assert rec.mean_reproj_px <= 1.0
    gt = np.stack([np.concatenate([so3_log_np(R), t]) for R, t in
                   zip(sfm_scene["R"], sfm_scene["t"])])[rec.registered]
    assert _aligned_center_error(rec.cams, gt) < 1e-2
    assert set(timings) == {"extract", "retrieve", "match", "reconstruct", "total"}


def test_global_on_tpu3d_registrations(sfm_scene, tpu3d_sfm, monkeypatch):
    """run_global_reconstruction on tpu3d's own registrations and tracks,
    with tpu3d's PnP draws, against tpu3d's global mode on the same
    inputs: the same registered set and point count, the mean reprojection
    error within 2%, the camera centres within 1e-3 of their spread after a
    similarity alignment (the reasons of test_engine_on_tpu3d_registrations;
    the pose graph is numpy f64 on both sides)."""
    _tpu3d_pnp_draws(monkeypatch, sfm_scene["cfg"])
    ref = JP.run_global_reconstruction(
        tpu3d_sfm["feats"], copy.deepcopy(tpu3d_sfm["regs"]),
        _jax_tracks(tpu3d_sfm["ts"]), sfm_scene["jcfg"], verbose=False, adj=tpu3d_sfm["adj"])
    feats, regs, ts = _port_inputs(tpu3d_sfm)
    rec = TP.run_global_reconstruction(feats, regs, ts, sfm_scene["cfg"], verbose=False,
                                       adj=tpu3d_sfm["adj"], device="cpu")
    np.testing.assert_array_equal(rec.registered, ref.registered)
    assert len(rec.points) == len(ref.points)
    assert abs(rec.mean_reproj_px - ref.mean_reproj_px) <= 0.02 * ref.mean_reproj_px
    assert _aligned_center_error(rec.cams, ref.cams) < 1e-3
    assert len(rec.low_confidence) == 0
    assert TP.LAST_SFM_TIMERS["pose_graph_component"] == N_VIEWS


def _jax_tracks(ts):
    """tpu3d's TrackStore holding the port copy's union-find state."""
    from tpu3d.matching import TrackStore as JTrackStore

    out = JTrackStore(*ts.kp_track.shape, capacity=ts.capacity)
    out.kp_track = ts.kp_track.copy()
    out.parent = ts.parent.copy()
    out.next_track = ts.next_track
    return out


def test_reconstruct_global_end_to_end(sfm_scene, tpu3d_sfm):
    """reconstruct(mode="global") from the files with the port's own draws,
    at the decision level: registered >= tpu3d's less one, mean
    reprojection error <= 1 px, and camera centres within 1% of their
    spread of the scene's after a similarity alignment."""
    rec, timings = TP.reconstruct(sfm_scene["dir"], sfm_scene["cfg"], verbose=False,
                                  mode="global", device="cpu")
    assert len(rec.registered) >= len(tpu3d_sfm["rec"].registered) - 1
    assert rec.mean_reproj_px <= 1.0
    assert _aligned_center_error(rec.cams, _scene_cams(sfm_scene, rec.registered)) < 1e-2


def test_unported_options_raise(sfm_scene, tmp_path, capsys):
    """What the port still refuses, each naming its ROADMAP item: densify
    --mesh (10) and approximate top-k retrieval (12). The options it once
    refused now run: full --frontend disk, extract --frontend superpoint
    and match --matcher lightglue (item 9; seeded random weights from
    tpu3d's inits), and densify --model sdf (item 7d) on full's
    reconstruction."""
    from tpu3d.features.disk import DiskUNet
    from tpu3d.features.learned import save_params_npz
    from tpu3d.features.superpoint import SuperPointNet
    from tpu3d.matching.lightglue import LightGlue
    from tpu3d_torch import cli

    common = ["--images", sfm_scene["dir"], "--artifacts", str(tmp_path), "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="item 10"):
        cli.main(["densify", *common, "--mesh", "auto"])
    cfg = sfm_scene["cfg"]
    approx = dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend,
                                                                   approx_topk_recall=0.95))
    gray = np.zeros((2, 64, 64), np.uint8)
    with pytest.raises(NotImplementedError, match="item 12"):
        TP.run_extraction((gray, np.zeros((2, 64, 64, 3), np.uint8)), approx, verbose=False,
                          device="cpu")

    def weights(name, module, *shapes):
        key = jax.random.PRNGKey(0)
        params = module.init(key, *(jnp.zeros(s) if isinstance(s, tuple) else s for s in shapes))
        path = str(tmp_path / f"{name}.npz")
        save_params_npz(path, jax.tree_util.tree_map(np.asarray, params))
        return path

    disk = weights("disk", DiskUNet(), (1, 32, 32, 3))
    sp = weights("superpoint", SuperPointNet(), (1, 32, 32, 1))
    kp, size = jnp.zeros((1, 8, 2)), jnp.ones((1, 2))
    d256 = jnp.zeros((1, 8, 256))
    lg = weights("lightglue", LightGlue(input_dim=256, n_layers=2), kp, d256, size, kp, d256, size)

    def run(cmd, art, *flags):
        cli.main([cmd, "--images", sfm_scene["dir"], "--artifacts", str(tmp_path / art),
                  "--device", "cpu", "--focal", str(sfm_scene["focal"]), "--max-keypoints",
                  "512", "--quiet", *flags])
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    out = run("full", "disk", "--frontend", "disk", "--frontend-weights", disk)
    assert out["registered"] >= 2 and np.isfinite(out["mean_reproj_px"])
    out = run("densify", "disk", "--model", "sdf", "--grid-resolution", "16", "--ray-stride",
              "16", "--num-samples", "16", "--dense-downscale", "2")
    assert out["recipe"]["model"] == "sdf" and np.isfinite(out["final_loss"])
    out = run("extract", "sp", "--frontend", "superpoint", "--frontend-weights", sp)
    assert out["images"] == N_VIEWS
    assert np.load(tmp_path / "sp" / "features.npz")["descriptors"].shape[-1] == 256
    out = run("match", "sp", "--matcher", "lightglue", "--matcher-weights", lg)
    assert out["match_timers"]["n_edges"] > 0 and (tmp_path / "sp" / "pairs_meta.json").exists()


def _run_cli(argv):
    """tpu3d_torch.cli.main(argv): (exit code, stdout, stderr)."""
    import contextlib
    import io

    from tpu3d_torch import cli

    out, err = io.StringIO(), io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            cli.main(argv)
        except SystemExit as e:
            code = e.code
    return code, out.getvalue(), err.getvalue()


def _cli_common(sfm_scene, art):
    return ["--images", sfm_scene["dir"], "--artifacts", str(art), "--focal",
            str(sfm_scene["focal"]), "--device", "cpu", "--quiet", "--max-keypoints", str(K)]


@pytest.fixture(scope="module")
def staged_cli(sfm_scene, tmp_path_factory):
    """The port's staged commands on the scene's files: extract, match,
    reconstruct --from-matches in both modes (the global one into a copy
    of the store), export, and the one-process full run; each command's
    last stdout line parsed."""
    import shutil

    root = tmp_path_factory.mktemp("staged")
    art, glob = root / "art", root / "art_global"
    out = {"art": art, "art_global": glob}
    for name, argv in (("extract", ["extract"]), ("match", ["match"]),
                       ("incremental", ["reconstruct", "--from-matches", "--ply",
                                        str(root / "cloud.ply")])):
        code, stdout, _ = _run_cli([argv[0], *_cli_common(sfm_scene, art), *argv[1:]])
        assert code == 0
        out[name] = json.loads(stdout.strip().splitlines()[-1])
    shutil.copytree(art, glob)
    code, stdout, _ = _run_cli(["reconstruct", *_cli_common(sfm_scene, glob), "--from-matches",
                                "--mode", "global"])
    out["global"] = json.loads(stdout.strip().splitlines()[-1])
    code, stdout, _ = _run_cli(["export", *_cli_common(sfm_scene, art)])
    assert code == 0
    out["export"] = json.loads(stdout.strip().splitlines()[-1])
    code, stdout, _ = _run_cli(["full", *_cli_common(sfm_scene, root / "full")])
    out["full"] = json.loads(stdout.strip().splitlines()[-1])
    return out


def test_cli_staged_commands(sfm_scene, tpu3d_sfm, staged_cli):
    """extract -> match -> reconstruct --from-matches (both modes) ->
    export with --device cpu: each stage's artifacts hold tpu3d's file
    names and keys and load in tpu3d's loaders; the incremental result from
    the files is the one-process full run's (the same registered count,
    points and mean reprojection error: the files carry every input
    exactly); both modes reach tpu3d's decision level."""
    from tpu3d.io.artifacts import ArtifactStore as JaxArtifactStore
    from tpu3d.io.matches import load_matches as jax_load_matches

    art = staged_cli["art"]
    store = JaxArtifactStore(str(art))
    feats = store.load("features")
    assert set(feats) == {"keypoints", "keypoints_px", "descriptors", "valid", "colors_bgr",
                          "image_size"}
    assert feats["descriptors"].shape == (N_VIEWS, K, 128)
    assert set(store.load_json("features_meta")) == {"names", "downscale", "seconds"}
    assert set(store.load_json("pairs_meta")) == {"registrations", "adjacency", "next_track",
                                                  "seconds"}
    regs, ts, adj = jax_load_matches(str(art), N_VIEWS, K, 400_000)
    assert len(regs) == staged_cli["match"]["images"]
    assert sum(len(r.edges) for r in regs) == staged_cli["match"]["edges"]
    assert set(adj) == set(range(N_VIEWS))
    for key in ("art", "art_global"):
        rec = JaxArtifactStore(str(staged_cli[key])).load("reconstruction")
        meta = JaxArtifactStore(str(staged_cli[key])).load_json("reconstruction_meta")
        assert set(rec) == {"cams", "registered", "points", "colors_bgr", "track_ids",
                            "extrinsics"}
        assert set(meta) == {"registered_names", "mean_reproj_px", "num_obs", "mode",
                             "downscale", "seconds", "sfm_phase_seconds", "sfm_backend",
                             "low_confidence_names", "per_camera_reproj_px"}
        assert meta["mode"] == ("global" if key == "art_global" else "incremental")
    inc, full = staged_cli["incremental"], staged_cli["full"]
    assert (inc["registered"], inc["points"], inc["mean_reproj_px"]) == \
        (full["registered"], full["points"], full["mean_reproj_px"])
    for mode in ("incremental", "global"):
        assert staged_cli[mode]["registered"] >= len(tpu3d_sfm["rec"].registered) - 1
        assert staged_cli[mode]["mean_reproj_px"] <= 1.0
    assert set(staged_cli["export"]["written"]) == {
        "img_list.txt", "all_points/descriptors/colors, img_size", "bow_codebook.plk",
        "img_pairs/all_matches", "reconstructed_img/cameras_extrinsic/points_3d/result.ply"}


def _same_npy(a, b):
    """Equal .npy contents, object arrays element by element."""
    x, y = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
    assert x.shape == y.shape and x.dtype == y.dtype
    if x.dtype == object:
        for u, v in zip(x.ravel(), y.ravel()):
            np.testing.assert_array_equal(u, v)
    else:
        np.testing.assert_array_equal(x, y)


def test_export_matches_tpu3d(staged_cli, tmp_path):
    """tpu3d's export of the same artifacts: every file equal but the
    codebook, whose k-means draws differ (jax.random against a
    torch.Generator); it matches in k and shape."""
    import joblib

    from tpu3d.io.reference_export import export_reference_layout

    mine = staged_cli["export"]["out"]
    ref_dir = str(tmp_path / "ref")
    assert export_reference_layout(str(staged_cli["art"]), ref_dir) == \
        staged_cli["export"]["written"]
    names = sorted(os.listdir(ref_dir))
    assert names == sorted(os.listdir(mine))
    for name in names:
        a, b = os.path.join(mine, name), os.path.join(ref_dir, name)
        if name == "bow_codebook.plk":
            (k, cb), (k_ref, cb_ref) = joblib.load(a), joblib.load(b)
            assert k == k_ref and cb.shape == cb_ref.shape and np.isfinite(cb).all()
        elif name.endswith(".npy"):
            _same_npy(a, b)
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name


def test_cli_reconstruct_from_tpu3d_matches(sfm_scene, tpu3d_sfm, tmp_path):
    """tpu3d's features and match artifacts (its save_matches on its own
    slice, as its `match` writes them) into the port's reconstruct
    --from-matches, both modes: tpu3d's decision level, and camera centres
    within 1% of their spread of the scene's after a similarity alignment."""
    from tpu3d.io.artifacts import ArtifactStore as JaxArtifactStore
    from tpu3d.io.matches import save_matches as jax_save_matches

    jf = tpu3d_sfm["feats"]
    store = JaxArtifactStore(str(tmp_path))
    store.save("features", keypoints=jf.keypoints, keypoints_px=jf.keypoints_px,
               descriptors=jf.descriptors, valid=jf.valid, colors_bgr=jf.colors_bgr,
               image_size=jf.image_size)
    store.save_json("features_meta", {"names": jf.names, "downscale": 1, "seconds": 0.0})
    jax_save_matches(str(tmp_path), copy.deepcopy(tpu3d_sfm["regs"]),
                     _jax_tracks(tpu3d_sfm["ts"]), tpu3d_sfm["adj"])
    for mode in ("incremental", "global"):
        code, stdout, _ = _run_cli(["reconstruct", *_cli_common(sfm_scene, tmp_path),
                                    "--from-matches", "--mode", mode])
        assert code == 0
        out = json.loads(stdout.strip().splitlines()[-1])
        assert out["registered"] >= len(tpu3d_sfm["rec"].registered) - 1
        assert out["mean_reproj_px"] <= 1.0
        rec = store.load("reconstruction")
        assert _aligned_center_error(rec["cams"],
                                     _scene_cams(sfm_scene, rec["registered"])) < 1e-2


def test_cli_missing_artifacts_exit_1(sfm_scene, staged_cli, tmp_path):
    """reconstruct --from-matches without match artifacts, and match or
    reconstruct without features, print tpu3d's message and exit 1."""
    import shutil

    feats_only = tmp_path / "feats_only"
    feats_only.mkdir()
    for name in ("features.npz", "features_meta.json"):
        shutil.copy(staged_cli["art"] / name, feats_only / name)
    code, _, err = _run_cli(["reconstruct", *_cli_common(sfm_scene, feats_only),
                             "--from-matches"])
    assert code == 1 and "run `match` first" in err
    for cmd in (["match"], ["reconstruct", "--from-matches"]):
        code, _, err = _run_cli([cmd[0], *_cli_common(sfm_scene, tmp_path / "empty"), *cmd[1:]])
        assert code == 1 and "run `extract` first" in err


def test_cli_full_then_densify(sfm_scene, tmp_path, capsys):
    """``python -m tpu3d_torch.cli full`` then ``densify --epochs 1`` (a 32^3
    grid), both from tpu3d_torch: tpu3d's ArtifactStore loads what full
    wrote unchanged, the PLY has a vertex per kept point, and densify
    trains from the port-made reconstruction."""
    from tpu3d.io.artifacts import ArtifactStore as JaxArtifactStore
    from tpu3d_torch import cli

    art = str(tmp_path / "art")
    ply = str(tmp_path / "art" / "cloud.ply")
    common = ["--images", sfm_scene["dir"], "--artifacts", art, "--focal",
              str(sfm_scene["focal"]), "--device", "cpu", "--quiet"]
    cli.main(["full", *common, "--max-keypoints", str(K), "--ply", ply])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(summary) == {"registered", "points", "mean_reproj_px", "stage_seconds",
                            "extract_timers", "match_timers"}
    store = JaxArtifactStore(art)
    rec = store.load("reconstruction")
    meta = store.load_json("reconstruction_meta")
    assert len(rec["cams"]) == summary["registered"] == len(meta["registered_names"])
    assert rec["extrinsics"].shape == (summary["registered"], 3, 4)
    assert store.load_json("features_meta")["num_images"] == N_VIEWS
    with open(ply) as f:
        n_vert = int(next(ln for ln in f if ln.startswith("element vertex")).split()[-1])
    assert 0 < n_vert <= summary["points"]
    cli.main(["densify", *common, "--epochs", "1", "--dense-downscale", "1",
              "--grid-resolution", "32", "--num-samples", "16", "--ray-stride", "8",
              "--max-eval-views", "1", "--no-checkpoint"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["final_loss"])
    assert store.load("mesh_grid")["grid"].shape == (32, 32, 32, 4)


if __name__ == "__main__":
    # tpu3d's reconstruct on chip_smoke's full-size scene (24 views of
    # 968x648, 2048 keypoints, the default config with the scene's focal)
    # on the CPU, over three seeds of its draws (retrieval, gate, engine
    # and rescue keys): the registered count and mean reprojection error
    # that chip_smoke.py's full phase holds the port to.
    #     JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_reconstruct.py [global]
    # With ``global``, tpu3d's run_global_reconstruction instead: what
    # chip_smoke.py's sfm phase holds the port's global mode to.
    import sys
    import tempfile
    import time

    import chip_smoke
    import tpu3d.sfm.engine as JE

    jax.config.update("jax_platforms", "cpu")
    global_mode = sys.argv[1:] == ["global"]
    base_engine = JE.IncrementalSfM
    rows = []
    with tempfile.TemporaryDirectory() as d:
        sc = _scene_on_disk(d, chip_smoke.SCENE_SEED, chip_smoke.N_VIEWS, chip_smoke.WIDTH,
                            chip_smoke.HEIGHT, 2048)
        jcfg = _with_sfm_focal(sc["jcfg"], sc["focal"])
        for seed in range(3):
            class SeededEngine(base_engine):
                def __init__(self, n_images, config=None, seed=seed):
                    super().__init__(n_images, config, seed)

            JP.IncrementalSfM = SeededEngine
            t0 = time.time()
            feats = JP.run_extraction(sc["dir"], jcfg, verbose=False)
            adj = JP.run_retrieval(feats, jcfg, seed=seed)
            regs, ts = JP.run_matching(feats, adj, jcfg, seed=seed + 1, verbose=False)
            run = JP.run_global_reconstruction if global_mode else JP.run_reconstruction
            rec = run(feats, regs, ts, jcfg, verbose=False, adj=adj, seed=seed + 3)
            rows.append((len(rec.registered), rec.mean_reproj_px, len(rec.points)))
            print(f"tpu3d {'global' if global_mode else 'incremental'} on the CPU, seed "
                  f"{seed}: registered {len(rec.registered)}/"
                  f"{chip_smoke.N_VIEWS}, points {len(rec.points)}, mean reprojection "
                  f"{rec.mean_reproj_px:.6f} px, {time.time() - t0:.1f} s", flush=True)
    reg = min(r[0] for r in rows)
    err = [r[1] for r in rows]
    print(f"min registered {reg}; mean reprojection worst {max(err):.6f} px, spread "
          f"{max(err) - min(err):.6f} px -> limit {max(err) + 2 * (max(err) - min(err)):.6f} px")
    sys.exit(0)
