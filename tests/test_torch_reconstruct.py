"""The port's reconstruct stage against tpu3d's, on the CPU: the torch half
of core/lie, DLT + Gauss-Newton triangulation, PnP, the BA residuals and
Jacobians, the Schur-CG bundle adjustment, the incremental engine with
tpu3d's own registrations and draws, and reconstruct / cli full end to end.

Tolerances, each with its reason, are stated where they are asserted.
"""
import copy
import dataclasses
import json

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
    M = sfm_scene["cfg"].sfm.ransac.num_hypotheses // 2
    key = [jax.random.PRNGKey(0)]

    def tpu3d_draws(self, n):
        key[0], sub = jax.random.split(key[0])
        g = np.asarray(jax.random.gumbel(sub, (M, TE.PNP_CAP)))[:, :n]
        return torch.from_numpy(np.ascontiguousarray(g))

    monkeypatch.setattr(TE.IncrementalSfM, "_pnp_draws", tpu3d_draws)
    jf = tpu3d_sfm["feats"]
    feats = TP.ExtractedFeatures.from_numpy(jf.names, jf.keypoints, jf.keypoints_px, jf.valid,
                                            jf.colors_bgr, jf.image_size, jf.descriptors,
                                            device="cpu")
    regs = [TE.ImageRegistration(img=r.img, edges=[TE.EdgeObservations(
        **{f.name: getattr(e, f.name) for f in dataclasses.fields(e)}) for e in r.edges])
        for r in tpu3d_sfm["regs"]]
    rec = TP.run_reconstruction(feats, regs, copy.deepcopy(tpu3d_sfm["ts"]), sfm_scene["cfg"],
                                verbose=False, adj=tpu3d_sfm["adj"], device="cpu")
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


def test_unported_options_raise(sfm_scene):
    cfg = sfm_scene["cfg"]
    gray = np.zeros((2, 64, 64), np.uint8)
    with pytest.raises(NotImplementedError, match="item 8"):
        TP.reconstruct((gray, np.zeros((2, 64, 64, 3), np.uint8)), cfg, mode="global",
                       device="cpu")
    gate = dataclasses.replace(cfg, sfm=dataclasses.replace(cfg.sfm, edge_consistency_gate=True))
    with pytest.raises(NotImplementedError, match="edge_consistency_gate"):
        TP.run_reconstruction(None, [], None, gate, device="cpu")
    eng = TE.IncrementalSfM(2, cfg.sfm)
    with pytest.raises(NotImplementedError, match="6b"):
        eng.register_low_confidence([])


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
    #     JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_reconstruct.py
    import sys
    import tempfile
    import time

    import chip_smoke
    import tpu3d.sfm.engine as JE

    jax.config.update("jax_platforms", "cpu")
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
            rec = JP.run_reconstruction(feats, regs, ts, jcfg, verbose=False, adj=adj,
                                        seed=seed + 3)
            rows.append((len(rec.registered), rec.mean_reproj_px, len(rec.points)))
            print(f"tpu3d on the CPU, seed {seed}: registered {len(rec.registered)}/"
                  f"{chip_smoke.N_VIEWS}, points {len(rec.points)}, mean reprojection "
                  f"{rec.mean_reproj_px:.6f} px, {time.time() - t0:.1f} s", flush=True)
    reg = min(r[0] for r in rows)
    err = [r[1] for r in rows]
    print(f"min registered {reg}; mean reprojection worst {max(err):.6f} px, spread "
          f"{max(err) - min(err):.6f} px -> limit {max(err) + 2 * (max(err) - min(err)):.6f} px")
    sys.exit(0)
