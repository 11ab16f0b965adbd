"""The port's SfM options against tpu3d's on the CPU, on the same inputs:
the edge-consistency gate, the --register-all low-confidence pass (the four
cases of tests/test_register_all.py and one with track anchors whose depth
ratios disagree), shared-focal refinement on tests/test_ba.py's problem,
and the match artifacts both ways."""
import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import synthetic_scene
from tpu3d.ba.focal import refine_focal as jax_refine_focal
from tpu3d.config import CameraConfig as JCameraConfig
from tpu3d.config import SfMConfig as JSfMConfig
from tpu3d.core import lie as jlie
from tpu3d.io import matches as JM
from tpu3d.matching import TrackStore as JTrackStore
from tpu3d.sfm import engine as JE
from tpu3d.sfm import pipeline as JP
from tpu3d_torch.ba.focal import refine_focal
from tpu3d_torch.config import CameraConfig, SfMConfig
from tpu3d_torch.io import matches as TM
from tpu3d_torch.matching.tracks import TrackStore
from tpu3d_torch.sfm import engine as TE
from tpu3d_torch.sfm import pipeline as TP

FOCAL = 1000.0


def _engines(n_images, register_all=True):
    """tpu3d's engine and the port's, both on the CPU."""
    j = JE.IncrementalSfM(n_images, JSfMConfig(camera=JCameraConfig(focal_length=FOCAL),
                                               register_all=register_all, backend="cpu"))
    t = TE.IncrementalSfM(n_images, SfMConfig(camera=CameraConfig(focal_length=FOCAL),
                                              register_all=register_all, backend="cpu"))
    return j, t


def _edge_args(ref_img, n, rel_R, rel_t, tracks=None, rng=None):
    """tests/test_register_all.py's edge: random matches near the centre,
    the new view's coordinates jittered by half a pixel."""
    rng = rng or np.random.default_rng(0)
    uv = rng.uniform(-50.0, 50.0, (n, 2)).astype(np.float32)
    return dict(ref_img=ref_img, idx_ref=np.arange(n), idx_new=np.arange(n),
                track=np.full(n, -1, np.int64) if tracks is None else tracks,
                uv_ref=uv, uv_new=uv + rng.normal(0, 0.5, (n, 2)).astype(np.float32),
                colors_ref=np.zeros((n, 3), np.uint8), rel_R=rel_R, rel_t=rel_t)


def _regs(spec):
    """[(img, [edge kwargs])] as tpu3d's and the port's registrations."""
    return ([JE.ImageRegistration(img=i, edges=[JE.EdgeObservations(**copy.deepcopy(e))
                                                for e in es]) for i, es in spec],
            [TE.ImageRegistration(img=i, edges=[TE.EdgeObservations(**copy.deepcopy(e))
                                                for e in es]) for i, es in spec])


def _anchor_case(eng):
    """Image 1 sees 60 tracks that image 0 (registered, at the origin)
    reconstructed, a third of them at 1.5x and a third at 2.2x their depth
    along image 0's rays: every anchor reprojects exactly in image 0, but
    the depth ratios disagree (spread 0.33 > 0.25)."""
    rng = np.random.default_rng(3)
    n = 60
    X = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), rng.uniform(4, 6, n)], -1)
    R1 = jlie.so3_exp_np(np.asarray([0.02, -0.04, 0.01], np.float32)).astype(np.float64)
    t1 = np.asarray([-0.5, 0.02, 0.03])
    X1 = X @ R1.T + t1
    stored = X * np.repeat([1.0, 1.5, 2.2], n // 3)[:, None]
    eng.cams[0] = 0.0
    eng.has_cam[0] = True
    eng.num_registered = 1
    eng.points[:n] = stored
    eng.point_valid[:n] = True
    return [(1, [dict(ref_img=0, idx_ref=np.arange(n), idx_new=np.arange(n),
                      track=np.arange(n, dtype=np.int64),
                      uv_ref=(FOCAL * X[:, :2] / X[:, 2:]).astype(np.float32),
                      uv_new=(FOCAL * X1[:, :2] / X1[:, 2:]).astype(np.float32),
                      colors_ref=np.zeros((n, 3), np.uint8),
                      rel_R=R1.astype(np.float32),
                      rel_t=(t1 / np.linalg.norm(t1)).astype(np.float32))])]


def _low_confidence_case(name, eng):
    I = np.eye(3, dtype=np.float32)
    if name == "anchors_spread":
        return _anchor_case(eng)
    eng.cams[0] = (np.asarray([0, 0, 0, 0.1, 0.0, 0.2], np.float32) if name == "chained"
                   else np.zeros(6, np.float32))
    eng.has_cam[0] = True
    eng.num_registered = 1
    if name == "chained":
        rel_R = jlie.so3_exp_np(np.asarray([0.03, -0.05, 0.02], np.float32))
        return [(2, [_edge_args(0, 20, rel_R, np.asarray([0.4, 0.0, 0.1], np.float32))])]
    if name == "across_rounds":
        return [(2, [_edge_args(1, 12, I, np.asarray([0.2, 0.1, 0], np.float32))]),
                (1, [_edge_args(0, 12, I, np.asarray([0.3, 0, 0], np.float32))])]
    if name == "no_observations":
        return [(1, [_edge_args(0, 10, I, np.asarray([0.2, 0, 0], np.float32))])]
    eng.has_cam[:] = True            # all_registered
    eng.num_registered = len(eng.has_cam)
    return [(0, []), (1, [])]


@pytest.mark.parametrize("name", ["chained", "across_rounds", "no_observations",
                                  "all_registered", "anchors_spread"])
def test_register_low_confidence_matches_tpu3d(name):
    """The same placed set in the same order, and the cameras within 1e-5."""
    j, t = _engines(3)
    spec = _low_confidence_case(name, j)
    _low_confidence_case(name, t)
    jregs, tregs = _regs(spec)
    placed = t.register_low_confidence(tregs)
    assert placed == j.register_low_confidence(jregs)
    np.testing.assert_array_equal(t.has_cam, j.has_cam)
    np.testing.assert_allclose(t.cams, j.cams, atol=1e-5)
    assert t.num_registered == j.num_registered
    assert t._gather_global_problem() is None and j._gather_global_problem() is None
    if name == "anchors_spread":
        # the spread gate refuses the placement; relaxed takes it, tagged
        for relaxed in (False, True):
            ti, ji = {}, {}
            got = t._relative_pose_fallback(1, tregs[0].edges, ti, relaxed=relaxed)
            ref = j._relative_pose_fallback(1, jregs[0].edges, ji, relaxed=relaxed)
            assert (got is None) == (ref is None) == (not relaxed)
            assert ti == ji
        assert ti["fallback_relpose_inliers"].endswith("(relaxed)")


def test_finalize_marks_low_confidence():
    """finalize with register_all fills Reconstruction.low_confidence as
    tpu3d's does (no BA run: run_global_ba off)."""
    j, t = _engines(3)
    for e in (j, t):
        e.cfg = dataclasses.replace(e.cfg, run_global_ba=False)
    spec = _low_confidence_case("across_rounds", j)
    _low_confidence_case("across_rounds", t)
    jregs, tregs = _regs(spec)
    names = ["a", "b", "c"]
    rec, ref = t.finalize(names, tregs), j.finalize(names, jregs)
    np.testing.assert_array_equal(rec.low_confidence, ref.low_confidence)
    np.testing.assert_array_equal(rec.registered, ref.registered)
    assert list(rec.low_confidence) == [1, 2]


def _gate_state(rot_deg):
    """Six cameras along a line viewing 200 points, each image observing
    every point; edges (i, i+1) and (i, i+2) carry the true relative pose.
    Camera 3 is turned by ``rot_deg`` about y in the engines' state."""
    rng = np.random.default_rng(7)
    n_img, n_pts = 6, 200
    X = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-2, 2, n_pts),
                  rng.uniform(6, 9, n_pts)], -1).astype(np.float32)
    R = [jlie.so3_exp_np(np.asarray([0.0, 0.03 * i, 0.0], np.float32)) for i in range(n_img)]
    tt = [np.asarray([-0.4 * i, 0.0, 0.0], np.float32) for i in range(n_img)]
    uv = [(FOCAL * (X @ R[i].T + tt[i])[:, :2] / (X @ R[i].T + tt[i])[:, 2:]).astype(np.float32)
          for i in range(n_img)]
    spec = []
    for jimg in range(1, n_img):
        es = []
        for iimg in (jimg - 2, jimg - 1):
            if iimg < 0:
                continue
            rR = R[jimg] @ R[iimg].T
            rt = tt[jimg] - rR @ tt[iimg]
            es.append(dict(ref_img=iimg, idx_ref=np.arange(n_pts), idx_new=np.arange(n_pts),
                           track=np.arange(n_pts, dtype=np.int64), uv_ref=uv[iimg],
                           uv_new=uv[jimg], colors_ref=np.zeros((n_pts, 3), np.uint8),
                           rel_R=rR, rel_t=(rt / np.linalg.norm(rt)).astype(np.float32)))
        spec.append((jimg, es))
    bad = jlie.so3_exp_np(np.asarray([0.0, np.radians(rot_deg), 0.0])) @ R[3]
    cams = np.stack([np.concatenate([jlie.so3_log_np(bad if i == 3 else R[i]), tt[i]])
                     for i in range(n_img)]).astype(np.float32)
    return X, cams, uv, spec


@pytest.mark.parametrize("rot_deg", [0.0, 20.0])
def test_edge_consistency_gate_matches_tpu3d(rot_deg):
    """One engine state through both gates: the same number dropped (the
    turned camera at 20 degrees, none at 0) and the same has_cam /
    obs_valid; the global BA after a drop leaves the cameras within 1e-4."""
    X, cams, uv, spec = _gate_state(rot_deg)
    j, t = _engines(6, register_all=False)
    for e in (j, t):
        e.cams[:] = cams
        e.has_cam[:] = True
        e.num_registered = 6
        e.points[: len(X)] = X
        e.point_valid[: len(X)] = True
        for i in range(6):
            e._record_obs(i, np.arange(len(X)), np.arange(len(X)), uv[i])
    jregs, tregs = _regs(spec)
    dropped = TP._edge_consistency_gate(t, tregs, verbose=False)
    assert dropped == JP._edge_consistency_gate(j, jregs, verbose=False)
    assert dropped == (1 if rot_deg else 0)
    np.testing.assert_array_equal(t.has_cam, j.has_cam)
    np.testing.assert_array_equal(t.obs_valid, j.obs_valid)
    assert t.num_registered == j.num_registered
    if rot_deg:
        assert not t.has_cam[3]
        np.testing.assert_allclose(t.cams[t.has_cam], j.cams[j.has_cam], atol=1e-4)


def test_refine_focal_matches_tpu3d():
    """tests/test_ba.py's problem (5 cameras, 120 points, the free cameras
    and the points perturbed, a 25% low start): the port's focal within
    1e-3 relative of tpu3d's (f32 BA solves of two libraries, 28 of them
    chained through the golden-section bracket) and within 1% of the
    truth."""
    rng = np.random.default_rng(42)
    sc = synthetic_scene(rng, n_points=120, n_cams=5, focal=1000.0)
    n_cams, n_pts = sc["R"].shape[0], sc["X"].shape[0]
    cams0 = np.stack([np.concatenate([jlie.so3_log_np(sc["R"][c]), sc["t"][c]])
                      for c in range(n_cams)]).astype(np.float32)
    cams0[1:] += rng.normal(0, 0.005, cams0[1:].shape).astype(np.float32)
    X0 = sc["X"] + rng.normal(0, 0.01, sc["X"].shape).astype(np.float32)
    cam_idx = np.repeat(np.arange(n_cams), n_pts)
    pt_idx = np.tile(np.arange(n_pts), n_cams)
    uv_px = sc["uv"].reshape(-1, 2).astype(np.float32)
    w = np.ones(len(cam_idx), np.float32)
    cam_fixed = np.zeros(n_cams, np.float32)
    cam_fixed[0] = 1.0
    args = (cams0, X0, cam_idx, pt_idx, uv_px, w, cam_fixed)
    f_ref, _ = jax_refine_focal(*(jnp.asarray(a) for a in args), focal0=750.0)
    f, st = refine_focal(*(torch.from_numpy(np.asarray(a)) for a in args), focal0=750.0)
    assert abs(f - f_ref) / f_ref < 1e-3, (f, f_ref)
    assert abs(f - 1000.0) / 1000.0 < 0.01
    assert float(st.cost) < 1e-4


def _match_state():
    """Registrations over 4 images of 64 keypoints (one edge without a
    relative pose) and their track store, as plain kwargs."""
    rng = np.random.default_rng(5)
    ts = TrackStore(4, 64, capacity=1000)
    spec = []
    for jimg, refs in ((1, [0]), (2, [0, 1]), (3, [2])):
        es = []
        for k, r in enumerate(refs):
            m = 20 + 5 * k
            i0, i1 = rng.choice(64, m, replace=False), rng.choice(64, m, replace=False)
            rel = jlie.so3_exp_np(rng.normal(0, 0.1, 3).astype(np.float32)).astype(np.float64)
            es.append(dict(ref_img=r, idx_ref=i0, idx_new=i1, track=ts.union_pair(r, jimg, i0, i1),
                           uv_ref=rng.normal(0, 100, (m, 2)).astype(np.float32),
                           uv_new=rng.normal(0, 100, (m, 2)).astype(np.float32),
                           colors_ref=rng.integers(0, 255, (m, 3)).astype(np.uint8),
                           rel_R=None if jimg == 3 else rel,
                           rel_t=None if jimg == 3 else rng.normal(0, 1, 3)))
        spec.append((jimg, es))
    adj = {0: [1, 2], 1: [0, 2], 2: [0, 1, 3], 3: [2]}
    return spec, ts, adj


def _same_matches(a, b):
    (regs_a, ts_a, adj_a), (regs_b, ts_b, adj_b) = a, b
    assert adj_a == adj_b
    np.testing.assert_array_equal(ts_a.kp_track, ts_b.kp_track)
    np.testing.assert_array_equal(ts_a.parent, ts_b.parent)
    assert ts_a.next_track == ts_b.next_track
    assert [r.img for r in regs_a] == [r.img for r in regs_b]
    for ra, rb in zip(regs_a, regs_b):
        assert len(ra.edges) == len(rb.edges)
        for ea, eb in zip(ra.edges, rb.edges):
            for f in dataclasses.fields(TE.EdgeObservations):
                va, vb = getattr(ea, f.name), getattr(eb, f.name)
                if va is None or vb is None:
                    assert va is None and vb is None, f.name
                else:
                    np.testing.assert_array_equal(va, vb, err_msg=f.name)


def test_matches_artifacts_both_ways(tmp_path):
    """The port's save_matches then load_matches gives back what was saved
    (the relative pose as float32 values, the file's precision); tpu3d's
    load_matches reads the port's files and the port reads tpu3d's, with
    equal arrays."""
    spec, ts, adj = _match_state()
    _, tregs = _regs(spec)
    port_dir, tpu3d_dir = tmp_path / "port", tmp_path / "tpu3d"
    port_dir.mkdir()
    tpu3d_dir.mkdir()
    TM.save_matches(str(port_dir), tregs, ts, adj, 1.5)
    back = TM.load_matches(str(port_dir), 4, 64, 1000)
    for r in tregs:
        for e in r.edges:
            if e.rel_R is not None:
                e.rel_R = e.rel_R.astype(np.float32).astype(np.float64)
                e.rel_t = e.rel_t.astype(np.float32).astype(np.float64)
    _same_matches(back, (tregs, ts, adj))
    _same_matches(JM.load_matches(str(port_dir), 4, 64, 1000), back)
    jregs, _ = _regs(spec)
    jts = JTrackStore(4, 64, capacity=1000)
    jts.kp_track, jts.parent, jts.next_track = ts.kp_track.copy(), ts.parent.copy(), ts.next_track
    JM.save_matches(str(tpu3d_dir), jregs, jts, adj, 1.5)
    _same_matches(TM.load_matches(str(tpu3d_dir), 4, 64, 1000), back)
    assert TM.load_matches(str(tmp_path), 4, 64, 1000) is None
