"""The port's fused orientation + descriptor pass (tpu3d_torch/kernels/
orient_desc.py) against tpu3d's Pallas kernel run in interpret mode on the
CPU, against tpu3d's split path, and through the whole classical frontend
with ``fused_descriptor=True``.

Tolerances: theta within 1e-5 rad and the samples within
``sample_tolerance`` wherever both sides pick the same histogram peak: 1e-5
x max|g| for rounding, plus 2 sqrt(2) max|g| r dtheta, the most a theta
difference dtheta can move a bilinear sample at radius r (a bilinear
sample's slope is at most 2 max|g| per px on each axis). The two differ in
f32 rounding only (the Pallas kernel sums its histogram and its circulant
as matmuls in an order of its own, the port in a fixed order), which moves
the parabolic peak by a few ulp (one keypoint in these inputs by 8.8e-6
rad).
A keypoint whose two largest smoothed bins lie within 1e-5 of each other
(relative) can pick the other peak under such rounding: those are counted
and must be under 5%.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

import tpu3d.kernels.orient_desc as JOD
from tpu3d.config import FrontendConfig as JaxFrontendConfig
from tpu3d.features import descriptor as JD
from tpu3d.features.frontend import extract_features as jax_extract_features
from tpu3d_torch.config import FrontendConfig
from tpu3d_torch.features import descriptor as TD
from tpu3d_torch.features.frontend import extract_features
from tpu3d_torch.kernels import LAUNCHES, reset_launches
from tpu3d_torch.kernels.orient_desc import (atan2_poly, near_ties, orient_desc_samples,
                                             orient_desc_samples_plain, sample_tolerance)

THETA_TOL = 1e-5
SAMPLE_TOL = 1e-5


def _inputs(seed, L=3, H=160, W=200, K=64, border=False):
    """test_kernels.py:124-style inputs: smoothed noise levels, keypoints
    inside (or, with ``border``, near the bottom and right edges of) the
    image."""
    rng = np.random.default_rng(seed)
    img = gaussian_filter(rng.normal(0, 1, (L, H, W)), 2.0).astype(np.float32)
    gx = np.gradient(img, axis=2).astype(np.float32)
    gy = np.gradient(img, axis=1).astype(np.float32)
    if border:
        ky = rng.uniform(H - 12, H - 1, K).astype(np.float32)
        kx = rng.uniform(W - 12, W - 1, K).astype(np.float32)
    else:
        ky = rng.uniform(45, H - 45, K).astype(np.float32)
        kx = rng.uniform(45, W - 45, K).astype(np.float32)
    lvl = rng.integers(0, L, K).astype(np.int32)
    sigma = rng.uniform(1.6, 3.5, K).astype(np.float32)
    ymax = np.full(K, H - 1.001, np.float32)
    xmax = np.full(K, W - 1.001, np.float32)
    return gx, gy, ky, kx, lvl, sigma, ymax, xmax


def _pallas(args):
    out = JOD.orient_desc_samples(*(jnp.asarray(a) for a in args), interpret=True)
    return [np.asarray(o) for o in out]


def _port(args, fn=orient_desc_samples_plain):
    out = fn(*(torch.from_numpy(a) for a in args))
    return [o.numpy() for o in out]


def _dtheta(a, b):
    return np.abs(((a - b + np.pi) % (2 * np.pi)) - np.pi)


def _hold(args, got, ref):
    """theta and samples agree except at near-tie keypoints; returns the
    mask of keypoints that agree."""
    gxs, gys, th = got
    rgx, rgy, rth = ref
    ties = near_ties(*(torch.from_numpy(a) for a in args)).numpy()
    assert ties.mean() < 0.05, f"{ties.sum()} near ties of {len(ties)}"
    agree = _dtheta(th, rth) <= THETA_TOL
    assert np.all(agree | ties), np.nonzero(~(agree | ties))
    tol = sample_tolerance(torch.from_numpy(args[0]), torch.from_numpy(args[1]),
                           torch.from_numpy(args[5]), torch.from_numpy(_dtheta(th, rth)),
                           SAMPLE_TOL).numpy()
    assert np.all((np.abs(gxs - rgx) <= tol)[agree])
    assert np.all((np.abs(gys - rgy) <= tol)[agree])
    return agree


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_interpret_pallas(seed):
    args = _inputs(seed)
    _hold(args, _port(args), _pallas(args))


@pytest.mark.parametrize("H,W", [(157, 197), (157, 200)])
def test_border_keypoints_agree_with_pallas_window(H, W):
    """Keypoints within 12 px of the bottom and right edges, their samples
    clamped to the octave rectangle: the gather semantics (base clipped to
    the level) and the Pallas kernel's 96x256 window give the same samples.

    They agree wherever the window reaches past the image's last row, as
    here (tpu3d pads H to a multiple of 8). Where H is already a multiple
    of 8, the window's last row is the image's last one and the kernel's
    in-window clip to PATCH_Y - 2 (tpu3d/kernels/orient_desc.py:76) holds a
    sample at H - 1.001 on row H - 2 instead of interpolating towards row
    H - 1 (at 160x200: 6 of 64 border keypoints agree). The port follows
    the gather, tpu3d's reference path (features/descriptor.py::_bilinear),
    as patch_sample does."""
    args = _inputs(2, H=H, W=W, border=True)
    assert _hold(args, _port(args), _pallas(args)).all()


def test_wrapper_takes_the_plain_version_on_cpu():
    args = _inputs(3, K=16)
    reset_launches()
    got = _port(args, orient_desc_samples)
    for a, b in zip(got, _port(args)):
        np.testing.assert_array_equal(a, b)
    assert LAUNCHES["orient_desc_kernel"] == 0


def test_atan2_poly_matches_tpu3d():
    rng = np.random.default_rng(4)
    y = rng.normal(0, 1, 4096).astype(np.float32)
    x = rng.normal(0, 1, 4096).astype(np.float32)
    x[:16] = 0.0
    y[16:32] = 0.0
    got = atan2_poly(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    ref = np.asarray(JOD._atan2_poly(jnp.asarray(y), jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    # tpu3d's docstring says |err| < 1e-5 rad; these draws reach 1.17e-5
    assert np.abs(got - np.arctan2(y, x)).max() < 2e-5


def _grid():
    g = np.arange(16, dtype=np.float32) - 7.5
    dyg, dxg = np.meshgrid(g, g, indexing="ij")
    return dyg.reshape(-1), dxg.reshape(-1)


def test_descriptors_against_tpu3d_fused_and_split():
    """Binned descriptors: against tpu3d's fused path cosine > 0.9999 where
    theta agrees; against tpu3d's split path (exact atan2 and a two-pass
    smoothing), tpu3d's own criteria (test_kernels.py:124): theta within
    0.05 rad on >= 80% and cosine > 0.98 there."""
    args = _inputs(5)
    gx, gy, ky, kx, lvl, sigma, ymax, xmax = (torch.from_numpy(a) for a in args)
    desc, theta = TD.orient_and_describe(gx, gy, kx, ky, lvl, sigma, ymax, xmax, fused=True)
    desc, theta = desc.numpy(), theta.numpy()
    dyg, dxg = _grid()
    pgx, pgy, pth = _pallas(args)
    ref = np.asarray(JD.bin_descriptor(jnp.asarray(pgx), jnp.asarray(pgy), jnp.asarray(pth),
                                       jnp.asarray(dyg), jnp.asarray(dxg)))
    agree = _dtheta(theta, pth) <= THETA_TOL
    assert agree.mean() >= 0.95
    assert np.all(np.sum(desc * ref, -1)[agree] > 0.9999)

    j = [jnp.asarray(a) for a in args]
    th_split = JD.keypoint_orientations(j[0], j[1], j[3], j[2], j[4], j[5], j[6], j[7])
    d_split = np.asarray(JD.sift_descriptors(j[0], j[1], j[3], j[2], j[4], j[5], th_split,
                                             j[6], j[7]))
    close = _dtheta(theta, np.asarray(th_split)) < 0.05
    assert close.mean() >= 0.8
    assert np.all(np.sum(desc * d_split, -1)[close] > 0.98)


def _image(seed, H=160, W=192):
    rng = np.random.default_rng(seed)
    img = gaussian_filter(rng.uniform(0, 1, (2, H, W)), 1.5)
    img = (img - img.min()) / (img.max() - img.min())
    return (img * 255 + 0.5).astype(np.uint8)


def test_extract_features_fused_against_tpu3d(monkeypatch):
    """The whole frontend with fused_descriptor=True on a small synthetic
    batch, against tpu3d's extract_features with its fused Pallas kernel in
    interpret mode (tpu3d's orient_and_describe imports
    orient_desc_samples at call time, so the test swaps in the interpret
    variant; nothing in tpu3d changes). The pyramids differ by f32 rounding,
    which the subpixel solve turns into position differences of up to
    ~1e-3 px (test_torch_frontend.py); so: the same valid slots, positions
    within 1e-2 px, and 95% of the descriptors at cosine > 0.9999."""
    monkeypatch.setattr(JOD, "orient_desc_samples",
                        functools.partial(JOD.orient_desc_samples, interpret=True))
    imgs = _image(6)
    jcfg = JaxFrontendConfig(max_keypoints=128, fused_descriptor=True)
    ref = jax_extract_features(jnp.asarray(imgs), jcfg)
    reset_launches()
    got = extract_features(torch.from_numpy(imgs),
                           FrontendConfig(max_keypoints=128, fused_descriptor=True), device="cpu")
    assert LAUNCHES["orient_desc_kernel"] == 0
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_allclose(got.keypoints_px.numpy()[valid],
                               np.asarray(ref.keypoints_px)[valid], rtol=0, atol=1e-2)
    cos = np.sum(got.descriptors.numpy() * np.asarray(ref.descriptors), -1)[valid]
    assert np.mean(cos > 0.9999) >= 0.95, np.sort(cos)[:8]
