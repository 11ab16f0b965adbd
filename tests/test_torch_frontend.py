"""The port's classical frontend (tpu3d_torch/features) against tpu3d's, on
two 320x240 views of the synthetic scene with 512 keypoints and 3 octaves.

tpu3d runs on the CPU through its gather paths; the port through the plain
versions of its kernels. Tolerances are stated beside each check."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from chip_smoke import make_scene
from tpu3d.config import FrontendConfig as JaxFrontendConfig
from tpu3d.features import descriptor as jdesc
from tpu3d.features import detector as jdet
from tpu3d.features.frontend import extract_features as jax_extract
from tpu3d.features.pyramid import build_pyramid as jax_pyramid
from tpu3d_torch.config import FrontendConfig
from tpu3d_torch.features import descriptor as tdesc
from tpu3d_torch.features import detector as tdet
from tpu3d_torch.features.frontend import extract_features
from tpu3d_torch.features.pyramid import build_pyramid

K, OCTAVES = 512, 3


@pytest.fixture(scope="module")
def images():
    return make_scene(seed=3, n_views=2, width=320, height=240)["gray"]


@pytest.fixture(scope="module")
def jax_pyr(images):
    return jax_pyramid(jnp.asarray(images.astype(np.float32) / 255.0), OCTAVES, 3, 1.6)


def test_pyramid_levels(images, jax_pyr):
    """Same taps, same order of the shifted adds: levels within 1e-5."""
    gauss, dogs = build_pyramid(torch.from_numpy(images.astype(np.float32) / 255.0),
                                OCTAVES, 3, 1.6)
    for o in range(OCTAVES):
        np.testing.assert_allclose(gauss[o].numpy(), np.asarray(jax_pyr[0][o]), rtol=0, atol=1e-5)
        np.testing.assert_allclose(dogs[o].numpy(), np.asarray(jax_pyr[1][o]), rtol=0, atol=1e-5)


def _kth_score(scores, k):
    s = np.sort(scores)[::-1]
    return s[k - 1] if len(s) >= k else -np.inf


def test_detect_octave_on_the_same_dog(jax_pyr):
    """Keypoints of one octave from tpu3d's DoG: the same set, except slots
    whose score lies within 1e-6 of the K-th score (top-k ties); positions
    within 1e-4 px (the 3x3 solve is the same arithmetic); scores within
    1e-6."""
    dog = np.asarray(jax_pyr[1][0])
    a = jdet.detect_octave(jnp.asarray(dog), K, 0.015, 10.0, 2)
    b = tdet.detect_octave(torch.from_numpy(dog), K, 0.015, 10.0, 2)
    for i in range(dog.shape[0]):
        va, vb = np.asarray(a.valid[i]), b.valid[i].numpy()
        pa = np.stack([np.asarray(a.scale[i]), np.asarray(a.y[i]), np.asarray(a.x[i])], -1)[va]
        pb = np.stack([b.scale[i].numpy(), b.y[i].numpy(), b.x[i].numpy()], -1)[vb]
        sa, sb = np.asarray(a.score[i])[va], b.score[i].numpy()[vb]
        kth = _kth_score(sa, K)
        assert len(pa) > 100
        dist, j = cKDTree(pa).query(pb)
        far = dist > 1e-4
        assert np.all(np.abs(sb[far] - kth) < 1e-6), "unmatched keypoint away from the K-th score"
        np.testing.assert_allclose(sb[~far], sa[j[~far]], rtol=0, atol=1e-6)
        assert abs(len(pa) - len(pb)) <= int(np.sum(np.abs(sa - kth) < 1e-6))


def _descriptor_inputs(images, jax_pyr):
    """tpu3d's keypoints of octave 0 with their gradient stack."""
    gauss = np.asarray(jax_pyr[0][0])
    B, _, H, W = gauss.shape
    kp = jdet.detect_octave(jax_pyr[1][0], K, 0.015, 10.0, 2)
    lvl_l = np.clip(np.round(np.asarray(kp.scale)).astype(np.int32), 1, 3)
    lvl = ((np.arange(B)[:, None] * 3 + lvl_l - 1)).reshape(-1).astype(np.int32)
    keep = np.asarray(kp.valid).reshape(-1)
    g = jnp.asarray(gauss[:, 1:4].reshape(B * 3, H, W))
    gx, gy = (np.asarray(v) for v in jdesc.gradients(g))
    sig = (1.6 * 2.0 ** (np.asarray(kp.scale) / 3)).reshape(-1).astype(np.float32)
    n = int(keep.sum())
    return dict(gx=gx, gy=gy, kx=np.asarray(kp.x).reshape(-1)[keep],
                ky=np.asarray(kp.y).reshape(-1)[keep], lvl=lvl[keep], sigma=sig[keep],
                ymax=np.full(n, H - 1.001, np.float32), xmax=np.full(n, W - 1.001, np.float32))


def test_orientation_and_descriptors_on_the_same_inputs(images, jax_pyr):
    """Orientation (11x11 samples, 36-bin histogram, parabolic peak) within
    1e-4 rad, and descriptors within 1e-5: both packages sample exact f32
    bilinear values and bin them with the same one-hot sums."""
    x = _descriptor_inputs(images, jax_pyr)
    ja = {k: jnp.asarray(v) for k, v in x.items()}
    jd, jtheta = jdesc.orient_and_describe(ja["gx"], ja["gy"], ja["kx"], ja["ky"], ja["lvl"],
                                           ja["sigma"], ja["ymax"], ja["xmax"])
    ta = {k: torch.from_numpy(v) for k, v in x.items()}
    td, ttheta = tdesc.orient_and_describe(ta["gx"], ta["gy"], ta["kx"], ta["ky"], ta["lvl"],
                                           ta["sigma"], ta["ymax"], ta["xmax"])
    dtheta = np.angle(np.exp(1j * (ttheta.numpy() - np.asarray(jtheta))))
    assert np.abs(dtheta).max() < 1e-4
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-5)
    # The fused path (atan2_poly, one circulant smoothing) picks the same
    # peak on most keypoints: tpu3d's own fused-vs-split criteria
    # (test_kernels.py:124).
    fd, ftheta = tdesc.orient_and_describe(ta["gx"], ta["gy"], ta["kx"], ta["ky"], ta["lvl"],
                                           ta["sigma"], ta["ymax"], ta["xmax"], fused=True)
    close = np.abs(np.angle(np.exp(1j * (ftheta.numpy() - np.asarray(jtheta))))) < 0.05
    assert close.mean() >= 0.8
    assert np.all(np.sum(fd.numpy() * np.asarray(jd), -1)[close] > 0.98)


def test_extract_features_matches_tpu3d(images):
    """The whole frontend from uint8 images. The pyramids differ by f32
    rounding (~2e-7), which the subpixel solve turns into position
    differences of up to ~1e-3 px, and the gradients they are sampled from
    differ by the same rounding. So: the same number of keypoints per
    image; every keypoint has a counterpart within 1e-2 px, except slots
    within 1e-6 of the K-th score; scores within 1e-6; descriptors within
    1e-4 where the positions agree within 3e-5 px (most keypoints), and
    within 5e-4 for every counterpart."""
    jcfg = JaxFrontendConfig(max_keypoints=K, num_octaves=OCTAVES)
    a = jax_extract(jnp.asarray(images), jcfg)
    cfg = FrontendConfig(**dataclasses.asdict(jcfg))
    b = extract_features(torch.from_numpy(images), cfg, device="cpu")
    assert b.descriptors.shape == (2, K, 128) and b.keypoints.shape == (2, K, 2)
    np.testing.assert_array_equal(b.image_size.numpy(), np.asarray(a.image_size))
    for i in range(2):
        va, vb = np.asarray(a.valid[i]), b.valid[i].numpy()
        assert va.sum() > 200 and va.sum() == vb.sum()
        pa, pb = np.asarray(a.keypoints_px[i])[va], b.keypoints_px[i].numpy()[vb]
        sa, sb = np.asarray(a.scores[i])[va], b.scores[i].numpy()[vb]
        kth = _kth_score(sa, K)
        dist, j = cKDTree(pa).query(pb)
        far = dist > 1e-2
        assert np.all(np.abs(sb[far] - kth) < 1e-6)
        np.testing.assert_allclose(sb[~far], sa[j[~far]], rtol=0, atol=1e-6)
        da, db = np.asarray(a.descriptors[i])[va][j], b.descriptors[i].numpy()[vb]
        close = dist < 3e-5
        assert close.mean() > 0.5
        np.testing.assert_allclose(db[close], da[close], rtol=0, atol=1e-4)
        np.testing.assert_allclose(db[~far], da[~far], rtol=0, atol=5e-4)
        np.testing.assert_allclose(b.keypoints[i].numpy()[vb][~far],
                                   np.asarray(a.keypoints[i])[va][j[~far]], rtol=0, atol=1e-2)
