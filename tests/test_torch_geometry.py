"""The port's small building blocks against tpu3d, one function at a time:
camera coordinates, the blur taps, the 8-point solver, the essential
projection, the epipolar residuals, midpoint triangulation and the four-way
decomposition of E. The gate tests (test_torch_matching.py) reach these
only through RANSAC; here each is held to tpu3d on the same inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_geometry import make_pair
from tpu3d.core import camera as jcam
from tpu3d.features import pyramid as jpyr
from tpu3d.geometry import epipolar as jepi
from tpu3d.geometry import pose as jpose
from tpu3d.geometry import triangulate as jtri
from tpu3d_torch.core import camera as tcam
from tpu3d_torch.features import pyramid as tpyr
from tpu3d_torch.geometry import epipolar as tepi
from tpu3d_torch.geometry import pose as tpose
from tpu3d_torch.geometry import triangulate as ttri


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _normalized_pair(seed, n):
    X, R, tt, uv0, uv1, focal = make_pair(np.random.default_rng(seed), n=n, noise=0.3)
    return R, tt, uv0 / focal, uv1 / focal


def _same_up_to_sign(a, b, atol):
    a, b = np.asarray(a), np.asarray(b)
    assert min(np.abs(a - b).max(), np.abs(a + b).max()) < atol


def test_camera_coordinates(rng):
    """pixel_to_centered and centered_to_pixel within 1e-5 px of tpu3d's,
    with a per-image size broadcast over keypoints; the round trip is the
    identity."""
    xy = rng.uniform(0, 968, (3, 50, 2)).astype(np.float32)
    size = np.array([[968.0, 648.0], [320.0, 240.0], [1937.0, 1295.0]], np.float32)[:, None, :]
    uv = tcam.pixel_to_centered(t(xy), t(size))
    np.testing.assert_allclose(uv.numpy(), np.asarray(jcam.pixel_to_centered(
        jnp.asarray(xy), jnp.asarray(size))), rtol=0, atol=1e-5)
    back = tcam.centered_to_pixel(uv, t(size))
    np.testing.assert_allclose(back.numpy(), np.asarray(jcam.centered_to_pixel(
        jnp.asarray(uv.numpy()), jnp.asarray(size))), rtol=0, atol=1e-5)
    np.testing.assert_allclose(back.numpy(), xy, rtol=0, atol=1e-4)


@pytest.mark.parametrize("sigma", [0.8, 1.226, 1.6, 2.5])
def test_gaussian_taps(sigma):
    """The device taps and the host taps blur() uses agree with tpu3d's
    within 1e-7."""
    ref = np.asarray(jpyr.gaussian_kernel1d(sigma))
    np.testing.assert_allclose(tpyr.gaussian_kernel1d(sigma).numpy(), ref, rtol=0, atol=1e-7)
    np.testing.assert_allclose(tpyr._host_kernel1d(sigma), jpyr._host_kernel1d(sigma),
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("n", [8, 60])
def test_eight_point(n):
    """The minimal (MGS null vector) and the overdetermined (eigh) path,
    batched over 4 draws with a 0/1 mask: F before the projection within
    1e-4 up to sign (an eigenvector's sign is free), and E after it."""
    draws = [_normalized_pair(seed, n) for seed in range(4)]
    x0 = np.stack([d[2] for d in draws]).astype(np.float32)
    x1 = np.stack([d[3] for d in draws]).astype(np.float32)
    w = np.ones((4, n), np.float32)
    if n > 8:
        w[:, -5:] = 0.0
    for project in (False, True):
        got = tepi.essential_eight_point(t(x0), t(x1), t(w), project=project).numpy()
        ref = np.asarray(jepi.essential_eight_point(jnp.asarray(x0), jnp.asarray(x1),
                                                    jnp.asarray(w), project=project))
        for b in range(4):
            _same_up_to_sign(got[b] / np.abs(got[b]).max(), ref[b] / np.abs(ref[b]).max(), 1e-4)


def test_essential_projection_and_residuals(rng):
    """project_to_essential within 1e-5 (u_i v_iᵀ of the two kept singular
    pairs does not depend on the SVD's signs); the algebraic residual and
    the Sampson error within 1e-6, for one E per point set and for a block
    of hypotheses against one point set."""
    F = rng.normal(0, 1, (5, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(tepi.project_to_essential(t(F)).numpy(),
                               np.asarray(jepi.project_to_essential(jnp.asarray(F))),
                               rtol=0, atol=1e-5)
    _, _, x0, x1 = _normalized_pair(7, 200)
    E = np.asarray(jepi.project_to_essential(jnp.asarray(F))).astype(np.float32)
    x0, x1 = x0.astype(np.float32), x1.astype(np.float32)
    for fn in ("epipolar_residual", "sampson_error"):
        got = getattr(tepi, fn)(t(E), t(np.broadcast_to(x0, (5, 200, 2))),
                                t(np.broadcast_to(x1, (5, 200, 2)))).numpy()
        ref = np.asarray(getattr(jepi, fn)(jnp.asarray(E), jnp.asarray(x0), jnp.asarray(x1)))
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    hyp = tepi.sampson_error(t(E), t(x0), t(x1)).numpy()   # (5, 200)
    np.testing.assert_allclose(hyp, np.asarray(jepi.sampson_error(
        jnp.asarray(E), jnp.asarray(x0), jnp.asarray(x1))), rtol=1e-5, atol=1e-6)


def test_triangulate_midpoint():
    """World points within 1e-4 of tpu3d's, and of the truth on clean
    correspondences."""
    X, R, tt, uv0, uv1, focal = make_pair(np.random.default_rng(3), n=100)
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    args = (eye, zero, R.astype(np.float32), tt.astype(np.float32), uv0 / focal, uv1 / focal)
    got = ttri.triangulate_midpoint(*map(t, args)).numpy()
    ref = np.asarray(jtri.triangulate_midpoint(*map(jnp.asarray, args)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, X, rtol=0, atol=1e-3)


def test_decompose_essential():
    """The four (R, t) candidates of E = [t]x R: the same set as tpu3d's
    within 1e-5 (their order follows the SVD's free signs), each R a proper
    rotation, and the true pose among them."""
    _, R, tt, _, _, _ = make_pair(np.random.default_rng(5), n=10)
    tx = np.array([[0, -tt[2], tt[1]], [tt[2], 0, -tt[0]], [-tt[1], tt[0], 0]])
    E = (tx @ R).astype(np.float32)
    Rs, ts = (x.numpy() for x in tpose.decompose_essential(t(E)))
    jRs, jts = (np.asarray(x) for x in jpose.decompose_essential(jnp.asarray(E)))

    def flat(Rs_, ts_):
        return [np.concatenate([r.ravel(), v]) for r, v in zip(Rs_, ts_)]

    for cand in flat(jRs, jts):
        assert min(np.abs(cand - c).max() for c in flat(Rs, ts)) < 1e-5
    for r in Rs:
        np.testing.assert_allclose(r @ r.T, np.eye(3), rtol=0, atol=1e-5)
        assert np.linalg.det(r) > 0
    assert min(np.abs(r - R).max() + np.abs(v - tt).max() for r, v in zip(Rs, ts)) < 1e-4
