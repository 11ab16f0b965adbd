"""The public names tpu3d has and the port once lacked, each against tpu3d
on the CPU: se3_compose, camera_rays, load_image_batch, merge_debug_ply,
dense.grid.trilinear_sample, kernels.mutual_nn, IncrementalSfM.register_pair
(on tpu3d's tests/test_sfm_engine.py sequence with tpu3d's draws), and the
package re-exports of tpu3d's ``__init__`` files. Tolerances are stated
where they are asserted."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_sfm_engine import build_synthetic_sequence


def _t(a):
    return torch.from_numpy(np.array(a))


# tpu3d's __init__ exports, written out here (not read from tpu3d at run
# time); tpu3d.kernels' mutual_nn_pallas is the port's mutual_nn.
EXPORTS = {
    "core": ["so3_exp", "so3_log", "so3_hat", "se3_apply", "se3_compose", "se3_inverse",
             "intrinsics_matrix", "project", "project_extrinsic", "pixel_to_centered",
             "centered_to_pixel", "camera_rays", "camera_center"],
    "io": ["list_images", "load_images", "load_image_batch", "write_ply", "filter_point_cloud",
           "ArtifactStore"],
    "sfm": ["EdgeObservations", "ImageRegistration", "IncrementalSfM", "PairObservations",
            "Reconstruction"],
    "geometry": ["essential_eight_point", "sampson_error", "epipolar_residual", "ransac",
                 "decompose_essential", "recover_pose", "triangulate_dlt", "triangulate_midpoint",
                 "refine_triangulation_gn", "pnp_dlt", "pnp_ransac", "refine_pose",
                 "find_essential_ransac", "EssentialResult"],
    "kernels": ["descriptor_top2", "mutual_nn"],
}


@pytest.mark.parametrize("package", sorted(EXPORTS))
def test_package_exports(package):
    mod = importlib.import_module(f"tpu3d_torch.{package}")
    missing = [n for n in EXPORTS[package] if not hasattr(mod, n)]
    assert not missing, missing
    assert set(EXPORTS[package]) <= set(mod.__all__)


def _rotations(rng, n):
    from tpu3d.core import lie as jlie

    w = rng.normal(0, 0.8, (n, 3)).astype(np.float32)
    return np.asarray(jlie.so3_exp(jnp.asarray(w)))


def test_se3_compose_matches_tpu3d():
    """Products of rotations and translations: within 1e-6 (f32 sums of
    three products)."""
    from tpu3d.core import lie as jlie
    from tpu3d_torch.core import se3_compose

    rng = np.random.default_rng(0)
    R1, R2 = _rotations(rng, 16), _rotations(rng, 16)
    t1, t2 = (rng.normal(0, 2, (16, 3)).astype(np.float32) for _ in range(2))
    got = se3_compose(_t(R1), _t(t1), _t(R2), _t(t2))
    ref = jlie.se3_compose(*map(jnp.asarray, (R1, t1, R2, t2)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-6)


def test_camera_rays_matches_tpu3d():
    """Origins and unit directions within 1e-6 (a normalized f32 product)."""
    from tpu3d.core import camera as jcam
    from tpu3d_torch.core import camera_rays

    rng = np.random.default_rng(1)
    R = _rotations(rng, 4)
    t = rng.normal(0, 1, (4, 3)).astype(np.float32)
    uv = rng.uniform(-400, 400, (4, 50, 2)).astype(np.float32)
    got = camera_rays(_t(R), _t(t), _t(uv), 800.0)
    ref = jcam.camera_rays(jnp.asarray(R), jnp.asarray(t), jnp.asarray(uv), 800.0)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-6)


@pytest.mark.parametrize("downscale", [1, 2])
def test_load_image_batch_matches_tpu3d(tmp_path, downscale):
    """Equal arrays and names on PNG files written here, batch by batch and
    past the end."""
    from tpu3d.io.images import load_image_batch as jax_load_image_batch
    from tpu3d_torch.io import list_images, load_image_batch

    rng = np.random.default_rng(2)
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (40, 60, 3), dtype=np.uint8)).save(
            tmp_path / f"{i:02d}.png")
    names = list_images(str(tmp_path))
    assert len(names) == 5
    for start in (0, 2, 4, 6):
        got = load_image_batch(str(tmp_path), names, start, 2, downscale)
        ref = jax_load_image_batch(str(tmp_path), names, start, 2, downscale)
        assert got[2] == ref[2]
        if not ref[2]:
            assert got[0] is None and got[1] is None
            continue
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])


@pytest.mark.parametrize("colors", [None, [(1, 2, 3), (4, 5, 6), (7, 8, 9)]])
def test_merge_debug_ply_matches_tpu3d(tmp_path, colors):
    """The same vertex count and a byte-equal file, an empty cloud skipped."""
    from tpu3d.io.ply import merge_debug_ply as jax_merge
    from tpu3d_torch.io.ply import merge_debug_ply

    rng = np.random.default_rng(3)
    clouds = [rng.normal(0, 1, (30, 3)), np.zeros((0, 3)), rng.normal(5, 1, (12, 3))]
    a, b = tmp_path / "port.ply", tmp_path / "tpu3d.ply"
    n = merge_debug_ply(str(a), clouds, colors, scale=2.0)
    assert n == jax_merge(str(b), clouds, colors, scale=2.0) == 42
    assert a.read_bytes() == b.read_bytes()
    assert merge_debug_ply(str(a), [np.zeros((0, 3))]) == 0


def test_trilinear_sample_matches_tpu3d():
    """dense.grid.trilinear_sample (the plain version on the CPU) against
    tpu3d's gather path, points inside, on and outside the box: values
    within 1e-6, the in-bounds mask equal."""
    from tpu3d.dense.grid import trilinear_sample as jax_trilinear
    from tpu3d_torch.dense.grid import trilinear_sample

    rng = np.random.default_rng(4)
    grid = rng.normal(0, 1, (9, 7, 5, 28)).astype(np.float32)
    lo = np.array([-1.0, -0.5, 0.0], np.float32)
    hi = np.array([1.0, 0.5, 2.0], np.float32)
    pts = rng.uniform(-1.3, 2.3, (500, 3)).astype(np.float32)
    pts[:8] = [lo, hi, [lo[0], hi[1], lo[2]], [0, 0, 1], hi + 1e-3, lo - 1e-3,
               [1.0, 0.0, 0.5], [0.3, -0.5, 2.0]]
    vals, inb = trilinear_sample(*(_t(a) for a in (grid, lo, hi, pts)))
    rv, rin = jax_trilinear(*map(jnp.asarray, (grid, lo, hi, pts)))
    np.testing.assert_array_equal(inb.numpy(), np.asarray(rin))
    assert 0 < inb.sum() < len(pts)
    np.testing.assert_allclose(vals.numpy(), np.asarray(rv), rtol=0, atol=1e-6)


def test_mutual_nn_matches_tpu3d():
    """kernels.mutual_nn against tpu3d's mutual_nn_pallas in interpret mode
    on two descriptor sets with invalid slots (tpu3d's kernel takes counts
    in multiples of 256): the same matches (indices and validity), scores
    within 1e-6 where valid."""
    from tpu3d.kernels.distance import mutual_nn_pallas
    from tpu3d_torch.kernels import mutual_nn

    rng = np.random.default_rng(5)
    d0 = rng.normal(0, 1, (512, 128)).astype(np.float32)
    d1 = np.concatenate([d0[:200] + rng.normal(0, 0.3, (200, 128)),
                         rng.normal(0, 1, (56, 128))]).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    v0 = (rng.uniform(size=512) > 0.1).astype(np.float32)
    v1 = (rng.uniform(size=256) > 0.1).astype(np.float32)
    got = mutual_nn(*(_t(a) for a in (d0, d1, v0, v1)), ratio=0.9)
    ref = mutual_nn_pallas(*map(jnp.asarray, (d0, d1, v0, v1)), ratio=0.9, interpret=True)
    valid = np.asarray(ref.valid)
    assert 50 < valid.sum()
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.idx0.numpy(), np.asarray(ref.idx0))
    np.testing.assert_array_equal(got.idx1.numpy()[valid], np.asarray(ref.idx1)[valid])
    np.testing.assert_allclose(got.score.numpy()[valid], np.asarray(ref.score)[valid],
                               rtol=0, atol=1e-6)


def _inject_tpu3d_draws(monkeypatch, engine_mod, num_hypotheses):
    """The port's engine draws from tpu3d's engine key (PRNGKey(0)), split
    once per draw as tpu3d's _next_key: the bootstrap's E-RANSAC (main and
    LO rounds, (M, EDGE_CAP)) and each registration's PnP ((M / 2,
    PNP_CAP), the first n columns)."""
    from tpu3d_torch.geometry.estimators import lo_hypotheses

    key = [jax.random.PRNGKey(0)]

    def split():
        key[0], sub = jax.random.split(key[0])
        return sub

    def gumbel(k, shape, n=None):
        g = np.asarray(jax.random.gumbel(k, shape))
        return _t(g if n is None else g[:, :n])

    def pnp(self, n):
        return gumbel(split(), (num_hypotheses // 2, engine_mod.PNP_CAP), n)

    def essential(self):
        k0, k1 = jax.random.split(split())
        return (gumbel(k0, (num_hypotheses, engine_mod.EDGE_CAP)),
                gumbel(k1, (lo_hypotheses(num_hypotheses), engine_mod.EDGE_CAP)))

    monkeypatch.setattr(engine_mod.IncrementalSfM, "_pnp_draws", pnp)
    monkeypatch.setattr(engine_mod.IncrementalSfM, "_essential_draws", essential)


def test_register_pair_on_tpu3d_sequence(monkeypatch):
    """tpu3d's tests/test_sfm_engine.py:74-122 sequence (five cameras on an
    arc, the pairs without a relative pose, so the first is bootstrapped by
    E-RANSAC) through each engine's register_pair with tpu3d's draws: the
    same status per pair, the same registered set and point count; camera
    centres after finalize within 1e-3 of the scene's extent (a chain of
    f32 solves from the same inputs)."""
    from tpu3d.config import CameraConfig as JCameraConfig
    from tpu3d.config import RansacConfig as JRansacConfig
    from tpu3d.config import SfMConfig as JSfMConfig
    from tpu3d.sfm import IncrementalSfM as JaxIncrementalSfM
    from tpu3d_torch.config import CameraConfig, RansacConfig, SfMConfig
    from tpu3d_torch.sfm import IncrementalSfM, PairObservations
    from tpu3d_torch.sfm import engine as TE

    _, cams_gt, jpairs, focal = build_synthetic_sequence(np.random.default_rng(42))
    kw = dict(max_tracks=5000, global_ba_every=3)
    jeng = JaxIncrementalSfM(5, JSfMConfig(camera=JCameraConfig(focal_length=focal),
                                           ransac=JRansacConfig(num_hypotheses=256), **kw))
    _inject_tpu3d_draws(monkeypatch, TE, 256)
    teng = IncrementalSfM(5, SfMConfig(camera=CameraConfig(focal_length=focal),
                                       ransac=RansacConfig(num_hypotheses=256), **kw),
                          device="cpu")
    for jp in jpairs:
        tp = PairObservations(**{k: getattr(jp, k) for k in jp.__dataclass_fields__})
        a, b = jeng.register_pair(jp), teng.register_pair(tp)
        assert a["status"] == b["status"] == "registered", (a, b)
    names = [f"img{i}" for i in range(5)]
    ref, got = jeng.finalize(names), teng.finalize(names)
    np.testing.assert_array_equal(got.registered, ref.registered)
    assert len(got.points) == len(ref.points) > 400
    from tpu3d_torch.core.lie import so3_exp_np

    def centers(cams):
        return np.stack([-so3_exp_np(c[:3]).T @ c[3:6] for c in np.asarray(cams, np.float64)])

    extent = np.ptp(centers(cams_gt), axis=0).max()
    assert np.abs(centers(got.cams) - centers(ref.cams)).max() <= 1e-3 * extent
