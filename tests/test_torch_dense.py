"""The port's dense render/eval path (tpu3d_torch/dense, kernels/trilinear,
cli) against tpu3d's, on the CPU.

On the CPU the trilinear wrapper runs its plain PyTorch version; it is
compared here with tpu3d's gather (dense/grid.py::trilinear_sample) and with
its Pallas kernel in interpret mode. The CUDA kernel itself is compared with
the plain version by tests/test_torch_gpu.py and chip_smoke.py.

Run as a script, it scores chip_smoke.py's full-size dense artifacts with
tpu3d's evaluate_views on the CPU and prints what
chip_smoke.TPU3D_CPU_DENSE_PSNR records:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_dense.py
"""
import json
import os
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
import tpu3d.dense.eval as JE
import tpu3d.dense.train as JT
import tpu3d_torch.dense.eval as TE
import tpu3d_torch.dense.train as TT
from tpu3d.config import DenseConfig as JaxDenseConfig
from tpu3d.dense.contract import contract as jax_contract
from tpu3d.dense.grid import VoxelGrid as JaxGrid
from tpu3d.dense.grid import eval_sh as jax_eval_sh
from tpu3d.dense.grid import query as jax_query
from tpu3d.dense.grid import trilinear_sample as jax_trilinear
from tpu3d.dense.render import composite as jax_composite
from tpu3d.dense.render import composite_weights as jax_composite_weights
from tpu3d.dense.render import render_image as jax_render_image
from tpu3d.dense.sdf import ray_aabb as jax_ray_aabb
from tpu3d.dense.sdf import sample_stratified as jax_sample_stratified
from tpu3d.io.artifacts import ArtifactStore as JaxStore
from tpu3d.kernels.trilinear import pack_grid, sample_packed
from tpu3d_torch.cli import densify, densify_eval_only, densify_from_rays, main, render_artifacts
from tpu3d_torch.core import lie
from tpu3d_torch.dense import grid as TG
from tpu3d_torch.dense.contract import contract
from tpu3d_torch.dense.render import composite, composite_weights, render_image
from tpu3d_torch.dense.sdf import ray_aabb, sample_stratified
from tpu3d_torch.io.artifacts import ArtifactStore
from tpu3d_torch.kernels import LAUNCHES
from tpu3d_torch.kernels.trilinear import index32, trilinear_sample, vector_width

N_VIEWS, W, H, RES = 8, 96, 64, 32


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _grid_and_points(rng, shape=(16, 24, 32, 28), n=300):
    """tests/test_trilinear_kernel.py's case: a random grid over an
    asymmetric box and points inside, outside and on its corners."""
    grid = rng.normal(0, 1, shape).astype(np.float32)
    lo = np.array([-1.0, -2.0, 0.5], np.float32)
    hi = np.array([1.0, 0.0, 2.5], np.float32)
    pts = np.concatenate([rng.uniform(-1.1, 1.1, (n - 4, 1)), rng.uniform(-2.1, 0.1, (n - 4, 1)),
                          rng.uniform(0.4, 2.6, (n - 4, 1))], axis=1).astype(np.float32)
    corners = np.array([[-1, -2, 0.5], [1, 0, 2.5], [-1, 0, 2.5], [0, -1, 1.5]], np.float32)
    return grid, lo, hi, np.concatenate([pts, corners])


def test_trilinear_plain_matches_tpu3d(rng):
    """The plain version against tpu3d's gather and its Pallas kernel in
    interpret mode: in-bounds flags identical, values within 1e-5 (the
    Pallas kernel sums in another order; tests/test_trilinear_kernel.py
    holds tpu3d's two versions to the same)."""
    grid, lo, hi, pts = _grid_and_points(rng)
    X, Y, Z, C = grid.shape
    before = LAUNCHES["trilinear_kernel"]
    got, got_in = trilinear_sample(t(grid), t(lo), t(hi), t(pts))
    assert LAUNCHES["trilinear_kernel"] == before   # a CPU tensor: plain version
    plain, plain_in = TG.trilinear_sample(t(grid), t(lo), t(hi), t(pts))
    assert torch.equal(got, plain) and torch.equal(got_in, plain_in)
    assert got.shape == (len(pts), C) and got_in.dtype == torch.bool
    ref, ref_in = jax_trilinear(jnp.asarray(grid), jnp.asarray(lo), jnp.asarray(hi),
                                jnp.asarray(pts))
    pal, pal_in = sample_packed(pack_grid(jnp.asarray(grid)), jnp.asarray(lo),
                                jnp.asarray(hi), (X, Y, Z), jnp.asarray(pts), interpret=True)
    for vals, inb in ((ref, ref_in), (np.asarray(pal)[:, :C], pal_in)):
        np.testing.assert_array_equal(got_in.numpy(), np.asarray(inb))
        np.testing.assert_allclose(got.numpy(), np.asarray(vals), rtol=1e-5, atol=1e-5)
    assert 0 < int(got_in.sum()) < len(pts)
    assert float(got[~got_in].abs().max()) == 0.0


def test_grid_from_tpu3d_roundtrips_packed_layout(rng):
    """tpu3d's packed (X, Y, Z/8+1, 2, 128) grid and its plain (X, Y, Z, 28)
    grid both carry over exactly, with the bounds and the background SH."""
    grid = rng.normal(0, 1, (8, 12, 16, 28)).astype(np.float32)
    lo, hi = np.float32([-1, -2, 0]), np.float32([1, 0, 3])
    bg = rng.normal(0, 1, (3, 9)).astype(np.float32)
    packed = np.asarray(pack_grid(jnp.asarray(grid)))
    assert packed.shape == (8, 12, 3, 2, 128)
    for arr, extra in ((packed, {"bg_sh": bg}), (grid, {})):
        vg, bg_sh = TG.grid_from_tpu3d(dict(grid=arr, min_bound=lo, max_bound=hi, **extra), "cpu")
        np.testing.assert_array_equal(vg.grid.numpy(), grid)
        assert vg.grid.is_contiguous() and vg.resolution == (8, 12, 16)
        np.testing.assert_array_equal(vg.min_bound.numpy(), lo)
        np.testing.assert_array_equal(vg.max_bound.numpy(), hi)
        assert (bg_sh is None) == (not extra)
        if extra:
            np.testing.assert_array_equal(bg_sh.numpy(), bg)
    with pytest.raises(ValueError, match="packed"):
        TG.grid_from_tpu3d(dict(grid=grid[0], min_bound=lo, max_bound=hi), "cpu")


def test_mesh_grid_dc_only_channels(rng):
    """The mesh_grid fallback puts density and the three SH DC terms where
    tpu3d's cmd_render does (channels 0, 1, 10, 19), the rest zero."""
    m = rng.normal(0, 1, (4, 5, 8, 4)).astype(np.float16)
    vg = TG.grid_from_mesh_grid(dict(grid=m, min_bound=np.zeros(3), max_bound=np.ones(3)), "cpu")
    g = vg.grid.numpy()
    assert g.shape == (4, 5, 8, 28) and g.dtype == np.float32
    for src, dst in [(0, 0), (1, 1), (2, 10), (3, 19)]:
        np.testing.assert_array_equal(g[..., dst], m[..., src].astype(np.float32))
    assert np.count_nonzero(np.delete(g, [0, 1, 10, 19], axis=-1)) == 0


# --------------------------------------------------------------------------
# Small functions, each against tpu3d's: within 1e-6, indices exactly.


def _cams(rng, n):
    cams = np.zeros((n, 6), np.float32)
    cams[:, :3] = rng.normal(0, 0.3, (n, 3))
    cams[:, 3:] = rng.normal(0, 1, (n, 3)) + np.float32([0, 0, 4])
    return cams


def _case_eval_sh(rng):
    k = rng.normal(0, 1, (50, 3, 9)).astype(np.float32)
    d = rng.normal(0, 1, (50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return TG.eval_sh(t(k), t(d)), jax_eval_sh(jnp.asarray(k), jnp.asarray(d))


def _case_composite(rng):
    sigma = rng.uniform(0, 5, (20, 16)).astype(np.float32)
    rgb = rng.uniform(0, 1, (20, 16, 3)).astype(np.float32)
    z = np.sort(rng.uniform(0.5, 3, (20, 16)), axis=1).astype(np.float32)
    bg = rng.uniform(0, 1, (20, 3)).astype(np.float32)
    return ([composite(t(sigma), t(rgb), t(z)), composite(t(sigma), t(rgb), t(z), bg=t(bg)),
             composite(t(sigma), t(rgb), t(z), white_bg=False)],
            [jax_composite(*map(jnp.asarray, (sigma, rgb, z))),
             jax_composite(*map(jnp.asarray, (sigma, rgb, z)), bg=jnp.asarray(bg)),
             jax_composite(*map(jnp.asarray, (sigma, rgb, z)), white_bg=False)])


def _case_ray_aabb(rng):
    o = rng.normal(0, 2, (64, 3)).astype(np.float32)
    d = rng.normal(0, 1, (64, 3)).astype(np.float32)
    d[:4, 0] = 0.0                                   # axis-parallel rays
    lo, hi = np.float32([-1, -0.5, -1]), np.float32([1, 0.5, 2])
    return ray_aabb(t(o), t(d), t(lo), t(hi)), jax_ray_aabb(*map(jnp.asarray, (o, d, lo, hi)))


def _case_sample_stratified(rng):
    tn = rng.uniform(0.1, 1, 30).astype(np.float32)
    tf = tn + rng.uniform(0.5, 4, 30).astype(np.float32)
    return ([sample_stratified(t(tn), t(tf), n) for n in (192, 144, 7)],
            [jax_sample_stratified(None, jnp.asarray(tn), jnp.asarray(tf), n, perturb=False)
             for n in (192, 144, 7)])


def _case_composite_weights(rng):
    sigma = rng.uniform(0, 5, (20, 16)).astype(np.float32)
    z = np.sort(rng.uniform(0.5, 3, (20, 16)), axis=1).astype(np.float32)
    return composite_weights(t(sigma), t(z)), jax_composite_weights(jnp.asarray(sigma),
                                                                    jnp.asarray(z))


def _case_query(rng):
    grid, lo, hi, pts = _grid_and_points(rng, (8, 10, 12, 28), 120)
    d = rng.normal(0, 1, (len(pts), 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    vg = TG.create_grid((8, 10, 12), lo, hi)
    assert torch.equal(vg.grid, torch.full((8, 10, 12, 28), 0.01))
    vg = vg._replace(grid=t(grid))
    return TG.query(vg, t(pts), t(d)), jax_query(
        JaxGrid(jnp.asarray(grid), jnp.asarray(lo), jnp.asarray(hi)), jnp.asarray(pts),
        jnp.asarray(d))


def _case_contract(rng):
    p = (rng.normal(0, 1, (200, 3)) * rng.uniform(0.01, 30, (200, 1))).astype(np.float32)
    return contract(t(p)), jax_contract(jnp.asarray(p))


def _case_view_rays(rng):
    cam = _cams(rng, 1)[0]
    norm = TT.SceneNormalization(np.float32([0.1, -0.2, 0.3]), 2.5)
    jnorm = JT.SceneNormalization(norm.center, norm.scale)
    return ([*TE.view_rays(cam, 30, 44, 50.0, norm, 2), *TE.view_rays(cam, 30, 44, 50.0)],
            [*JE.view_rays(cam, 30, 44, 50.0, jnorm, 2), *JE.view_rays(cam, 30, 44, 50.0)])


def _case_rays_from_cameras(rng):
    cams = _cams(rng, 3)
    imgs = rng.integers(0, 256, (3, 20, 28, 3)).astype(np.uint8)
    norm = TT.SceneNormalization(np.float32([0.5, 0, -1]), 3.0)
    got = TT.rays_from_cameras(cams, imgs, 40.0, norm, stride=3)
    ref = JT.rays_from_cameras(cams, imgs, 40.0, JT.SceneNormalization(norm.center, norm.scale), 3)
    got2 = TE.dataset_from_views(cams, imgs, 40.0, np.array([2, 0]))
    ref2 = JE.dataset_from_views(cams, imgs, 40.0, np.array([2, 0]))
    return list(got) + list(got2), list(ref) + list(ref2)


def _points(rng):
    p = rng.normal(0, 1, (500, 3)) * np.float64([3, 1, 2]) + np.float64([5, -2, 1])
    p[:10] *= 200.0                                  # far outliers
    return p.astype(np.float32)


def _case_auto_near_far(rng):
    pts, cams = _points(rng), _cams(rng, 70)
    norm = TT.normalize_scene_coremax(pts)
    jnorm = JT.SceneNormalization(norm.center, norm.scale)
    return (TT.auto_near_far(cams, pts, norm), TT.auto_near_far(cams, pts)), \
        (JT.auto_near_far(cams, pts, jnorm), JT.auto_near_far(cams, pts))


def _case_normalizations(rng):
    pts = _points(rng)
    names = ("normalize_scene", "normalize_scene_coremax", "normalize_scene_legacy",
             "normalize_scene_contracted")
    got = [getattr(TT, n)(pts) for n in names]
    ref = [getattr(JT, n)(pts) for n in names]
    return ([x for n in got for x in (n.center, n.scale)] + [TT.core_points(pts)],
            [x for n in ref for x in (n.center, n.scale)] + [JT.core_points(pts)])


def _case_split_views(rng):
    names = [f"IMG_{k:04d}.JPG" for k in rng.choice(300, 40, replace=False)]
    cases = [(names, 8), (names, 5), (["a", "b", "c", "d", "e"], 2), (names[:3], 0),
             ([f"v{k}" for k in range(16)], 4)]
    return ([TE.split_views_by_name(n, k) for n, k in cases] + [TE.split_views(19, 8)],
            [JE.split_views_by_name(n, k) for n, k in cases] + [JE.split_views(19, 8)])


def _case_interpolate_poses(rng):
    cams = _cams(rng, 5)
    return [TE.interpolate_poses(cams, 9), TE.interpolate_poses(cams[:1], 3)], \
        [JE.interpolate_poses(cams, 9), JE.interpolate_poses(cams[:1], 3)]


def _case_psnr_and_exposure(rng):
    a = rng.uniform(0, 1, (10, 12, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (10, 12, 3)).astype(np.float32)
    return [TT.psnr(a, b), TE.fit_view_exposure(a, b)], [JT.psnr(a, b), JE.fit_view_exposure(a, b)]


def _case_lie(rng):
    ws = [rng.normal(0, 1, 3), np.zeros(3), np.float64([np.pi - 1e-3, 0, 0]), [1e-9, 0, 0]]
    from tpu3d.core import lie as jlie
    return ([lie.so3_exp_np(w) for w in ws] + [lie.so3_log_np(lie.so3_exp_np(w)) for w in ws],
            [jlie.so3_exp_np(w) for w in ws] + [jlie.so3_log_np(jlie.so3_exp_np(w)) for w in ws])


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in _flat(v)]
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)]


@pytest.mark.parametrize("case", [
    _case_eval_sh, _case_composite, _case_composite_weights, _case_query, _case_ray_aabb,
    _case_sample_stratified, _case_contract,
    _case_view_rays, _case_rays_from_cameras, _case_auto_near_far, _case_normalizations,
    _case_split_views, _case_interpolate_poses, _case_psnr_and_exposure, _case_lie,
], ids=lambda f: f.__name__[6:])
def test_small_functions_match_tpu3d(rng, case):
    got, ref = case(rng)
    got, ref = _flat(got), _flat(ref)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        if g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# render_image against both of tpu3d's routes.


def _sphere_grid(res, lo, hi, rng, radius=0.5):
    coords = np.stack(np.meshgrid(*[np.linspace(a, b, res) for a, b in zip(lo, hi)],
                                  indexing="ij"), -1)
    inside = (np.linalg.norm(coords, axis=-1) < radius).astype(np.float32)
    g = rng.normal(0, 0.3, (res, res, res, 28)).astype(np.float32)
    g[..., 0] = inside * 30.0 + g[..., 0]
    g[..., 1] += inside / 0.282095
    return g


@pytest.mark.parametrize("case", ["plain", "clip_aabb", "bg_sh", "contract", "cascade"])
def test_render_image_matches_tpu3d(rng, case):
    """The port's one forward route against tpu3d's XLA gather route and its
    Pallas route (interpret mode), within 1e-5, with each option of the
    eval path: per-ray box clipping, the learned SH background, the
    contraction warp, and the cascade's base grid under a detail grid."""
    lo, hi = np.float32([-1, -1, -1]), np.float32([1, 1, 1])
    g = _sphere_grid(24, lo, hi, rng)
    n = 48
    o = rng.normal(0, 1, (n, 3)).astype(np.float32)
    o = 2.5 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o + rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    kw, jkw, near, far = {}, {}, 0.5, 4.5
    vg = TG.VoxelGrid(t(g), t(lo), t(hi))
    jvg = JaxGrid(jnp.asarray(g), jnp.asarray(lo), jnp.asarray(hi))
    if case == "clip_aabb":
        kw = jkw = dict(clip_aabb=True)
    elif case == "bg_sh":
        bg = rng.normal(0, 1, (3, 9)).astype(np.float32)
        kw, jkw = dict(bg_sh=t(bg), clip_aabb=True), dict(bg_sh=jnp.asarray(bg), clip_aabb=True)
    elif case == "contract":
        kw = jkw = dict(contract=True)
        vg = TG.VoxelGrid(t(g), t(2 * lo), t(2 * hi))
        jvg = JaxGrid(jnp.asarray(g), jnp.asarray(2 * lo), jnp.asarray(2 * hi))
        near, far = 0.5, 3.0
    elif case == "cascade":
        dlo, dhi = np.float32([-0.6, -0.5, -0.4]), np.float32([0.5, 0.6, 0.5])
        dg = rng.normal(0, 0.5, (16, 16, 16, 28)).astype(np.float32)
        base = vg
        vg = TG.VoxelGrid(t(dg), t(dlo), t(dhi))
        kw = dict(base_grid=base, clip_aabb=True)
        jkw = dict(base_grid=jvg, clip_aabb=True)
        jvg = JaxGrid(jnp.asarray(dg), jnp.asarray(dlo), jnp.asarray(dhi))
    got = render_image(vg, t(o), t(d), near, far, 40, chunk=32, **kw).numpy()
    assert got.shape == (n, 3) and np.isfinite(got).all()
    key = jax.random.PRNGKey(0)
    for use_pallas in (False, True):
        ref = np.asarray(jax_render_image(jvg, key, jnp.asarray(o), jnp.asarray(d), near, far,
                                          40, chunk=32, use_pallas=use_pallas, **jkw))
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert got.std() > 0.05                     # the sphere is in view


def test_occupancy_pruned_render_is_not_ported(rng):
    """Occupancy-pruned rendering, refused before the port had
    dense/occupancy.py, now renders as tpu3d's render_image(occ_prune=True)
    (XLA route) does, within 1e-5, for rays with an unclipped band: a band
    that ends outside the box keeps its first and last probes and its last
    depths off the box's faces, where rounding would decide whether they
    count (tests/test_torch_dense_options.py holds clipped bands and the
    samplers to tpu3d's)."""
    g = np.zeros((16, 16, 16, 28), np.float32)
    g[..., 1:] = rng.normal(0, 0.3, (16, 16, 16, 27))
    g[6:10, 5:11, 7:9, 0] = 4.0
    vg = TG.VoxelGrid(t(g), t(np.full(3, -1.0, np.float32)), t(np.full(3, 1.0, np.float32)))
    o = rng.normal(0, 1, (40, 3)).astype(np.float32)
    o = (2.5 * o / np.linalg.norm(o, axis=1, keepdims=True)).astype(np.float32)
    d = (-o / 2.5).astype(np.float32)
    got = render_image(vg, t(o), t(d), 0.1, 4.5, 16, occ_prune=True)
    ref = jax_render_image(JaxGrid(*(jnp.asarray(x.numpy()) for x in vg)),
                           jax.random.PRNGKey(0), jnp.asarray(o), jnp.asarray(d), 0.1, 4.5, 16,
                           use_pallas=False, occ_prune=True)
    assert np.isfinite(got.numpy()).all() and got.numpy().std() > 0.01
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# The whole slice: chip_smoke's dense artifacts, scored by both.


@pytest.fixture(scope="module")
def dense_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("dense")
    scene = chip_smoke.make_scene(seed=0, n_views=N_VIEWS, width=W, height=H)
    chip_smoke.make_dense_artifacts(str(d), scene, RES)
    return str(d), scene


def test_densify_eval_only_matches_tpu3d(dense_dir):
    """densify_eval_only against tpu3d's _densify_eval_only on the same
    artifact directory: the same dense_result, PSNRs within 0.01 dB."""
    from tpu3d.cli import _densify_eval_only
    from tpu3d.config import PipelineConfig as JaxPipelineConfig

    d, scene = dense_dir
    names = [f"img_{i:03d}.png" for i in range(N_VIEWS)]
    jstore = JaxStore(d)
    args = types.SimpleNamespace(holdout_every=8, max_eval_views=0)
    _densify_eval_only(args, JaxPipelineConfig(), jstore, jstore.load("reconstruction"),
                       jstore.load_json("reconstruction_meta"), names, scene["rgb"],
                       scene["focal"])
    ref = jstore.load_json("dense_result")
    # the photographs in another order, with an extra one: matched by name
    order = np.arange(N_VIEWS)[::-1]
    before = LAUNCHES["trilinear_kernel"]
    got = densify_eval_only(d, np.concatenate([scene["rgb"][order], scene["rgb"][:1]]),
                            [names[k] for k in order] + ["extra.png"], scene["focal"],
                            device="cpu")
    assert LAUNCHES["trilinear_kernel"] == before
    saved = ArtifactStore(d).load_json("dense_result")
    assert json.dumps(saved, sort_keys=True) == json.dumps(got, sort_keys=True)
    assert got.keys() == ref.keys() and got["test_view_names"] == ["img_004.png"]
    for k, v in ref.items():
        if k.startswith("test_psnr"):      # NaN where no pixel is background
            np.testing.assert_allclose(got[k], v, rtol=0, atol=0.01, err_msg=k)
        else:
            assert got[k] == v, k
    assert got["test_psnr"] > 12.0
    with pytest.raises(ValueError, match="img_004.png"):
        densify_eval_only(d, scene["rgb"][:2], names[:2], scene["focal"], device="cpu")


def test_render_artifacts_matches_tpu3d(dense_dir, tmp_path):
    """render_artifacts' frames against tpu3d's render_view with the meta's
    band and normalization: registered views (one out of range, skipped) and
    an orbit, then the mesh_grid fallback without a dense_grid."""
    d, scene = dense_dir
    store = JaxStore(d)
    dm, rec = store.load_json("dense_meta"), store.load("reconstruction")
    g = store.load("dense_grid")
    jnorm = JT.SceneNormalization(np.asarray(dm["norm_center"], np.float32), dm["norm_scale"])
    cfg = JaxDenseConfig(near=dm["near"], far=dm["far"], num_samples=dm["num_samples"],
                         per_ray_aabb=dm["per_ray_aabb"])
    jvg = JaxGrid(*(jnp.asarray(g[k]) for k in ("grid", "min_bound", "max_bound")))
    frames = render_artifacts(d, (H, W), scene["focal"], views=(1, 99), orbit=2, stride=2,
                              device="cpu")
    assert list(frames) == ["view_0001.png", "orbit_0000.png", "orbit_0001.png"]
    cams = [rec["cams"][1], *JE.interpolate_poses(rec["cams"], 2)]
    for cam, img in zip(cams, frames.values()):
        ref = JE.render_view(jvg, cam, H, W, scene["focal"], cfg, jnorm, stride=2,
                             bg_sh=g["bg_sh"])
        assert img.shape == ref.shape == (H // 2, W // 2, 3)
        np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-5)
    # The compact mesh grid, as densify exports it (f16 density + DC).
    other = tmp_path / "mesh_only"
    other.mkdir()
    for f in ("reconstruction.npz", "reconstruction_meta.json", "dense_meta.json"):
        (other / f).write_bytes(open(os.path.join(d, f), "rb").read())
    mg = np.stack([g["grid"][..., c] for c in (0, 1, 10, 19)], -1).astype(np.float16)
    JaxStore(str(other)).save("mesh_grid", grid=mg, min_bound=g["min_bound"],
                              max_bound=g["max_bound"])
    img = render_artifacts(str(other), (H, W), scene["focal"], views=(1,), stride=2,
                           device="cpu")["view_0001.png"]
    g28 = np.zeros_like(g["grid"])
    for src, dst in [(0, 0), (1, 1), (2, 10), (3, 19)]:
        g28[..., dst] = mg[..., src].astype(np.float32)
    ref = JE.render_view(JaxGrid(jnp.asarray(g28), jnp.asarray(g["min_bound"]),
                                 jnp.asarray(g["max_bound"])),
                         rec["cams"][1], H, W, scene["focal"], cfg, jnorm, stride=2)
    np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-5)


def test_cli_commands_on_the_cpu(dense_dir, tmp_path, capsys):
    """The argparse commands: densify --eval-only prints dense_result;
    render writes PNGs; densify without --eval-only trains on a fresh
    reconstruction and writes tpu3d's dense artifacts, with the plenoxel
    model and (since the SDF model was ported) with --model sdf."""
    d, scene = dense_dir
    images = tmp_path / "images"
    images.mkdir()
    for i, rgb in enumerate(scene["rgb"]):
        Image.fromarray(rgb).save(images / f"img_{i:03d}.png")
    common = ["--images", str(images), "--artifacts", d, "--dense-downscale", "1",
              "--focal", str(scene["focal"]), "--device", "cpu"]
    main(["densify", "--eval-only", *common])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["test_view_names"] == ["img_004.png"] and out["test_psnr"] > 12.0
    main(["render", *common, "--render-views", "0,2", "--render-stride", "2",
          "--out", str(tmp_path / "renders")])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["frames"] == 2 and out["hw"] == [H, W] and not out["dc_only_colors"]
    assert sorted(os.listdir(tmp_path / "renders")) == ["view_0000.png", "view_0002.png"]
    train = tmp_path / "train"
    chip_smoke.make_reconstruction_artifacts(str(train), scene)
    common[3] = str(train)
    sdf = tmp_path / "sdf"
    chip_smoke.make_reconstruction_artifacts(str(sdf), scene)
    main(["densify", *common[:3], str(sdf), *common[4:], "--model", "sdf", "--grid-resolution",
          "16", "--ray-stride", "8", "--num-samples", "16", "--quiet"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["recipe"]["model"] == "sdf" and np.isfinite(out["test_psnr"])
    assert ArtifactStore(str(sdf)).load_json("dense_meta")["model"] == "sdf"
    main(["densify", *common, "--grid-resolution", "16", "--ray-stride", "8",
          "--num-samples", "16", "--quiet"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["test_view_names"] == ["img_004.png"] and np.isfinite(out["test_psnr"])
    assert out["recipe"]["grid_resolution"] == 16
    store = ArtifactStore(str(train))
    assert store.load("dense_grid")["grid"].shape == (16, 16, 16, 28)
    assert store.load("mesh_grid")["grid"].dtype == np.float16
    assert store.load_json("dense_meta")["num_samples"] == 16 and store.has("dense_ckpt")
    assert (train / "test_render0.png").exists() and (train / "test_gt0.png").exists()


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")


def test_dense_entry_points_default_to_the_card(no_card, dense_dir):
    d, scene = dense_dir
    names = [f"img_{i:03d}.png" for i in range(N_VIEWS)]
    for call in (lambda: render_artifacts(d, (H, W), scene["focal"]),
                 lambda: densify_eval_only(d, scene["rgb"], names, scene["focal"]),
                 lambda: densify(d, scene["rgb"], names, scene["focal"], contraction=True),
                 lambda: densify_from_rays(d, "rays.npy")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize("C, ptrs, width", [
    (28, (0, 1 << 20), 4), (32, (16, 48), 4), (28, (4, 1 << 20), 1), (28, (0, 8), 1),
    (1, (0, 0), 1), (3, (0, 0), 1), (30, (0, 0), 1), (4, (16, 32), 4)])
def test_trilinear_vector_width(C, ptrs, width):
    """float4 loads and stores only where C is a multiple of 4 and the grid
    and output pointers are 16-byte aligned (a dense grid: C = 28 from the
    allocator); any other C <= 32 or an unaligned view takes the scalar
    path of the same kernel."""
    assert vector_width(C, *ptrs) == width


@pytest.mark.parametrize("grid_numel, out_numel, fits", [
    (256 ** 3 * 28, 8192 * 192 * 28, True), (2 ** 31 - 1, 1, True), (2 ** 31, 1, False),
    (1, 2 ** 31 - 1, True), (1, 2 ** 31, False), (512 ** 3 * 28, 1, False)])
def test_trilinear_index32(grid_numel, out_numel, fits):
    """32-bit grid and output offsets only where X*Y*Z*C and N*C fit in an
    int32: the dense stage's 256^3 x 28 grid and render chunk do, a 512^3
    grid does not and takes the 64-bit instantiation of the same kernel."""
    assert index32(grid_numel, out_numel) is fits


def test_trilinear_wrapper_refuses_other_devices():
    meta = torch.device("meta")
    b = torch.empty(3, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        trilinear_sample(torch.empty((4, 4, 4, 28), device=meta), b, b,
                         torch.empty((5, 3), device=meta))


if __name__ == "__main__":
    import shutil

    jax.config.update("jax_platforms", "cpu")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "build",
                        "tpu3d_dense_reference")
    t0 = time.time()
    sc = chip_smoke.make_scene(chip_smoke.SCENE_SEED)
    chip_smoke.make_dense_artifacts(root, sc)
    store = JaxStore(root)
    dm, g = store.load_json("dense_meta"), store.load("dense_grid")
    names = [f"img_{i:03d}.png" for i in range(chip_smoke.N_VIEWS)]
    _, test_idx = JE.split_views_by_name(names, 8)
    ev = JE.evaluate_views(
        JaxGrid(*(jnp.asarray(g[k]) for k in ("grid", "min_bound", "max_bound"))),
        store.load("reconstruction")["cams"][test_idx], sc["rgb"][test_idx], sc["focal"],
        JaxDenseConfig(near=dm["near"], far=dm["far"], num_samples=dm["num_samples"],
                       per_ray_aabb=dm["per_ray_aabb"]),
        JT.SceneNormalization(np.asarray(dm["norm_center"], np.float32), dm["norm_scale"]),
        stride=2, chunk=2048, bg_sh=g["bg_sh"])
    print(f"tpu3d on the CPU, {chip_smoke.DENSE_RES}^3 x 28, views "
          f"{[names[k] for k in test_idx]} at {chip_smoke.WIDTH}x{chip_smoke.HEIGHT} "
          f"stride 2: PSNR {ev['per_view']} mean {ev['mean_psnr']!r} dB, "
          f"{time.time() - t0:.1f} s")
    shutil.rmtree(root)
