"""Retrieval, view graph, tracks and the two-view gate of the port against
tpu3d, with tpu3d's random draws injected where the port has a seam for
them (a torch.Generator gives other numbers than jax.random)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_geometry import make_pair
from tpu3d.geometry.estimators import find_essential_ransac as jax_find_e
from tpu3d.geometry.fivepoint import five_point_ransac as jax_five_point
from tpu3d.geometry.ransac import _sample_indices as jax_sample_indices
from tpu3d.matching import bow as jbow
from tpu3d.matching import pairs as jpairs
from tpu3d.matching.tracks import TrackStore as JaxTrackStore
from tpu3d_torch.geometry.estimators import find_essential_ransac, lo_hypotheses
from tpu3d_torch.geometry.fivepoint import five_point_ransac
from tpu3d_torch.geometry.pose import recover_pose
from tpu3d_torch.geometry.ransac import _sample_indices
from tpu3d_torch.matching import bow as tbow
from tpu3d_torch.matching import pairs as tpairs
from tpu3d_torch.matching.tracks import TrackStore


def t(a):
    return torch.from_numpy(np.array(a))


def jax_codebook_draws(key, valid, k):
    """The draws of tpu3d's build_codebook / kmeans for this key."""
    v = jnp.asarray(valid.reshape(-1), jnp.float32)
    n = v.shape[0]
    fill = jax.random.choice(key, n, (n,), p=v / jnp.sum(v))
    init = jax.random.choice(jax.random.fold_in(key, 1), n, (k,), replace=False)
    return np.asarray(fill), np.asarray(init)


def test_bow_with_injected_draws(rng):
    """Codebook within 1e-5 and the same visual words, tf-idf vectors and
    top-k neighbours, given tpu3d's fill and initial rows."""
    B, K, D, k = 6, 96, 32, 24
    centers = rng.normal(0, 1, (k, D))
    # Image b sees clusters 3b .. 3b+8: overlapping views, distinct tf-idf.
    words = 3 * np.arange(B)[:, None] + rng.integers(0, 9, (B, K))
    d = centers[words % k] + 0.15 * rng.normal(0, 1, (B, K, D))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    v = (rng.uniform(size=(B, K)) < 0.9).astype(np.float32)
    key = jax.random.PRNGKey(0)
    fill, init = jax_codebook_draws(key, v, k)
    jcb = np.asarray(jbow.build_codebook(key, jnp.asarray(d), jnp.asarray(v), k, 5))
    tcb = tbow.build_codebook(t(d), t(v), t(fill), t(init), 5)
    np.testing.assert_allclose(tcb.numpy(), jcb, rtol=0, atol=1e-5)
    jwords = np.asarray(jax.vmap(jbow.vector_quantize, in_axes=(0, None))(jnp.asarray(d), jnp.asarray(jcb)))
    twords = tbow.vector_quantize(t(d), tcb)
    np.testing.assert_array_equal(twords.numpy(), jwords)
    jtv = jbow.tfidf_vectors(jnp.asarray(jwords), jnp.asarray(v), k)
    ttv = tbow.tfidf_vectors(twords, t(v), k)
    np.testing.assert_allclose(ttv.numpy(), np.asarray(jtv), rtol=1e-6, atol=1e-6)
    jidx, jsim = jbow.topk_similar(jtv, 3)
    tidx, tsim = tbow.topk_similar(ttv, 3)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tsim.numpy(), np.asarray(jsim), rtol=0, atol=1e-6)


def test_view_graph_and_pair_order_identical(rng):
    n = 12
    idx = np.stack([rng.permutation([j for j in range(n) if j != i])[:5] for i in range(n)])
    sim = np.sort(rng.uniform(0, 1, (n, 5)), axis=1)[:, ::-1].astype(np.float32)
    for thr, mn in ((0.5, 3), (0.9, 1), (0.0, 5)):
        ja = jpairs.build_view_graph(idx, sim, thr, mn)
        ta = tpairs.build_view_graph(idx, sim, thr, mn)
        assert ta == ja
        assert tpairs.bfs_pair_order(ta) == jpairs.bfs_pair_order(ja)
        assert tpairs.bfs_pair_order(ta, start=3) == jpairs.bfs_pair_order(ja, start=3)
    assert tpairs.connected_order_fallback(7) == jpairs.connected_order_fallback(7)


def test_tracks_identical(rng):
    n_img, K = 5, 40
    a, b = JaxTrackStore(n_img, K, capacity=500, use_native=False), TrackStore(n_img, K, capacity=500)
    for _ in range(30):
        i, j = rng.choice(n_img, 2, replace=False)
        m = int(rng.integers(1, 15))
        i0 = rng.choice(K, m, replace=False)
        i1 = rng.choice(K, m, replace=False)
        assert b.overlap_fraction(i, j, i0, i1) == a.overlap_fraction(i, j, i0, i1)
        np.testing.assert_array_equal(b.union_pair(i, j, i0, i1), a.union_pair(i, j, i0, i1))
    np.testing.assert_array_equal(b.kp_track, a.kp_track)
    assert b.next_track == a.next_track
    ids = np.arange(b.next_track)
    np.testing.assert_array_equal(b.resolve(ids), a.resolve(ids))


def _pair(seed, n=300):
    rng = np.random.default_rng(seed)
    X, R, tt, uv0, uv1, focal = make_pair(rng, n=n, noise=0.1, outlier_frac=0.3)
    valid = np.ones(n, np.float32)
    valid[n - 10:] = 0.0
    return R, tt, uv0, uv1, valid, focal


def test_sample_indices_identical(rng):
    valid = (rng.uniform(size=200) < 0.7).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jidx = np.asarray(jax_sample_indices(key, jnp.asarray(valid), 64, 8))
    g = np.asarray(jax.random.gumbel(key, (64, 200)))
    np.testing.assert_array_equal(_sample_indices(t(g), t(valid), 8).numpy(), jidx)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_find_essential_ransac_with_injected_samples(seed):
    """The same inlier mask and cheirality set, and R, t within 1e-4, with
    tpu3d's minimal samples (its Gumbel draws for both rounds)."""
    R, tt, uv0, uv1, valid, focal = _pair(seed)
    key = jax.random.PRNGKey(seed)
    ja = jax_find_e(key, jnp.asarray(uv0), jnp.asarray(uv1), jnp.asarray(valid), focal, 1.0, 512)
    k0, k1 = jax.random.split(key)
    n = len(valid)
    noise = (t(np.asarray(jax.random.gumbel(k0, (512, n)))),
             t(np.asarray(jax.random.gumbel(k1, (lo_hypotheses(512), n)))))
    tb = find_essential_ransac(t(uv0), t(uv1), t(valid), focal, noise, 1.0)
    np.testing.assert_array_equal(tb.inliers.numpy(), np.asarray(ja.inliers))
    np.testing.assert_array_equal(tb.front.numpy(), np.asarray(ja.front))
    np.testing.assert_allclose(tb.R.numpy(), np.asarray(ja.R), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tb.t.numpy(), np.asarray(ja.t), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tb.R.numpy(), R, rtol=0, atol=1e-2)
    # A leading pair axis gives each pair the unbatched answer.
    tbb = find_essential_ransac(t(np.stack([uv0, uv0])), t(np.stack([uv1, uv1])),
                                t(np.stack([valid, valid])), focal,
                                tuple(torch.stack([x, x]) for x in noise), 1.0)
    for i in range(2):
        np.testing.assert_array_equal(tbb.inliers[i].numpy(), tb.inliers.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_five_point_ransac_with_injected_samples(seed):
    """The same inlier mask and count with tpu3d's minimal samples. The
    winning E agrees up to sign within 1e-2 only: its root is polished by
    f32 bisection on a near-singular polynomial, where the two packages'
    roundings move z by ~1e-5 relative; the rotations the two E give
    differ by less than 0.1 degree."""
    R, tt, uv0, uv1, valid, focal = _pair(seed)
    key = jax.random.PRNGKey(seed)
    jE, jinl, jcnt = jax_five_point(key, jnp.asarray(uv0), jnp.asarray(uv1),
                                    jnp.asarray(valid), focal, 1.0, 128)
    g = t(np.asarray(jax.random.gumbel(key, (128, len(valid)))))
    E, inl, cnt = five_point_ransac(t(uv0), t(uv1), t(valid), focal, g, 1.0)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(jinl))
    assert int(cnt) == int(jcnt)
    jE = np.asarray(jE)
    assert min(np.abs(E.numpy() - jE).max(), np.abs(E.numpy() + jE).max()) < 1e-2
    x0, x1, w = t(uv0) / focal, t(uv1) / focal, inl.float()
    Rp = recover_pose(E, x0, x1, w)[0].numpy().astype(np.float64)
    Rj = recover_pose(t(jE), x0, x1, w)[0].numpy().astype(np.float64)
    assert np.degrees(np.arccos(np.clip((np.trace(Rp @ Rj.T) - 1) / 2, -1, 1))) < 0.1
