"""The port's two kernels (tpu3d_torch/kernels) against tpu3d.

On the CPU each wrapper runs its plain PyTorch version; those are compared
here with tpu3d's gather path, its Pallas kernels in interpret mode and its
matcher. The CUDA kernels themselves are compared with the plain versions by
tests/test_torch_gpu.py and by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3d.features.descriptor import _bilinear
from tpu3d.kernels.distance import descriptor_top2 as jax_top2
from tpu3d.kernels.patch_sample import sample_gradient_patches as jax_patches
from tpu3d.matching.mnn import match_descriptors as jax_match
from tpu3d_torch.features.detector import _neighbors27
from tpu3d_torch.kernels import LAUNCHES
from tpu3d_torch.kernels.distance import descriptor_top2
from tpu3d_torch.kernels.patch_sample import sample_gradient_patches
from tpu3d_torch.matching.mnn import match_descriptors


def unit(rng, shape):
    x = rng.normal(0, 1, shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_patch_sample_plain_matches_bilinear(rng):
    """Against tpu3d's gather path (_bilinear), including coordinates
    beyond the stack: the base cell clips to [0, H-2] while the fraction
    comes from the unclipped coordinate, in both. Same arithmetic in the
    same order, so the tolerance is 1e-6 abs."""
    L, H, W, K, S = 5, 40, 56, 64, 121
    gx = rng.normal(0, 1, (L, H, W)).astype(np.float32)
    gy = rng.normal(0, 1, (L, H, W)).astype(np.float32)
    ys = rng.uniform(-3, H + 2, (K, S)).astype(np.float32)
    xs = rng.uniform(-3, W + 2, (K, S)).astype(np.float32)
    lvl = rng.integers(0, L, K).astype(np.int32)
    before = LAUNCHES["patch_sample_kernel"]
    got = sample_gradient_patches(t(gx), t(gy), t(ys), t(xs), t(lvl)).numpy()
    assert LAUNCHES["patch_sample_kernel"] == before   # a CPU tensor: plain version
    assert got.shape == (K, 2, S)
    for c, img in enumerate((gx, gy)):
        ref = np.asarray(_bilinear(jnp.asarray(img), jnp.asarray(lvl)[:, None],
                                   jnp.asarray(ys), jnp.asarray(xs)))
        np.testing.assert_allclose(got[:, c], ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("S", [128, 256])
def test_patch_sample_plain_matches_pallas_interpret(rng, S):
    """Against the TPU kernel in interpret mode, inside the window that
    its callers keep to. The kernel sums the same four products in another
    order (two one-hot matmuls): 1e-6 abs at unit-variance values."""
    L, H, W, K = 3, 128, 160, 6
    gx = rng.normal(0, 1, (L, H, W)).astype(np.float32)
    gy = rng.normal(0, 1, (L, H, W)).astype(np.float32)
    cy = rng.uniform(40, H - 40, (K, 1))
    cx = rng.uniform(40, W - 40, (K, 1))
    ys = (cy + rng.uniform(-20, 20, (K, S))).astype(np.float32)
    xs = (cx + rng.uniform(-20, 20, (K, S))).astype(np.float32)
    lvl = rng.integers(0, L, K).astype(np.int32)
    got = sample_gradient_patches(t(gx), t(gy), t(ys), t(xs), t(lvl)).numpy()
    ref = np.asarray(jax_patches(jnp.asarray(gx), jnp.asarray(gy), jnp.asarray(ys),
                                 jnp.asarray(xs), jnp.asarray(lvl), interpret=True))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_neighbors27_is_exact(rng):
    """The detector's 3x3x3 fetch: one sampling call at integer points,
    where the bilinear sample is the stored value exactly (for points up
    to H-2, W-2: the detector keeps an 8-pixel border)."""
    L, H, W, K = 7, 30, 40, 50
    dog = rng.normal(0, 1, (L, H, W)).astype(np.float32)
    s = rng.integers(1, L - 1, K)
    y = rng.integers(1, H - 2, K)
    x = rng.integers(1, W - 2, K)
    nb = _neighbors27(t(dog), t(s), t(y), t(x))
    assert len(nb) == 27
    for (ds, dy, dx), vals in nb.items():
        np.testing.assert_array_equal(vals.numpy(), dog[s + ds, y + dy, x + dx])


def _no_ties(best, second, gap=1e-5):
    assert np.all(best - second > gap), "draw without near-ties"


def test_top2_plain_matches_pallas_interpret(rng):
    """Against descriptor_top2 in interpret mode (no masks there): best and
    second within 1e-6, argmax exactly, on unit descriptors without ties."""
    d0 = unit(rng, (256, 128))
    d1 = unit(rng, (512, 128))
    best, second, arg = jax_top2(jnp.asarray(d0), jnp.asarray(d1), interpret=True)
    best, second, arg = map(np.asarray, (best, second, arg))
    _no_ties(best, second)
    ones0 = torch.ones((1, 256))
    ones1 = torch.ones((1, 512))
    b, s, a = descriptor_top2(t(d0)[None], t(d1)[None], ones0, ones1)
    np.testing.assert_allclose(b[0].numpy(), best, rtol=0, atol=1e-6)
    np.testing.assert_allclose(s[0].numpy(), second, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(a[0].numpy(), arg)


def test_top2_plain_masks_and_ties():
    """Masked rows and columns score -2 (mnn.py:43-45); equal scores go to
    the lowest index and then count as the second best."""
    q = torch.tensor([[[1.0, 0.0], [0.0, 1.0], [0.6, 0.8]]])
    k = torch.tensor([[[0.0, 1.0], [1.0, 0.0], [1.0, 0.0], [0.6, 0.8]]])
    vq = torch.tensor([[1.0, 0.0, 1.0]])
    vk = torch.tensor([[1.0, 1.0, 1.0, 0.0]])
    best, second, arg = descriptor_top2(q, k, vq, vk)
    np.testing.assert_allclose(best[0].numpy(), [1.0, -2.0, 0.8], atol=1e-7)
    np.testing.assert_allclose(second[0].numpy(), [1.0, -2.0, 0.6], atol=1e-7)
    np.testing.assert_array_equal(arg[0].numpy(), [1, 0, 0])


def test_match_descriptors_matches_mnn(rng):
    """The batched matcher (two top-2 launches per block) against tpu3d's
    mnn.match_descriptors pair by pair: scores within 1e-6, matched index
    and validity exactly, with injected true correspondences and padding."""
    B, K, D = 3, 256, 128
    d0 = unit(rng, (B, K, D))
    d1 = unit(rng, (B, K, D))
    d1[:, :128] = d0[:, :128] + rng.normal(0, 0.05, (B, 128, D)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    v0 = np.ones((B, K), np.float32)
    v1 = np.ones((B, K), np.float32)
    v0[:, 200:] = 0.0
    v1[1, 10:40] = 0.0
    got = match_descriptors(t(d0), t(d1), t(v0), t(v1))
    for b in range(B):
        ref = jax_match(jnp.asarray(d0[b]), jnp.asarray(d1[b]), jnp.asarray(v0[b]),
                        jnp.asarray(v1[b]))
        sim = d0[b] @ d1[b].T
        srt = np.sort(np.where(v1[b][None] > 0, sim, -2.0), axis=1)
        _no_ties(srt[:200, -1], srt[:200, -2])
        np.testing.assert_array_equal(got.valid[b].numpy(), np.asarray(ref.valid))
        np.testing.assert_array_equal(got.idx1[b].numpy(), np.asarray(ref.idx1))
        np.testing.assert_allclose(got.score[b].numpy(), np.asarray(ref.score),
                                   rtol=0, atol=1e-6)
    single = match_descriptors(t(d0[0]), t(d1[0]), t(v0[0]), t(v1[0]))
    np.testing.assert_array_equal(single.valid.numpy(), got.valid[0].numpy())
