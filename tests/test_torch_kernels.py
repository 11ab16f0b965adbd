"""The port's kernels (tpu3d_torch/kernels) against tpu3d and numpy.

On the CPU each wrapper runs its plain PyTorch version; those are compared
here with tpu3d's gather path, its Pallas kernels in interpret mode and its
matcher, and the view's ray build with numpy ``view_rays`` (itself held to
tpu3d's in tests/test_torch_dense.py). The CUDA kernels themselves are
compared with the plain versions by tests/test_torch_gpu.py and by
chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3d.features.descriptor import _bilinear
from tpu3d.features.detector import _neighbors27 as jax_neighbors27
from tpu3d.kernels.distance import descriptor_top2 as jax_top2
from tpu3d.kernels.distance import mutual_nn_pallas as jax_mutual_nn
from tpu3d.kernels.patch_sample import sample_gradient_patches as jax_patches
from tpu3d.matching.mnn import match_descriptors as jax_match
from tpu3d_torch.dense import eval as TE
from tpu3d_torch.dense.train import SceneNormalization
from tpu3d_torch.features.detector import _OFFS27, _neighbors27, offsets27
from tpu3d_torch.features.frontend import frame_tables
from tpu3d_torch.kernels import LAUNCHES
from tpu3d_torch.kernels.distance import descriptor_top2, mutual_top2
from tpu3d_torch.kernels.patch_sample import sample_gradient_patches
from tpu3d_torch.kernels.view_rays import _fma, view_rays, view_rays_plain
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


def test_neighbors27_tables_are_cached_and_match_tpu3d(rng):
    """The detector's offset tables are built once per device, hold the
    values the per-octave construction made, and give tpu3d's
    _neighbors27 (its CPU path: plain gathers) key for key."""
    dev = torch.device("cpu")
    dys, dxs, dls = offsets27(dev)
    assert all(a is b for a, b in zip(offsets27(dev), (dys, dxs, dls)))
    assert torch.equal(dys, torch.tensor([o[1] for o in _OFFS27], dtype=torch.float32))
    assert torch.equal(dxs, torch.tensor([o[2] for o in _OFFS27], dtype=torch.float32))
    assert torch.equal(dls, torch.tensor([o[0] for o in _OFFS27], dtype=torch.int32))
    assert dls.dtype == torch.int32 and dys.dtype == dxs.dtype == torch.float32
    L, H, W, K = 6, 24, 31, 40
    dog = rng.normal(0, 1, (L, H, W)).astype(np.float32)
    s = rng.integers(1, L - 1, K)
    y = rng.integers(1, H - 2, K)
    x = rng.integers(1, W - 2, K)
    got = _neighbors27(t(dog), t(s), t(y), t(x))
    ref = jax_neighbors27(jnp.asarray(dog), jnp.asarray(s), jnp.asarray(y), jnp.asarray(x))
    assert list(got) == list(ref)
    for key, vals in got.items():
        np.testing.assert_array_equal(vals.numpy(), np.asarray(ref[key]))


@pytest.mark.parametrize("H, W, O", [(648, 968, 4), (64, 64, 1), (37, 129, 5)])
def test_frame_tables_match_the_per_batch_construction(H, W, O):
    """The frontend's octave sizes and image size, cached per device and
    shape, equal what it built per batch from Python lists (ceil halving)."""
    dev = torch.device("cpu")
    hs, ws, size = frame_tables(H, W, O, dev)
    assert frame_tables(H, W, O, dev)[0] is hs
    ref_h, ref_w = [float(H)], [float(W)]
    for _ in range(1, O):
        ref_h.append(float(-(-ref_h[-1] // 2)))
        ref_w.append(float(-(-ref_w[-1] // 2)))
    assert torch.equal(hs, torch.tensor(ref_h, dtype=torch.float32))
    assert torch.equal(ws, torch.tensor(ref_w, dtype=torch.float32))
    assert torch.equal(size, torch.tensor([W, H], dtype=torch.float32))
    assert hs.tolist() == [float(-(-H // 2 ** o)) for o in range(O)]


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


def test_mutual_top2_plain_matches_pallas_interpret(rng):
    """Both directions against tpu3d's descriptor_top2 in interpret mode,
    called as mutual_nn_pallas calls it (queries and keys swapped for the
    column argmax), at K0 = 256, K1 = 512: row best and second within 1e-6,
    row argmax exactly; col_arg exactly on the columns whose top-2 gap over
    the rows exceeds 1e-5. Then mutual_nn_pallas' matches against the
    port's matcher (one mutual_top2 call) on injected correspondences:
    validity and matched index equal."""
    d0 = unit(rng, (256, 128))
    d1 = unit(rng, (512, 128))
    d1[:200] = d0[:200] + rng.normal(0, 0.05, (200, 128)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    best, second, arg = map(np.asarray, jax_top2(jnp.asarray(d0), jnp.asarray(d1),
                                                 interpret=True))
    cbest, csecond, carg = map(np.asarray, jax_top2(jnp.asarray(d1), jnp.asarray(d0),
                                                    interpret=True))
    b, s, a, ca = mutual_top2(t(d0)[None], t(d1)[None], torch.ones((1, 256)),
                              torch.ones((1, 512)))
    _no_ties(best, second)
    np.testing.assert_allclose(b[0].numpy(), best, rtol=0, atol=1e-6)
    np.testing.assert_allclose(s[0].numpy(), second, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(a[0].numpy(), arg)
    clear = cbest - csecond > 1e-5
    assert ca.shape == (1, 512) and ca.dtype == torch.int32 and clear.mean() > 0.99
    np.testing.assert_array_equal(ca[0].numpy()[clear], carg[clear])
    ones0, ones1 = jnp.ones(256), jnp.ones(512)
    ref = jax_mutual_nn(jnp.asarray(d0), jnp.asarray(d1), ones0, ones1, interpret=True)
    got = match_descriptors(t(d0), t(d1), torch.ones(256), torch.ones(512))
    assert 150 < int(got.valid.sum()) <= 256
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.idx1.numpy(), np.asarray(ref.idx1))


@pytest.mark.parametrize("K0, K1", [(96, 160), (200, 131)])
def test_mutual_top2_plain_matches_two_top2_calls(rng, K0, K1):
    """col_arg against a second descriptor_top2 call with the roles
    swapped (mnn.py's column argmax), with random masks on both sides:
    equal on every column whose top-2 gap over the rows exceeds 1e-5, and
    the row outputs equal to descriptor_top2's."""
    B, D = 3, 64
    q, k = unit(rng, (B, K0, D)), unit(rng, (B, K1, D))
    vq = (rng.random((B, K0)) < 0.85).astype(np.float32)
    vk = (rng.random((B, K1)) < 0.85).astype(np.float32)
    b, s, a, ca = mutual_top2(t(q), t(k), t(vq), t(vk))
    rb, rs, ra = descriptor_top2(t(q), t(k), t(vq), t(vk))
    cb, cs, cref = descriptor_top2(t(k), t(q), t(vk), t(vq))
    assert torch.equal(b, rb) and torch.equal(s, rs) and torch.equal(a, ra)
    clear = (cb - cs > 1e-5) | (t(vk) == 0)     # a masked column: row 0 in both
    assert ca.shape == (B, K1) and float(clear.float().mean()) > 0.99
    assert torch.equal(ca[clear], cref[clear])
    assert bool((ca[t(vk) == 0] == 0).all())


def test_mutual_top2_plain_masks_and_ties():
    """A masked query row gives column 0 and a masked key column row 0;
    equal scores go to the lowest index in both directions (query rows 0
    and 3 are equal)."""
    q = torch.tensor([[[1.0, 0.0], [0.0, 1.0], [0.6, 0.8], [1.0, 0.0]]])
    k = torch.tensor([[[0.0, 1.0], [1.0, 0.0], [1.0, 0.0], [0.6, 0.8]]])
    vq = torch.tensor([[1.0, 0.0, 1.0, 1.0]])
    vk = torch.tensor([[1.0, 1.0, 1.0, 0.0]])
    best, second, arg, col_arg = mutual_top2(q, k, vq, vk)
    np.testing.assert_allclose(best[0].numpy(), [1.0, -2.0, 0.8, 1.0], atol=1e-7)
    np.testing.assert_allclose(second[0].numpy(), [1.0, -2.0, 0.6, 1.0], atol=1e-7)
    np.testing.assert_array_equal(arg[0].numpy(), [1, 0, 0, 1])
    np.testing.assert_array_equal(col_arg[0].numpy(), [2, 0, 0, 0])


def test_match_descriptors_matches_mnn(rng):
    """The batched matcher (one mutual top-2 launch per block) against tpu3d's
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


# One ulp of 1: a unit direction's components lie in [-1, 1].
ULP_1 = 2.0 ** -23


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("H, W", [(31, 44), (30, 45)])
@pytest.mark.parametrize("normalized", [False, True], ids=["raw", "normalized"])
@pytest.mark.parametrize("rvec", [(0.3, -0.7, 0.2), (4e-9, -2e-9, 1e-9)], ids=["pose", "tiny"])
def test_view_rays_plain_matches_numpy(stride, H, W, normalized, rvec):
    """view_rays_plain from view_pose's rotation and centre against numpy
    view_rays of the same camera: the same pixel count and order, origins
    bit for bit, directions within 4 ulp of 1 (numpy's product with R is a
    BLAS sgemm; the plain version rounds it as OpenBLAS's fma chain does,
    which makes them bit for bit on such a host, but another BLAS may round
    otherwise), at odd and even sizes, strides 1-3, with and without a scene
    normalization, and with a rotation under so3_exp_np's 1e-8 branch."""
    cam = np.array([*rvec, 0.4, -1.1, 3.2])
    norm = SceneNormalization(np.array([0.3, -0.2, 0.9], np.float32), 2.7) if normalized else None
    o_np, d_np = TE.view_rays(cam, H, W, 37.5, norm, stride)
    R, o = TE.view_pose(cam, norm)
    o_t, d_t = view_rays_plain(R, o, H, W, 37.5, stride)
    assert o_t.dtype == d_t.dtype == torch.float32
    assert o_t.shape == d_t.shape == (len(range(0, H, stride)) * len(range(0, W, stride)), 3)
    np.testing.assert_array_equal(o_t.numpy(), o_np)
    assert np.abs(d_t.numpy() - d_np).max() <= 4 * ULP_1
    np.testing.assert_allclose(np.linalg.norm(d_t.numpy(), axis=-1), 1.0, rtol=0, atol=4 * ULP_1)


def test_view_rays_on_the_cpu_runs_the_plain_version():
    """The wrapper on the CPU: the plain version's tensors, and no launch of
    view_rays_kernel counted."""
    R, o = TE.view_pose(np.array([0.1, 0.2, -0.3, 1.0, 0.5, 2.0]))
    before = LAUNCHES["view_rays_kernel"]
    got = view_rays(R, o, 30, 45, 40.0, 2, "cpu")
    want = view_rays_plain(R, o, 30, 45, 40.0, 2)
    assert LAUNCHES["view_rays_kernel"] == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].device.type == "cpu"


def test_plain_fma_rounds_once():
    """The plain version's fused multiply-add: x y + z rounded once to f32,
    against exact rational arithmetic, on random operands across 80 binary
    orders of z, and where rounding the f64 sum to f32 would round twice
    ((1 + 2^-12)^2 is a tie in f32; +-2^-80 breaks it either way)."""
    from fractions import Fraction

    rng = np.random.default_rng(5)
    x = rng.normal(size=4000).astype(np.float32)
    y = rng.normal(size=4000).astype(np.float32)
    z = (rng.normal(size=4000) * np.exp2(rng.uniform(-40, 40, 4000))).astype(np.float32)
    tie = np.float32(1 + 2.0 ** -12)
    x = np.concatenate([x, [tie, tie]]).astype(np.float32)
    y = np.concatenate([y, [tie, tie]]).astype(np.float32)
    z = np.concatenate([z, [2.0 ** -80, -(2.0 ** -80)]]).astype(np.float32)
    got = _fma(t(x), t(y), t(z)).numpy()
    assert got[-2] == np.float32(1 + 2.0 ** -11 + 2.0 ** -23)
    assert got[-1] == np.float32(1 + 2.0 ** -11)
    for xi, yi, zi, gi in zip(x, y, z, got):
        exact = Fraction(float(xi)) * Fraction(float(yi)) + Fraction(float(zi))
        near = np.float32(float(exact))
        cands = (np.nextafter(near, np.float32(-np.inf)), near,
                 np.nextafter(near, np.float32(np.inf)))
        best = min(cands, key=lambda c: (abs(Fraction(float(c)) - exact),
                                         int(np.float32(c).view(np.int32)) & 1))
        assert gi == best
