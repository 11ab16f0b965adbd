"""tpu3d_torch's CUDA kernels against their plain PyTorch versions on the
card. Every test here is marked ``gpu`` and skips without a CUDA device.

The module imports neither jax nor tpu3d, so it also runs where only the
port is installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from tpu3d_torch.ba import bundle_adjust
from tpu3d_torch.features.detector import _neighbors27
from tpu3d_torch.kernels import LAUNCHES
from tpu3d_torch.kernels.orient_desc import (near_ties, orient_desc_samples,
                                             orient_desc_samples_plain, sample_tolerance)
from tpu3d_torch.kernels.distance import descriptor_top2, descriptor_top2_plain
from tpu3d_torch.kernels.patch_sample import (sample_gradient_patches,
                                              sample_gradient_patches_plain)
from tpu3d_torch.kernels.trilinear import trilinear_sample, trilinear_sample_plain
from tpu3d_torch.matching.mnn import match_descriptors

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def gen(cuda):
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    return g


def _unit(shape, gen, dev):
    return torch.nn.functional.normalize(torch.randn(shape, generator=gen, device=dev), dim=-1)


def test_patch_sample_kernel_matches_plain(cuda, gen):
    """Two channels and one, with per-sample level offsets, at coordinates
    beyond the stack too: within 1e-5 abs (the kernel rounds each product
    as the plain version does, so the two agree to the last bit in practice)."""
    L, H, W, K, S = 6, 96, 130, 300, 256
    gx = torch.randn((L, H, W), generator=gen, device=cuda)
    gy = torch.randn((L, H, W), generator=gen, device=cuda)
    ys = torch.rand((K, S), generator=gen, device=cuda) * (H + 3) - 2
    xs = torch.rand((K, S), generator=gen, device=cuda) * (W + 3) - 2
    lvl = torch.randint(0, L, (K,), generator=gen, device=cuda, dtype=torch.int32)
    dlvl = torch.randint(-1, 2, (S,), generator=gen, device=cuda, dtype=torch.int32)
    before = LAUNCHES["patch_sample_kernel"]
    for args in ((gx, gy, ys, xs, lvl), (gx, None, ys, xs, lvl, dlvl)):
        got = sample_gradient_patches(*args)
        torch.cuda.synchronize()
        ref = sample_gradient_patches_plain(*args)
        assert got.shape == ref.shape
        assert (got - ref).abs().max().item() <= 1e-5
    assert LAUNCHES["patch_sample_kernel"] == before + 2


def test_neighbors27_on_the_card(cuda, gen):
    L, H, W, K = 7, 30, 40, 500
    dog = torch.randn((L, H, W), generator=gen, device=cuda)
    s = torch.randint(1, L - 1, (K,), generator=gen, device=cuda)
    y = torch.randint(1, H - 2, (K,), generator=gen, device=cuda)
    x = torch.randint(1, W - 2, (K,), generator=gen, device=cuda)
    for (ds, dy, dx), vals in _neighbors27(dog, s, y, x).items():
        assert torch.equal(vals, dog[s + ds, y + dy, x + dx])


def test_top2_kernel_matches_plain(cuda, gen):
    """Ragged tiles (K not a multiple of 64) and masks: best and second
    within 1e-5, argmax equal wherever the top-2 gap exceeds 1e-5."""
    B, K0, K1, D = 3, 300, 517, 128
    q, k = _unit((B, K0, D), gen, cuda), _unit((B, K1, D), gen, cuda)
    vq = (torch.rand((B, K0), generator=gen, device=cuda) < 0.9).float()
    vk = (torch.rand((B, K1), generator=gen, device=cuda) < 0.9).float()
    before = LAUNCHES["top2_kernel"]
    best, second, arg = descriptor_top2(q, k, vq, vk)
    torch.cuda.synchronize()
    assert LAUNCHES["top2_kernel"] == before + 1
    pb, ps, pa = descriptor_top2_plain(q, k, vq, vk)
    assert (best - pb).abs().max().item() <= 1e-5
    assert (second - ps).abs().max().item() <= 1e-5
    clear = (pb - ps) > 1e-5
    assert bool(((arg == pa) | ~clear).all())


def test_top2_kernel_ties_and_masks(cuda):
    q = torch.tensor([[[1.0, 0.0], [0.0, 1.0], [0.6, 0.8]]], device=cuda)
    k = torch.tensor([[[0.0, 1.0], [1.0, 0.0], [1.0, 0.0], [0.6, 0.8]]], device=cuda)
    vq = torch.tensor([[1.0, 0.0, 1.0]], device=cuda)
    vk = torch.tensor([[1.0, 1.0, 1.0, 0.0]], device=cuda)
    best, second, arg = descriptor_top2(q, k, vq, vk)
    np.testing.assert_allclose(best[0].cpu().numpy(), [1.0, -2.0, 0.8], atol=1e-7)
    np.testing.assert_allclose(second[0].cpu().numpy(), [1.0, -2.0, 0.6], atol=1e-7)
    np.testing.assert_array_equal(arg[0].cpu().numpy(), [1, 0, 0])


def test_match_descriptors_on_the_card(cuda, gen):
    """The matcher on the card against the same matcher on the CPU."""
    B, K, D = 4, 512, 128
    d0 = _unit((B, K, D), gen, cuda)
    d1 = torch.nn.functional.normalize(d0 + 0.05 * torch.randn(
        (B, K, D), generator=gen, device=cuda), dim=-1)
    v0 = torch.ones((B, K), device=cuda)
    v0[:, 400:] = 0
    v1 = torch.ones((B, K), device=cuda)
    got = match_descriptors(d0, d1, v0, v1)
    ref = match_descriptors(d0.cpu(), d1.cpu(), v0.cpu(), v1.cpu())
    assert got.valid.sum().item() > 0.5 * B * 400
    assert (got.valid.cpu() == ref.valid).float().mean().item() > 0.999
    both = got.valid.cpu() & ref.valid
    assert torch.equal(got.idx1.cpu()[both], ref.idx1[both])


@pytest.mark.parametrize("C", [28, 1, 32])
def test_trilinear_kernel_equals_plain(cuda, gen, C):
    """Bit for bit (the kernel rounds the same operations in the same order
    as the plain version), with points inside, outside and on the box's
    faces and corners, and in-bounds flags identical."""
    X, Y, Z, N = 9, 17, 24, 4000
    grid = torch.randn((X, Y, Z, C), generator=gen, device=cuda)
    mn = torch.tensor([-1.0, -2.0, 0.5], device=cuda)
    mx = torch.tensor([1.0, 0.0, 2.5], device=cuda)
    pts = mn + (mx - mn) * (torch.rand((N, 3), generator=gen, device=cuda) * 1.2 - 0.1)
    pts[:8] = torch.stack([torch.where(torch.tensor([(k >> a) & 1 for a in range(3)],
                                                    device=cuda) > 0, mx, mn)
                           for k in range(8)])
    pts[8:16] = mn + (mx - mn) * torch.rand((8, 3), generator=gen, device=cuda)
    pts[8:16, 1] = mx[1]
    before = LAUNCHES["trilinear_kernel"]
    got, got_in = trilinear_sample(grid, mn, mx, pts)
    torch.cuda.synchronize()
    assert LAUNCHES["trilinear_kernel"] == before + 1
    ref, ref_in = trilinear_sample_plain(grid, mn, mx, pts)
    assert torch.equal(got_in, ref_in) and bool(got_in[:16].all())
    assert 0 < int(got_in.sum()) < N
    assert torch.equal(got, ref)


@pytest.mark.parametrize("C", [28, 3])
def test_trilinear_grad_kernel_matches_plain(cuda, gen, C):
    """The scatter against its plain version: points inside, outside and on
    the box, and 1,500 in one cell (the conflict-heavy case), on the float4
    path (C = 28) and the scalar one (C = 3). Atomics sum in no fixed order:
    within 1e-5 x max|plain|, 1e-4 for the cluster, as tpu3d's tests allow
    between its scatter and XLA's autodiff."""
    from tpu3d_torch.kernels.trilinear_grad import (trilinear_scatter_grad,
                                                    trilinear_scatter_grad_plain)

    res = (8, 16, 16)
    mn = torch.full((3,), -1.0, device=cuda)
    mx = torch.full((3,), 1.0, device=cuda)
    spread = torch.rand((700, 3), generator=gen, device=cuda) * 2.6 - 1.3
    spread[:5] = torch.tensor([[-1, -1, -1], [1, 1, 1], [0, 1, -1], [1, 0, 0], [-1, 1, 1.0]],
                              device=cuda)
    cluster = torch.tensor([0.1, 0.2, -0.3], device=cuda) + (
        torch.rand((1500, 3), generator=gen, device=cuda) * 0.04 - 0.02)
    for pts, rel in ((spread, 1e-5), (cluster, 1e-4)):
        g = torch.randn((len(pts), C), generator=gen, device=cuda)
        before = LAUNCHES["trilinear_grad_kernel"]
        got = trilinear_scatter_grad(g, mn, mx, res, pts.contiguous())
        torch.cuda.synchronize()
        assert LAUNCHES["trilinear_grad_kernel"] == before + 1
        ref = trilinear_scatter_grad_plain(g, mn, mx, res, pts)
        assert got.shape == ref.shape == (*res, C)
        assert (got - ref).abs().max().item() <= rel * ref.abs().max().item()


@pytest.mark.parametrize("hierarchical", [False, True])
def test_train_step_on_the_card(cuda, gen, hierarchical):
    """One training step with every in-slice prior and latent on, through
    both kernels on the card, against the same step on the CPU (plain
    versions) with the same injected random numbers. The gradient (Adam's
    moments) and the latents agree within 1e-5 x their size (the scatter's
    atomics and the card's exp/log round differently; 2e-5 for the squared
    moment, as a square doubles a relative error). The grid within 5e-4,
    tpu3d's tolerance between its two routes: Adam's first step moves a
    voxel by lr g / (|g| + 1e-8), so where |g| is near 1e-8 a rounding-sized
    change of g moves the voxel by a share of lr (measured on an H100: one
    voxel of 114,688 by 1.7e-5)."""
    from tpu3d_torch.config import DenseConfig
    from tpu3d_torch.dense import train as TT
    from tpu3d_torch.dense.grid import VoxelGrid

    cfg = DenseConfig(grid_resolution=16, batch_size=256, num_samples=16, near=0.5, far=4.0,
                      n_coarse=8, n_fine=8, hierarchical=hierarchical, tv_sigma=0.3,
                      tv_sh=0.05, sparsity_sigma=0.02, exposure=True, sh_background=True)
    grid = torch.randn((16, 16, 16, 28), generator=gen, device=cuda) * 0.3
    grid[..., 0] = torch.randn((16, 16, 16), generator=gen, device=cuda) * 2.0
    o = torch.zeros((256, 3), device=cuda)
    o[:, 0] = -2.0
    d = torch.nn.functional.normalize(torch.randn((256, 3), generator=gen, device=cuda) * 0.4
                                      + torch.tensor([1.0, 0.0, 0.0], device=cuda), dim=-1)
    rgb = torch.rand((256, 3), generator=gen, device=cuda)
    cid = torch.randint(0, 4, (256,), generator=gen, device=cuda)
    noise = TT.draw_step_noise(cfg, grid.shape, 256, gen, cuda)
    states, losses = [], []
    before = (LAUNCHES["trilinear_kernel"], LAUNCHES["trilinear_grad_kernel"])
    for dev in (cuda, torch.device("cpu")):
        st = TT.init_state(cfg, VoxelGrid(grid.clone().to(dev), torch.full((3,), -1.5, device=dev),
                                          torch.full((3,), 1.5, device=dev)), 5, 4)
        losses.append(float(TT.train_step(st, cfg, o.to(dev), d.to(dev), rgb.to(dev),
                                          cid.to(dev),
                                          noise=TT.StepNoise(*(None if x is None else x.to(dev)
                                                               for x in noise)))))
        states.append(st)
    assert LAUNCHES["trilinear_kernel"] == before[0] + (2 if hierarchical else 1)
    assert LAUNCHES["trilinear_grad_kernel"] == before[1] + 1
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1])
    (a, b) = states
    pa, pb = a.grid.grid, b.grid.grid
    pairs = [(pa, pb), (a.optimizer.state[pa]["exp_avg"], b.optimizer.state[pb]["exp_avg"]),
             (a.optimizer.state[pa]["exp_avg_sq"], b.optimizer.state[pb]["exp_avg_sq"]),
             (a.exposure, b.exposure), (a.background, b.background)]
    for k, ((x, y), tol) in enumerate(zip(pairs, (None, 1e-5, 2e-5, 1e-5, 1e-5))):
        diff = (x.detach().cpu() - y.detach()).abs().max().item()
        assert diff <= (5e-4 if tol is None else tol * y.detach().abs().max().item()), (k, diff)
    assert (pa.detach().cpu() - grid.cpu()).abs().max().item() > 1e-3


def test_render_image_on_the_card(cuda, gen):
    """render_image through the kernel against the same render on the CPU."""
    from tpu3d_torch.dense.grid import VoxelGrid
    from tpu3d_torch.dense.render import render_image

    g = torch.randn((24, 24, 24, 28), generator=gen, device=cuda)
    g[..., 0] = g[..., 0].abs() * 20
    vg = VoxelGrid(g, torch.full((3,), -1.0, device=cuda), torch.full((3,), 1.0, device=cuda))
    o = torch.nn.functional.normalize(torch.randn((300, 3), generator=gen, device=cuda), dim=-1)
    d = torch.nn.functional.normalize(-o + 0.3 * torch.randn((300, 3), generator=gen,
                                                             device=cuda), dim=-1)
    o = 2.5 * o
    bg = torch.randn((3, 9), generator=gen, device=cuda)
    got = render_image(vg, o, d, 0.5, 4.5, 64, chunk=128, clip_aabb=True, bg_sh=bg)
    ref = render_image(VoxelGrid(*(x.cpu() for x in vg)), o.cpu(), d.cpu(), 0.5, 4.5, 64,
                       chunk=128, clip_aabb=True, bg_sh=bg.cpu())
    assert (got.cpu() - ref).abs().max().item() <= 1e-5


def test_orient_desc_kernel_matches_plain(cuda, gen):
    """Smoothed random levels, keypoints inside and on the border of their
    octave rectangle: theta within 1e-5 rad and the samples within
    sample_tolerance (1e-5 x max|g| plus what dtheta can move a sample)
    except at near-tie keypoints (< 5%). The
    kernel sums the histogram in the plain version's order and rounds as it
    does; only sincosf and PyTorch's sin/cos may differ."""
    L, H, W, K = 6, 120, 150, 512
    img = torch.randn((L, 1, H, W), generator=gen, device=cuda)
    img = torch.nn.functional.avg_pool2d(img, 5, 1, 2)[:, 0]
    gx = (torch.roll(img, -1, -1) - torch.roll(img, 1, -1)).contiguous() * 0.5
    gy = (torch.roll(img, -1, -2) - torch.roll(img, 1, -2)).contiguous() * 0.5
    ky = torch.rand(K, generator=gen, device=cuda) * (H - 1)
    kx = torch.rand(K, generator=gen, device=cuda) * (W - 1)
    lvl = torch.randint(0, L, (K,), generator=gen, device=cuda, dtype=torch.int32)
    sigma = 1.6 + torch.rand(K, generator=gen, device=cuda) * 2.0
    ymax = torch.full((K,), H - 1.001, device=cuda)
    xmax = torch.full((K,), W - 1.001, device=cuda)
    ymax[::4] = H / 2 - 1.001          # a smaller octave's rectangle
    args = (gx, gy, ky, kx, lvl, sigma, ymax, xmax)
    before = LAUNCHES["orient_desc_kernel"]
    gxs, gys, th = orient_desc_samples(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["orient_desc_kernel"] == before + 1
    rgx, rgy, rth = orient_desc_samples_plain(*args)
    dth = torch.remainder(th - rth + np.pi, 2 * np.pi) - np.pi
    ties = near_ties(*args)
    assert ties.float().mean().item() < 0.05
    agree = dth.abs() <= 1e-5
    assert bool((agree | ties).all())
    tol = sample_tolerance(gx, gy, sigma, dth.abs())
    assert bool(((gxs - rgx).abs() <= tol)[agree].all())
    assert bool(((gys - rgy).abs() <= tol)[agree].all())


def test_bundle_adjust_on_the_card(cuda, gen):
    """The Schur-CG LM on the card against the CPU on one problem: the same
    number of iterations (stopped by max_iters before convergence), cost
    within 1e-4 relative, cameras and points within 1e-4 (index_add_'s
    atomics sum in another order than the CPU's)."""
    C, P = 5, 400
    rng = np.random.default_rng(0)
    X = np.stack([rng.uniform(-2, 2, P), rng.uniform(-2, 2, P), rng.uniform(5, 9, P)], -1)
    cams = np.zeros((C, 6))
    cams[:, 3] = np.arange(C) * 0.4 - 0.8
    ci = np.repeat(np.arange(C), P)
    pi = np.tile(np.arange(P), C)
    Xc = X[pi] + cams[ci, 3:]
    uv = Xc[:, :2] / Xc[:, 2:] + rng.normal(0, 3e-4, (C * P, 2))
    # cameras 0 and 1 frozen at their true poses: the scale gauge is fixed
    cams0 = cams + np.concatenate([np.zeros((2, 6)), rng.normal(0, 0.02, (C - 2, 6))])
    X0 = X + rng.normal(0, 0.05, X.shape)
    fixed = np.zeros(C)
    fixed[:2] = 1.0
    arrays = [np.asarray(a, np.float32) for a in (cams0, X0)] + [ci, pi] + [
        np.asarray(a, np.float32) for a in (uv, np.ones(C * P), fixed)]
    cpu = bundle_adjust(*(torch.from_numpy(a) for a in arrays), max_iters=5,
                        robust_delta=3e-3)
    gpu = bundle_adjust(*(torch.from_numpy(a).to(cuda) for a in arrays), max_iters=5,
                        robust_delta=3e-3)
    assert gpu.n_iters == cpu.n_iters == 5
    assert abs(gpu.cost.item() - cpu.cost.item()) <= 1e-4 * cpu.cost.item()
    assert (gpu.cams.cpu() - cpu.cams).abs().max().item() <= 1e-4
    assert (gpu.points.cpu() - cpu.points).abs().max().item() <= 1e-4
