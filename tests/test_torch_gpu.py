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
from tpu3d_torch.kernels.distance import (descriptor_top2, descriptor_top2_plain, mutual_top2,
                                          mutual_top2_plain)
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
    beyond the stack too: bit for bit (the kernel rounds each product as
    the plain version does)."""
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
        assert torch.equal(got, ref)
    assert LAUNCHES["patch_sample_kernel"] == before + 2


@pytest.mark.parametrize("S", [1, 27, 121, 256, 300])
@pytest.mark.parametrize("two", [False, True], ids=["C1", "C2"])
@pytest.mark.parametrize("with_dlvl", [False, True], ids=["lvl", "dlvl"])
def test_patch_sample_kernel_shapes(cuda, gen, S, two, with_dlvl):
    """The main path's sample counts (1, 27, 121, 256) and one above them,
    one and two channels, with and without level offsets, K = 301 (K x S
    not a multiple of the 256-thread block), and coordinates on the last
    row and column and beyond: max |err| = 0."""
    L, H, W, K = 5, 40, 57, 301
    gx = torch.randn((L, H, W), generator=gen, device=cuda)
    gy = torch.randn((L, H, W), generator=gen, device=cuda) if two else None
    ys = torch.rand((K, S), generator=gen, device=cuda) * (H + 2) - 1
    xs = torch.rand((K, S), generator=gen, device=cuda) * (W + 2) - 1
    ys[::3, 0] = H - 1.0              # the last row and column, exactly
    xs[1::3, 0] = W - 1.0
    ys[2::3, -1] = H - 1.001
    xs[2::3, -1] = W - 1.0
    lvl = torch.randint(0, L, (K,), generator=gen, device=cuda, dtype=torch.int32)
    dlvl = (torch.randint(-1, 2, (S,), generator=gen, device=cuda, dtype=torch.int32)
            if with_dlvl else None)
    got = sample_gradient_patches(gx, gy, ys, xs, lvl, dlvl)
    torch.cuda.synchronize()
    ref = sample_gradient_patches_plain(gx, gy, ys, xs, lvl, dlvl)
    assert got.shape == ref.shape == (K, 2 if two else 1, S)
    assert torch.equal(got, ref)


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


@pytest.mark.parametrize("K0, K1, D", [(300, 517, 128), (300, 517, 130), (129, 64, 520),
                                       (600, 517, 256)],
                         ids=["ragged", "D130-scalar-copies", "D520", "D256-superpoint"])
def test_mutual_top2_kernel_matches_plain(cuda, gen, K0, K1, D):
    """One launch for both directions, ragged tiles (K not a multiple of
    128) and masks, on the 16-byte copy path (D = 128), the 4-byte one
    (D = 130) and a D above the first kernel's 384 limit: best and second
    within 1e-5, the row argmax equal wherever the row's top-2 gap exceeds
    1e-5, col_arg equal wherever the column's does (a masked column gives
    row 0 in both), and the rows equal to descriptor_top2's launch."""
    B = 3
    q, k = _unit((B, K0, D), gen, cuda), _unit((B, K1, D), gen, cuda)
    vq = (torch.rand((B, K0), generator=gen, device=cuda) < 0.9).float()
    vk = (torch.rand((B, K1), generator=gen, device=cuda) < 0.9).float()
    before = LAUNCHES["top2_kernel"]
    best, second, arg, col_arg = mutual_top2(q, k, vq, vk)
    torch.cuda.synchronize()
    assert LAUNCHES["top2_kernel"] == before + 1
    assert col_arg.shape == (B, K1) and col_arg.dtype == torch.int32
    pb, ps, pa, pc = mutual_top2_plain(q, k, vq, vk)
    assert (best - pb).abs().max().item() <= 1e-5
    assert (second - ps).abs().max().item() <= 1e-5
    assert bool(((arg == pa) | ((pb - ps) <= 1e-5)).all())
    cb, cs, _ = descriptor_top2_plain(k, q, vk, vq)
    clear = ((cb - cs) > 1e-5) | (vk == 0)
    assert float(clear.float().mean()) > 0.99
    assert torch.equal(col_arg[clear], pc[clear])
    rb, rs, ra = descriptor_top2(q, k, vq, vk)
    assert torch.equal(rb, best) and torch.equal(rs, second) and torch.equal(ra, arg)


def test_mutual_top2_kernel_ties_and_masks(cuda):
    """test_top2_kernel_ties_and_masks with the column output: a masked key
    column gives row 0; query rows 0 and 3 are equal, so their columns'
    ties go to row 0."""
    q = torch.tensor([[[1.0, 0.0], [0.0, 1.0], [0.6, 0.8], [1.0, 0.0]]], device=cuda)
    k = torch.tensor([[[0.0, 1.0], [1.0, 0.0], [1.0, 0.0], [0.6, 0.8]]], device=cuda)
    vq = torch.tensor([[1.0, 0.0, 1.0, 1.0]], device=cuda)
    vk = torch.tensor([[1.0, 1.0, 1.0, 0.0]], device=cuda)
    best, second, arg, col_arg = mutual_top2(q, k, vq, vk)
    np.testing.assert_allclose(best[0].cpu().numpy(), [1.0, -2.0, 0.8, 1.0], atol=1e-7)
    np.testing.assert_allclose(second[0].cpu().numpy(), [1.0, -2.0, 0.6, 1.0], atol=1e-7)
    np.testing.assert_array_equal(arg[0].cpu().numpy(), [1, 0, 0, 1])
    np.testing.assert_array_equal(col_arg[0].cpu().numpy(), [2, 0, 0, 0])


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


@pytest.mark.parametrize("C", [28, 1, 3, 32])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset4"])
@pytest.mark.parametrize("N", [4001, 8, 0])
def test_trilinear_kernel_vector_and_scalar_paths(cuda, gen, C, aligned, N):
    """The float4 path (C % 4 == 0 on a 16-byte aligned grid) and the
    scalar one (C = 1, 3, or a grid view 4 bytes into its storage, so its
    pointer is not 16-byte aligned), N not a multiple of the 32 samples a
    warp takes, one warp's group exactly, and N = 0: bit for bit, flags
    identical."""
    from tpu3d_torch.kernels.trilinear import vector_width

    X, Y, Z = 7, 10, 13
    store = torch.randn(X * Y * Z * C + 1, generator=gen, device=cuda)
    grid = (store[:-1] if aligned else store[1:]).view(X, Y, Z, C)
    assert grid.is_contiguous() and (grid.data_ptr() % 16 == 0) == aligned
    want = 4 if C % 4 == 0 and aligned else 1
    assert vector_width(C, grid.data_ptr(), torch.empty(16, device=cuda).data_ptr()) == want
    mn = torch.tensor([-1.0, -2.0, 0.5], device=cuda)
    mx = torch.tensor([1.0, 0.0, 2.5], device=cuda)
    pts = mn + (mx - mn) * (torch.rand((N, 3), generator=gen, device=cuda) * 1.2 - 0.1)
    if N >= 8:
        pts[:8] = torch.stack([torch.where(torch.tensor([(k >> a) & 1 for a in range(3)],
                                                        device=cuda) > 0, mx, mn)
                               for k in range(8)])
    before = LAUNCHES["trilinear_kernel"]
    got, got_in = trilinear_sample(grid, mn, mx, pts)
    torch.cuda.synchronize()
    assert LAUNCHES["trilinear_kernel"] == before + 1
    ref, ref_in = trilinear_sample_plain(grid, mn, mx, pts)
    assert got.shape == ref.shape == (N, C) and got_in.shape == (N,)
    assert torch.equal(got_in, ref_in)
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


def _step_on_card_and_cpu(cuda, gen, cfg, grid, lo, hi, occ=None, base=None, sdf=False):
    """One training step (the SDF step with ``sdf``) on the card and the
    same step on the CPU (plain versions) with the same injected random
    numbers: (states, losses, trilinear and scatter launches of the card's
    step)."""
    from tpu3d_torch.dense import train as TT
    from tpu3d_torch.dense.grid import VoxelGrid

    o = torch.zeros((256, 3), device=cuda)
    o[:, 0] = -2.0
    d = torch.nn.functional.normalize(torch.randn((256, 3), generator=gen, device=cuda) * 0.4
                                      + torch.tensor([1.0, 0.0, 0.0], device=cuda), dim=-1)
    rgb = torch.rand((256, 3), generator=gen, device=cuda)
    cid = torch.randint(0, 4, (256,), generator=gen, device=cuda)
    noise = TT.draw_step_noise(TT.sdf_noise_config(cfg) if sdf else cfg, grid.shape, 256, gen,
                               cuda)
    states, losses, launched = [], [], None
    for dev in (cuda, torch.device("cpu")):
        before = (LAUNCHES["trilinear_kernel"], LAUNCHES["trilinear_grad_kernel"])
        st = TT.init_state(cfg, VoxelGrid(grid.clone().to(dev), torch.tensor(lo, device=dev),
                                          torch.tensor(hi, device=dev)), 5, 4)
        kw = {} if sdf else dict(occ=None if occ is None else occ.to(dev),
                                 base=None if base is None else VoxelGrid(*(x.to(dev)
                                                                            for x in base)))
        losses.append(float((TT.sdf_train_step if sdf else TT.train_step)(
            st, cfg, o.to(dev), d.to(dev), rgb.to(dev), cid.to(dev),
            noise=TT.StepNoise(*(None if x is None else x.to(dev) for x in noise)), **kw)))
        states.append(st)
        launched = launched or (LAUNCHES["trilinear_kernel"] - before[0],
                                LAUNCHES["trilinear_grad_kernel"] - before[1])
    return states, losses, launched


def _assert_steps_agree(states, losses, grid, optimizer="adam"):
    """Loss within 1e-5 relative; the optimizer's moments and the latents
    within 1e-5 x their size (2e-5 for Adam's squared moment); the grid
    within 5e-4 (see test_train_step_on_the_card)."""
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1])
    a, b = states
    pa, pb = a.grid.grid, b.grid.grid
    if optimizer == "rmsprop":
        pairs = [(pa, pb, None), (a.optimizer.state[pa]["nu"], b.optimizer.state[pb]["nu"], 2e-5)]
    else:
        pairs = [(pa, pb, None),
                 (a.optimizer.state[pa]["exp_avg"], b.optimizer.state[pb]["exp_avg"], 1e-5),
                 (a.optimizer.state[pa]["exp_avg_sq"], b.optimizer.state[pb]["exp_avg_sq"],
                  2e-5)]
    pairs += [(x, y, 1e-5) for x, y in ((a.exposure, b.exposure), (a.background, b.background))
              if x is not None]
    for k, (x, y, tol) in enumerate(pairs):
        diff = (x.detach().cpu() - y.detach()).abs().max().item()
        assert diff <= (5e-4 if tol is None else tol * y.detach().abs().max().item()), (k, diff)
    assert (pa.detach().cpu() - grid.cpu()).abs().max().item() > 1e-3


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

    cfg = DenseConfig(grid_resolution=16, batch_size=256, num_samples=16, near=0.5, far=4.0,
                      n_coarse=8, n_fine=8, hierarchical=hierarchical, tv_sigma=0.3,
                      tv_sh=0.05, sparsity_sigma=0.02, exposure=True, sh_background=True)
    grid = torch.randn((16, 16, 16, 28), generator=gen, device=cuda) * 0.3
    grid[..., 0] = torch.randn((16, 16, 16), generator=gen, device=cuda) * 2.0
    states, losses, launched = _step_on_card_and_cpu(cuda, gen, cfg, grid, [-1.5] * 3,
                                                     [1.5] * 3)
    assert launched == (2 if hierarchical else 1, 1)
    _assert_steps_agree(states, losses, grid)


def test_sdf_step_on_the_card(cuda, gen):
    """One SDF step (box-clipped band, valid-ray MSE) with every prior and
    latent on, through both kernels on the card, against the same step on
    the CPU with the same injected random numbers, to the plenoxel step's
    limits (test_train_step_on_the_card). A third of the rays miss the box."""
    from tpu3d_torch.config import DenseConfig

    cfg = DenseConfig(grid_resolution=16, batch_size=256, num_samples=16, tv_sigma=0.3,
                      tv_sh=0.05, sparsity_sigma=0.02, exposure=True, sh_background=True)
    grid = torch.randn((16, 16, 16, 28), generator=gen, device=cuda) * 0.3
    grid[..., 0] = torch.randn((16, 16, 16), generator=gen, device=cuda) * 2.0
    states, losses, launched = _step_on_card_and_cpu(cuda, gen, cfg, grid, [-0.6] * 3,
                                                     [0.6] * 3, sdf=True)
    assert launched == (1, 1)
    _assert_steps_agree(states, losses, grid)


def _learned_inputs(cuda, gen):
    from tpu3d_torch.features.disk import DiskUNet
    from tpu3d_torch.matching.lightglue import LightGlue

    torch.manual_seed(0)
    disk, lg = DiskUNet().eval(), LightGlue(input_dim=128, n_layers=2).eval()
    x = torch.rand((2, 3, 64, 96), generator=gen, device=cuda)
    return disk, lg, x


def test_disk_on_the_card(cuda, gen):
    """DiskUNet on the card in full f32 against the CPU from the same
    weights: the 129-channel map within 1e-4 x its size, and detection: at
    least 99% of the card's valid keypoints are the CPU's (a score within
    rounding of a window neighbour's can flip an NMS decision)."""
    from tpu3d_torch import f32_scope
    from tpu3d_torch.features.disk import extract_disk

    disk, _, x = _learned_inputs(cuda, gen)
    with f32_scope(), torch.no_grad():
        ref = disk(x.cpu())
        got = disk.to(cuda)(x).cpu()
        assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
        f_gpu = extract_disk(disk, x.permute(0, 2, 3, 1), 256)
        f_cpu = extract_disk(disk.cpu(), x.cpu().permute(0, 2, 3, 1), 256)
    for b in range(2):
        a = {tuple(p) for p in f_gpu.keypoints[b][f_gpu.valid[b]].cpu().tolist()}
        c = {tuple(p) for p in f_cpu.keypoints[b][f_cpu.valid[b]].tolist()}
        assert len(a & c) >= 0.99 * len(a)


def test_lightglue_on_the_card(cuda, gen):
    """LightGlue (2 layers) on the card in full f32 against the CPU with
    padding masks: log-assignment scores within 1e-4 + 2e-5 x |score|."""
    from tpu3d_torch import f32_scope

    _, lg, _ = _learned_inputs(cuda, gen)
    M, N = 64, 80
    kp0 = torch.rand((1, M, 2), generator=gen, device=cuda) * 480
    kp1 = torch.rand((1, N, 2), generator=gen, device=cuda) * 480
    d0 = torch.randn((1, M, 128), generator=gen, device=cuda)
    d1 = torch.randn((1, N, 128), generator=gen, device=cuda)
    size = torch.tensor([[640.0, 480.0]], device=cuda)
    v0 = (torch.arange(M, device=cuda) < M - 10).float()[None]
    v1 = (torch.arange(N, device=cuda) < N - 16).float()[None]
    args = (kp0, d0, size, kp1, d1, size, v0, v1)
    with f32_scope(), torch.no_grad():
        ref = lg(*(a.cpu() for a in args))
        got = lg.to(cuda)(*args).cpu()
    assert bool(((got - ref).abs() <= 1e-4 + 2e-5 * ref.abs()).all())


@pytest.mark.parametrize("option", ["cascade", "occupancy"])
def test_cascade_and_occupancy_steps_on_the_card(cuda, gen, option):
    """One cascade step (hierarchical, rmsprop, a zero (8, 16, 16) detail
    layer against a frozen 16^3 base: four forward launches, the base and
    the detail in each pass) and one occupancy-guided step (an occupancy
    grid with its middle cells occupied) on the card, against the same
    steps on the CPU's plain path with the same injected random numbers, at
    test_train_step_on_the_card's tolerances."""
    from tpu3d_torch.config import DenseConfig

    base_grid = torch.randn((16, 16, 16, 28), generator=gen, device=cuda) * 0.3
    base_grid[..., 0] = torch.randn((16, 16, 16), generator=gen, device=cuda) * 2.0
    kw = dict(grid_resolution=16, batch_size=256, num_samples=16, near=0.5, far=4.0,
              n_coarse=8, n_fine=8)
    if option == "cascade":
        cfg = DenseConfig(hierarchical=True, optimizer="rmsprop", **kw)
        base = (base_grid, torch.full((3,), -1.5, device=cuda), torch.full((3,), 1.5, device=cuda))
        grid = torch.zeros((8, 16, 16, 28), device=cuda)
        states, losses, launched = _step_on_card_and_cpu(
            cuda, gen, cfg, grid, [-0.6, -0.8, -0.7], [0.9, 0.8, 0.6], base=base)
        assert launched == (4, 1)
    else:
        cfg = DenseConfig(occupancy_prune=True, occupancy_probes=32, **kw)
        occ = torch.zeros((4, 4, 4), dtype=torch.bool, device=cuda)
        occ[1:3, 1:3, 1:3] = True
        states, losses, launched = _step_on_card_and_cpu(cuda, gen, cfg, base_grid, [-1.5] * 3,
                                                         [1.5] * 3, occ=occ)
        grid = base_grid
        assert launched == (1, 1)
    _assert_steps_agree(states, losses, grid, cfg.optimizer)


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
    _orient_desc_case(cuda, gen, 512)


def test_orient_desc_kernel_partial_block(cuda, gen):
    """As above with K = 515: the last block of eight keypoints (one warp
    each) holds three."""
    _orient_desc_case(cuda, gen, 515)


def _orient_desc_case(cuda, gen, K):
    L, H, W = 6, 120, 150
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
    assert gxs.shape == gys.shape == (K, 256) and th.shape == (K,)
    dth = torch.remainder(th - rth + np.pi, 2 * np.pi) - np.pi
    ties = near_ties(*args)
    assert ties.float().mean().item() < 0.05
    agree = dth.abs() <= 1e-5
    assert bool((agree | ties).all())
    tol = sample_tolerance(gx, gy, sigma, dth.abs())
    assert bool(((gxs - rgx).abs() <= tol)[agree].all())
    assert bool(((gys - rgy).abs() <= tol)[agree].all())


def _ba_problem():
    """Five cameras (0 and 1 frozen at their true poses: the scale gauge is
    fixed) and 400 points, perturbed by 0.1 rad / m on three cameras and
    0.2 on the points; arguments of bundle_adjust as numpy arrays."""
    C, P = 5, 400
    rng = np.random.default_rng(0)
    X = np.stack([rng.uniform(-2, 2, P), rng.uniform(-2, 2, P), rng.uniform(5, 9, P)], -1)
    cams = np.zeros((C, 6))
    cams[:, 3] = np.arange(C) * 0.4 - 0.8
    ci = np.repeat(np.arange(C), P)
    pi = np.tile(np.arange(P), C)
    Xc = X[pi] + cams[ci, 3:]
    uv = Xc[:, :2] / Xc[:, 2:] + rng.normal(0, 3e-4, (C * P, 2))
    cams0 = cams + np.concatenate([np.zeros((2, 6)), rng.normal(0, 0.1, (C - 2, 6))])
    X0 = X + rng.normal(0, 0.2, X.shape)
    fixed = np.zeros(C)
    fixed[:2] = 1.0
    return [np.asarray(a, np.float32) for a in (cams0, X0)] + [ci, pi] + [
        np.asarray(a, np.float32) for a in (uv, np.ones(C * P), fixed)]


_BA_KW = dict(max_iters=4, robust_delta=3e-3)


def test_bundle_adjust_on_the_card(cuda):
    """The Schur-CG LM on the card: two runs give the same bits (cameras,
    points, cost and damping; the segment sums add in a fixed order), and
    against the CPU on one problem the same iterations and damping (the
    same accept decisions), cost within 1e-4 relative, cameras and points
    within 1e-4 (f32 sums in other orders). The problem stops by max_iters
    before convergence, with every step clear of the accept edge
    (tests/test_torch_reconstruct.py::
    test_bundle_adjust_card_problem_has_clear_steps). At a 0.02 / 0.05
    perturbation and five steps the last step cut the cost by ~1e-6
    relative, and one run in six on the card rejected it."""
    arrays = _ba_problem()
    cpu = bundle_adjust(*(torch.from_numpy(a) for a in arrays), **_BA_KW)
    runs = [bundle_adjust(*(torch.from_numpy(a).to(cuda) for a in arrays), **_BA_KW)
            for _ in range(2)]
    for name in ("cams", "points", "cost", "lam"):
        assert torch.equal(getattr(runs[0], name), getattr(runs[1], name)), name
    gpu = runs[0]
    assert gpu.n_iters == runs[1].n_iters == cpu.n_iters == 4
    assert gpu.lam.item() == cpu.lam.item()
    assert abs(gpu.cost.item() - cpu.cost.item()) <= 1e-4 * cpu.cost.item()
    assert (gpu.cams.cpu() - cpu.cams).abs().max().item() <= 1e-4
    assert (gpu.points.cpu() - cpu.points).abs().max().item() <= 1e-4


def _small_scene():
    """chip_smoke's synthetic scene cut to 8 views of 320x240, with the
    default config at its focal and 512 keypoints."""
    import dataclasses

    from chip_smoke import make_scene
    from tpu3d_torch.config import CameraConfig, PipelineConfig

    sc = make_scene(seed=0, n_views=8, width=320, height=240)
    cfg = PipelineConfig()
    cam = CameraConfig(focal_length=sc["focal"])
    cfg = dataclasses.replace(cfg, camera=cam, sfm=dataclasses.replace(cfg.sfm, camera=cam),
                              frontend=dataclasses.replace(cfg.frontend, max_keypoints=512))
    return sc, cfg


def test_global_mode_on_the_card(cuda):
    """reconstruct(mode="global") on the card, twice: every camera
    registered at under a pixel, patch_sample and top2 launched, and the
    second run the same registered set and the same bits in the cameras
    (BA's sums add in a fixed order; the pose graph is numpy)."""
    from tpu3d_torch.kernels import reset_launches
    from tpu3d_torch.sfm import pipeline as P

    sc, cfg = _small_scene()
    runs = []
    for _ in range(2):
        reset_launches()
        rec, _ = P.reconstruct((sc["gray"], sc["rgb"]), cfg, verbose=False, mode="global",
                               device=cuda)
        assert LAUNCHES["patch_sample_kernel"] > 0 and LAUNCHES["top2_kernel"] > 0
        runs.append(rec)
    assert len(runs[0].registered) == 8 and runs[0].mean_reproj_px <= 1.0
    np.testing.assert_array_equal(runs[0].registered, runs[1].registered)
    np.testing.assert_array_equal(runs[0].cams, runs[1].cams)


def test_staged_functions_on_the_card(cuda, tmp_path):
    """extract -> match -> reconstruct(from_matches) -> export on the card
    give full's registered count, points and mean reprojection error, and
    tpu3d's artifact files."""
    from tpu3d_torch import cli

    sc, cfg = _small_scene()
    art = tmp_path / "art"
    cli.extract((sc["gray"], sc["rgb"]), str(art), cfg, device=cuda)
    cli.match(str(art), cfg, device=cuda)
    got = cli.reconstruct(str(art), cfg, from_matches=True, device=cuda)
    exported = cli.export(str(art), device=cuda)
    ref = cli.full((sc["gray"], sc["rgb"]), str(tmp_path / "full"), cfg, device=cuda)
    assert (got["registered"], got["points"], got["mean_reproj_px"]) == \
        (ref["registered"], ref["points"], ref["mean_reproj_px"])
    for name in ("features.npz", "features_meta.json", "pairs_meta.json", "matches.npz",
                 "reconstruction.npz", "reconstruction_meta.json"):
        assert (art / name).exists(), name
    assert "reconstructed_img/cameras_extrinsic/points_3d/result.ply" in exported["written"]
