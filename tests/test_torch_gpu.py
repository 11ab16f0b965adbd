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


def _scatter_inputs(cuda, gen):
    """(res, box, [(points, label)]): points inside, outside and on the box,
    and 1,500 in one cell (every sample in one run of the kernel's bins)."""
    res = (8, 16, 16)
    mn = torch.full((3,), -1.0, device=cuda)
    mx = torch.full((3,), 1.0, device=cuda)
    spread = torch.rand((700, 3), generator=gen, device=cuda) * 2.6 - 1.3
    spread[:5] = torch.tensor([[-1, -1, -1], [1, 1, 1], [0, 1, -1], [1, 0, 0], [-1, 1, 1.0]],
                              device=cuda)
    cluster = torch.tensor([0.1, 0.2, -0.3], device=cuda) + (
        torch.rand((1500, 3), generator=gen, device=cuda) * 0.04 - 0.02)
    return res, (mn, mx), (spread, cluster)


@pytest.mark.parametrize("C", [28, 3])
def test_trilinear_grad_kernel_matches_plain(cuda, gen, C):
    """The scatter against its plain version run on a CPU copy of the
    inputs: points inside, outside and on the box, and 1,500 in one cell
    (the conflict-heavy case), on the float4 path (C = 28) and the scalar
    one (C = 3). The kernel sums each element in the plain version's order
    on the CPU (corner, then sample), so bit for bit."""
    from tpu3d_torch.kernels.trilinear_grad import (trilinear_scatter_grad,
                                                    trilinear_scatter_grad_plain)

    res, (mn, mx), clouds = _scatter_inputs(cuda, gen)
    for pts in clouds:
        g = torch.randn((len(pts), C), generator=gen, device=cuda)
        before = LAUNCHES["trilinear_grad_kernel"]
        got = trilinear_scatter_grad(g, mn, mx, res, pts.contiguous())
        torch.cuda.synchronize()
        assert LAUNCHES["trilinear_grad_kernel"] == before + 1
        ref = trilinear_scatter_grad_plain(g.cpu(), mn.cpu(), mx.cpu(), res, pts.cpu())
        assert got.shape == ref.shape == (*res, C)
        assert torch.equal(got.cpu().view(torch.int32), ref.view(torch.int32))


def test_scatter_and_train_step_repeat_bit_for_bit(cuda, gen):
    """Two launches of the scatter on copies of its inputs (other
    addresses), and two training steps (every prior and latent on) from one
    state with the same draws, give the same bits."""
    from tpu3d_torch.config import DenseConfig
    from tpu3d_torch.dense import train as TT
    from tpu3d_torch.dense.grid import VoxelGrid
    from tpu3d_torch.kernels.trilinear_grad import trilinear_scatter_grad

    res, (mn, mx), clouds = _scatter_inputs(cuda, gen)
    for pts in clouds:
        g = torch.randn((len(pts), 28), generator=gen, device=cuda)
        first = trilinear_scatter_grad(g, mn, mx, res, pts.contiguous())
        second = trilinear_scatter_grad(g.clone(), mn.clone(), mx.clone(), res, pts.clone())
        assert torch.equal(first.view(torch.int32), second.view(torch.int32))

    cfg = DenseConfig(grid_resolution=16, batch_size=256, num_samples=16, near=0.5, far=4.0,
                      tv_sigma=0.3, tv_sh=0.05, sparsity_sigma=0.02, exposure=True,
                      sh_background=True)
    grid = torch.randn((16, 16, 16, 28), generator=gen, device=cuda) * 0.3
    o = torch.zeros((256, 3), device=cuda)
    o[:, 0] = -2.0
    d = torch.nn.functional.normalize(torch.randn((256, 3), generator=gen, device=cuda) * 0.4
                                      + torch.tensor([1.0, 0.0, 0.0], device=cuda), dim=-1)
    rgb = torch.rand((256, 3), generator=gen, device=cuda)
    cid = torch.randint(0, 4, (256,), generator=gen, device=cuda)
    noise = TT.draw_step_noise(cfg, grid.shape, 256, gen, cuda)
    runs = []
    for _ in range(2):
        st = TT.init_state(cfg, VoxelGrid(grid.clone(), torch.tensor([-1.5] * 3, device=cuda),
                                          torch.tensor([1.5] * 3, device=cuda)), 5, 4)
        loss = TT.train_step(st, cfg, o, d, rgb, cid, noise=noise)
        p = st.grid.grid
        runs.append([loss.detach(), p.detach(), *st.optimizer.state[p].values(),
                     st.exposure, st.background])
    for a, b in zip(*runs):
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b)


def _rmsprop_inputs(cuda, gen, shape):
    """p, a gradient with every fifth element zero, and a second moment
    with every third element zero (nu + eps at its smallest)."""
    g = torch.randn(shape, generator=gen, device=cuda) * 0.05
    g.view(-1)[::5] = 0.0
    p = torch.randn(shape, generator=gen, device=cuda)
    nu = torch.rand(shape, generator=gen, device=cuda) * 1e-3
    nu.view(-1)[::3] = 0.0
    return p, g, nu


def _offset_copy(t, offset):
    """A contiguous copy of ``t`` whose data starts ``offset`` floats past
    the start of its allocation (the allocator's blocks are 512-B aligned)."""
    out = torch.empty(t.numel() + offset, device=t.device)[offset:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("shape, offsets", [((8, 16, 16, 28), (0, 0, 0)),
                                            ((1_000_003,), (0, 0, 0)),
                                            ((4099,), (1, 1, 1)), ((4099,), (1, 2, 3))],
                         ids=["grid", "ragged_tail", "head_peel", "unaligned_scalar"])
@pytest.mark.parametrize("lr_kind", ["tensor", "float"])
def test_rmsprop_kernel_matches_plain(cuda, gen, shape, offsets, lr_kind):
    """rmsprop_kernel against rmsprop_update_plain on the same card inputs,
    the lr a 0-d device tensor or a Python float: the detail grid's layout;
    1,000,003 elements (a ragged tail of 3 after the vectors); p, g and nu
    starting 4 bytes past a 16-byte boundary (a head of 3 scalar elements);
    p, g and nu at different offsets within 16 bytes (every element
    scalar). nu bit for bit; p within one ulp (the kernel subtracts the
    rounded product s * g, torch's addcmul may contract it into an FMA). On
    an H100 with torch 2.11 p held bit for bit too. Two launches on fresh
    copies give the same bits, and each counts one launch."""
    from tpu3d_torch.kernels.rmsprop import rmsprop_update, rmsprop_update_plain

    p, g, nu = _rmsprop_inputs(cuda, gen, shape)
    lr = torch.tensor(0.01, device=cuda) if lr_kind == "tensor" else 0.01
    ref_p, ref_nu = p.clone(), nu.clone()
    rmsprop_update_plain(ref_p, g, ref_nu, lr, 0.95, 1e-8)
    before = LAUNCHES["rmsprop_kernel"]
    outs = []
    for _ in range(2):
        pk, gk, nk = (_offset_copy(t, k) for t, k in zip((p, g, nu), offsets))
        assert [t.data_ptr() % 16 for t in (pk, gk, nk)] == [4 * k % 16 for k in offsets]
        rmsprop_update(pk, gk, nk, lr, 0.95, 1e-8)
        outs.append((pk, nk))
    torch.cuda.synchronize()
    assert LAUNCHES["rmsprop_kernel"] == before + 2
    (pa, na), (pb, nb) = outs
    assert torch.equal(pa.view(torch.int32), pb.view(torch.int32))
    assert torch.equal(na.view(torch.int32), nb.view(torch.int32))
    assert torch.equal(na.view(torch.int32), ref_nu.view(torch.int32))
    ulp = torch.nextafter(ref_p.abs(), torch.full_like(ref_p, float("inf"))) - ref_p.abs()
    assert bool(((pa - ref_p).abs() <= ulp).all())
    assert (pa - p).abs().max().item() > 1e-3


def test_rmsprop_kernel_in_a_cuda_graph(cuda, gen):
    """One update captured in a CUDA graph, the lr a 0-d device tensor,
    then replayed twice after the lr has changed: each replay equals the
    eager update at the lr it found, bit for bit (the kernel reads the lr
    on the device)."""
    from tpu3d_torch.kernels.rmsprop import rmsprop_update
    from tpu3d_torch.utils.cuda_graph import capture

    p0, g, nu0 = _rmsprop_inputs(cuda, gen, (8, 16, 16, 28))
    lr = torch.tensor(0.01, device=cuda)
    p, nu = p0.clone(), nu0.clone()
    rmsprop_update(p0.clone(), g, nu0.clone(), lr, 0.95, 1e-8)   # eager first, as a warm-up chunk
    graph = capture(lambda: rmsprop_update(p, g, nu, lr, 0.95, 1e-8))
    torch.cuda.synchronize()
    assert torch.equal(p, p0) and torch.equal(nu, nu0)
    ref_p, ref_nu = p0.clone(), nu0.clone()
    for new_lr in (0.003, 0.02):
        lr.fill_(new_lr)
        graph.replay()
        rmsprop_update(ref_p, g, ref_nu, torch.tensor(new_lr, device=cuda), 0.95, 1e-8)
        torch.cuda.synchronize()
        assert torch.equal(p.view(torch.int32), ref_p.view(torch.int32)), new_lr
        assert torch.equal(nu.view(torch.int32), ref_nu.view(torch.int32)), new_lr


def test_rmsprop_step_launches_once_per_parameter_on_the_card(cuda, gen):
    """RMSprop.step on CUDA parameters launches rmsprop_kernel once for
    each parameter with a gradient and leaves the one without as it was;
    nu equals the plain version's bit for bit."""
    from tpu3d_torch.dense.train import RMSprop
    from tpu3d_torch.kernels.rmsprop import rmsprop_update_plain

    params = [torch.nn.Parameter(torch.randn(s, generator=gen, device=cuda))
              for s in ((8, 16, 16, 28), (1000,), (7, 3))]
    grads = [torch.randn(t.shape, generator=gen, device=cuda) * 0.05 for t in params[:2]]
    refs = [(t.detach().clone(), torch.zeros_like(t)) for t in params]
    opt = RMSprop(params, lr=torch.tensor(0.01, device=cuda))
    for t, g in zip(params, grads):
        t.grad = g
    before = LAUNCHES["rmsprop_kernel"]
    opt.step()
    torch.cuda.synchronize()
    assert LAUNCHES["rmsprop_kernel"] == before + 2
    for (ref_p, ref_nu), g in zip(refs, grads):
        rmsprop_update_plain(ref_p, g, ref_nu, torch.tensor(0.01, device=cuda), 0.95, 1e-8)
    for t, (ref_p, ref_nu) in zip(params, refs):
        assert torch.equal(opt.state[t]["nu"], ref_nu)
    assert torch.equal(params[2].detach(), refs[2][0])


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
    moments) and the latents agree within 1e-5 x their size (the card's
    exp/log round differently from the CPU's, though the scatter equals its
    plain version bit for bit; 2e-5 for the squared moment, as a square
    doubles a relative error). The grid within 5e-4,
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


def test_graph_draws_equal_eager_draws(cuda):
    """A training step's draws captured in a CUDA graph from a registered
    generator: two replays give the two next eager draws of a generator
    seeded alike, bit for bit, and leave it where the eager calls do."""
    from tpu3d_torch.config import DenseConfig
    from tpu3d_torch.dense.train import draw_step_noise
    from tpu3d_torch.utils.cuda_graph import capture

    cfg = DenseConfig(hierarchical=True, n_coarse=8, n_fine=8, tv_sigma=0.3,
                      sparsity_sigma=0.02)
    eager_gen, graph_gen = torch.Generator(device=cuda), torch.Generator(device=cuda)
    eager_gen.manual_seed(3)
    graph_gen.manual_seed(3)
    shape = (16, 12, 20, 28)
    eager = [draw_step_noise(cfg, shape, 256, eager_gen, cuda) for _ in range(2)]
    out = []
    graph = capture(lambda: out.append(draw_step_noise(cfg, shape, 256, graph_gen, cuda)),
                    [graph_gen])
    for want in eager:
        graph.replay()
        torch.cuda.synchronize()
        for got, ref in zip(out[0], want):
            assert torch.equal(got, ref)
    after = (torch.rand(8, generator=eager_gen, device=cuda),
             torch.rand(8, generator=graph_gen, device=cuda))
    assert torch.equal(*after)


@pytest.mark.parametrize("option", ["adam", "cascade", "sdf"])
def test_multi_step_graph_matches_eager_on_the_card(cuda, gen, option):
    """make_multi_step on the card against the same steps called one by
    one, from one seed: chunks of 4 (the first the warm-up, run eagerly;
    the second captured and replayed; the third replayed) and a tail of 2
    (eager). Losses, grid, moments and latents bit for bit (every sum of
    the step has a fixed order, the scatter's too), two replays, and the
    kernel launches of each replay credited: as many as the eager steps
    count."""
    from tpu3d_torch.config import DenseConfig
    from tpu3d_torch.dense import train as TT
    from tpu3d_torch.dense.grid import VoxelGrid

    kw = dict(grid_resolution=16, batch_size=256, num_samples=16, near=0.5, far=4.0,
              n_coarse=8, n_fine=8, scan_chunk=4)
    grid = torch.randn((16, 16, 16, 28), generator=gen, device=cuda) * 0.3
    grid[..., 0] = torch.randn((16, 16, 16), generator=gen, device=cuda) * 2.0
    lo, hi = torch.full((3,), -1.5, device=cuda), torch.full((3,), 1.5, device=cuda)
    step_kw, step_fn = {}, TT.train_step
    if option == "cascade":
        cfg = DenseConfig(hierarchical=True, optimizer="rmsprop", **kw)
        step_kw["base"] = VoxelGrid(grid, lo, hi)
        grid = torch.zeros((8, 16, 16, 28), device=cuda)
        lo, hi = torch.tensor([-0.6, -0.8, -0.7], device=cuda), torch.tensor([0.9, 0.8, 0.6],
                                                                              device=cuda)
    else:
        cfg = DenseConfig(tv_sigma=0.3, tv_sh=0.05, sparsity_sigma=0.02, exposure=True,
                          sh_background=True, **kw)
        step_fn = TT.sdf_train_step if option == "sdf" else TT.train_step
    n_rays = 14 * 256
    o = torch.zeros((n_rays, 3), device=cuda)
    o[:, 0] = -2.0
    d = torch.nn.functional.normalize(torch.randn((n_rays, 3), generator=gen, device=cuda) * 0.4
                                      + torch.tensor([1.0, 0.0, 0.0], device=cuda), dim=-1)
    rgb = torch.rand((n_rays, 3), generator=gen, device=cuda)
    cid = torch.randint(0, 4, (n_rays,), generator=gen, device=cuda)
    perm = torch.randperm(n_rays, generator=gen, device=cuda)
    states, losses, launched = [], [], []
    for graphed in (False, True):
        st = TT.init_state(cfg, VoxelGrid(grid.clone(), lo, hi), 7, 4)
        g = torch.Generator(device=cuda)
        g.manual_seed(11)
        multi = TT.make_multi_step(step_fn, with_occ=option != "sdf")
        before = (LAUNCHES["trilinear_kernel"], LAUNCHES["trilinear_grad_kernel"])
        out = []
        for b, k in ((0, 4), (4, 4), (8, 4), (12, 2)):
            block = perm[b * 256:(b + k) * 256].view(k, 256)
            if graphed:
                out.append(multi(st, cfg, block, o, d, rgb, cid_all=cid, generator=g,
                                 **step_kw))
                continue
            for ix in block:
                out.append(step_fn(st, cfg, o[ix], d[ix], rgb[ix], cid[ix], generator=g,
                                   **step_kw)[None])
        torch.cuda.synchronize()
        launched.append((LAUNCHES["trilinear_kernel"] - before[0],
                         LAUNCHES["trilinear_grad_kernel"] - before[1]))
        states.append(st)
        losses.append(torch.cat(out).cpu())
        if graphed:
            assert (multi.replays, multi.eager_chunks, len(multi.capture_seconds)) == (2, 2, 1)
            multi.release()
    assert launched[0] == launched[1] and launched[0][1] == 14
    assert torch.equal(losses[1], losses[0])
    a, b = states
    assert a.step == b.step == int(b.count) == 14
    pa, pb = a.grid.grid, b.grid.grid
    pairs = [(pa, pb)] + [(a.optimizer.state[pa][k], b.optimizer.state[pb][k])
                          for k in a.optimizer.state[pa]]
    pairs += [(x, y) for x, y in ((a.exposure, b.exposure), (a.background, b.background))
              if x is not None]
    for x, y in pairs:
        assert torch.equal(y, x)
    assert (pb - grid).abs().max().item() > 1e-3


def _marks_problem(cuda, gen, n_rays=16 * 256):
    """A 16^3 grid trained by fused Adam on rays into its box: the config,
    the state's grid and box, and the rays with their order."""
    from tpu3d_torch.config import DenseConfig

    cfg = DenseConfig(grid_resolution=16, batch_size=256, num_samples=16, near=0.5, far=4.0,
                      scan_chunk=4)
    grid = torch.randn((16, 16, 16, 28), generator=gen, device=cuda) * 0.3
    lo, hi = torch.full((3,), -1.5, device=cuda), torch.full((3,), 1.5, device=cuda)
    o = torch.zeros((n_rays, 3), device=cuda)
    o[:, 0] = -2.0
    d = torch.nn.functional.normalize(torch.randn((n_rays, 3), generator=gen, device=cuda) * 0.4
                                      + torch.tensor([1.0, 0.0, 0.0], device=cuda), dim=-1)
    rgb = torch.rand((n_rays, 3), generator=gen, device=cuda)
    perm = torch.randperm(n_rays, generator=gen, device=cuda)
    return cfg, grid, lo, hi, (o, d, rgb), perm


@pytest.fixture
def traced(monkeypatch):
    """A fresh global tracer with tracing on."""
    from tpu3d_torch.utils import trace

    monkeypatch.setattr(trace, "_GLOBAL", None)
    monkeypatch.setattr(trace, "_ENABLED", True)
    return trace.get_tracer()


def test_multi_step_marks_read_and_bit_equal(cuda, gen, traced):
    """make_multi_step traced on the card against the same steps called one
    by one: chunks of 4 (eager, captured and replayed, replayed), a sync
    between the last two. The captured graph holds one optimizer mark pair
    a step; each replay read after the sync gives its chunk span k
    ``dense.optimizer`` device spans (the eager chunk k of its own), each a
    positive device time inside its replay's; ``dense.marks_read`` counts
    them. Losses, grid and moments equal the untraced eager steps' bit for
    bit."""
    from tpu3d_torch.dense import train as TT
    from tpu3d_torch.dense.grid import VoxelGrid
    from tpu3d_torch.utils import trace

    cfg, grid, lo, hi, (o, d, rgb), perm = _marks_problem(cuda, gen)
    states, losses = [], []
    for graphed in (False, True):
        st = TT.init_state(cfg, VoxelGrid(grid.clone(), lo, hi), 16)
        g = torch.Generator(device=cuda)
        g.manual_seed(5)
        multi = TT.make_multi_step(TT.train_step, with_occ=True)
        out = []
        for b in (0, 4, 8):
            block = perm[b * 256:(b + 4) * 256].view(4, 256)
            if graphed:
                out.append(multi(st, cfg, block, o, d, rgb, generator=g))
                torch.cuda.synchronize()
            else:
                was = trace.enable(False)
                out += [TT.train_step(st, cfg, o[ix], d[ix], rgb[ix], generator=g)[None]
                        for ix in block]
                trace.enable(was)
        if graphed:
            assert len(multi.graphs[4].marks) == 4
            multi.release()
        states.append(st)
        losses.append(torch.cat(out).cpu())
    assert torch.equal(losses[1], losses[0])
    a, b = states
    for x, y in [(a.grid.grid, b.grid.grid)] + [
            (a.optimizer.state[a.grid.grid][k], b.optimizer.state[b.grid.grid][k])
            for k in a.optimizer.state[a.grid.grid]]:
        assert torch.equal(y, x)

    spans = traced.spans()
    chunks = [s for s in spans if s["name"] == "dense.chunk"]
    assert [s["args"]["mode"] for s in chunks] == ["eager", "capture", "replay"]
    # render.composite_eager: the eager chunk's 4 steps and the capture's 4
    # (the capture runs the steps' Python; a replay runs none)
    assert traced.summary()["counters"] == {"dense.marks_read": 2.0,
                                            "render.composite_eager": 8.0}
    for chunk in chunks:
        opt = [s for s in spans if s["name"] == "dense.optimizer" and s["parent"] == chunk["id"]]
        assert len(opt) == 4 and all(s["dur"] > 0 and s["cat"] == "device" for s in opt)
        if chunk["args"]["mode"] != "eager":
            (rep,) = [s for s in spans if s["name"] == "dense.replay"
                      and s["parent"] == chunk["id"]]
            assert sum(s["dur"] for s in opt) < rep["dur"]


def test_multi_step_marks_overwritten_before_done_are_missed(cuda, gen, traced):
    """An armed replay whose marks the card has not reached when the next
    chunk is called (the stream held back by a sleep) counts as missed, the
    others as read; no chunk waits for the card."""
    from tpu3d_torch.dense import train as TT
    from tpu3d_torch.dense.grid import VoxelGrid

    cfg, grid, lo, hi, (o, d, rgb), perm = _marks_problem(cuda, gen)
    st = TT.init_state(cfg, VoxelGrid(grid.clone(), lo, hi), 16)
    multi = TT.make_multi_step(TT.train_step, with_occ=True)
    g = torch.Generator(device=cuda)
    g.manual_seed(5)

    def chunk(b):
        return multi(st, cfg, perm[b * 256:(b + 4) * 256].view(4, 256), o, d, rgb, generator=g)

    chunk(0)
    chunk(4)                        # captured and replayed: armed
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)
    chunk(8)                        # reads the capture's replay; armed behind the sleep
    chunk(12)                       # the previous replay has not run yet: missed
    torch.cuda.synchronize()
    multi.release()                 # reads the last
    assert traced.summary()["counters"] == {"dense.marks_read": 2.0, "dense.marks_missed": 1.0,
                                            "render.composite_eager": 8.0}
    modes = {s["id"]: s["args"]["mode"] for s in traced.spans() if s["name"] == "dense.chunk"}
    parents = [modes.get(s["parent"]) for s in traced.spans() if s["name"] == "dense.optimizer"]
    assert sorted(parents, key=str) == ["capture"] * 4 + ["eager"] * 4 + ["replay"] * 4


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


def _shade_chunk(cuda, gen, n, S, cascade):
    """A render chunk's inputs on the card: (n*S, 28) raw channels (N(0, 1)
    SH, densities |N(0, 1)| times 0.01 to 30 by ray), in-box flags with the
    first 5 rays wholly out, sorted depths, unit directions, a per-ray
    background, and a cascade base's channels and flags."""
    def values():
        v = torch.randn((n, S, 28), generator=gen, device=cuda)
        scale = torch.tensor([0.01, 0.3, 3.0, 30.0], device=cuda)[torch.arange(n, device=cuda) % 4]
        v[..., 0] = torch.randn((n, S), generator=gen, device=cuda).abs() * scale[:, None]
        return v.reshape(n * S, 28)

    def flags():
        f = torch.rand((n, S), generator=gen, device=cuda) > 0.25
        f[:5] = False
        return f.reshape(-1)

    z = torch.sort(torch.rand((n, S), generator=gen, device=cuda) * 4 + 0.5, dim=-1).values
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen, device=cuda), dim=-1)
    bg = torch.rand((n, 3), generator=gen, device=cuda)
    base = (values(), flags()) if cascade else (None, None)
    return values(), flags(), z, d, bg, base


def _shade_eager(vals, in_b, z, d, white_bg, bg, bvals, bin_b):
    """dense/render.py's eager path from a chunk's values: _sample's
    composition of a cascade base, _shade, composite."""
    from tpu3d_torch.dense.render import _dirs, _shade, composite

    n, S = z.shape
    if bvals is not None:
        vals = bvals * bin_b[:, None] + vals * in_b[:, None]
        in_b = torch.ones_like(in_b)
    sigma, rgb = _shade(vals, in_b, _dirs(d, S))
    return composite(sigma.reshape(n, S), rgb.reshape(n, S, 3), z, white_bg, bg)


@pytest.mark.parametrize("S", [192, 128, 37])
@pytest.mark.parametrize("cascade", [False, True], ids=["grid", "cascade"])
def test_shade_composite_kernel_matches_eager_and_plain(cuda, gen, S, cascade):
    """shade_composite_kernel on 1,021 rays (not a multiple of its 8 rays a
    block; S = 37 ends in a part round), white, per-ray and black
    backgrounds: within 1e-5 of the eager path on the card a pixel (render
    parity; the eager path's f32 cumprod and sums round otherwise), bit for
    bit the plain version run on the card, the wholly out-of-box rays the
    background exactly, one launch a call."""
    from tpu3d_torch.kernels.shade_composite import shade_composite, shade_composite_plain

    vals, in_b, z, d, bg, (bvals, bin_b) = _shade_chunk(cuda, gen, 1021, S, cascade)
    for white, b in ((True, None), (True, bg), (False, None)):
        before = LAUNCHES["shade_composite_kernel"]
        got = shade_composite(vals, in_b, z, d, white, b, bvals, bin_b)
        torch.cuda.synchronize()
        assert LAUNCHES["shade_composite_kernel"] == before + 1
        ref = _shade_eager(vals, in_b, z, d, white, b, bvals, bin_b)
        plain = shade_composite_plain(vals, in_b, z, d, white, b, bvals, bin_b)
        assert (got - ref).abs().max().item() <= 1e-5
        assert torch.equal(got, plain)
        want = b[:5] if b is not None else torch.full((5, 3), float(white), device=cuda)
        assert torch.equal(got[:5], want)


def test_shade_composite_kernel_repeats_bit_for_bit(cuda, gen):
    """Two launches on a render chunk's shape (8,192 rays x 192 samples) and
    a cascade's give the same bits."""
    from tpu3d_torch.kernels.shade_composite import shade_composite

    for cascade in (False, True):
        vals, in_b, z, d, bg, (bvals, bin_b) = _shade_chunk(cuda, gen, 8192, 192, cascade)
        a = shade_composite(vals, in_b, z, d, True, bg, bvals, bin_b)
        b = shade_composite(vals, in_b, z, d, True, bg, bvals, bin_b)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


@pytest.mark.parametrize("cascade", [False, True], ids=["grid", "base_grid"])
def test_render_image_fused_against_eager_on_the_card(cuda, gen, cascade):
    """render_image without an autograd graph to build (the kernel, one
    launch a chunk) against the same render through the eager path (the
    grid requiring grad under grad mode), with and without a cascade base,
    contraction with the base: within 1e-5 a pixel; the trilinear launches
    the same."""
    from tpu3d_torch.dense.grid import VoxelGrid
    from tpu3d_torch.dense.render import render_image

    g = torch.randn((24, 24, 24, 28), generator=gen, device=cuda)
    g[..., 0] = g[..., 0].abs() * 20
    vg = VoxelGrid(g, torch.full((3,), -1.0, device=cuda), torch.full((3,), 1.0, device=cuda))
    base = None
    if cascade:
        bgr = torch.randn((16, 16, 16, 28), generator=gen, device=cuda) * 0.5
        bgr[..., 0] = bgr[..., 0].abs() * 5
        base = VoxelGrid(bgr, torch.full((3,), -2.0, device=cuda),
                         torch.full((3,), 2.0, device=cuda))
        vg = VoxelGrid(vg.grid, torch.full((3,), -0.5, device=cuda),
                       torch.full((3,), 0.6, device=cuda))
    o = torch.nn.functional.normalize(torch.randn((300, 3), generator=gen, device=cuda), dim=-1)
    d = torch.nn.functional.normalize(-o + 0.3 * torch.randn((300, 3), generator=gen,
                                                             device=cuda), dim=-1)
    o = 2.5 * o
    bg_sh = torch.randn((3, 9), generator=gen, device=cuda)
    kw = dict(chunk=128, clip_aabb=not cascade, bg_sh=bg_sh, contract=cascade, base_grid=base)
    outs, launched = [], []
    for fused in (True, False):
        grid = vg if fused else VoxelGrid(vg.grid.clone().requires_grad_(), *vg[1:])
        before = (LAUNCHES["shade_composite_kernel"], LAUNCHES["trilinear_kernel"])
        outs.append(render_image(grid, o, d, 0.5, 4.5, 64, **kw).detach())
        torch.cuda.synchronize()
        launched.append((LAUNCHES["shade_composite_kernel"] - before[0],
                         LAUNCHES["trilinear_kernel"] - before[1]))
    assert launched[0][0] == 3 and launched[1][0] == 0
    assert launched[0][1] == launched[1][1] == 3 * (2 if cascade else 1)
    assert (outs[0] - outs[1]).abs().max().item() <= 1e-5


def test_render_view_counts_every_chunk_fused(cuda, gen, traced):
    """A traced render_view on the card: every chunk through the kernel
    (``render.composite_fused`` = chunks = launches), none eager; the rays
    built on the card (``render.rays_device``)."""
    from tpu3d_torch.config import DenseConfig
    from tpu3d_torch.dense.eval import render_view
    from tpu3d_torch.dense.grid import VoxelGrid

    grid = VoxelGrid(torch.rand((8, 8, 8, 28), generator=gen, device=cuda) - 0.3,
                     torch.full((3,), -1.0, device=cuda), torch.full((3,), 1.0, device=cuda))
    cfg = DenseConfig(near=0.5, far=5.0, num_samples=40, per_ray_aabb=True)
    before = LAUNCHES["shade_composite_kernel"]
    img = render_view(grid, np.array([0.1, -0.2, 0.05, 0.0, 0.0, 3.0]), 24, 20, 20.0, cfg,
                      stride=2, chunk=16, bg_sh=torch.rand((3, 9), generator=gen, device=cuda))
    assert img.shape == (12, 10, 3) and np.isfinite(img).all()
    assert traced.summary()["counters"] == {"render.composite_fused": 8.0,
                                            "render.rays_device": 1.0}
    assert LAUNCHES["shade_composite_kernel"] == before + 8


@pytest.mark.parametrize("H, W, stride", [(37, 29, 1), (30, 45, 3), (1296, 1936, 2)])
def test_view_rays_kernel_equals_plain(cuda, H, W, stride):
    """view_rays_kernel against its plain version run on the card, bit for
    bit (1,073 and 150 rays, not a multiple of its 256 a block, and the
    render cells' 627,264 of a 1936 x 1296 view at stride 2), against numpy
    view_rays within 4 ulp of 1 (bit for bit where numpy's sgemm is the
    kernel's fma chain; origins bit for bit), one launch a call."""
    from tpu3d_torch.dense.eval import view_pose, view_rays as numpy_rays
    from tpu3d_torch.dense.train import SceneNormalization
    from tpu3d_torch.kernels.view_rays import view_rays, view_rays_plain

    cam = np.array([0.3, -0.7, 0.2, 0.4, -1.1, 3.2])
    norm = SceneNormalization(np.array([0.3, -0.2, 0.9], np.float32), 2.7)
    focal = 0.9 * W
    R, o = view_pose(cam, norm)
    before = LAUNCHES["view_rays_kernel"]
    got = view_rays(R, o, H, W, focal, stride, cuda)
    torch.cuda.synchronize()
    assert LAUNCHES["view_rays_kernel"] == before + 1
    plain = view_rays_plain(R, o, H, W, focal, stride, cuda)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    o_np, d_np = numpy_rays(cam, H, W, focal, norm, stride)
    np.testing.assert_array_equal(got[0].cpu().numpy(), o_np)
    assert np.abs(got[1].cpu().numpy() - d_np).max() <= 4 * 2.0 ** -23


def test_render_view_builds_its_rays_on_the_card(cuda, gen, traced):
    """render_view on a CUDA grid without rays (built on the card) against
    the same view given numpy view_rays' rays: within 1e-6 a pixel; traced,
    the first counts ``render.rays_device`` 1 and opens no
    ``render.upload``, the second counts no device build. The grid's two
    outer layers hold no density: a box-clipped ray's last sample lies on
    the box's face, where its in-box flag turns on the ray's last bits (the
    limit of render parity that the other render tests avoid alike)."""
    from tpu3d_torch.config import DenseConfig
    from tpu3d_torch.dense.eval import render_view, view_rays
    from tpu3d_torch.dense.grid import VoxelGrid
    from tpu3d_torch.dense.train import SceneNormalization

    g = torch.rand((16, 16, 16, 28), generator=gen, device=cuda) - 0.3
    shell = torch.ones((16, 16, 16), dtype=torch.bool, device=cuda)
    shell[2:-2, 2:-2, 2:-2] = False
    g[..., 0][shell] = -1.0
    grid = VoxelGrid(g, torch.full((3,), -1.0, device=cuda), torch.full((3,), 1.0, device=cuda))
    cfg = DenseConfig(near=0.5, far=5.0, num_samples=64, per_ray_aabb=True)
    cam = np.array([0.1, -0.2, 0.05, 0.2, -0.1, 3.0])
    norm = SceneNormalization(np.array([0.05, 0.1, -0.1], np.float32), 1.3)
    bg = torch.rand((3, 9), generator=gen, device=cuda)
    before = LAUNCHES["view_rays_kernel"]
    got = render_view(grid, cam, 61, 83, 70.0, cfg, norm, stride=2, chunk=256, bg_sh=bg)
    assert LAUNCHES["view_rays_kernel"] == before + 1
    counters = dict(traced.summary()["counters"])
    assert counters.get("render.rays_device") == 1.0 and "render.rays_host" not in counters
    assert "render.upload" not in {s["name"] for s in traced.spans()}
    rays = view_rays(cam, 61, 83, 70.0, norm, 2)
    ref = render_view(grid, cam, 61, 83, 70.0, cfg, norm, stride=2, chunk=256, bg_sh=bg,
                      rays=rays)
    assert LAUNCHES["view_rays_kernel"] == before + 1
    assert traced.summary()["counters"]["render.rays_device"] == 1.0
    assert got.shape == ref.shape == (31, 42, 3)
    assert np.abs(got - ref).max() <= 1e-6


def test_training_never_launches_shade_composite(cuda, gen):
    """A training chunk takes the eager path: make_multi_step's chunks of 4
    (eager, captured and replayed, replayed) launch no
    shade_composite_kernel, and a training step's grid gradient equals, bit
    for bit, the one the eager functions give when called by hand as
    render_rays called them before the kernel."""
    from tpu3d_torch.dense import train as TT
    from tpu3d_torch.dense.grid import VoxelGrid
    from tpu3d_torch.dense.render import _sample, _shade, composite, ray_samples, render_rays

    cfg, grid, lo, hi, (o, d, rgb), perm = _marks_problem(cuda, gen)
    before = LAUNCHES["shade_composite_kernel"]
    st = TT.init_state(cfg, VoxelGrid(grid.clone(), lo, hi), 16)
    multi = TT.make_multi_step(TT.train_step, with_occ=True)
    g = torch.Generator(device=cuda)
    g.manual_seed(5)
    for b in (0, 4, 8):
        multi(st, cfg, perm[b * 256:(b + 4) * 256].view(4, 256), o, d, rgb, generator=g)
    torch.cuda.synchronize()
    assert multi.replays == 2
    multi.release()
    assert LAUNCHES["shade_composite_kernel"] == before

    ix = perm[:256]
    u = torch.rand((256, cfg.num_samples), generator=gen, device=cuda)
    grads = []
    for by_hand in (False, True):
        vg = VoxelGrid(grid.clone().requires_grad_(), lo, hi)
        if by_hand:
            pts, dirs, z = ray_samples(o[ix], d[ix], cfg.near, cfg.far, cfg.num_samples, lo,
                                       hi, perturb=True, u=u)
            sigma, c = _shade(*_sample(vg, pts), dirs)
            pred = composite(sigma.reshape(256, -1), c.reshape(256, -1, 3), z)
        else:
            pred = render_rays(vg, o[ix], d[ix], cfg.near, cfg.far, cfg.num_samples,
                               perturb=True, u=u)
        ((pred - rgb[ix]) ** 2).mean().backward()
        grads.append(vg.grid.grad)
    torch.cuda.synchronize()
    assert LAUNCHES["shade_composite_kernel"] == before
    assert torch.equal(grads[0], grads[1])


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


def _ba_problem(seed=0, C=5, P=400):
    """Five cameras (0 and 1 frozen at their true poses: the scale gauge is
    fixed) and 400 points, perturbed by 0.1 rad / m on three cameras and
    0.2 on the points; arguments of bundle_adjust as numpy arrays."""
    rng = np.random.default_rng(seed)
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


def test_bundle_adjust_batch_on_the_card(cuda):
    """Three problems of different sizes solved in one batch on the card
    with the engine's local BA arguments: each takes the iterations it takes
    alone, cameras and points within 1e-5 and cost within 1e-5 relative of
    its solve alone; two batched runs give the same bits; and a solve makes
    at most LM steps + 2 synchronizing calls (the segment widths once, the
    stop flags once a step: CG never reads back)."""
    from chip_smoke import _sync_calls
    from tpu3d_torch.ba.lm import bundle_adjust_batch
    from tpu3d_torch.sfm.engine import stack_ba_problems

    kw = dict(max_iters=10, cg_iters=8, stall_tol=1e-4)
    problems = [_ba_problem(s, C, P) for s, C, P in ((0, 5, 400), (1, 4, 250), (2, 3, 120))]
    problems = [a + [np.zeros(len(a[1]), np.float32)] for a in problems]
    stacked = [torch.from_numpy(a).to(cuda) for a in stack_ba_problems(problems)]
    runs = [_sync_calls(torch, lambda: bundle_adjust_batch(*stacked, **kw)) for _ in range(2)]
    (st, _), (st2, syncs) = runs          # the first run's count has one-time set-up
    for name in ("cams", "points", "cost", "lam", "n_iters"):
        assert torch.equal(getattr(st, name), getattr(st2, name)), name
    iters = st.n_iters.tolist()
    assert syncs <= max(iters) + 2
    for b, p in enumerate(problems):
        args = [torch.from_numpy(a).to(cuda) for a in p]
        s, s_syncs = _sync_calls(torch, lambda: bundle_adjust(*args, **kw))
        C, P = len(p[0]), len(p[1])
        assert s.n_iters == iters[b]
        assert s_syncs <= s.n_iters + 2
        assert (st.cams[b, :C] - s.cams).abs().max().item() <= 1e-5
        assert (st.points[b, :P] - s.points).abs().max().item() <= 1e-5
        assert abs(st.cost[b].item() - s.cost.item()) <= 1e-5 * s.cost.item()


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


def test_dist_two_ranks_on_one_card_over_gloo(cuda, tmp_path):
    """Two Gloo ranks on the one card with CUDA tensors
    (tests/torch_dist_worker.py's ``mixed`` case on ``cuda``): one step's
    grid gradient, TP on 1 x 2 and ray-DP on 2 x 1 (the trilinear kernel and
    its scatter), within 1e-6 of the 1 x 1 step's largest magnitude (an
    n_model scale would miss by far); the TP state's checkpoint written
    without device memory on either rank, its rows read back equal to each
    brick, the resumed trainer's whole grid on rank 0 alone;
    sharded_bundle_adjust the same on both
    ranks and as one rank's solve (cost within 1e-4 relative, cameras within
    1e-4); the sharded match block's rows (the top2 kernel) equal to one
    rank's."""
    import dataclasses
    import json
    import os
    import socket
    import subprocess
    import sys

    from tpu3d_torch.config import DenseConfig
    from tpu3d_torch.sfm.pipeline import run_extraction

    rng = np.random.RandomState(1)
    g = (rng.randn(16, 16, 16, 28) * 0.3).astype(np.float32)
    g[..., 0] = rng.randn(16, 16, 16) * 2.0
    B, cfg = 128, DenseConfig(grid_resolution=16, num_samples=24, near=0.1, far=2.5,
                              scene_scale=1.0, batch_size=128)
    o = rng.uniform(-0.3, 0.3, (B, 3)).astype(np.float32)
    d = rng.normal(0, 1, (B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ba = _ba_problem()
    sc, pcfg = _small_scene()
    feats = run_extraction((sc["gray"][:4], sc["rgb"][:4]), pcfg, verbose=False, device=cuda)
    pcfg = dataclasses.replace(pcfg, matching=dataclasses.replace(pcfg.matching, pair_batch=2))
    edges = np.array([(i, j) for i in range(4) for j in range(i + 1, 4)], np.int64)
    np.savez(tmp_path / "in.npz", cfg=json.dumps(dataclasses.asdict(cfg)), grid0=g,
             lo=np.full(3, -1.0, np.float32), hi=np.ones(3, np.float32), o=o, d=d,
             rgb=rng.uniform(0, 1, (B, 3)).astype(np.float32),
             u=rng.rand(B, 24).astype(np.float32), ba_iters=4,
             **dict(zip(("ba_cams0", "ba_points0", "ba_cam_idx", "ba_pt_idx", "ba_uv", "ba_w",
                         "ba_cam_fixed"), ba)),
             pipeline_cfg=json.dumps(dataclasses.asdict(pcfg)), kp=feats.keypoints,
             valid=feats.valid, image_size=feats.image_size, desc=feats.descriptors,
             edges=edges)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(root, "tests", "torch_dist_worker.py"), "mixed",
         str(tmp_path / "in.npz"), str(tmp_path), "cuda"],
        env=dict(os.environ, TPU3D_COORDINATOR=f"127.0.0.1:{port}", TPU3D_NUM_PROCESSES="2",
                 TPU3D_PROCESS_ID=str(pid)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for pid in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    r0, r1 = (dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2))
    for got, ref in ((np.concatenate([r0["grad_tp"], r1["grad_tp"]]), r0["grad_tp_ref"]),
                     (r0["grad_dp"], r0["grad_dp_ref"]), (r1["grad_dp"], r0["grad_dp_ref"])):
        scale = np.abs(ref).max()
        assert scale > 0 and np.abs(got - ref).max() <= 1e-6 * scale
    # the TP checkpoint: no rank's device memory grows while it is written
    for r in (r0, r1):
        assert int(r["ckpt_extra_bytes"]) == 0 and bool(r["ckpt_rows_equal"])
    np.testing.assert_array_equal(r0["resumed_grid"], np.concatenate([r0["tp_grid"],
                                                                      r1["tp_grid"]]))
    assert r1["resumed_grid"].size == 0
    for k in ("ba_cams", "ba_points", "ba_cost", "ba_iters_run"):
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    one = bundle_adjust(*(torch.from_numpy(a).to(cuda) for a in ba), max_iters=4, cg_iters=16)
    assert int(r0["ba_iters_run"]) == one.n_iters
    assert abs(float(r0["ba_cost"]) - one.cost.item()) <= 1e-4 * one.cost.item()
    assert np.abs(r0["ba_cams"] - one.cams.cpu().numpy()).max() <= 1e-4
    for r in (r0, r1):
        np.testing.assert_array_equal(r["rows_sharded"], r0["rows_one"])


# --------------------------------------------------------------------------
# The Plenoxels grid, 512^3 x 28: 3,758,096,384 elements, past 2^31 (15.03
# GB a tensor). Each test frees what it made before the next.

BIG = (512, 512, 512, 28)


def _big_points(cuda, gen, n=200_000):
    """Points over the whole box [-1, 1]^3 and a cluster in the far corner
    (x, y, z near 1: rows past element 2^31), the 8 box corners first."""
    mn, mx = torch.full((3,), -1.0, device=cuda), torch.full((3,), 1.0, device=cuda)
    pts = torch.rand((n, 3), generator=gen, device=cuda) * 2.2 - 1.1
    pts[:8] = torch.stack([torch.where(torch.tensor([(k >> a) & 1 for a in range(3)],
                                                    device=cuda) > 0, mx, mn)
                           for k in range(8)])
    pts[n // 2:] = 1.0 - torch.rand((n - n // 2, 3), generator=gen, device=cuda) * 0.05
    return mn, mx, pts


def _free():
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def test_trilinear_kernel_at_512_cubed(cuda, gen):
    """trilinear_kernel on a 512^3 x 28 grid (its int64 offsets) against
    the plain version on the card, bit for bit, at points over the whole
    box and in its far corner, whose corner rows lie past element 2^31."""
    from tpu3d_torch.kernels.trilinear import index32

    grid = torch.rand(BIG, generator=gen, device=cuda)
    assert not index32(grid.numel(), 28)
    mn, mx, pts = _big_points(cuda, gen)
    got, got_in = trilinear_sample(grid, mn, mx, pts)
    ref, ref_in = trilinear_sample_plain(grid, mn, mx, pts)
    far = ((pts + 1) / 2 * 511).floor().clamp(0, 510).long()
    rows = (far[:, 0] * 512 + far[:, 1]) * 512 + far[:, 2]
    assert int(rows.max()) * 28 > 2 ** 31 and bool(got_in[-1000:].all())
    assert torch.equal(got_in, ref_in) and torch.equal(got, ref)
    del grid, got, ref
    _free()


def test_trilinear_grad_kernel_at_512_cubed(cuda, gen):
    """The scatter into a 512^3 x 28 gradient (keys, sort, column starts,
    the kernel's every-row write) against the plain version's sums in its
    order (corner, then sample) on the CPU, at every touched row, the last
    1,000 rows (past element 2^31) and 100,000 rows drawn at random: bit for
    bit, untouched rows +0.0."""
    from tpu3d_torch.kernels.trilinear import _corner_setup
    from tpu3d_torch.kernels.trilinear_grad import trilinear_scatter_grad

    X, Y, Z, C = BIG
    mn, mx, pts = _big_points(cuda, gen)
    g = torch.randn((pts.shape[0], C), generator=gen, device=cuda)
    out = trilinear_scatter_grad(g, mn, mx, (X, Y, Z), pts)
    torch.cuda.synchronize()
    i0, frac, inb = _corner_setup((X, Y, Z), mn.cpu(), mx.cpu(), pts.cpu())
    gv = g.cpu() * inb[:, None]
    base = (i0[:, 0] * Y + i0[:, 1]) * Z + i0[:, 2]
    w = ((1 - frac[:, 0:1], frac[:, 0:1]), (1 - frac[:, 1:2], frac[:, 1:2]),
         (1 - frac[:, 2:3], frac[:, 2:3]))
    rows = torch.cat([base + (a * Y * Z + b * Z + c) for a in (0, 1) for b in (0, 1)
                      for c in (0, 1)])
    vals = torch.cat([w[0][a] * w[1][b] * w[2][c] * gv for a in (0, 1) for b in (0, 1)
                      for c in (0, 1)])
    n_rows = X * Y * Z
    picked = torch.cat([rows, torch.arange(n_rows - 1000, n_rows),
                        torch.randint(0, n_rows, (100_000,))])
    sel = torch.unique(picked)
    want = torch.zeros((len(sel), C)).index_add_(0, torch.searchsorted(sel, rows), vals)
    got = out.view(n_rows, C)[sel.to(cuda)].cpu()
    assert int(sel.max()) * C > 2 ** 31
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    del out
    _free()


def test_rmsprop_kernel_at_512_cubed(cuda, gen):
    """rmsprop_kernel over 3,758,096,384 elements (its int64 offsets)
    against rmsprop_update_plain on the card at the first and last 1,000
    elements and 100,000 drawn at random: nu bit for bit, p within one ulp
    (as at 256^3)."""
    from tpu3d_torch.kernels.rmsprop import rmsprop_update, rmsprop_update_plain

    p = torch.rand(BIG, generator=gen, device=cuda)
    g = torch.rand(BIG, generator=gen, device=cuda).sub_(0.5).mul_(0.1)
    nu = torch.rand(BIG, generator=gen, device=cuda).mul_(1e-3)
    n = p.numel()
    at = torch.cat([torch.arange(1000, device=cuda), torch.arange(n - 1000, n, device=cuda),
                    torch.randint(0, n, (100_000,), generator=gen, device=cuda)])
    ref_p, ref_g, ref_nu = (t.view(-1)[at].clone() for t in (p, g, nu))
    lr = torch.tensor(0.01, device=cuda)
    rmsprop_update(p, g, nu, lr, 0.95, 1e-8)
    rmsprop_update_plain(ref_p, ref_g, ref_nu, lr, 0.95, 1e-8)
    got_p, got_nu = p.view(-1)[at], nu.view(-1)[at]
    assert torch.equal(got_nu.view(torch.int32), ref_nu.view(torch.int32))
    ulp = torch.nextafter(ref_p.abs(), torch.full_like(ref_p, float("inf"))) - ref_p.abs()
    assert bool(((got_p - ref_p).abs() <= ulp).all())
    del p, g, nu
    _free()


def test_prior_step_memory_at_512_cubed(cuda, gen):
    """A training step of the 512^3 x 28 grid under RMSprop with the TV and
    sparsity priors on peaks less than 1 GB above the same step without
    them: the priors' gradient goes to their blocks' rows, with nothing of
    the grid's size (15.03 GB)."""
    import dataclasses

    from tpu3d_torch.config import DenseConfig
    from tpu3d_torch.dense import train as TT
    from tpu3d_torch.dense.grid import VoxelGrid

    cfg = DenseConfig(grid_resolution=512, batch_size=1024, num_samples=64, near=0.5, far=4.0,
                      optimizer="rmsprop", scene_scale=1.0)
    on = dataclasses.replace(cfg, tv_sigma=1e-5, tv_sh=1e-3, sparsity_sigma=1e-4)
    lo, hi = torch.full((3,), -1.0, device=cuda), torch.full((3,), 1.0, device=cuda)
    st = TT.init_state(cfg, VoxelGrid(torch.full(BIG, 0.01, device=cuda), lo, hi), 100)
    o = torch.zeros((1024, 3), device=cuda)
    o[:, 0] = -2.0
    d = torch.nn.functional.normalize(torch.randn((1024, 3), generator=gen, device=cuda) * 0.3
                                      + torch.tensor([1.0, 0.0, 0.0], device=cuda), dim=-1)
    rgb = torch.rand((1024, 3), generator=gen, device=cuda)
    g = torch.Generator(device=cuda)
    g.manual_seed(3)
    peaks = {}
    for name, c in (("warm", cfg), ("off", cfg), ("on", on)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        TT.train_step(st, c, o, d, rgb, generator=g)
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated()
    assert peaks["off"] > 3 * st.grid.grid.numel() * 4
    assert peaks["on"] - peaks["off"] < 1e9, peaks
    del st
    _free()


def _dvgo_rays(n, gen, dev):
    """Rays from about (0, 0, -3) into the box [-1, 1]^3, some missing it."""
    o = torch.tensor([0.0, 0.0, -3.0], device=dev) + 0.4 * torch.randn((n, 3), generator=gen,
                                                                        device=dev)
    d = torch.nn.functional.normalize(torch.tensor([0.0, 0.0, 1.0], device=dev)
                                      + 0.3 * torch.randn((n, 3), generator=gen, device=dev),
                                      dim=-1)
    return o, d, torch.rand((n, 3), generator=gen, device=dev)


def _dvgo_setup(cuda, gen, res, batch, **kw):
    from tpu3d_torch.config import DenseConfig
    from tpu3d_torch.dense import dvgo
    from tpu3d_torch.dense.grid import VoxelGrid

    cfg = DenseConfig(grid_resolution=res, batch_size=batch, near=0.1, far=6.0, scene_scale=1.0,
                      **kw)
    grid = torch.randn((res, res, res, dvgo.CHANNELS), generator=gen, device=cuda)
    grid[..., 0] *= 2.0
    lo, hi = torch.full((3,), -1.0, device=cuda), torch.full((3,), 1.0, device=cuda)
    return cfg, grid, lo, hi, lambda: dvgo.init_state(cfg, VoxelGrid(grid.clone(), lo, hi), 7,
                                                      seed=5)


def test_dvgo_replayed_chunk_equals_eager_chunk(cuda, gen):
    """DVGO's step through make_multi_step (chunks of 4: eager, captured and
    replayed, replayed, then an eager tail of 2) against the same steps
    called one by one: losses, grid, MLP, MaskedAdam's moments and the
    tallies bit for bit."""
    from tpu3d_torch import f32_scope
    from tpu3d_torch.dense import dvgo
    from tpu3d_torch.dense import train as TT

    cfg, grid, lo, hi, make = _dvgo_setup(cuda, gen, 16, 512, scan_chunk=4)
    o, d, rgb = _dvgo_rays(14 * 512, gen, cuda)
    perm = torch.randperm(14 * 512, generator=gen, device=cuda)
    states, losses = [], []
    with f32_scope():
        for graphed in (False, True):
            st = make()
            g = torch.Generator(device=cuda)
            g.manual_seed(11)
            multi = TT.make_multi_step(dvgo.dvgo_train_step, with_occ=False)
            out = []
            for b, k in ((0, 4), (4, 4), (8, 4), (12, 2)):
                block = perm[b * 512:(b + k) * 512].view(k, 512)
                if graphed:
                    out.append(multi(st, cfg, block, o, d, rgb, generator=g))
                    continue
                for ix in block:
                    out.append(dvgo.dvgo_train_step(st, cfg, o[ix], d[ix], rgb[ix],
                                                    generator=g)[None])
            torch.cuda.synchronize()
            if graphed:
                assert (multi.replays, multi.eager_chunks) == (2, 2)
                multi.release()
            states.append(st)
            losses.append(torch.cat(out).cpu())
    assert torch.equal(*losses)
    a, b = states
    assert a.step == b.step == 14
    for p, q in zip((a.grid.grid, *a.params), (b.grid.grid, *b.params)):
        assert torch.equal(p, q)
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a.optimizer.state[p][key], b.optimizer.state[q][key])
    assert all(torch.equal(x, y) for x, y in zip(a.tallies.values(), b.tallies.values()))


def test_dvgo_steps_at_160_match_the_reference(cuda, gen):
    """Three DVGO steps at the cell's sizes (160^3 x 13, 8192 rays, 558
    samples) against portbench's plain reference: the losses, the first
    gradient by leaf and the change by leaf."""
    from portbench.reference import dvgo as ref
    from tpu3d_torch import f32_scope
    from tpu3d_torch.dense import dvgo

    cfg, grid, lo, hi, make = _dvgo_setup(cuda, gen, 160, 8192)
    grid.mul_(0.1)
    batches = [_dvgo_rays(8192, gen, cuda) for _ in range(3)]
    st = make()
    params0 = [p.detach().clone() for p in st.params]
    g = torch.Generator(device=cuda)
    g.manual_seed(3)
    with f32_scope():
        losses = []
        for t, (o, d, rgb) in enumerate(batches):
            losses.append(float(dvgo.dvgo_train_step(st, cfg, o, d, rgb, generator=g)))
            if t == 0:
                m = [st.optimizer.state[q]["exp_avg"] / 0.1 for q in (st.grid.grid, *st.params)]
                grad = ref.leaf_norms(ref.leaf_sq_sums(m[0], m[1:]))
                del m
    change = ref.leaf_norms(ref.leaf_sq_sums(st.grid.grid.detach(),
                                             [p.detach() for p in st.params], grid, params0))
    del st
    torch.cuda.empty_cache()
    g.manual_seed(3)
    draws = [torch.rand((8192, 1), generator=g, device=cuda) for _ in batches]
    want = ref.train_steps(ref.Spec((160,) * 3, 1.0, 0.1, 6.0), grid, params0, lo, hi, batches,
                           draws)
    assert dvgo.n_samples((160,) * 3) == 558
    for a, b in zip(losses, want["losses"]):
        assert abs(a - b) <= 1e-5 * abs(b)
    for key, got in (("grad", grad), ("change", change)):
        for leaf, v in want[key].items():
            assert abs(got[leaf] - v) <= 1e-3 * v, (key, leaf, got[leaf], v)


def test_dvgo_spans_and_counters_are_recorded(cuda, gen, monkeypatch):
    """While tracing, an eager chunk records ``dense.rgbnet`` and
    ``dense.rgbnet_backward`` device spans a step (the backward's from the
    autograd engine's thread, under the chunk), a replayed chunk's graph
    marks hold both a step, and a loss read-back folds both tallies into
    the tracer's counters."""
    from tpu3d_torch import f32_scope
    from tpu3d_torch.dense import dvgo
    from tpu3d_torch.dense import train as TT
    from tpu3d_torch.utils import trace

    monkeypatch.setattr(trace, "_GLOBAL", None)
    monkeypatch.setattr(trace, "_ENABLED", True)
    cfg, grid, lo, hi, make = _dvgo_setup(cuda, gen, 16, 256, scan_chunk=2)
    o, d, rgb = _dvgo_rays(8 * 256, gen, cuda)
    st = make()
    multi = TT.make_multi_step(dvgo.dvgo_train_step, with_occ=False)
    with f32_scope():
        for b in range(0, 8, 2):
            multi(st, cfg, torch.arange(b * 256, (b + 2) * 256, device=cuda).view(2, 256), o, d,
                  rgb, generator=gen)
        torch.cuda.synchronize()
        multi.release()
    TT.fold_tallies(st)
    tr = trace.get_tracer()
    events = tr.spans()
    chunks = {e["id"]: e["args"]["mode"] for e in events if e["name"] == "dense.chunk"}
    for name in ("dense.rgbnet", "dense.rgbnet_backward"):
        modes = sorted(chunks[e["parent"]] for e in events
                       if e["name"] == name and e["parent"] in chunks)
        assert modes.count("eager") == 2 and modes.count("replay") >= 2, (name, modes)
    counters = tr.summary()["counters"]
    S = dvgo.n_samples((16,) * 3)
    assert counters["dense.rgbnet_rows"] == 8 * 256 * S
    assert 0 < counters["dense.colour_samples"] <= counters["dense.rgbnet_rows"]
    assert counters["dense.rgbnet_rows_run"] == counters["dense.colour_samples"]


def _rgbnet_step_inputs(cuda, gen, monkeypatch, res=160, batch=8192):
    """One DVGO march's MLP inputs at the dvgo-160.train cell's sizes (a
    160^3 x 13 grid, 8,192 rays, 558 samples): (k0, a view of the values,
    emb, that step's own coloured mask, the MLP's leaves)."""
    from tpu3d_torch.dense import dvgo

    cfg, grid, lo, hi, make = _dvgo_setup(cuda, gen, res, batch)
    grid.mul_(0.1)
    st = make()
    o, d, _ = _dvgo_rays(batch, gen, cuda)
    seen = {}
    real = dvgo.rgbnet_forward

    def recording(k0, emb, coloured, params, save=True):
        seen.update(k0=k0, emb=emb, coloured=coloured)
        return real(k0, emb, coloured, params, save)

    monkeypatch.setattr(dvgo, "rgbnet_forward", recording)
    with torch.no_grad():
        dvgo.march(st.grid, st.params, o, d, cfg.near, cfg.far,
                   dvgo._step_length(cfg, (res,) * 3),
                   torch.rand((batch, 1), generator=gen, device=cuda))
    monkeypatch.setattr(dvgo, "rgbnet_forward", real)
    params = tuple(p.detach() for p in st.params)
    del st, grid
    return seen["k0"], seen["emb"], seen["coloured"], params


def _positive_zero(t):
    """Every element +0.0 (not -0.0)."""
    return bool((t.contiguous().view(torch.int32) == 0).all())


def _check_rgbnet(k0, emb, coloured, params, g, grad_tol=1e-4):
    """The kernels' forward and backward against the plain version run on
    the card (cuBLAS f32): c on the coloured rows, gk0 and the six leaves'
    gradients to f32 tolerance, +0 at every uncoloured row of c and gk0.
    Returns the kernels' outputs."""
    from tpu3d_torch.kernels import rgbnet as K

    mask = coloured.reshape(-1)
    c, count, saved = K.rgbnet_forward(k0, emb, coloured, params, True)
    gk0, grads = K.rgbnet_backward(g, saved, params)
    torch.cuda.synchronize()
    want_c, want_count, want_saved = K.rgbnet_forward_plain(k0, emb, coloured, params)
    want_gk0, want_grads = K.rgbnet_backward_plain(g, want_saved, params)
    assert int(count) == int(want_count) == int(mask.sum())
    torch.testing.assert_close(c[mask], want_c[mask], rtol=0, atol=2e-6)
    assert _positive_zero(c[~mask]) and _positive_zero(gk0[~mask])
    if bool(mask.any()):
        scale = float(want_gk0.abs().max())
        torch.testing.assert_close(gk0[mask], want_gk0[mask], rtol=1e-4, atol=1e-5 * scale)
    for i, (got, want) in enumerate(zip(grads, want_grads)):
        assert got.shape == want.shape
        err = float((got - want).norm()) / max(float(want.norm()), 1e-30)
        assert err <= grad_tol, (i, err)
    return c, count, gk0, grads


def test_rgbnet_kernels_match_plain_at_the_cell_sizes(cuda, gen, monkeypatch):
    """The MLP's kernels on one step's own coloured mask at 8,192 rays x 558
    samples against the plain version: c, gk0 and the six gradients, +0 at
    every uncoloured row; each kernel launched once; two runs bit for bit."""
    from tpu3d_torch import f32_scope
    from tpu3d_torch.kernels import rgbnet as K

    k0, emb, coloured, params = _rgbnet_step_inputs(cuda, gen, monkeypatch)
    assert k0.shape == (8192 * 558, 12) and k0.stride() == (13, 1)
    n = int(coloured.sum())
    assert 0 < n < coloured.numel()
    g = torch.randn((k0.shape[0], 3), generator=gen, device=cuda) * 1e-3
    names = ("rgbnet_count_kernel", "rgbnet_compact_kernel", "rgbnet_forward_kernel",
             "rgbnet_backward_kernel", "rgbnet_reduce_kernel")
    before = {k: LAUNCHES[k] for k in names}
    with f32_scope():
        first = _check_rgbnet(k0, emb, coloured, params, g)
    assert all(LAUNCHES[k] == before[k] + 1 for k in names)
    c, count, saved = K.rgbnet_forward(k0, emb, coloured, params, True)
    second = (c, count, *K.rgbnet_backward(g, saved, params))
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    assert torch.equal(first[2], second[2])
    assert all(torch.equal(a, b) for a, b in zip(first[3], second[3]))


@pytest.mark.parametrize("n", [0, 1, 1000, "all"])
def test_rgbnet_kernels_at_edge_counts(cuda, gen, n):
    """No coloured row, one, 1,000 (a multiple of neither tile) and every
    row, at 32 rays x 37 samples: against the plain version, and the
    compaction's indices against nonzero."""
    from tpu3d_torch import f32_scope
    from tpu3d_torch.dense import dvgo
    from tpu3d_torch.kernels import rgbnet as K

    N, S = 32, 37
    vals = torch.randn((N * S, 13), generator=gen, device=cuda)
    emb = dvgo.view_encoding(_unit((N, 3), gen, cuda))
    coloured = torch.zeros(N * S, dtype=torch.bool, device=cuda)
    if n == "all":
        coloured[:] = True
    elif n:
        coloured[torch.randperm(N * S, generator=gen, device=cuda)[:n]] = True
    coloured = coloured.view(N, S)
    params = tuple(p.to(cuda) for p in dvgo.init_rgbnet(2))
    params = params[:-1] + (torch.randn(3, generator=gen, device=cuda),)
    g = torch.randn((N * S, 3), generator=gen, device=cuda)
    idx, count = K.compact(coloured)
    rows = coloured.reshape(-1).nonzero().reshape(-1)
    assert int(count) == rows.numel()
    assert torch.equal(idx[:rows.numel()].long(), rows)
    with f32_scope():
        _check_rgbnet(vals[:, 1:], emb, coloured, params, g, grad_tol=1e-5)


def test_rgbnet_graph_replays_over_counts_that_differ(cuda, gen):
    """The forward and backward captured once in a CUDA graph and replayed
    on two batches whose coloured counts differ: each against the plain
    version (the count is read on the card, not at capture)."""
    from tpu3d_torch import f32_scope
    from tpu3d_torch.dense import dvgo
    from tpu3d_torch.kernels import rgbnet as K

    N, S = 512, 93
    R = N * S
    vals = torch.zeros((R, 13), device=cuda)
    emb = torch.zeros((N, 27), device=cuda)
    coloured = torch.zeros((N, S), dtype=torch.bool, device=cuda)
    g = torch.zeros((R, 3), device=cuda)
    params = tuple(p.to(cuda) for p in dvgo.init_rgbnet(4))
    k0 = vals[:, 1:]

    def load(share):
        vals.copy_(torch.randn((R, 13), generator=gen, device=cuda))
        emb.copy_(dvgo.view_encoding(_unit((N, 3), gen, cuda)))
        coloured.copy_(torch.rand((N, S), generator=gen, device=cuda) < share)
        g.copy_(torch.randn((R, 3), generator=gen, device=cuda))

    def run():
        c, count, saved = K.rgbnet_forward(k0, emb, coloured, params, True)
        return (c, count) + K.rgbnet_backward(g, saved, params)

    with f32_scope():
        load(0.5)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = run()
        counts = []
        for share in (0.2, 0.7):
            load(share)
            graph.replay()
            torch.cuda.synchronize()
            c, count, gk0, grads = out
            counts.append(int(count))
            mask = coloured.reshape(-1)
            want_c, _, want_saved = K.rgbnet_forward_plain(k0, emb, coloured, params)
            want_gk0, want_grads = K.rgbnet_backward_plain(g, want_saved, params)
            torch.testing.assert_close(c, want_c, rtol=0, atol=2e-6)
            assert _positive_zero(gk0[~mask])
            torch.testing.assert_close(gk0, want_gk0, rtol=1e-4,
                                       atol=1e-5 * float(want_gk0.abs().max()))
            for got, want in zip(grads, want_grads):
                assert float((got - want).norm()) <= 1e-5 * float(want.norm())
        assert counts[0] != counts[1]
        del graph
