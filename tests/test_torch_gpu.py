"""tpu3d_torch's CUDA kernels against their plain PyTorch versions on the
card. Every test here is marked ``gpu`` and skips without a CUDA device.

The module imports neither jax nor tpu3d, so it also runs where only the
port is installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from tpu3d_torch.features.detector import _neighbors27
from tpu3d_torch.kernels import LAUNCHES
from tpu3d_torch.kernels.distance import descriptor_top2, descriptor_top2_plain
from tpu3d_torch.kernels.patch_sample import (sample_gradient_patches,
                                              sample_gradient_patches_plain)
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
