"""The plain reference agrees with the program's CPU path at a tiny grid
(this test imports both; the reference itself imports neither the program
nor JAX)."""
import numpy as np
import pytest
import torch

from portbench.reference import render as ref
from portbench_tiny import run_tiny
from tpu3d_torch.dense import render as prog
from tpu3d_torch.dense.eval import view_rays
from tpu3d_torch.dense.grid import VoxelGrid
from tpu3d_torch.dense.train import SceneNormalization


def _grid(seed, res=(12, 10, 14), lo=-1.0, hi=1.0):
    g = torch.Generator().manual_seed(seed)
    grid = torch.rand((*res, 28), generator=g) * 2 - 0.5
    grid[..., 0] *= 20
    return grid, torch.full((3,), lo), torch.full((3,), hi)


def _rays(seed, n=200):
    g = torch.Generator().manual_seed(seed)
    o = torch.tensor([0.3, -0.2, -3.0]) + 0.1 * torch.randn((n, 3), generator=g)
    d = torch.tensor([0.0, 0.05, 1.0]) + 0.3 * torch.randn((n, 3), generator=g)
    return o, d / d.norm(dim=-1, keepdim=True)


@pytest.mark.parametrize("clip", [True, False])
def test_render_rays_matches_the_program(clip):
    grid, lo, hi = _grid(1)
    o, d = _rays(2)
    u = torch.rand((o.shape[0], 48), generator=torch.Generator().manual_seed(3))
    got = prog.render_rays(VoxelGrid(grid, lo, hi), o, d, 1.5, 5.0, 48, clip_aabb=clip,
                           perturb=True, u=u)
    want = ref.render_rays(ref.Grids(grid, lo, hi), o, d, 1.5, 5.0, 48, clip, u=u)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_hierarchical_contracted_cascade_matches_the_program():
    base, blo, bhi = _grid(4, (16, 16, 16), -2.0, 2.0)
    det, dlo, dhi = _grid(5, (10, 12, 8), -0.7, 0.6)
    o, d = _rays(6)
    gen = torch.Generator().manual_seed(7)
    u, uf = torch.rand((o.shape[0], 24), generator=gen), torch.rand((o.shape[0], 16),
                                                                    generator=gen)
    got = prog.render_rays_hierarchical(VoxelGrid(det, dlo, dhi), o, d, 1.0, 6.0, 32, 16,
                                        u_coarse=u, u_fine=uf, contract=True,
                                        base_vg=VoxelGrid(base, blo, bhi))
    want = ref.render_rays_hierarchical(ref.Grids(det, dlo, dhi, base, blo, bhi), o, d, 1.0,
                                        6.0, 32, 16, False, True, u, uf)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_view_rays_match_the_program():
    cam = np.array([0.3, -1.1, 0.2, 0.5, -0.4, 6.0])
    center, scale = np.array([1.0, 2.0, 3.0], np.float32), 4.5
    got = view_rays(cam, 20, 30, 27.0, SceneNormalization(center, scale))
    want = ref.view_rays(cam, 20, 30, 27.0, center, scale)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("cell", ["plenoxel-256.train", "recipe-256.detail",
                                  "plenoxel-256.render"])
def test_a_sound_run_is_correct(cell):
    r = run_tiny(cell)
    assert r["correct"], r["compared"]
    assert r["failed"] == 0 and r["attempted"] > 0
