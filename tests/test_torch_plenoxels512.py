"""The Plenoxels configuration's training path on the CPU: the TV and
sparsity crop priors with their gradient added to their blocks' rows alone
(dense/train.py ``_apply_priors``), against autograd's form and against the
benchmark's plain reference (portbench/reference/train_priors.py), inside
make_multi_step's chunks, and ``densify --dense-batch``.

The 512^3 x 28 grid itself runs only on the card (tests/test_torch_gpu.py,
portbench's ``plenoxels-512.train``); here every shape is small.
"""
import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from portbench.reference import train as ref
from portbench.reference import train_priors as ref_priors
from tpu3d_torch import cli as TC
from tpu3d_torch.config import DenseConfig
from tpu3d_torch.dense import train as TT
from tpu3d_torch.dense.grid import VoxelGrid
from tpu3d_torch.utils import trace

RES, BATCH, N_RAYS = 16, 64, 320
LO, HI = torch.full((3,), -1.5), torch.full((3,), 1.5)
PRIORS = dict(tv_sigma=0.3, tv_sh=0.05, sparsity_sigma=0.02, tv_crop=5)


def _cfg(**kw):
    base = dict(grid_resolution=RES, batch_size=BATCH, num_samples=8, near=0.5, far=4.0,
                optimizer="rmsprop", **PRIORS)
    base.update(kw)
    return DenseConfig(**base)


def _grid(seed=1, shape=(RES, RES, RES, 28)):
    g = torch.Generator().manual_seed(seed)
    grid = torch.randn(shape, generator=g) * 0.3
    grid[..., 0] = torch.randn(shape[:3], generator=g) * 2.0
    return grid


def _rays(seed=0, n=N_RAYS):
    g = torch.Generator().manual_seed(seed)
    o = torch.zeros((n, 3))
    o[:, 0] = -2.0
    o[:, 1:] = torch.rand((n, 2), generator=g) * 0.6 - 0.3
    d = torch.randn((n, 3), generator=g) * 0.4
    d[:, 0] = d[:, 0].abs() + 1.0
    return o, d / d.norm(dim=-1, keepdim=True), torch.rand((n, 3), generator=g)


def _noise(cfg, step, shape=(RES, RES, RES)):
    """A step's draws: its uniforms and both blocks' origins, from the step."""
    g = torch.Generator().manual_seed(100 + step)
    crop = cfg.tv_crop
    return TT.StepNoise(
        torch.rand((BATCH, cfg.num_samples), generator=g), None,
        torch.stack([torch.randint(0, d - min(crop, d - 1), (), generator=g) for d in shape]),
        torch.stack([torch.randint(0, d - min(crop, d) + 1, (), generator=g) for d in shape]))


def _autograd_priors(grid, cfg, noise):
    """The priors through autograd on the whole grid, as the step took them
    before: (the priors' value, the grid's gradient)."""
    with torch.enable_grad():
        p = grid.clone().requires_grad_()
        tv_s, tv_c = TT._tv_crop_loss(p, noise.tv_origin, cfg.tv_crop)
        value = (torch.zeros(()) + cfg.tv_sigma * tv_s + cfg.tv_sh * tv_c
                 + cfg.sparsity_sigma * TT._sparsity_crop_loss(p, noise.sparsity_origin,
                                                               cfg.tv_crop))
        value.backward()
    return value.detach(), p.grad


@pytest.mark.parametrize("shape", [(RES, RES, RES, 28), (12, 10, 14, 28), (4, 3, 5, 28)],
                         ids=["cube", "box", "smaller_than_crop"])
def test_row_only_prior_gradient_equals_autograd(shape):
    """_apply_priors against autograd's whole-grid form: the value and the
    gradient to rounding; every element outside the two blocks' rows is
    left as the backward wrote it, bit for bit."""
    cfg = _cfg()
    grid = _grid(2, shape)
    noise = _noise(cfg, 0, shape[:3])
    want_value, want_grad = _autograd_priors(grid, cfg, noise)
    p = grid.clone().requires_grad_()
    before = torch.randn(shape, generator=torch.Generator().manual_seed(5))
    p.grad = before.clone()
    value = TT._apply_priors(p, TT._crop_priors(cfg, noise), torch.zeros(()))
    torch.testing.assert_close(value, want_value, rtol=1e-6, atol=0)
    torch.testing.assert_close(p.grad, before + want_grad, rtol=1e-6, atol=1e-7)
    alone = grid.clone().requires_grad_()
    alone.grad = torch.zeros(shape)
    TT._apply_priors(alone, TT._crop_priors(cfg, noise), torch.zeros(()))
    torch.testing.assert_close(alone.grad, want_grad, rtol=1e-5, atol=1e-7)
    touched = want_grad.reshape(-1, 28).abs().sum(dim=1) > 0
    inside = torch.zeros(int(np.prod(shape[:3])), dtype=torch.bool)
    for origin, size in ((noise.tv_origin, TT._tv_size(shape, cfg.tv_crop)),
                         (noise.sparsity_origin, TT._sparsity_size(shape, cfg.tv_crop))):
        inside[TT._crop_rows(shape, origin, size).reshape(-1)] = True
    assert bool(touched[inside].any()) and not bool(touched[~inside].any())
    outside = p.grad.reshape(-1, 28)[~inside]
    assert torch.equal(outside.view(torch.int32),
                       before.reshape(-1, 28)[~inside].view(torch.int32))


def test_init_state_trains_the_grid_in_place():
    """The training state holds the grid it is given, not a copy (a 512^3 x
    28 grid is 15.03 GB): the trained leaf shares its storage, and RMSprop
    adds its second moment alone."""
    grid = torch.full((RES, RES, RES, 28), 0.01)
    state = TT.init_state(_cfg(), VoxelGrid(grid, LO, HI), 5)
    assert state.grid.grid.data_ptr() == grid.data_ptr() and state.grid.grid.requires_grad
    assert list(state.optimizer.state[state.grid.grid]) == ["nu"]


def test_train_step_with_priors_matches_autograd_form():
    """Three training steps with the priors on against the same steps whose
    priors go through autograd on the whole grid (the step's form before
    its priors went to their rows): losses, grid and RMSprop's nu to
    rounding."""
    cfg = _cfg()
    o, d, rgb = _rays()
    states = [TT.init_state(cfg, VoxelGrid(_grid(), LO, HI), 5) for _ in range(2)]
    real = TT._apply_priors

    def autograd_form(grid, priors, loss):
        noise = TT.StepNoise(None, None, priors[0].origin, priors[1].origin)
        value, grad = _autograd_priors(grid.detach(), cfg, noise)
        grid.grad += grad
        return loss + value

    for step in range(3):
        sel = torch.randperm(N_RAYS, generator=torch.Generator().manual_seed(step))[:BATCH]
        noise = _noise(cfg, step)
        got = TT.train_step(states[0], cfg, o[sel], d[sel], rgb[sel], noise=noise)
        TT._apply_priors = autograd_form
        try:
            want = TT.train_step(states[1], cfg, o[sel], d[sel], rgb[sel], noise=noise)
        finally:
            TT._apply_priors = real
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    a, b = states
    torch.testing.assert_close(a.grid.grid, b.grid.grid, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(a.optimizer.state[a.grid.grid]["nu"],
                               b.optimizer.state[b.grid.grid]["nu"], rtol=1e-5, atol=1e-12)


def _ref_config(cfg):
    return {"num_samples": cfg.num_samples, "per_ray_aabb": cfg.per_ray_aabb,
            "contraction": False, "hierarchical": False}


def test_train_step_with_priors_matches_the_reference():
    """Three steps of the port's train_step (TV and sparsity priors on,
    RMSprop) from a seeded grid against the same steps of the benchmark's
    plain reference (render, autograd for the data term, the priors' closed
    form on their blocks, RMSprop), with the same rays and draws: losses,
    grid and second moment within 1e-5."""
    cfg = _cfg()
    o, d, rgb = _rays()
    g0 = _grid()
    state = TT.init_state(cfg, VoxelGrid(g0.clone(), LO, HI), 5)
    sc = ref.StepConfig(_ref_config(cfg), cfg.near, cfg.far)
    pri = {k: PRIORS[k] for k in ("tv_sigma", "tv_sh", "tv_crop", "sparsity_sigma")}
    opt = dict(name="rmsprop", lr=cfg.learning_rate, decay=0.95, eps=1e-8)
    p, nu = g0.clone().requires_grad_(), torch.zeros_like(g0)
    for step in range(3):
        sel = torch.randperm(N_RAYS, generator=torch.Generator().manual_seed(step))[:BATCH]
        noise = _noise(cfg, step)
        got = TT.train_step(state, cfg, o[sel], d[sel], rgb[sel], noise=noise)
        lv = ref.loss(ref_priors.Grids(p, LO, HI), sc, o[sel], d[sel], rgb[sel], noise.u, None)
        (gr,) = torch.autograd.grad(lv, p)
        with torch.no_grad():
            value, blocks = ref_priors.priors(p.detach(), pri, noise.tv_origin.tolist(),
                                              noise.sparsity_origin.tolist())
            for at, gb, channel in blocks:
                if channel is None:
                    gr[at] += gb
                else:
                    gr[at][..., channel] += gb
            ref_priors.optimizer_step(p, gr, nu, None, opt, step + 1)
        np.testing.assert_allclose(float(got), float(lv.detach() + value), rtol=1e-5)
    torch.testing.assert_close(state.grid.grid.detach(), p.detach(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(state.optimizer.state[state.grid.grid]["nu"], nu, rtol=1e-5,
                               atol=1e-10)
    assert (p.detach() - g0).abs().max() > 1e-3


def test_reference_train_steps_match_the_port():
    """reference/train_priors.py's train_steps from the constant grid
    against the port's steps with the same draws: losses, the first
    gradient's and the change's leaf norms within 1e-5."""
    cfg = _cfg(tv_crop=32)
    o, d, rgb = _rays()
    state = TT.init_state(cfg, VoxelGrid(torch.full((RES, RES, RES, 28), 0.01), LO, HI), 5)
    batches, draws, losses = [], [], []
    for step in range(3):
        sel = torch.randperm(N_RAYS, generator=torch.Generator().manual_seed(step))[:BATCH]
        noise = _noise(cfg, step)
        losses.append(float(TT.train_step(state, cfg, o[sel], d[sel], rgb[sel], noise=noise)))
        if step == 0:
            grad = ref.leaf_norms([v / 0.05 for v in ref.channel_sums(
                state.optimizer.state[state.grid.grid]["nu"])])
        batches.append((o[sel], d[sel], rgb[sel]))
        draws.append((noise.u, None, noise.tv_origin, noise.sparsity_origin))
    pri = dict(PRIORS, tv_crop=32)
    want = ref_priors.train_steps(ref.StepConfig(_ref_config(cfg), cfg.near, cfg.far),
                                  dict(name="rmsprop", lr=cfg.learning_rate, decay=0.95,
                                       eps=1e-8), pri, (RES, RES, RES, 28), 0.01, LO, HI,
                                  batches, draws)
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-5)
    change = ref.leaf_norms(ref.channel_sq_sums(state.grid.grid.detach(), 0.01))
    for name in want["grad"]:
        np.testing.assert_allclose(grad[name], want["grad"][name], rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(change[name], want["change"][name], rtol=1e-5, err_msg=name)


def test_reference_prior_closed_forms_equal_autograd():
    """The reference's closed-form TV and sparsity gradients against
    autograd on the same blocks (the closed form's rounding differs)."""
    block = _grid(7, (9, 7, 8, 28))
    b = block.clone().requires_grad_()
    c = b
    per_ch = sum(((c.narrow(a, 1, c.shape[a] - 1) - c.narrow(a, 0, c.shape[a] - 1)) ** 2
                  ).mean(dim=(0, 1, 2)) for a in range(3))
    (0.3 * per_ch[0] + 0.05 * per_ch[1:].sum()).backward()
    value, grad = ref_priors.tv_value_grad(block, 0.3, 0.05)
    torch.testing.assert_close(value, (0.3 * per_ch[0] + 0.05 * per_ch[1:].sum()).detach(),
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(grad, b.grad, rtol=1e-5, atol=1e-8)
    s = block[..., 0].clone().requires_grad_()
    want = 0.02 * torch.log1p(torch.relu(s) ** 2 / 0.25).mean()
    want.backward()
    value, grad = ref_priors.sparsity_value_grad(block[..., 0], 0.02)
    torch.testing.assert_close(value, want.detach(), rtol=1e-6, atol=0)
    torch.testing.assert_close(grad, s.grad, rtol=1e-5, atol=1e-9)
    assert bool((s.grad == 0).any()) and bool((s.grad > 0).any())


def _dataset():
    o, d, rgb = _rays(4, 168)
    return TT.RayDataset(o.numpy(), d.numpy(), rgb.numpy(),
                         np.repeat(np.arange(7, dtype=np.int32), 24))


def test_chunk_16_equals_chunk_1_with_the_prior(monkeypatch):
    """train_plenoxel under RMSprop with the TV prior at the configuration's
    weights and crop (and the sparsity prior), scan_chunk 16 against 1, two
    epochs of 21 steps: the same logged losses and grid, bit for bit; while
    tracing, every chunk is a ``dense.chunk`` span (2 a scan_chunk 16 epoch,
    one a step at scan_chunk 1)."""
    monkeypatch.setattr(trace, "_GLOBAL", None)
    monkeypatch.setattr(trace, "_ENABLED", True)
    kw = dict(grid_resolution=8, batch_size=8, num_samples=8, near=0.5, far=4.0, epochs=2,
              scene_scale=1.0, optimizer="rmsprop", tv_sigma=1e-5, tv_sh=1e-3, tv_crop=32,
              sparsity_sigma=0.01)
    out = {}
    for chunk in (16, 1):
        g, losses = TT.train_plenoxel(_dataset(), DenseConfig(scan_chunk=chunk, **kw), seed=2,
                                      verbose=False, log_every=1, device="cpu")
        out[chunk] = (g.grid, losses)
    (g16, l16), (g1, l1) = out[16], out[1]
    assert len(l16) == len(l1) == 42
    np.testing.assert_array_equal(l16, l1)
    assert torch.equal(g16, g1)
    assert trace.get_tracer().summary()["spans"]["dense.chunk"]["count"] == 2 * 2 + 42


def test_densify_dense_batch_reaches_the_config(tmp_path, monkeypatch):
    """``densify --dense-batch B`` trains with DenseConfig.batch_size B
    (2048 without the flag), the priors and optimizer of the Plenoxels
    command line with it."""
    scene = chip_smoke.make_scene(0, n_views=8, width=48, height=32)
    images = tmp_path / "images"
    images.mkdir()
    for i, rgb in enumerate(scene["rgb"]):
        Image.fromarray(rgb).save(images / f"img_{i:03d}.png")
    seen = []
    real = TC.train_plenoxel

    def spy(dataset, cfg, **kw):
        seen.append(cfg)
        return real(dataset, cfg, **kw)

    monkeypatch.setattr(TC, "train_plenoxel", spy)
    for batch in ("40", None):
        art = tmp_path / f"a{batch}"
        chip_smoke.make_reconstruction_artifacts(str(art), scene)
        TC.main(["densify", "--images", str(images), "--artifacts", str(art), "--device", "cpu",
                 "--dense-downscale", "1", "--focal", str(scene["focal"]), "--quiet",
                 "--grid-resolution", "8", "--num-samples", "8", "--ray-stride", "4",
                 "--dense-optimizer", "rmsprop", "--tv-sigma", "1e-5", "--tv-sh", "1e-3",
                 "--no-checkpoint", *(["--dense-batch", batch] if batch else [])])
    assert [c.batch_size for c in seen] == [40, 2048]
    assert all((c.optimizer, c.tv_sigma, c.tv_sh) == ("rmsprop", 1e-5, 1e-3) for c in seen)
    assert TT.LAST_TRAIN_AUX["phases"][-1]["steps"] >= 1
    assert dataclasses.replace(seen[0], batch_size=2048) == seen[1]
