"""DVGO's fine stage (tpu3d_torch/dense/dvgo.py, ``densify --model dvgo``)
against the plain reference portbench/reference/dvgo.py, on seeded random
grids and MLP weights at a 12^3 grid with the published MLP widths: the
pixels, each loss term and every leaf's gradient, MaskedAdam, the dead
samples outside the box, the two tau filters, the lr decay, the chunked
loop, the tallies, the colour MLP over the coloured samples alone
(kernels/rgbnet.py's plain version) against the MLP over every sample,
checkpoint and resume, ``densify --model dvgo`` then ``render``, and every
refused flag."""
import threading

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

import chip_smoke
from portbench.reference import dvgo as ref
from tpu3d_torch import cli as TC
from tpu3d_torch.config import DenseConfig
from tpu3d_torch.dense import dvgo
from tpu3d_torch.dense import train as TT
from tpu3d_torch.dense.grid import VoxelGrid
from tpu3d_torch.io.artifacts import ArtifactStore
from tpu3d_torch.kernels import rgbnet
from tpu3d_torch.utils import trace

RES = 12
NEAR, FAR = 0.1, 6.0
LO, HI = torch.full((3,), -1.0), torch.full((3,), 1.0)


def _cfg(**kw) -> DenseConfig:
    return DenseConfig(grid_resolution=RES, batch_size=48, near=NEAR, far=FAR, scene_scale=1.0,
                       **kw)


def _grid(seed: int, density_scale: float = 3.0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    grid = torch.randn((RES,) * 3 + (dvgo.CHANNELS,), generator=g)
    grid[..., 0] *= density_scale
    return grid


def _rays(n: int = 48, seed: int = 0):
    """Rays from about (0, 0, -3) towards the box, some of them missing it."""
    g = torch.Generator().manual_seed(seed)
    o = torch.tensor([0.0, 0.0, -3.0]) + 0.4 * torch.randn(n, 3, generator=g)
    d = F.normalize(torch.tensor([0.0, 0.0, 1.0]) + 0.35 * torch.randn(n, 3, generator=g), dim=-1)
    return o, d, torch.rand(n, 3, generator=g), torch.rand(n, 1, generator=g)


def _spec() -> ref.Spec:
    return ref.Spec((RES,) * 3, 1.0, NEAR, FAR)


def _program(grid, params, o, d, rgb, u):
    """The program's march and terms, with every leaf's gradient."""
    vg = VoxelGrid(grid.clone().requires_grad_(), LO, HI)
    ps = [p.clone().requires_grad_() for p in params]
    out = dvgo.march(vg, ps, o, d, NEAR, FAR, _spec().step, u)
    terms = dvgo.loss_terms(*out[:4], rgb)
    loss = terms[0] + dvgo.WEIGHT_ENTROPY_LAST * terms[1] + dvgo.WEIGHT_RGBPER * terms[2]
    grads = torch.autograd.grad(loss, [vg.grid, *ps])
    return out, terms, grads


def _reference(grid, params, o, d, rgb, u, **faults):
    leaves = [grid.clone().requires_grad_()] + [p.clone().requires_grad_() for p in params]
    pix, *terms = ref.step_terms(leaves[0], leaves[1:], LO, HI, _spec(), o, d, rgb, u, **faults)
    loss = terms[0] + ref.W_ENTROPY * terms[1] + ref.W_RGBPER * terms[2]
    return pix, terms, torch.autograd.grad(loss, leaves)


def test_sizes_follow_dvgo():
    assert dvgo.n_samples((160,) * 3) == 558 == ref.Spec((160,) * 3, 1.0, 0.1, 6.0).n
    assert dvgo.step_length((-1,) * 3, (1,) * 3, (160,) * 3) == pytest.approx(0.5 * 2 / 160)
    assert dvgo.act_shift() == pytest.approx(np.log(1 / 0.99 - 1))
    shapes = [tuple(t.shape) for t in dvgo.init_rgbnet(0)]
    assert shapes == [(128, 39), (128,), (128, 128), (128,), (3, 128), (3,)]
    assert float(dvgo.init_rgbnet(0)[-1].abs().sum()) == 0.0
    assert dvgo.view_encoding(torch.ones(2, 3)).shape == (2, 27)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pixels_terms_and_gradients_match_the_reference(seed):
    grid, params = _grid(seed), dvgo.init_rgbnet(seed + 10)
    o, d, rgb, u = _rays(seed=seed)
    (pix, *_), terms, grads = _program(grid, params, o, d, rgb, u)
    want_pix, want_terms, want_grads = _reference(grid, params, o, d, rgb, u)
    torch.testing.assert_close(pix, want_pix, rtol=0, atol=2e-6)
    for got, want in zip(terms, want_terms):
        torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-7)
    for got, want in zip(grads, want_grads):
        scale = float(want.abs().max())
        assert scale > 0
        torch.testing.assert_close(got, want, rtol=0, atol=2e-4 * scale)
    # the masked update reads exact zeros: the same elements on both sides
    assert torch.equal(grads[0] == 0, want_grads[0] == 0)
    assert bool((grads[0] == 0).any()) and bool((grads[0] != 0).any())


def test_masked_adam_keeps_zero_gradient_elements_and_updates_the_mlp_everywhere():
    g = torch.Generator().manual_seed(4)
    grid, w = torch.randn(4, 4, 4, 13, generator=g), torch.randn(8, 5, generator=g)
    opt = TT.MaskedAdam([{"params": [grid], "lr": torch.tensor(0.1), "skip_zero_grad": True},
                         {"params": [w], "lr": torch.tensor(1e-3)}], betas=(0.9, 0.99))
    want = [grid.clone(), w.clone()]
    moments = [(torch.zeros_like(t), torch.zeros_like(t)) for t in want]
    for t in range(1, 4):
        grads = [torch.randn(grid.shape, generator=g), torch.randn(w.shape, generator=g)]
        grads[0][grads[0].abs() < 0.7] = 0.0
        if t > 1:
            grads[1][0] = 0.0
        before = [grid.clone(), opt.state[grid]["exp_avg"].clone(),
                  opt.state[grid]["exp_avg_sq"].clone()]
        w_before = w.clone()
        grid.grad, w.grad = grads
        opt.step()
        zero = grads[0] == 0
        for now, old in zip((grid, opt.state[grid]["exp_avg"], opt.state[grid]["exp_avg_sq"]),
                            before):
            assert torch.equal(now[zero], old[zero])
        assert bool((grid[~zero] != before[0][~zero]).all())
        # the MLP's row of zero gradient moves on its momentum after step 1
        assert bool((w[0] != w_before[0]).all()) or t == 1
        for k, (q, gr, (m, v)) in enumerate(zip(want, grads, moments)):
            ref.masked_adam(q, gr, m, v, t, 0.1 if k == 0 else 1e-3, masked=k == 0)
        torch.testing.assert_close(grid, want[0], rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(w, want[1], rtol=1e-6, atol=1e-7)
    assert float(opt.state[w]["step"]) == 3.0


def test_samples_outside_the_box_are_dead():
    o = torch.tensor([[0.0, 0.0, -3.0], [2.5, 0.0, -3.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    S, step = dvgo.n_samples((RES,) * 3), _spec().step
    pts, dead = dvgo.sample_ray(o, d, LO, HI, NEAR, FAR, S, step)
    inside = (pts[0, :, 2] <= 1.0)
    assert torch.equal(dead[0], ~inside) and bool(inside.any()) and bool((~inside).any())
    assert bool(dead[1].all())
    assert float(pts[0, 0, 2]) == pytest.approx(-1.0)            # the box entry
    grid = torch.full((RES,) * 3 + (13,), 4.0)                    # opaque everywhere
    vg = VoxelGrid(grid, LO, HI)
    pix, _, wc, t_last, _ = dvgo.march(vg, dvgo.init_rgbnet(0), o, d, NEAR, FAR, step)
    assert float(t_last[1]) == 1.0 and torch.equal(pix[1], torch.ones(3))
    assert float(wc[0][dead[0]].abs().sum()) == 0.0
    # not masked, the samples past the box would read the face's density
    want = ref.step_terms(grid, dvgo.init_rgbnet(0), LO, HI, _spec(), o, d, torch.zeros(2, 3),
                          torch.zeros(2, 1), no_box_mask=True)[0]
    assert float((want[1] - pix[1]).abs().max()) > 0.1


def test_the_two_tau_filters():
    o, d, rgb, u = _rays(seed=5)
    params = dvgo.init_rgbnet(3)
    # alpha <= tau everywhere: nothing composited, no gradient to the grid
    clear = torch.full((RES,) * 3 + (13,), -5.0)                  # alpha 3.4e-5
    clear[..., 1:] = torch.randn((RES,) * 3 + (12,), generator=torch.Generator().manual_seed(0))
    (pix, _, wc, t_last, coloured), _, grads = _program(clear, params, o, d, rgb, u)
    assert torch.equal(pix, torch.ones_like(pix)) and torch.equal(t_last, torch.ones_like(t_last))
    assert not bool(coloured.any()) and float(grads[0].abs().sum()) == 0.0
    no_tau = _reference(clear, params, o, d, rgb, u, no_tau=True)[0]
    assert float((no_tau - pix).detach().abs().max()) > 1e-4
    # an opaque front half: the samples behind it weigh w <= tau, uncoloured
    front = _grid(6)
    front[..., :RES // 2, 0] = 12.0
    (pix, _, wc, t_last, coloured), _, grads = _program(front, params, o, d, rgb, u)
    S = dvgo.n_samples((RES,) * 3)
    pts, dead = dvgo.sample_ray(o, d, LO, HI, NEAR, FAR, S, _spec().step, u)
    live_behind = ~dead & (pts[..., 2] > 0.3)
    assert bool(live_behind.any()) and not bool((coloured & live_behind).any())
    assert torch.equal(wc > 0, coloured)
    torch.testing.assert_close(pix, _reference(front, params, o, d, rgb, u)[0], rtol=0, atol=2e-6)


def test_lr_decays_per_step():
    s = TT.LrSchedule(0.1, (), 20000)
    for k in (0, 1, 999, 20000, 55555):
        assert s(k) == pytest.approx(0.1 * 0.1 ** (k / 20000), rel=1e-12)
        assert float(s.on_device(torch.tensor(k))) == np.float32(s(k))
    state = dvgo.init_state(_cfg(), VoxelGrid(_grid(0), LO, HI), 10)
    o, d, rgb, _ = _rays()
    state.set_step(20000)
    dvgo.dvgo_train_step(state, _cfg(), o, d, rgb, generator=torch.Generator().manual_seed(0))
    lrs = [float(g["lr"]) for g in state.optimizer.param_groups]
    assert lrs == [np.float32(0.01), np.float32(1e-4)] and state.step == 20001


def _dataset(n: int = 240, seed: int = 1) -> TT.RayDataset:
    o, d, rgb, _ = _rays(n, seed)
    return TT.RayDataset(o.numpy(), d.numpy(), rgb.numpy())


def test_chunked_loop_equals_single_steps():
    """train_dvgo at scan_chunk 4 (MultiStep's chunks, eager on the CPU)
    against scan_chunk 1, bit for bit, and its record."""
    out = [dvgo.train_dvgo(_dataset(), _cfg(scan_chunk=k, epochs=2), seed=3, verbose=False,
                           log_every=2, device="cpu") for k in (4, 1)]
    (g4, p4, l4), (g1, p1, l1) = out
    assert torch.equal(g4.grid, g1.grid) and l4 == l1 and len(l4) == 6
    assert all(torch.equal(a, b) for a, b in zip(p4, p1))
    assert TT.LAST_TRAIN_AUX["steps"] == 10


def test_tallies_fold_into_the_tracer_at_a_read_back(monkeypatch):
    monkeypatch.setattr(trace, "_GLOBAL", None)
    monkeypatch.setattr(trace, "_ENABLED", True)
    dvgo.train_dvgo(_dataset(), _cfg(scan_chunk=2), seed=3, verbose=False, log_every=2,
                    device="cpu")
    counters = trace.get_tracer().summary()["counters"]
    S = dvgo.n_samples((RES,) * 3)
    # reads back at steps 0, 2, 4: the tallies of steps 1-5 fold in
    assert counters["dense.rgbnet_rows"] == 5 * 48 * S
    assert 0 < counters["dense.colour_samples"] < counters["dense.rgbnet_rows"]
    assert counters["dense.rgbnet_rows_run"] == counters["dense.colour_samples"]


def _dense_forward(k0, emb, coloured, params, save=True):
    """The colour MLP over every row (the dense formula): rgbnet_forward's
    interface, the colours of the uncoloured rows kept."""
    R, S = k0.shape[0], k0.shape[0] // emb.shape[0]
    w1, b1, w2, b2, w3, b3 = params
    x = torch.cat([k0, emb[:, None, :].expand(-1, S, -1).reshape(R, -1)], -1)
    h1 = torch.addmm(b1, x, w1.t()).relu_()
    h2 = torch.addmm(b2, h1, w2.t()).relu_()
    c = torch.sigmoid(torch.addmm(b3, h2, w3.t()))
    return c, coloured.sum(dtype=torch.int32).reshape(1), (x, h1, h2, c)


def _dense_backward(g, saved, params):
    x, h1, h2, c = saved
    w1, _, w2, _, w3, _ = params
    gl = g * (1 - c) * c
    gh2 = torch.ops.aten.threshold_backward(gl.mm(w3), h2, 0.0)
    gh1 = torch.ops.aten.threshold_backward(gh2.mm(w2), h1, 0.0)
    return gh1.mm(w1[:, :12]), (gh1.t().mm(x), gh1.sum(0), gh2.t().mm(h1), gh2.sum(0),
                                gl.t().mm(h2), gl.sum(0))


@pytest.mark.parametrize("seed", [0, 1])
def test_compacted_mlp_equals_the_dense_formula_on_coloured_rows(seed):
    """kernels/rgbnet.py's plain version against the MLP over every row:
    the colours of the coloured rows and 0 at the others, the k0 cotangent
    likewise (+0), and the leaves' gradients when the cotangent is 0 at the
    uncoloured rows, as the step's is."""
    g = torch.Generator().manual_seed(seed)
    N, S = 24, 31
    k0 = torch.randn((N * S, 13), generator=g)[:, 1:]
    emb = dvgo.view_encoding(F.normalize(torch.randn((N, 3), generator=g), dim=-1))
    coloured = torch.rand((N, S), generator=g) < 0.4
    params = dvgo.init_rgbnet(seed + 3)
    params = params[:-1] + (0.1 * torch.randn(3, generator=g),)
    mask = coloured.reshape(-1)
    cot = torch.randn((N * S, 3), generator=g) * mask[:, None]
    c, count, saved = rgbnet.rgbnet_forward(k0, emb, coloured, params)
    gk0, grads = rgbnet.rgbnet_backward(cot, saved, params)
    want_c, _, want_saved = _dense_forward(k0, emb, coloured, params)
    want_gk0, want_grads = _dense_backward(cot, want_saved, params)
    assert int(count) == int(mask.sum()) and 0 < int(count) < N * S
    torch.testing.assert_close(c[mask], want_c[mask], rtol=0, atol=1e-6)
    assert bool((want_c[~mask] != 0).all())
    for got in (c[~mask], gk0[~mask]):
        assert bool((got.view(torch.int32) == 0).all())          # +0.0, not -0.0
    torch.testing.assert_close(gk0[mask], want_gk0[mask], rtol=1e-5, atol=1e-8)
    for got, want in zip(grads, want_grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
    # the CPU compaction: the coloured rows in ascending order
    idx, n = rgbnet.compact(coloured)
    assert torch.equal(idx[:int(n)].long(), mask.nonzero().reshape(-1))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masked_adam_skips_the_same_grid_elements_as_under_the_dense_formula(seed,
                                                                             monkeypatch):
    """The whole march, loss and backward with the MLP over the coloured
    rows against the same with the MLP over every row: the same pixels and
    terms, the grid gradient's exact zeros (the elements MaskedAdam skips)
    at the same elements, and the gradients to rounding."""
    grid, params = _grid(seed), dvgo.init_rgbnet(seed + 10)
    o, d, rgb, u = _rays(seed=seed)
    (pix, *_), terms, grads = _program(grid, params, o, d, rgb, u)
    monkeypatch.setattr(dvgo, "rgbnet_forward", _dense_forward)
    monkeypatch.setattr(dvgo, "rgbnet_backward", _dense_backward)
    (want_pix, *_), want_terms, want_grads = _program(grid, params, o, d, rgb, u)
    torch.testing.assert_close(pix, want_pix, rtol=0, atol=1e-6)
    for got, want in zip(terms, want_terms):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-8)
    zero = grads[0] == 0
    assert torch.equal(zero, want_grads[0] == 0)
    assert bool(zero[..., 1:].any()) and bool((~zero[..., 1:]).any())
    for got, want in zip(grads, want_grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * float(want.abs().max()))


def test_rgbnet_refuses_what_it_does_not_take():
    k0, emb = torch.zeros((10, 12)), torch.zeros((2, 27))
    coloured, params = torch.zeros((2, 5), dtype=torch.bool), dvgo.init_rgbnet(0)
    rgbnet.rgbnet_forward(k0, emb, coloured, params)
    for bad in ((torch.zeros((10, 11)), emb, coloured, params),
                (k0, torch.zeros((3, 27)), coloured, params),
                (k0, emb, coloured.float(), params),
                (k0, emb, coloured, params[:5]),
                (k0.t().contiguous().t(), emb, coloured, params)):
        with pytest.raises(ValueError):
            rgbnet.rgbnet_forward(*bad)


def test_a_thread_adopts_the_forward_context():
    seen = []
    with trace.graph_marks() as marks:
        ctx = trace.thread_context()

    def other():
        with trace.adopt(ctx):
            seen.append(trace._LOCAL.marks is marks)
        seen.append(getattr(trace._LOCAL, "marks", None) is None)

    t = threading.Thread(target=other)
    t.start()
    t.join()
    assert seen == [True, True]


def test_checkpoint_and_resume(tmp_path):
    store = ArtifactStore(str(tmp_path))
    cfg = _cfg(epochs=1, scan_chunk=2)
    grid, params, _ = dvgo.train_dvgo(_dataset(), cfg, seed=3, verbose=False, device="cpu",
                                      checkpoint_store=store)
    state, epoch, losses = TT.load_checkpoint(store, cfg, 5, "cpu", init=dvgo.init_state)
    assert epoch == 0 and state.step == 5 and len(losses) == 1
    assert torch.equal(state.grid.grid.detach(), grid.grid)
    assert all(torch.equal(a.detach(), b) for a, b in zip(state.params, params))
    for q in (state.grid.grid, *state.params):
        st = state.optimizer.state[q]
        assert float(st["step"]) == 5.0 and float(st["exp_avg_sq"].abs().sum()) > 0
    # resumed, the run goes on from epoch 1 with the saved model and moments
    grid2, params2, losses2 = dvgo.train_dvgo(_dataset(), TT.dataclasses.replace(cfg, epochs=2),
                                              seed=3, verbose=False, device="cpu",
                                              checkpoint_store=store, resume=True)
    assert TT.LAST_TRAIN_AUX["steps"] == 10 and len(losses2) == 2
    assert not torch.equal(grid2.grid, grid.grid)


def _scene_artifacts(tmp_path):
    scene = chip_smoke.make_scene(0, n_views=8, width=48, height=32)
    images = tmp_path / "images"
    images.mkdir()
    for i, rgb in enumerate(scene["rgb"]):
        Image.fromarray(rgb).save(images / f"img_{i:03d}.png")
    art = tmp_path / "art"
    chip_smoke.make_reconstruction_artifacts(str(art), scene)
    return scene, images, art


def test_densify_model_dvgo_then_render(tmp_path, capsys):
    scene, images, art = _scene_artifacts(tmp_path)
    common = ["--images", str(images), "--artifacts", str(art), "--device", "cpu",
              "--dense-downscale", "1", "--focal", str(scene["focal"]), "--quiet"]
    TC.main(["densify", *common, "--model", "dvgo", "--grid-resolution", "8",
             "--ray-stride", "4", "--dense-batch", "64"])
    store = ArtifactStore(str(art))
    meta, saved = store.load_json("dense_meta"), store.load("dense_grid")
    assert meta["model"] == "dvgo" and meta["num_samples"] == dvgo.n_samples((8,) * 3)
    assert saved["grid"].shape == (8, 8, 8, 13) and "rgbnet_5" in saved
    assert np.isfinite(store.load_json("dense_result")["test_psnr"])
    assert store.load("mesh_grid") is None
    with pytest.raises(ValueError, match="DVGO model's colour comes from its MLP"):
        TC.mesh(str(art))
    capsys.readouterr()
    TC.main(["render", *common, "--render-views", "0,1", "--render-stride", "4"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"frames": 2' in out
    pngs = sorted((art / "renders").glob("*.png"))
    assert len(pngs) == 2 and np.asarray(Image.open(pngs[0])).shape == (8, 12, 3)
    ev = TC.densify_eval_only(store, scene["rgb"], [f"img_{i:03d}.png" for i in range(8)],
                              scene["focal"], device="cpu")
    assert np.isfinite(ev["test_psnr"])


@pytest.mark.parametrize("flag", [
    {"mesh": "1x1"}, {"contraction": True}, {"hierarchical": True}, {"detail_epochs": 2},
    {"detail_res": 64}, {"detail_only": True}, {"occupancy": True}, {"camera_gate": True},
    {"optimizer": "rmsprop"}, {"tv_sigma": 1e-5}, {"tv_sh": 1e-3}, {"sparsity_sigma": 1e-3},
    {"exposure": True}, {"sh_background": True}, {"coarse_epochs": 1}, {"aniso_grid": True}])
def test_densify_refuses_what_dvgo_does_not_take(flag, tmp_path):
    with pytest.raises(ValueError, match="--model dvgo does not take"):
        TC.densify(str(tmp_path), np.zeros((1, 4, 4, 3), np.uint8), ["a"], 1.0, model="dvgo",
                   device="cpu", **flag)


def test_a_ray_file_does_not_train_dvgo(tmp_path):
    with pytest.raises(ValueError, match="not --model dvgo"):
        TC.densify_from_rays(str(tmp_path), str(tmp_path / "rays.pkl"), model="dvgo",
                             device="cpu")
