"""The check fails what it must: the control (the reference computed in
bfloat16, put in the program's place) and each fault a cell can have, each
driven through the rest of a whole run at the tiny size on the CPU."""
import numpy as np
import pytest
import torch

import tpu3d_torch.dense.eval as deval
import tpu3d_torch.dense.train as dtrain
from portbench.loops import render, train
from portbench_tiny import run_tiny

TRAIN_CELLS = ["plenoxel-256.train", "recipe-256.detail"]


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_training_control_in_bfloat16_is_not_correct(cell, monkeypatch):
    def control(self):
        return self.reference(torch.bfloat16)

    real = train.Run._checked_steps

    def checked(self):
        real(self)                   # the program still runs its steps
        return control(self)

    monkeypatch.setattr(train.Run, "_checked_steps", checked)
    assert not run_tiny(cell)["correct"]


def test_render_control_in_bfloat16_is_not_correct(monkeypatch):
    monkeypatch.setattr(render.Run, "_view",
                        lambda self, f: self.reference_image(f, torch.bfloat16))
    assert not run_tiny("plenoxel-256.render")["correct"]


def _unchanged(real):
    def update(state, cfg, loss, gains, bg_sh):
        loss.backward()
        state.optimizer.zero_grad(set_to_none=True)
        state.count.add_(1)
        state.step += 1
        return loss.detach()
    return update


def _half_batch(real):
    def step(state, cfg, rays_o, rays_d, rgb, *a, **kw):
        h = rays_o.shape[0] // 2
        g = kw.get("generator")
        kw["noise"] = dtrain.draw_step_noise(cfg, state.grid.grid.shape, rays_o.shape[0], g,
                                             rays_o.device)
        kw["noise"] = kw["noise"]._replace(
            u=kw["noise"].u[:h], u_fine=None if kw["noise"].u_fine is None
            else kw["noise"].u_fine[:h])
        return real(state, cfg, rays_o[:h], rays_d[:h], rgb[:h], *a, **kw)
    return step


def _first_batch(real):
    """Every step of a chunk on the chunk's first batch."""
    def steps(self, state, cfg, idx, *a, **kw):
        return real(self, state, cfg, idx[:1].expand_as(idx), *a, **kw)
    return steps


def _same_draw(real):
    """Every step on the first step's draws: the generator's stream is not
    advanced between the steps of a chunk."""
    first = []

    def draw(*a, **kw):
        if not first:
            first.append(real(*a, **kw))
        return first[0]
    return draw


def _altered_loss(real):
    def step(*a, **kw):
        return real(*a, **kw) * 1.01
    return step


@pytest.mark.parametrize("cell", TRAIN_CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "first_batch", "same_draw",
                                   "altered_loss"])
def test_training_fault_is_not_correct(cell, fault, monkeypatch):
    if fault == "unchanged":
        monkeypatch.setattr(dtrain, "_update", _unchanged(dtrain._update))
    elif fault == "half_batch":
        monkeypatch.setattr(dtrain, "train_step", _half_batch(dtrain.train_step))
    elif fault == "first_batch":
        monkeypatch.setattr(dtrain.MultiStep, "_steps", _first_batch(dtrain.MultiStep._steps))
    elif fault == "same_draw":
        monkeypatch.setattr(dtrain, "draw_step_noise", _same_draw(dtrain.draw_step_noise))
    else:
        monkeypatch.setattr(dtrain, "train_step", _altered_loss(dtrain.train_step))
    assert not run_tiny(cell)["correct"]


def _stale(real):
    last = []

    def view(*a, **kw):
        img = real(*a, **kw)
        out = last[0] if last else img
        last[:] = [img]
        return out
    return view


def _half_rays(real):
    def image(vg, rays_o, rays_d, *a, **kw):
        h = rays_o.shape[0] // 2
        top = real(vg, rays_o[:h], rays_d[:h], *a, **kw)
        return torch.cat([top, top.mean(dim=0, keepdim=True).expand(rays_o.shape[0] - h, 3)])
    return image


def _altered_pixel(real):
    def view(*a, **kw):
        img = np.array(real(*a, **kw))
        img[img.shape[0] // 2, img.shape[1] // 2, 0] += 0.25
        return img
    return view


@pytest.mark.parametrize("fault", ["stale_view", "half_rays", "altered_pixel"])
def test_render_fault_is_not_correct(fault, monkeypatch):
    if fault == "stale_view":
        monkeypatch.setattr(deval, "render_view", _stale(deval.render_view))
    elif fault == "half_rays":
        monkeypatch.setattr(deval, "render_image", _half_rays(deval.render_image))
    else:
        monkeypatch.setattr(deval, "render_view", _altered_pixel(deval.render_view))
    assert not run_tiny("plenoxel-256.render")["correct"]
