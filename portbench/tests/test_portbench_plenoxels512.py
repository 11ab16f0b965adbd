"""The two cells on the Plenoxels grid and the cascade's render
(``plenoxels-512.train``, loop ``train_priors``; ``recipe-256.render``, loop
``cascade_render``) at the tiny size on the CPU: a sound run is correct,
the control and each fault are not, and the reader of the priors' span
reads the replays' spans alone."""
import pytest
import torch

import tpu3d_torch.dense.eval as deval
import tpu3d_torch.dense.train as dtrain
from portbench import harness
from portbench.loops import cascade_render, train_priors
from portbench_tiny import tiny
from test_portbench_control import (_altered_loss, _altered_pixel, _first_batch, _half_batch,
                                    _half_rays, _same_draw, _stale)
from tpu3d_torch.utils import trace

TRAIN, RENDER = "plenoxels-512.train", "recipe-256.render"


def run_tiny(cell: str, seed: int = 3000000007, **cfg_kw) -> dict:
    """One whole run of the cell at portbench_tiny's size on the CPU (the
    render's flythrough, chunk and checked views cut as for the render
    cell), with ``cfg_kw`` over the configuration."""
    import time

    c, cfg, traffic = tiny(cell)
    cfg.update(cfg_kw)
    if traffic["loop"] == "cascade_render":
        traffic.update(path_frames=6, chunk=512, check_views=2)
    return harness.run(cfg, traffic, c.limits, seed, 0.3, False, "cpu", time.time(),
                       c.end_to_end(), c.per_layer())


@pytest.mark.parametrize("cell", [TRAIN, RENDER])
def test_a_sound_run_is_correct(cell):
    r = run_tiny(cell)
    assert r["correct"], r["compared"]
    assert r["failed"] == 0 and r["attempted"] > 0


def test_the_train_cell_steps_with_the_priors(monkeypatch):
    """The cell's steps take the configuration's TV prior (and RMSprop at
    its decay): every step hands _update the TV block."""
    seen = []
    real = dtrain._update

    def update(state, cfg, loss, gains, bg_sh, *priors):
        seen.append((cfg.tv_sigma, cfg.tv_sh, cfg.optimizer, tuple(p.kind for p in priors)))
        return real(state, cfg, loss, gains, bg_sh, *priors)

    monkeypatch.setattr(dtrain, "_update", update)
    assert run_tiny(TRAIN)["correct"]
    assert seen and set(seen) == {(1e-5, 1e-3, "rmsprop", ("tv",))}


def test_training_control_in_bfloat16_is_not_correct(monkeypatch):
    real = train_priors.Run._checked_steps

    def checked(self):
        real(self)
        return self.reference(torch.bfloat16)

    monkeypatch.setattr(train_priors.Run, "_checked_steps", checked)
    assert not run_tiny(TRAIN)["correct"]


def test_render_control_in_bfloat16_is_not_correct(monkeypatch):
    monkeypatch.setattr(cascade_render.Run, "_view",
                        lambda self, f: self.reference_image(f, torch.bfloat16))
    assert not run_tiny(RENDER)["correct"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "first_batch", "same_draw",
                                   "altered_loss", "no_prior"])
def test_training_fault_is_not_correct(fault, monkeypatch):
    """loops/train.py's faults, and the priors left out of the step. The
    configuration's weights (1e-5, 1e-3) move the checked steps by less
    than rounding at this size, so the prior's fault runs at weights 1 and
    1, where the check must see it."""
    kw = {}
    if fault == "unchanged":
        def unchanged(state, cfg, loss, gains, bg_sh, *priors):
            loss.backward()
            state.optimizer.zero_grad(set_to_none=True)
            state.count.add_(1)
            state.step += 1
            return loss.detach()

        monkeypatch.setattr(dtrain, "_update", unchanged)
    elif fault == "half_batch":
        monkeypatch.setattr(dtrain, "train_step", _half_batch(dtrain.train_step))
    elif fault == "first_batch":
        monkeypatch.setattr(dtrain.MultiStep, "_steps", _first_batch(dtrain.MultiStep._steps))
    elif fault == "same_draw":
        monkeypatch.setattr(dtrain, "draw_step_noise", _same_draw(dtrain.draw_step_noise))
    elif fault == "altered_loss":
        monkeypatch.setattr(dtrain, "train_step", _altered_loss(dtrain.train_step))
    else:
        kw = dict(tv_sigma=1.0, tv_sh=1.0)
        assert run_tiny(TRAIN, **kw)["correct"]
        monkeypatch.setattr(dtrain, "_crop_priors", lambda cfg, noise: ())
    assert not run_tiny(TRAIN, **kw)["correct"]


@pytest.mark.parametrize("fault", ["stale_view", "half_rays", "altered_pixel", "no_base"])
def test_render_fault_is_not_correct(fault, monkeypatch):
    """loops/render.py's faults, and the view rendered without its base."""
    if fault == "stale_view":
        monkeypatch.setattr(deval, "render_view", _stale(deval.render_view))
    elif fault == "half_rays":
        monkeypatch.setattr(deval, "render_image", _half_rays(deval.render_image))
    elif fault == "altered_pixel":
        monkeypatch.setattr(deval, "render_view", _altered_pixel(deval.render_view))
    else:
        real = deval.render_view
        monkeypatch.setattr(deval, "render_view",
                            lambda *a, **kw: real(*a, **dict(kw, base_grid=None)))
    assert not run_tiny(RENDER)["correct"]


def test_cascade_context_counts_both_grids():
    """The render cell's byte and FLOP counts: two trilinear reads a sample."""
    from portbench import counts

    run = object.__new__(cascade_render.Run)
    run.pixels, run.n, run.trace = 1000, 192, None
    ctx = run.layer_context()
    assert ctx["trilinear_bytes"] == 3 * 2 * counts.trilinear_bytes(1000 * 192, 28)
    assert ctx["view_flops"] == 1000 * 192 * (2 * counts.sample_flops(28)
                                              + counts.SHADE_FLOPS + counts.COMPOSITE_FLOPS)


@pytest.fixture
def tracer(monkeypatch):
    monkeypatch.setattr(trace, "_GLOBAL", None)
    monkeypatch.setattr(trace, "_ENABLED", True)
    return trace.get_tracer()


def test_prior_reader_reads_replays_only(tracer, monkeypatch):
    """The median of the ``dense.prior`` spans under replay chunks; None
    without any, and None from a tracer without a span accessor."""
    reader = harness.reader("prior_ms_per_step")
    assert reader.read({}) is None
    for mode, ms in (("eager", [9.0]), ("capture", [8.0]), ("replay", [0.2, 0.3, 0.1])):
        with trace.hot_span("dense.chunk", k=len(ms), mode=mode) as chunk:
            pass
        for v in ms:
            with tracer._lock:
                tracer._events.append(tracer._device_event("dense.prior", v, chunk.id, 0.0))
        with tracer._lock:
            tracer._events.append(tracer._device_event("dense.optimizer", 5.0, chunk.id, 0.0))
    assert reader.read({}) == pytest.approx(0.2)

    class Parent:
        def summary(self):
            return {"spans": {}, "counters": {}}

    monkeypatch.setattr(trace, "_GLOBAL", Parent())
    assert reader.read({}) is None
