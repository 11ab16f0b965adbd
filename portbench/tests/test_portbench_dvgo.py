"""The DVGO training cell (``dvgo-160.train``, loop ``train_dvgo``) at the
tiny size on the CPU: its files load by name, the reference imports neither
JAX nor the program, a sound run is correct, the control and each fault are
not, and the colour MLP's readers read the replays' spans alone."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import tpu3d_torch.dense.dvgo as dvgo
import tpu3d_torch.dense.train as dtrain
from portbench import counts, counts_dvgo, harness
from portbench.loops import train_dvgo
from portbench_tiny import tiny
from test_portbench_control import _first_batch
from tpu3d_torch.utils import trace

ROOT = Path(__file__).resolve().parents[2]
CELL = "dvgo-160.train"


def run_tiny(seed: int = 3000000019, **cfg_kw) -> dict:
    import time

    c, cfg, traffic = tiny(CELL)
    cfg.update(cfg_kw)
    return harness.run(cfg, traffic, c.limits, seed, 0.3, False, "cpu", time.time(),
                       c.end_to_end(), c.per_layer())


def test_the_cell_loads_by_name():
    script = (
        "import sys, json; from pathlib import Path; sys.path.insert(0, sys.argv[1]);"
        "from portbench import harness;"
        "c = harness.Cell(Path(sys.argv[1]), 'dvgo-160.train');"
        "print(json.dumps([c.config['name'], c.config['grid_resolution'], c.traffic['loop'],"
        " sorted(c.limits), [m['name'] for m in c.end_to_end()],"
        " [m['name'] for m in c.per_layer()], harness.loop(c.traffic['loop']).__name__]))")
    out = subprocess.run([sys.executable, "-c", script, str(ROOT)], capture_output=True,
                         text=True, check=True)
    name, res, loop, limits, e2e, layers, mod = json.loads(out.stdout)
    assert (name, res, loop, mod) == ("dvgo-160", 160, "train_dvgo", "portbench.loops.train_dvgo")
    assert limits == ["change_gap", "grad_gap", "loss_gap"]
    assert e2e == ["train_rays_per_s", "setup_s"]
    assert layers == ["train_host_ms_per_chunk", "scatter_roofline", "train_step_mfu",
                      "device_idle_share.train", "optimizer_replay_ms_per_step",
                      "rgbnet_ms_per_step", "rgbnet_mfu"]


def test_the_reference_imports_neither_jax_nor_the_program():
    tree = ast.parse((ROOT / "portbench" / "reference" / "dvgo.py").read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names <= {"__future__", "math", "typing", "numpy", "torch"}, names


def test_a_sound_run_is_correct():
    r = run_tiny()
    assert r["correct"], r["compared"]
    assert r["failed"] == 0 and r["attempted"] > 0


def _in_place(monkeypatch, make):
    """The program still steps; ``make(run)`` is put in its place."""
    real = train_dvgo.Run._checked_steps

    def checked(self):
        real(self)
        return make(self)

    monkeypatch.setattr(train_dvgo.Run, "_checked_steps", checked)


def test_control_in_bfloat16_is_not_correct(monkeypatch):
    _in_place(monkeypatch, lambda run: run.reference(torch.bfloat16))
    assert not run_tiny()["correct"]


@pytest.mark.parametrize("fault", ["tf32", "plain_adam", "no_box_mask", "no_tau", "half_batch"])
def test_reference_fault_is_not_correct(fault, monkeypatch):
    """reference/dvgo.py's faults put in the program's place. From DVGO's
    zero grid the tau filters take nothing out in the tiny run's 7 steps
    (alpha 5e-3, 32 samples a ray, every density rising), so the filters'
    fault runs from a density of -4.2, where alpha (7e-5) is below tau at
    every sample: the filters leave the program nothing to train (its sound
    run is correct, the reference as still), and without them the
    reference trains."""
    kw = {"init": -4.2} if fault == "no_tau" else {}
    if kw:
        assert run_tiny(**kw)["correct"]
    _in_place(monkeypatch, lambda run: run.reference(**{fault: True}))
    assert not run_tiny(**kw)["correct"]


@pytest.mark.parametrize("fault", ["first_batch", "unchanged"])
def test_program_fault_is_not_correct(fault, monkeypatch):
    if fault == "first_batch":
        monkeypatch.setattr(dtrain.MultiStep, "_steps", _first_batch(dtrain.MultiStep._steps))
    else:
        def unchanged(state, cfg, loss, gains, bg_sh, *priors):
            loss.backward()
            state.optimizer.zero_grad(set_to_none=True)
            state.count.add_(1)
            state.step += 1
            return loss.detach()

        monkeypatch.setattr(dvgo, "_update", unchanged)
    assert not run_tiny()["correct"]


def test_counts():
    per_row = 2 * (39 * 128 + 128 * 128 + 128 * 3)
    assert counts_dvgo.rgbnet_forward_flops() == per_row == 43_520
    needed = 2 * (3 * 128 + 128 * 128 + 128 * 12)
    assert counts_dvgo.rgbnet_flops(10) == 10 * (2 * per_row + needed)
    assert counts_dvgo.scatter_bytes(8192, 558, (160,) * 3) == counts.scatter_bytes(
        8192 * 558, 13, (160,) * 3)
    grid = 160 ** 3 * 13 * 4
    assert counts_dvgo.step_bytes((160,) * 3, 8192) == (
        6 * (grid + counts_dvgo.rgbnet_params() * 4) + 8192 * 36)


@pytest.fixture
def tracer(monkeypatch):
    monkeypatch.setattr(trace, "_GLOBAL", None)
    monkeypatch.setattr(trace, "_ENABLED", True)
    return trace.get_tracer()


def test_rgbnet_readers_read_replays_only(tracer, monkeypatch):
    """Each replayed step's forward plus backward, the median; the mfu from
    the coloured samples a step; None without spans or counters."""
    ms_reader, mfu_reader = harness.reader("rgbnet_ms_per_step"), harness.reader("rgbnet_mfu")
    assert ms_reader.read({}) is None and mfu_reader.read({"colour_samples_per_step": 1}) is None
    for mode, fwd, bwd in (("eager", [9.0], [9.0]), ("replay", [1.0, 2.0, 3.0], [2.0, 2.0, 2.0])):
        with trace.hot_span("dense.chunk", k=len(fwd), mode=mode) as chunk:
            pass
        with tracer._lock:
            for f, b in zip(fwd, bwd):
                tracer._events.append(tracer._device_event("dense.rgbnet", f, chunk.id, 0.0))
                tracer._events.append(tracer._device_event("dense.rgbnet_backward", b,
                                                           chunk.id, 0.0))
    assert ms_reader.read({}) == pytest.approx(4.0)
    mfu = mfu_reader.read({"colour_samples_per_step": 1e6})
    assert mfu == pytest.approx(100 * counts_dvgo.rgbnet_flops(1e6) / counts.H100_FP32_FLOPS
                                / 4e-3)
    assert mfu_reader.read({"colour_samples_per_step": None}) is None

    class Parent:
        def summary(self):
            return {"spans": {}, "counters": {}}

    monkeypatch.setattr(trace, "_GLOBAL", Parent())
    assert ms_reader.read({}) is None
