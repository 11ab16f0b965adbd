"""The dense path's hot and device spans (tpu3d_torch/utils/trace.py) on the
CPU: nothing recorded while tracing is off; the render view's tree and the
training loop's chunk spans while the tracer is enabled; which ray build a
view took, by its counter; the same spans as
``tpu3d.*`` ranges under torch.profiler, a kernel launch's as an
operator's range; device spans a no-op without a card; and the training
loop's printed rays/s over the whole loop."""
import numpy as np
import pytest
import torch

from tpu3d_torch.config import DenseConfig
from tpu3d_torch.dense import eval as TE
from tpu3d_torch.dense import train as TT
from tpu3d_torch.dense.grid import VoxelGrid
from tpu3d_torch.utils import trace

VIEW_PHASES = ["render.ray_build", "render.upload", "render.enqueue", "render.image_copy"]


@pytest.fixture
def tracer(monkeypatch):
    """A fresh global tracer, tracing off."""
    monkeypatch.setattr(trace, "_GLOBAL", None)
    monkeypatch.setattr(trace, "_ENABLED", False)
    return trace.get_tracer()


def _render():
    """One 12 x 10 view at stride 2 of a random 8^3 grid, in chunks of 16
    rays (30 rays: 2 chunks)."""
    g = torch.Generator().manual_seed(0)
    grid = VoxelGrid(torch.rand((8, 8, 8, 28), generator=g) - 0.3,
                     torch.full((3,), -1.0), torch.full((3,), 1.0))
    cam = np.array([0.1, -0.2, 0.05, 0.0, 0.0, 3.0])
    cfg = DenseConfig(near=0.5, far=5.0, num_samples=8)
    return TE.render_view(grid, cam, 12, 10, 10.0, cfg, stride=2, chunk=16)


def _train():
    """train_plenoxel on the CPU: 21 steps of 8 rays, chunks of 16 and 5."""
    rng = np.random.RandomState(3)
    o = rng.normal(size=(168, 3)).astype(np.float32)
    o = 2.5 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o + rng.normal(scale=0.3, size=o.shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ds = TT.RayDataset(o, d, rng.uniform(0.2, 0.8, (168, 3)).astype(np.float32))
    cfg = DenseConfig(grid_resolution=8, batch_size=8, num_samples=8, near=0.5, far=4.0,
                      epochs=1, scene_scale=1.0, scan_chunk=16)
    return TT.train_plenoxel(ds, cfg, seed=2, verbose=False, log_every=4, device="cpu")


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def test_nothing_recorded_while_tracing_is_off(tracer):
    """Off, a hot span is one shared no-op context, and neither a render
    view nor a training loop records a span or a counter."""
    assert not trace.tracing()
    assert trace.hot_span("a", x=1) is trace.hot_span("b")
    assert trace.device_span("c") is trace.hot_span("a")
    img = _render()
    _train()
    assert img.shape == (6, 5, 3)
    assert tracer.spans() == [] and tracer.summary() == {"spans": {}, "counters": {}}


def test_enabled_tracer_records_the_view_tree_and_the_chunks(tracer):
    """Enabled: ``render.view`` with its ray count and chunks, and its four
    phases as its children in order; every training chunk a ``dense.chunk``
    span (eager on the CPU) with its length; no device span on the CPU; the
    chunks' ids distinct, parents None. Disabling stops the recording."""
    assert trace.enable(True) is False
    assert trace.tracing()
    _render()
    spans = tracer.spans()
    (view,) = [s for s in spans if s["name"] == "render.view"]
    assert view["args"] == {"rays": 30, "chunks": 2} and view["parent"] is None
    kids = sorted((s for s in spans if s["parent"] == view["id"]), key=lambda s: s["ts"])
    assert [s["name"] for s in kids] == VIEW_PHASES
    for s in kids:
        assert view["ts"] <= s["ts"] and s["ts"] + s["dur"] <= view["ts"] + view["dur"] + 1.0
    assert all(s["ph"] == "X" and "cat" not in s for s in spans)

    n = len(spans)
    _train()
    chunks = [s for s in tracer.spans()[n:] if s["name"] == "dense.chunk"]
    assert [(s["args"], s["parent"]) for s in chunks] == [
        ({"k": 16, "mode": "eager"}, None), ({"k": 5, "mode": "eager"}, None)]
    assert len({s["id"] for s in tracer.spans()}) == len(tracer.spans())
    assert not [s for s in tracer.spans() if s.get("cat") == "device"]
    summary = tracer.summary()
    assert summary["spans"]["dense.chunk"]["count"] == 2
    assert summary["spans"]["render.view"]["count"] == 1

    assert trace.enable(False) is True
    m = len(tracer.spans())
    _render()
    assert len(tracer.spans()) == m


def test_cpu_render_view_counts_the_host_ray_build(tracer):
    """A traced render_view on a CPU grid builds its rays in numpy:
    ``render.rays_host`` 1, ``render.rays_device`` never, and the view keeps
    its four phases, the upload among them."""
    trace.enable(True)
    try:
        _render()
    finally:
        trace.enable(False)
    counters = tracer.summary()["counters"]
    assert counters["render.rays_host"] == 1 and "render.rays_device" not in counters
    spans = tracer.spans()
    (view,) = [s for s in spans if s["name"] == "render.view"]
    kids = sorted((s for s in spans if s["parent"] == view["id"]), key=lambda s: s["ts"])
    assert [s["name"] for s in kids] == VIEW_PHASES


def test_device_ray_build_counts_and_spans(tracer):
    """device_view_rays (on the CPU, the kernel's plain version): one
    ``render.ray_build`` span around the pose and the build, and
    ``render.rays_device`` 1; the rays those of numpy view_rays (origins
    bit for bit, directions within 4 ulp of 1)."""
    cam = np.array([0.1, -0.2, 0.05, 0.0, 0.0, 3.0])
    trace.enable(True)
    try:
        o, d = TE.device_view_rays(cam, 12, 10, 10.0, None, 2, "cpu")
    finally:
        trace.enable(False)
    assert tracer.summary()["counters"] == {"render.rays_device": 1.0}
    assert [s["name"] for s in tracer.spans()] == ["render.ray_build"]
    o_np, d_np = TE.view_rays(cam, 12, 10, 10.0, None, 2)
    np.testing.assert_array_equal(o.numpy(), o_np)
    assert np.abs(d.numpy() - d_np).max() <= 4 * 2.0 ** -23


def test_profiler_sees_the_spans_as_ranges(tracer):
    """Under torch.profiler (the tracer not enabled) the same spans are
    recorded and appear as ``tpu3d.*`` ranges, nested as in the tracer; the
    recording stops with the profile."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.tracing()
        _render()
        _train()
    assert not trace.tracing()
    names = _by_name(tracer.spans())
    assert len(names["render.view"]) == 1 and len(names["dense.chunk"]) == 2
    ranges = {}
    for e in prof.events():
        if e.name.startswith(trace.PROFILER_PREFIX):
            ranges.setdefault(e.name[len(trace.PROFILER_PREFIX):], []).append(e.time_range)
    assert {k: len(v) for k, v in ranges.items()} == {k: len(v) for k, v in names.items()}
    (view,) = ranges["render.view"]
    for name in VIEW_PHASES:
        (r,) = ranges[name]
        assert view.start <= r.start and r.end <= view.end
    for a, b in zip(ranges["render.ray_build"], ranges["dense.chunk"]):
        assert a.end <= b.start
    n = len(tracer.spans())
    _render()
    assert len(tracer.spans()) == n


def test_launch_span_is_an_operator_range_under_the_profiler(tracer):
    """A launch span (around a kernel launch of the port's own) records in
    the tracer as a hot span does, nested under the open one; under
    torch.profiler its ``tpu3d.*`` range is an operator's record, not a
    user annotation, so that the profiler links the kernel launched inside
    it to it, while a hot span's range stays an annotation. Off, both are
    the shared no-op context."""
    from torch.profiler import ProfilerActivity, profile

    assert trace.launch_span("kernels.x") is trace.hot_span("y")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.hot_span("dense.chunk", k=1, mode="eager"):
            with trace.launch_span("kernels.x"):
                pass
    events = {e.name: e for e in prof.events() if e.name.startswith(trace.PROFILER_PREFIX)}
    assert set(events) == {"tpu3d.dense.chunk", "tpu3d.kernels.x"}
    assert not events["tpu3d.kernels.x"].is_user_annotation
    assert events["tpu3d.dense.chunk"].is_user_annotation
    spans = _by_name(tracer.spans())
    (chunk,), (launch,) = spans["dense.chunk"], spans["kernels.x"]
    assert launch["parent"] == chunk["id"]


def test_device_span_is_a_no_op_on_the_cpu(tracer):
    """Without an initialised card a device span records nothing, traced or
    not, and a capture's mark collector stays empty."""
    trace.enable(True)
    try:
        with trace.graph_marks() as marks:
            with trace.hot_span("outer"):
                with trace.device_span("dense.optimizer") as ev:
                    assert ev is None
    finally:
        trace.enable(False)
    assert marks == []
    assert [s["name"] for s in tracer.spans()] == ["outer"]


def test_cli_trace_turns_spans_on_for_the_command(tracer, tmp_path):
    """``traced`` with a trace path turns tracing on for the command alone
    and writes its hot spans, with their parent links, to the Chrome trace."""
    import json

    from tpu3d_torch.cli import traced

    path = tmp_path / "t.json"
    seen = traced("render", lambda: (trace.tracing(), _render()), trace=str(path),
                  device="cpu")
    assert seen[0] is True and not trace.tracing()
    events = json.loads(path.read_text())["traceEvents"]
    assert [e["name"] for e in events][-1] == "render"
    view = next(e for e in events if e["name"] == "render.view")
    assert sorted(e["name"] for e in events if e.get("parent") == view["id"]) == \
        sorted(VIEW_PHASES)


class _Clock:
    def __init__(self):
        self.now = 100.0

    def time(self):
        return self.now


def test_loss_log_rate_counts_the_loop_steps(monkeypatch, capsys):
    """Two epochs of 4 steps in chunks of 2, one second a step, batch 10:
    every printed rate is the loop's steps so far x 10 over the seconds
    since the log began, 10 rays/s, in the second epoch too (the step index
    within the epoch gave 5, 8, 2 and 4)."""
    clock = _Clock()
    monkeypatch.setattr(TT, "time", clock)
    losses = []
    log = TT._LossLog(losses, 2, 10, 4, "[dense]")
    updates = 0
    for epoch in range(2):
        for b in (0, 2):
            clock.now += 2.0
            updates += 2
            log.chunk(torch.tensor([0.5, 0.25]), b, epoch, updates)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(losses) == 4
    assert [ln.split("(")[1] for ln in lines] == ["10 rays/s)"] * 4
    assert [e["seconds"] for e in log.entries] == [2.0, 4.0, 6.0, 8.0]
