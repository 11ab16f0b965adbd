"""The readers of the program's spans (``metrics/optimizer_replay_ms_per_step.py``,
``metrics/render_ray_build_ms_per_view.py``) on a synthetic global tracer:
the value from the spans they select, None when the tracer holds none, and
None from a program whose tracer has no span accessor (a parent commit)."""
import pytest

from portbench import harness
from tpu3d_torch.utils import trace


@pytest.fixture
def tracer(monkeypatch):
    monkeypatch.setattr(trace, "_GLOBAL", None)
    monkeypatch.setattr(trace, "_ENABLED", True)
    return trace.get_tracer()


def _device(tr, name, ms, parent):
    """A device span of ``ms`` under the hot span ``parent``, as a read
    replay's marks are recorded."""
    with tr._lock:
        tr._events.append(tr._device_event(name, ms, parent, 0.0))


def test_optimizer_replay_reads_replays_only(tracer):
    """The median of the optimizer spans under replay chunks: those under an
    eager chunk, a capture and no chunk are left out."""
    for mode, ms in (("eager", [50.0, 50.0]), ("capture", [40.0]),
                     ("replay", [5.0, 6.0, 7.5]), ("replay", [5.5])):
        with trace.hot_span("dense.chunk", k=len(ms), mode=mode) as chunk:
            pass
        for v in ms:
            _device(tracer, "dense.optimizer", v, chunk.id)
    _device(tracer, "dense.optimizer", 99.0, None)
    with trace.hot_span("dense.chunk", k=1, mode="replay") as chunk:
        pass
    _device(tracer, "dense.replay", 30.0, chunk.id)
    assert harness.reader("optimizer_replay_ms_per_step").read({}) == pytest.approx(5.75)


def test_ray_build_per_view(tracer):
    """The ray builds inside views, summed, over the views; a ray build
    outside a view (evaluate_views builds its rays first) is left out."""
    import time

    for _ in range(2):
        with trace.hot_span("render.view", rays=4, chunks=1):
            with trace.hot_span("render.ray_build"):
                time.sleep(0.002)
            with trace.hot_span("render.enqueue"):
                pass
    with trace.hot_span("render.ray_build"):
        time.sleep(0.05)
    spans = tracer.spans()
    views = {s["id"] for s in spans if s["name"] == "render.view"}
    want = sum(s["dur"] for s in spans if s["name"] == "render.ray_build"
               and s["parent"] in views) / 1e3 / 2
    got = harness.reader("render_ray_build_ms_per_view").read({})
    assert got == pytest.approx(want) and 2.0 <= got < 50.0


@pytest.mark.parametrize("metric", ["optimizer_replay_ms_per_step",
                                    "render_ray_build_ms_per_view"])
def test_no_spans_read_none(tracer, monkeypatch, metric):
    assert harness.reader(metric).read({}) is None
    with trace.hot_span("other"):
        pass
    assert harness.reader(metric).read({}) is None

    class Parent:
        """A tracer as the parent commit has it: no span accessor."""
        def summary(self):
            return {"spans": {}, "counters": {}}

    monkeypatch.setattr(trace, "_GLOBAL", Parent())
    assert harness.reader(metric).read({}) is None
