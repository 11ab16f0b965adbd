"""The port's utils (tpu3d_torch/utils): tpu3d's tests/test_trace.py case
against the port's Tracer, the summary and export against tpu3d's for the
same spans, and the dispatch counts."""
import json

from tpu3d.utils import Tracer as JaxTracer
from tpu3d.utils import dispatch as jax_dispatch
from tpu3d_torch.utils import Tracer, dispatch, get_tracer, trace_span


def test_tracer_spans_and_export(tmp_path):
    tr = Tracer()
    with tr.span("outer"):
        with tr.span("inner", n=3):
            pass
        tr.count("widgets", 2)
    s = tr.summary()
    assert s["spans"]["outer"]["count"] == 1
    assert s["spans"]["inner"]["count"] == 1
    assert s["counters"]["widgets"] == 2
    p = tmp_path / "trace.json"
    tr.export_chrome_trace(str(p))
    data = json.loads(p.read_text())
    assert len(data["traceEvents"]) == 2


def test_tracer_matches_tpu3d(tmp_path):
    """The same spans (synced ones a no-op wait on the CPU) give tpu3d's
    event fields, names, order and metadata, and the same summary keys and
    counts."""
    ours, ref = Tracer(), JaxTracer()
    for tr in (ours, ref):
        for k in range(3):
            with tr.span("stage", sync=True, k=k):
                with tr.span("inner"):
                    pass
        tr.count("calls")
        tr.count("calls", 2.5)
    paths = []
    for name, tr in (("ours", ours), ("ref", ref)):
        paths.append(tmp_path / f"{name}.json")
        tr.export_chrome_trace(str(paths[-1]))
    a, b = (json.loads(p.read_text())["traceEvents"] for p in paths)
    assert [(e["name"], e["args"], e["ph"], sorted(e)) for e in a] == \
        [(e["name"], e["args"], e["ph"], sorted(e)) for e in b]
    sa, sb = ours.summary(), ref.summary()
    assert sa["counters"] == sb["counters"] == {"calls": 3.5}
    assert {k: v["count"] for k, v in sa["spans"].items()} == \
        {k: v["count"] for k, v in sb["spans"].items()} == {"inner": 3, "stage": 3}


def test_global_tracer_and_dispatch_counts(monkeypatch):
    from tpu3d_torch.utils import trace

    monkeypatch.setattr(trace, "_GLOBAL", None)
    with trace_span("a", sync=True, x=1):
        pass
    assert get_tracer() is get_tracer()
    assert get_tracer().summary()["spans"]["a"]["count"] == 1
    for mod in (dispatch, jax_dispatch):
        mod.reset()
        mod.tick("local_ba")
        mod.tick("ba_readback", 3)
        mod.tick("local_ba")
    assert dispatch.snapshot() == jax_dispatch.snapshot() == {"local_ba": 2, "ba_readback": 3}
    snap = dispatch.snapshot()
    dispatch.reset()
    assert dispatch.snapshot() == {} and snap == {"local_ba": 2, "ba_readback": 3}
    jax_dispatch.reset()
