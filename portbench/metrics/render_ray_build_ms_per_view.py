"""Host ms of the render view's ray build per view (dense/eval.py
``view_rays``, numpy on the host): the summed length of the program's hot
spans ``render.ray_build`` inside a ``render.view`` span, over the number of
``render.view`` spans, read from the program's global tracer. Tracing is on
while the profiler records the sub-window's whole views (the profiler does
not slow numpy). None where the program records no view."""


def read(ctx):
    from tpu3d_torch.utils.trace import get_tracer

    spans = getattr(get_tracer(), "spans", None)
    if spans is None:
        return None
    events = spans()
    views = {e["id"] for e in events if e["name"] == "render.view"}
    if not views:
        return None
    build_us = sum(e["dur"] for e in events
                   if e["name"] == "render.ray_build" and e["parent"] in views)
    return build_us / 1e3 / len(views)
