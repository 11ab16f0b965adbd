"""Device ms per view (dense/eval.py ``render_view`` -> dense/render.py
``render_image``): the union of every device operation in the traced
sub-window of whole views, per view."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.busy_us <= 0:
        return None
    return tr.busy_us / ctx["views"] / 1e3
