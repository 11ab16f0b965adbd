"""A whole view's share of the card's peak (dense/eval.py ``render_view``):
the view's least time, the larger of its FLOPs (every sample's trilinear
read of 28 channels, SH shading and compositing) over the float32 peak and
its compulsory bytes (rays in, colours out) over the memory rate, over its
measured device time (the union of the device's operations in the traced
sub-window, over its views)."""
from portbench import counts


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.busy_us <= 0:
        return None
    least_us = counts.least_seconds(ctx["view_bytes"], ctx["view_flops"]) * 1e6
    return 100.0 * least_us / (tr.busy_us / ctx["views"])
