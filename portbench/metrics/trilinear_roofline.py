"""The forward trilinear kernel's share of its roofline (kernels/trilinear.py,
csrc/trilinear.cu) while rendering: the least time of its bytes (the sample
points read once, the values and in-box flags written once; the grid rows the
points need depend on the data and are left out) over the device time of its
``trilinear_kernel`` launches, over the traced views."""
from portbench import counts


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    us = tr.device_us("trilinear_kernel")
    if us <= 0:
        return None
    return 100.0 * counts.least_seconds(ctx["trilinear_bytes"], 0) * 1e6 / us
