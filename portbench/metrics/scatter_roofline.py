"""The scatter's share of its roofline (kernels/trilinear_grad.py,
csrc/trilinear_grad.cu): the least time of its bytes (cotangents and sample
points read once, the gradient grid written once, over the card's memory
rate) over the device time of its own kernels, ``trilinear_grad_keys`` and
``trilinear_grad_kernel``, per step. The sort and the column offsets between
them are plain torch and are not counted."""
from portbench import counts


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    us = tr.device_us("trilinear_grad") / ctx["steps"]
    if us <= 0:
        return None
    return 100.0 * counts.least_seconds(ctx["scatter_bytes"], 0) * 1e6 / us
