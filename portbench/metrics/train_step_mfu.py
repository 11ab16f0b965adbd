"""The whole training step's share of the card's peak (``train_step`` as a
graph replay): the step's least time, the larger of its FLOPs over the
float32 peak and its compulsory bytes (grid and optimizer state read once
and written once, the batch's rays read once) over the memory rate, over its
measured device time per step (the union of the device's operations in the
traced sub-window, over its steps)."""
from portbench import counts


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.busy_us <= 0:
        return None
    least_us = counts.least_seconds(ctx["step_bytes"], ctx["step_flops"]) * 1e6
    return 100.0 * least_us / (tr.busy_us / ctx["steps"])
