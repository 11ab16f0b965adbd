"""Optimizer device ms per step (dense/train.py ``make_optimizer``: fused
Adam or RMSprop): the device time of the kernels launched inside the
optimizer's ``Optimizer.step#...`` range, over an eager chunk of the window's
shapes, per step. A graph replay has no host ranges to attribute by, and the
eager chunk launches the same kernels."""


def read(ctx):
    us = ctx.get("optimizer_us_per_step")
    return us / 1e3 if us else None
