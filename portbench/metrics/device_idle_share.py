"""The device's idle share: 1 - the union of the device's operations over the
wall time of the traced sub-window, in percent. It reads
``device_idle_share.train`` (whole chunks, one loss read-back among them) and
``device_idle_share.render`` (whole views: ray build, chunks, image copy)."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.window_us <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_us / tr.window_us)
