"""Host ms per chunk: the harness's host-clock span around each call of the
training loop's multi-step object (dense/train.py ``MultiStep.__call__``: the
enqueue of one chunk of steps), the mean over the window's chunks before the
profiled sub-window (the profiler, and what it leaves behind, slow the host's
launches)."""


def read(ctx):
    ms = ctx.get("chunk_ms")
    return sum(ms) / len(ms) if ms else None
