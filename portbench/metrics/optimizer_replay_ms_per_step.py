"""Optimizer device ms per step inside the window's graph replays
(dense/train.py ``_update``: the program's device span ``dense.optimizer``
around the optimizer's step, two event-record nodes in each captured step):
the median over the ``dense.optimizer`` spans whose parent is a
``dense.chunk`` span of mode ``replay``, read from the program's global
tracer. Tracing is on while the profiler records the sub-window; a replay's
marks are read when the card has finished them by the next chunk call
(counters ``dense.marks_read`` / ``dense.marks_missed``), so in a closed loop
the replays before a loss read-back and the sub-window's last are read. The
eager chunk that ``optimizer_ms_per_step`` profiles is not a replay and is
left out. None where the program records no such span."""
import statistics


def read(ctx):
    from tpu3d_torch.utils.trace import get_tracer

    spans = getattr(get_tracer(), "spans", None)
    if spans is None:
        return None
    events = spans()
    replays = {e["id"] for e in events
               if e["name"] == "dense.chunk" and e["args"].get("mode") == "replay"}
    ms = [e["dur"] / 1e3 for e in events
          if e["name"] == "dense.optimizer" and e["parent"] in replays]
    return statistics.median(ms) if ms else None
