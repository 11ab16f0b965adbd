"""The crop priors' device ms per step inside the window's graph replays
(dense/train.py ``_update``: the program's device span ``dense.prior``
around the TV and sparsity priors' values and row-only gradients, two
event-record nodes in each captured step): the median over the
``dense.prior`` spans whose parent is a ``dense.chunk`` span of mode
``replay``, read from the program's global tracer, as
``optimizer_replay_ms_per_step`` reads ``dense.optimizer``. None where the
program records no such span: a configuration without priors, or a
program without the span."""
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
          if e["name"] == "dense.prior" and e["parent"] in replays]
    return statistics.median(ms) if ms else None
