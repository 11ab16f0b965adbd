"""The colour MLP's device ms per step inside the window's graph replays
(dense/dvgo.py ``_RgbNet``: the program's device spans ``dense.rgbnet``
around the MLP's forward, the view encoding, three linears and the sigmoid,
and ``dense.rgbnet_backward`` around its backward, each two event-record
nodes in every captured step): each replayed chunk's forward and backward
spans paired in order, a step's sum the pair's, the median over the steps
of the ``dense.chunk`` spans of mode ``replay``, read from the program's
global tracer. None where the program records no such span."""
import statistics
from collections import defaultdict


def step_ms(events) -> list:
    """Each replayed step's forward plus backward device ms."""
    replays = {e["id"] for e in events
               if e["name"] == "dense.chunk" and e["args"].get("mode") == "replay"}
    spans = defaultdict(lambda: ([], []))
    for e in events:
        if e["parent"] in replays and e["name"] in ("dense.rgbnet", "dense.rgbnet_backward"):
            spans[e["parent"]][e["name"] == "dense.rgbnet_backward"].append(e["dur"] / 1e3)
    return [f + b for fwd, bwd in spans.values() for f, b in zip(fwd, bwd)]


def read(ctx):
    from tpu3d_torch.utils.trace import get_tracer

    spans = getattr(get_tracer(), "spans", None)
    if spans is None:
        return None
    ms = step_ms(spans())
    return statistics.median(ms) if ms else None
