"""The colour MLP's share of the float32 peak: its least FLOPs a step
(counts_dvgo.py: the forward and backward of 39-128-128-3 over the samples
that DVGO's equations colour, the program's counter
``dense.colour_samples`` a step) over ``rgbnet_ms_per_step``, the device ms
of its forward and backward spans in a replayed step. None where the
program records no such span or counter."""
from portbench import counts, counts_dvgo, harness


def read(ctx):
    coloured = ctx.get("colour_samples_per_step")
    ms = harness.reader("rgbnet_ms_per_step").read(ctx) if coloured else None
    if not ms:
        return None
    return 100.0 * counts_dvgo.rgbnet_flops(coloured) / counts.H100_FP32_FLOPS / (ms / 1e3)
