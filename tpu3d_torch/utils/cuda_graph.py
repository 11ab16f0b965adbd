"""CUDA-graph capture, shared by BA's CG iteration (ba/lm.py) and dense
training's chunks of steps (dense/train.py::make_multi_step)."""
from __future__ import annotations

from typing import Callable, Iterable

import torch


def capture(fn: Callable[[], object], generators: Iterable[torch.Generator] = (),
            pool=None, device=None) -> "torch.cuda.CUDAGraph":
    """fn's kernels captured as a CUDA graph (recorded, not run), on a side
    stream that the current one waits for and that waits for it. Draws from
    ``generators`` are registered with the graph, so that each replay
    advances them as the same calls would eagerly; ``pool`` is another
    graph's memory pool to share (graphs that never run at once). A failed
    capture raises."""
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    side = torch.cuda.Stream(device)
    with torch.cuda.device(side.device):
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            graph.capture_begin(pool=pool)
            try:
                fn()
            finally:
                graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)
    return graph
