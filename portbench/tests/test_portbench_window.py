"""The end-to-end numbers are taken over all the work and all the time of
the window: a stall anywhere in it moves them."""
import time

import numpy as np
import pytest
import torch

from portbench.loops import render, train


def _render_run(stall_every: int):
    run = object.__new__(render.Run)
    run.dev, run.pixels, run.images = torch.device("cpu"), 32, {}
    run.poses = [None] * 6
    calls = []

    def view(frame):
        calls.append(frame)
        time.sleep(0.02 if stall_every and len(calls) % stall_every == 0 else 0.002)
        return np.zeros((4, 8, 3), np.float32)

    run._view = view
    return run, calls


@pytest.mark.parametrize("stall_every", [0, 5])
def test_render_rate_and_tail_over_every_view(stall_every):
    run, calls = _render_run(stall_every)
    t0 = time.perf_counter()
    out = run.window(0.3, False)
    elapsed = time.perf_counter() - t0
    n = out["attempted"]
    assert n == len(calls) and out["failed"] == 0
    rate = out["metrics"]["render_rays_per_s"]
    assert n * 32 / elapsed <= rate <= n * 32 / 0.3
    p95 = out["metrics"]["render_view_p95_ms"]
    if stall_every:
        assert p95 >= 15.0             # a fifth of the views stall: the tail shows them
        assert rate < 32 / 0.004       # ... and the rate
    else:
        assert p95 < 15.0


def test_train_rate_counts_a_stalled_chunk():
    run = object.__new__(train.Run)
    run.dev, run.K, run.B, run.traffic = torch.device("cpu"), 2, 10, {"log_every": 1000}
    run.next_batch = 0
    stalls = []

    def chunk(k):
        run.next_batch += k
        time.sleep(0.1 if run.next_batch == 2 * k else 0.001)
        stalls.append(run.next_batch == 2 * k)
        return torch.zeros(k)

    run._chunk = chunk
    out = run.window(0.2, False)
    steps = out["attempted"]
    # the 0.1 s stall is in the window: the rate is over all of it
    assert any(stalls)
    assert out["metrics"]["train_rays_per_s"] <= steps * 10 / 0.2
    assert steps * 10 / out["metrics"]["train_rays_per_s"] >= 0.2
