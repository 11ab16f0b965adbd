"""The benchmark's byte and FLOP counts against hand figures."""
from portbench import counts

GRID_256_28 = 256 ** 3 * 28 * 4        # 1.879 GB of float32


def test_grid_bytes():
    assert counts.grid_bytes((256, 256, 256), 28) == GRID_256_28 == 1_879_048_192


def test_step_bytes_adam_six_grids_rmsprop_four():
    rays = 2048 * 9 * 4
    assert counts.step_bytes("adam", (256,) * 3, 28, 2048) == 6 * GRID_256_28 + rays
    assert counts.step_bytes("rmsprop", (256,) * 3, 28, 2048) == 4 * GRID_256_28 + rays


def test_scatter_bytes_and_bound():
    n = 2048 * 192
    b = counts.scatter_bytes(n, 28, (256,) * 3)
    assert b == n * 28 * 4 + n * 3 * 4 + GRID_256_28
    # the train step's scatter: 0.5755 ms, as the kernel table of PERF.md has it
    assert abs(counts.least_seconds(b, 0) * 1e3 - 0.5755) < 5e-4


def test_trilinear_bytes_per_point():
    assert counts.trilinear_bytes(1, 28) == 12 + 112 + 1


def test_step_least_time_bound_by_bytes():
    adam = counts.least_seconds(counts.step_bytes("adam", (256,) * 3, 28, 2048),
                                counts.step_flops("adam", (256,) * 3, 28, 2048, 192))
    assert abs(adam * 1e3 - 6 * GRID_256_28 / 3.35e12 * 1e3) < 1e-3   # 3.37 ms
    flops = counts.step_flops("adam", (256,) * 3, 28, 2048, 192)
    assert flops / counts.H100_FP32_FLOPS < adam / 10


def test_view_least_time_bound_by_flops():
    rays, samples = 968 * 648, 192
    flops = counts.view_flops(rays, samples, 28)
    assert flops == rays * samples * (28 * 21 + 18 + 80 + 12)
    least = counts.least_seconds(counts.view_bytes(rays), flops)
    assert least == flops / counts.H100_FP32_FLOPS     # 1.25 ms a view
