"""A cell's configuration and traffic cut to a size the CPU runs in a
second: every shape kept in kind, every count small."""
import copy
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]


def tiny(cell_name: str):
    """(cell, config, traffic) of a BENCHMARK.json cell at the tiny size."""
    cell = harness.Cell(ROOT, cell_name)
    cfg = copy.deepcopy(cell.config)
    cfg.update(grid_resolution=16, num_samples=16, batch_size=64, scan_chunk=2, n_coarse=8,
               n_fine=8)
    cfg["scene"].update(width=48, height=32, n_views=8, points_per_side=8)
    if "detail" in cfg:
        cfg["detail"]["voxel_budget"] = 16
    traffic = dict(cell.traffic)
    if traffic["loop"] == "render":
        traffic.update(path_frames=6, chunk=512, check_views=2)
    else:
        traffic.update(log_every=5)
    return cell, cfg, traffic


def run_tiny(cell_name: str, seed: int = 20240611, seconds: float = 0.3) -> dict:
    """One whole run of the cell at the tiny size on the CPU, skipping the
    harness's look for a card."""
    import time

    cell, cfg, traffic = tiny(cell_name)
    return harness.run(cfg, traffic, cell.limits, seed, seconds, False, "cpu", time.time(),
                       cell.end_to_end(), cell.per_layer())
