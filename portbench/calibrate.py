"""Readings that a cell's limits are set from, on the card, in one process:

    python3 portbench/calibrate.py --workload <cell> --seeds 101,102,...

For each seed it prints one JSON line with the compared numbers of
  - ``program``: the program's own output against the reference (the lower
    readings),
  - ``control``: the reference computed in bfloat16, put in the program's
    place (float32 is what the configurations state; the steps have no
    matrix product, so TF32 would change nothing),
  - and the faults a cell can have, planted in the reference put in the
    program's place: training, half of each batch left out and the mean
    taken over the rest (``half_batch``), and every step of a chunk of K on
    the chunk's first batch (``first_batch``); rendering, half of the rays of
    each view left out and filled with the mean of the rest
    (``half_rays``), and the previous pose's image handed back
    (``stale_view``). A training state left unchanged reads 1 by
    construction and needs no run.
No window is measured: a training cell's readings come from its checked
steps, a render cell's from the program's render of the sampled poses.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def train_readings(cell, seed: int) -> dict:
    import torch

    from portbench import harness

    mod = harness.loop(cell.traffic["loop"])
    run = mod.Run(cell.config, cell.traffic, seed, "cuda")
    run.release()
    want = run.reference()
    # each chunk's steps all on the chunk's first batch (step 1 is a chunk of its own)
    K = run.K
    first = [run.batches[0]] + [run.batches[1 + (i // K) * K] for i in range(len(run.batches) - 1)]
    return {"program": mod.gaps(run.program, want, run.groups),
            "control": mod.gaps(run.reference(torch.bfloat16), want, run.groups),
            "half_batch": mod.gaps(run.reference(half_batch=True), want, run.groups),
            "first_batch": mod.gaps(run.reference(batches=first), want, run.groups)}


def render_readings(cell, seed: int) -> dict:
    import numpy as np
    import torch

    from portbench import harness

    run = harness.loop(cell.traffic["loop"]).Run(cell.config, cell.traffic, seed, "cuda",
                                                     warm=False)
    rng = np.random.default_rng(seed)
    frames = sorted(int(f) for f in rng.choice(len(run.poses),
                                               int(cell.traffic["check_views"]), replace=False))
    out = {"program": 0.0, "control": 0.0, "half_rays": 0.0, "stale_view": 0.0}
    for f in frames:
        want = run.reference_image(f)
        got = run._view(f)
        low = run.reference_image(f, torch.bfloat16)
        half = want.reshape(-1, 3).copy()
        half[len(half) // 2:] = half[:len(half) // 2].mean(axis=0)
        stale = run.reference_image((f - 1) % len(run.poses))
        for key, img in (("program", got), ("control", low), ("half_rays", half),
                         ("stale_view", stale)):
            out[key] = max(out[key], float(np.abs(img.reshape(want.shape) - want).max()))
    return {k: {"max_abs_px": v} for k, v in out.items()}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    args = p.parse_args()

    from portbench import harness

    cell = harness.Cell(ROOT, args.workload)
    read = train_readings if cell.traffic["loop"] == "train" else render_readings
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        r = read(cell, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": round(time.time() - t0, 3), **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
