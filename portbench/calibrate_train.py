"""calibrate.py's readings for a training cell whose loop is not ``train``
(calibrate.py picks a cell's readings by its loop's name), on the card:

    python3 portbench/calibrate_train.py --workload plenoxels-512.train --seeds 101,102,...

One JSON line per seed with calibrate.train_readings' ``program``,
``control`` and faults, and, for a loop with priors, ``no_prior``: the
reference stepped without its priors put in the program's place (how much
the check sees of the prior).
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    args = p.parse_args()

    import torch

    from portbench import calibrate, harness

    cell = harness.Cell(ROOT, args.workload)
    mod = harness.loop(cell.traffic["loop"])
    real = mod.Run.reference
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        runs = []

        def reference(self, *a, **kw):
            runs.append(self)
            return real(self, *a, **kw)

        mod.Run.reference = reference
        try:
            r = calibrate.train_readings(cell, seed)
        finally:
            mod.Run.reference = real
        run = runs[0]
        if getattr(run, "priors", None):
            want = run.reference()
            pri = run.priors
            run.priors = dict(pri, tv_sigma=0.0, tv_sh=0.0, sparsity_sigma=0.0)
            r["no_prior"] = mod.gaps(run.reference(), want, run.groups)
            run.priors = pri
            del want
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": round(time.time() - t0, 3), **r}), flush=True)
        del run, runs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
