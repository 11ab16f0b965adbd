"""calibrate.py's readings for the DVGO training cell, on the card:

    python3 portbench/calibrate_dvgo.py --workload dvgo-160.train --seeds 101,102,...

One JSON line per seed with the compared numbers of ``program`` (the
program's own steps against reference/dvgo.py), ``control`` (the reference
in bfloat16 put in the program's place), the faults of calibrate.py
(``half_batch``, ``first_batch``), and reference/dvgo.py's own faults put
in the program's place: ``tf32`` (the MLP's linears on TF32 inputs),
``plain_adam`` (the grid's update not masked), ``no_box_mask`` (samples
outside the box not dead) and ``no_tau`` (neither tau filter). A state
left unchanged reads 1 by construction and needs no run.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

FAULTS = ("tf32", "plain_adam", "no_box_mask", "no_tau")


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
        want = run.reference()
        for fault in FAULTS:
            r[fault] = mod.gaps(run.reference(**{fault: True}), want, run.groups)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": round(time.time() - t0, 3), **r}), flush=True)
        del run, runs, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
