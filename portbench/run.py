"""Run one cell of the port's benchmark on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic and limits are found by name from
BENCHMARK.json. The run makes its inputs from the seed on the device, warms
up, measures for the given seconds (with ``--trace 1`` it reads the cell's
per-layer metrics from a profiled sub-window instead of the end-to-end
ones), checks what the window produced against the plain reference under
``portbench/reference``, and prints one JSON object as the last line of its
standard output, the compared numbers beside their limits as the last lines
of its standard error. Without a CUDA card it exits 2 and prints no result.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Build and kernel caches at fixed paths inside the checkout, so that only a
# checkout's first run builds (the port builds its kernels in build/tpu3d_torch).
CACHE = ROOT / "build" / "portbench"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench import harness

    cell = harness.Cell(ROOT, args.workload)
    # The host's thread pools are part of the deployment that the
    # configuration states (``host_threads``), set before numpy and torch load.
    threads = cell.config.get("host_threads")
    if threads is not None:
        for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
            os.environ[var] = str(int(threads))

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = harness.run(cell.config, cell.traffic, cell.limits, args.seed % 2 ** 63,
                         args.seconds, bool(args.trace), "cuda", T_START, cell.end_to_end(),
                         cell.per_layer())
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the process loaded {found}; the port and the benchmark must not "
              "load JAX or the JAX package", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
