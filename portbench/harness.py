"""The harness: finds a cell's files by name, runs it, checks what it
produced and assembles the result.

Everything that belongs to one cell is found by name: the configuration
``configs/<config>.json`` (the file that BENCHMARK.json names), the traffic
mix ``traffic/<traffic>.json``, whose ``loop`` names the loop in
``loops/<loop>.py``, the limits of the check ``limits/<cell>.json``,
and each per-layer metric's reader ``metrics/<metric>.py`` (or, for a
metric named ``<quantity>.<split>``, ``metrics/<quantity>.py``). A later change
adds a cell, a mix or a metric by adding files and entries.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu3d")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of BENCHMARK.json's ``workloads``, with its files."""

    def __init__(self, root: Path, name: str):
        self.bench = load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
        self.name, self.entry = name, cells[name]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config = load_json(root / configs[self.entry["config"]]["file"])
        self.traffic = load_json(HERE / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = load_json(HERE / "limits" / f"{name}.json")
        self.chips = int(self.entry["chips"])

    def end_to_end(self) -> List[dict]:
        return [m for m in self.bench["end_to_end"] if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[dict]:
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in mine)]


def loop(name: str):
    return importlib.import_module(f"portbench.loops.{name}")


def reader(metric: str):
    """The per-layer metric's reader: ``metrics/<metric>.py``, or else the
    reader that the name before its first dot names, so that one file reads
    ``device_idle_share.train`` and ``device_idle_share.render`` alike."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared as whole names."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def compare(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, dict]:
    """Each number against its limit (passing at or below it)."""
    out = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in out.values())
    return ok, out


def run(config: dict, traffic: dict, limits: Dict[str, float], seed: int, seconds: float,
        trace: bool, device, t_start: float, end_to_end: List[dict],
        per_layer: List[dict]) -> dict:
    """Set up, warm up, measure for ``seconds``, read the per-layer
    metrics of a traced run, then check. Returns the result's fields, with
    ``compared`` last."""
    import torch

    on_card = torch.device(device).type == "cuda"
    run = loop(traffic["loop"]).Run(config, traffic, seed, device)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.time() - t_start
    print("setup stages (s): " + ", ".join(f"{k} {v:.3f}" for k, v in run.stages.seconds.items())
          + f"; setup_s {setup_s:.3f}", file=sys.stderr)
    out = run.window(seconds, trace)
    print(f"window: {out['attempted']} operations; {out['note']}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    metrics: Dict[str, dict] = {}
    breakdown = None
    if trace:
        ctx = run.layer_context()
        for m in per_layer:
            value = reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if ctx["trace"] is not None:
            breakdown = ctx["trace"].breakdown()
            busy_s, window_s = ctx["trace"].busy_us / 1e6, ctx["trace"].window_us / 1e6
    else:
        measured = dict(out["metrics"], setup_s=setup_s)
        for m in end_to_end:
            metrics[m["name"]] = {"value": measured[m["name"]], "unit": m["unit"]}
    numbers = run.check()
    ok, compared = compare(numbers, limits)
    result = {"correct": ok and out["failed"] == 0, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device_info(device, peak)}
    if trace and breakdown is not None:
        result["device"].update(busy_s=busy_s, window_s=window_s)
        result["breakdown"] = breakdown
    result["compared"] = compared
    return result


def device_info(device, peak: int) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": peak, "power_limit_w": power_limit()}


def power_limit() -> Optional[float]:
    """The card's power limit in watts, as nvidia-smi reads it."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None
