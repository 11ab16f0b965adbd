"""BENCHMARK.json keeps to the benchmark's contract, and a cell, a
configuration, a traffic mix or a per-layer metric dropped into its folder
is found by name with no other file edited."""
import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and (ROOT / p).is_dir()
    assert len(BENCH["command"]) <= 32 and all(TEXT.match(w) for w in BENCH["command"])


def test_names_units_and_texts():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(BENCH["paths"][0] + "/") and (ROOT / c["file"]).is_file()
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m) - {"workloads"} <= {"name", "unit", "better", "bound", "source", "layer",
                                         "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(set(n for n in names)) == len(names)


def test_every_cell_has_its_files_and_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        metrics = ROOT / "portbench" / "metrics"
        assert ((metrics / f"{m['name']}.py").is_file()
                or (metrics / f"{m['name'].split('.')[0]}.py").is_file())
    configs = {c["name"] for c in BENCH["configs"]}
    assert configs == {w["config"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "portbench" / "limits" / f"{w['name']}.json").is_file()
        mine = [m["name"] for m in BENCH["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in mine and len(mine) >= 2
        layers = [m for m in BENCH["per_layer"] if w["name"] in m["workloads"]]
        assert layers and all(m["moves"] in mine for m in layers)


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path / "portbench")
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "plenoxel-256.json").read_text())
    cfg.update(name="plenoxel-128", grid_resolution=128)
    (pb / "configs" / "plenoxel-128.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "train-short.json").write_text(
        json.dumps({"loop": "train", "grid": "main", "ray_stride": 2, "log_every": 10}))
    (pb / "limits" / "plenoxel-128.train-short.json").write_text(json.dumps({"loss_gap": 1}))
    (pb / "metrics" / "steps_traced.py").write_text("def read(ctx):\n    return ctx['steps']\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="plenoxel-128",
                                 file="portbench/configs/plenoxel-128.json"))
    bench["workloads"].append({"name": "plenoxel-128.train-short", "config": "plenoxel-128",
                               "traffic": "train-short", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("plenoxel-128.train-short")
    bench["per_layer"].append({"name": "steps_traced", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "training loop",
                               "moves": "train_rays_per_s",
                               "workloads": ["plenoxel-128.train-short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = (
        "import sys, json; from pathlib import Path; sys.path.insert(0, sys.argv[1]);"
        "from portbench import harness;"
        "c = harness.Cell(Path(sys.argv[1]), 'plenoxel-128.train-short');"
        "print(json.dumps([c.config['grid_resolution'], c.traffic['log_every'], c.limits,"
        " [m['name'] for m in c.per_layer()], [m['name'] for m in c.end_to_end()],"
        " harness.reader('steps_traced').read({'steps': 7}),"
        " harness.reader('steps_traced.render').read({'steps': 8}),"
        " harness.loop(c.traffic['loop']).__name__]))")
    out = subprocess.run([sys.executable, "-c", script, str(tmp_path)], capture_output=True,
                         text=True, check=True)
    res, log_every, limits, layers, e2e, steps, split, drv = json.loads(out.stdout)
    assert (res, log_every, limits, steps, split) == (128, 10, {"loss_gap": 1}, 7, 8)
    assert layers == ["steps_traced"] and e2e == ["train_rays_per_s", "setup_s"]
    assert drv == "portbench.loops.train"
    after = _digest(pb)
    assert all(after[k] == v for k, v in before.items())


@pytest.mark.parametrize("bad", ["a b", "x,y", "a/b", "é", "-lead"])
def test_the_name_rule_refuses(bad):
    assert not NAME.match(bad)
