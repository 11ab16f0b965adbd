"""Nothing under portbench imports JAX, jaxlib, Flax or the JAX package, and
a whole run loads none of them: each module's top-level name (the part
before the first dot) is compared whole, since the program's name,
tpu3d_torch, begins with the JAX package's."""
import ast
import json
import subprocess
import sys
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in (ROOT / "portbench").rglob("*.py"):
        assert not set(_imported(path)) & set(harness.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").rglob("*.py"):
        assert "tpu3d_torch" not in set(_imported(path)), path


def test_whole_names_are_compared():
    assert "tpu3d_torch".split(".")[0] not in harness.FORBIDDEN
    assert "tpu3d.cli".split(".")[0] in harness.FORBIDDEN


def test_a_run_loads_no_jax():
    script = (
        "import sys, json, time; sys.path.insert(0, sys.argv[1]);"
        "sys.path.insert(0, sys.argv[1] + '/portbench/tests');"
        "from portbench_tiny import run_tiny; from portbench import harness;"
        "r = [run_tiny(c)['correct'] for c in ('plenoxel-256.train', 'plenoxel-256.render')];"
        "print(json.dumps([r, harness.forbidden_modules()]))")
    out = subprocess.run([sys.executable, "-c", script, str(ROOT)], capture_output=True,
                         text=True, check=True)
    ok, found = json.loads(out.stdout.strip().splitlines()[-1])
    assert ok == [True, True] and found == []
