"""Rules of the port: tpu3d_torch and chip_smoke.py import neither jax nor
tpu3d, entry points run on the card unless asked for the CPU, and kernel
wrappers take the plain version only for CPU tensors."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from tpu3d_torch.config import PipelineConfig
from tpu3d_torch.features.frontend import extract_features
from tpu3d_torch.kernels import LAUNCHES, reset_launches
from tpu3d_torch.kernels.distance import descriptor_top2
from tpu3d_torch.kernels.orient_desc import orient_desc_samples
from tpu3d_torch.kernels.patch_sample import sample_gradient_patches
from tpu3d_torch.kernels.trilinear_grad import trilinear_scatter_grad
from tpu3d_torch.sfm import pipeline as TP

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "tpu3d_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_tpu3d(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in ("jax", "jaxlib", "tpu3d")]
    assert not bad, f"{path.name} imports {bad}"


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")


def _features():
    n, K = 2, 16
    return dict(names=["a", "b"], keypoints=np.zeros((n, K, 2)), keypoints_px=np.zeros((n, K, 2)),
                valid=np.ones((n, K), bool), colors_bgr=np.zeros((n, K, 3), np.uint8),
                image_size=np.full((n, 2), 64.0), descriptors=np.zeros((n, K, 128)))


def test_entry_points_default_to_the_card(no_card):
    cfg = PipelineConfig()
    gray = np.zeros((2, 64, 64), np.uint8)
    calls = [
        lambda: extract_features(torch.from_numpy(gray)),
        lambda: TP.run_extraction((gray, np.zeros((2, 64, 64, 3), np.uint8)), cfg, verbose=False),
        lambda: TP.ExtractedFeatures.from_numpy(**_features()),
        lambda: TP.run_retrieval(TP.ExtractedFeatures.from_numpy(**_features(), device="cpu"), cfg),
        lambda: TP.run_matching(TP.ExtractedFeatures.from_numpy(**_features(), device="cpu"),
                                {0: [1], 1: [0]}, cfg, verbose=False),
        lambda: TP.reconstruct((gray, np.zeros((2, 64, 64, 3), np.uint8)), cfg, verbose=False),
        lambda: TP.run_reconstruction(TP.ExtractedFeatures.from_numpy(**_features(),
                                                                      device="cpu"),
                                      [], None, cfg, verbose=False),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_wrappers_refuse_other_devices():
    meta = torch.device("meta")
    x = torch.empty((2, 8, 8), device=meta)
    c = torch.empty((4, 3), device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        sample_gradient_patches(x, x, c, c, torch.empty(4, dtype=torch.int32, device=meta))
    q = torch.empty((1, 4, 8), device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        descriptor_top2(q, q, torch.empty((1, 4), device=meta), torch.empty((1, 4), device=meta))
    b = torch.empty(3, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        trilinear_scatter_grad(torch.empty((5, 28), device=meta), b, b, (4, 4, 4),
                               torch.empty((5, 3), device=meta))
    k = torch.empty(4, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        orient_desc_samples(x, x, k, k, torch.empty(4, dtype=torch.int32, device=meta), k, k, k)


def test_fused_descriptor_takes_the_plain_version_on_cpu():
    cfg = PipelineConfig.from_dict({"frontend": {"fused_descriptor": True, "max_keypoints": 8}})
    reset_launches()
    fs = extract_features(torch.rand((1, 160, 160)), cfg.frontend, device="cpu")
    assert fs.descriptors.shape == (1, 8, 128) and bool(torch.isfinite(fs.descriptors).all())
    assert LAUNCHES["orient_desc_kernel"] == 0


def test_chip_smoke_needs_a_card(no_card, capsys):
    assert chip_smoke.main() == 1
    assert capsys.readouterr().out == ""


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_config_copy_matches_tpu3d():
    """The port's own config dataclasses: same fields, same defaults, and
    from_dict carries a tpu3d config across."""
    import dataclasses

    from tpu3d.config import FrontendConfig as JaxFrontendConfig
    from tpu3d.config import PipelineConfig as JaxPipelineConfig

    jax_cfg = JaxPipelineConfig()
    assert dataclasses.asdict(PipelineConfig()) == dataclasses.asdict(jax_cfg)
    changed = dataclasses.replace(jax_cfg, frontend=JaxFrontendConfig(max_keypoints=77))
    ported = PipelineConfig.from_dict(dataclasses.asdict(changed))
    assert isinstance(ported, PipelineConfig) and ported.frontend.max_keypoints == 77
    assert dataclasses.asdict(ported) == dataclasses.asdict(changed)
