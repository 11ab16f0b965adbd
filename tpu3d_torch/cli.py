"""The port's dense entry points, as tpu3d's ``cli render`` and
``cli densify --eval-only`` (tpu3d/cli.py:1011-1115, :847-920).

    python -m tpu3d_torch.cli render --images DIR --artifacts DIR [--orbit N]
    python -m tpu3d_torch.cli densify --eval-only --images DIR --artifacts DIR

Both read tpu3d's artifacts unchanged (``reconstruction``,
``reconstruction_meta``, ``dense_grid`` [+ ``dense_grid_detail``],
``dense_meta``) and take the normalization, band, sample count, per-ray box
clipping and contraction the grid was trained with from ``dense_meta``.
``render_artifacts`` and ``densify_eval_only`` are the functions behind the
two commands; they run on the card unless given ``device="cpu"``. Dense
training is not ported yet.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from tpu3d_torch import resolve_device
from tpu3d_torch.config import DenseConfig
from tpu3d_torch.dense.eval import (evaluate_views, interpolate_poses, render_view,
                                    split_views_by_name)
from tpu3d_torch.dense.grid import grid_from_mesh_grid, grid_from_tpu3d
from tpu3d_torch.dense.train import (SceneNormalization, auto_near_far,
                                     normalize_scene_contracted, normalize_scene_legacy)
from tpu3d_torch.io.artifacts import ArtifactStore

Artifacts = Union[str, ArtifactStore]


def _store(artifacts: Artifacts) -> ArtifactStore:
    return artifacts if isinstance(artifacts, ArtifactStore) else ArtifactStore(artifacts)


def _load(store: ArtifactStore, name: str, hint: str) -> dict:
    d = store.load(name)
    if d is None:
        raise FileNotFoundError(f"no {name} artifact in {store.root}: {hint}")
    return d


def registered_views(artifacts: Artifacts, include_low_confidence: bool = False
                     ) -> Tuple[np.ndarray, list, dict]:
    """(cams (M, 6), names, reconstruction_meta) of the registered views,
    without the low-confidence ones unless asked (tpu3d/cli.py:439-451)."""
    store = _store(artifacts)
    rec = _load(store, "reconstruction", "run `reconstruct` first")
    meta = store.load_json("reconstruction_meta") or {}
    names = list(meta.get("registered_names", []))
    if len(names) != len(rec["cams"]):
        raise ValueError("reconstruction_meta's registered_names do not match "
                         "the reconstruction's cameras")
    low = set(meta.get("low_confidence_names", []))
    keep = [k for k, n in enumerate(names) if include_low_confidence or n not in low]
    return rec["cams"][keep], [names[k] for k in keep], meta


def _dense_config(dm: dict, near: float, far: float, num_samples: int) -> DenseConfig:
    return DenseConfig(near=near, far=far,
                       num_samples=int(dm.get("num_samples", num_samples)),
                       per_ray_aabb=bool(dm.get("per_ray_aabb", DenseConfig.per_ray_aabb)),
                       contraction=bool(dm.get("contraction", False)))


def render_artifacts(artifacts: Artifacts, image_hw: Tuple[int, int], focal: float,
                     views: Sequence[int] = (0, 60, 120, 180), orbit: int = 0,
                     stride: int = 1, num_samples: int = 192,
                     device="cuda") -> Dict[str, np.ndarray]:
    """Render registered views and an ``orbit``-frame flythrough from the
    trained grid, as tpu3d's ``cmd_render``. image_hw and focal are at the
    grid's image scale. Returns {file name: (H', W', 3) float image in
    [0, 1] before clipping}; views out of range are skipped with a note.
    Without a ``dense_grid`` it renders tpu3d's compact ``mesh_grid``
    (density + SH DC: view-independent colours)."""
    dev = resolve_device(device)
    store = _store(artifacts)
    rec = _load(store, "reconstruction", "run `reconstruct` first")
    d = store.load("dense_grid")
    if d is not None:
        grid, bg_sh = grid_from_tpu3d(d, dev)
    else:
        grid = grid_from_mesh_grid(_load(store, "mesh_grid", "run `densify` first"), dev)
        bg_sh = None
    dm = store.load_json("dense_meta") or {}
    if "norm_center" in dm:
        norm = SceneNormalization(np.asarray(dm["norm_center"], np.float32),
                                  float(dm["norm_scale"]))
    elif dm.get("contraction", False):
        norm = normalize_scene_contracted(rec["points"])
    else:   # grids saved before densify recorded its normalization
        norm = normalize_scene_legacy(rec["points"])
    if dm:
        near, far = float(dm["near"]), float(dm["far"])
    else:
        near, far = auto_near_far(rec["cams"], rec["points"], norm)
    cfg = _dense_config(dm, near, far, num_samples)
    H, W = image_hw
    cams = rec["cams"]
    frames = {}
    for v in views:
        if not 0 <= v < len(cams):
            print(f"view {v} out of range (registered: {len(cams)})", file=sys.stderr)
            continue
        frames[f"view_{v:04d}.png"] = render_view(grid, cams[v], H, W, focal, cfg, norm,
                                                  stride=stride, bg_sh=bg_sh)
    if orbit > 0:
        for k, cam in enumerate(interpolate_poses(cams, orbit)):
            frames[f"orbit_{k:04d}.png"] = render_view(grid, cam, H, W, focal, cfg, norm,
                                                       stride=stride, bg_sh=bg_sh)
    return frames


def densify_eval_only(artifacts: Artifacts, rgb_u8: np.ndarray, names: Sequence[str],
                      focal: float, holdout_every: int = 8, max_eval_views: int = 0,
                      include_low_confidence: bool = False, device="cuda") -> dict:
    """Score the saved grids (``dense_grid`` [+ ``dense_grid_detail`` as the
    cascade's detail layer]) on the name-keyed held-out views, as tpu3d's
    ``_densify_eval_only``; writes and returns ``dense_result``.

    rgb_u8: (n, H, W, 3) photographs at the grid's image scale, the image
    named names[i] in rgb_u8[i]; it must hold every held-out view. focal is
    at the same scale. max_eval_views 0 scores them all."""
    dev = resolve_device(device)
    store = _store(artifacts)
    cams, reg_names, meta = registered_views(store, include_low_confidence)
    dm = store.load_json("dense_meta")
    if dm is None:
        raise FileNotFoundError(f"no dense_meta in {store.root}: run densify first")
    grid, bg_sh = grid_from_tpu3d(_load(store, "dense_grid", "run densify first"), dev)
    dd = store.load("dense_grid_detail")
    detail = None if dd is None else grid_from_tpu3d(dd, dev)[0]
    norm = SceneNormalization(np.asarray(dm["norm_center"], np.float32),
                              float(dm["norm_scale"]))
    cfg = _dense_config(dm, float(dm["near"]), float(dm["far"]), DenseConfig.num_samples)
    _, test_idx = split_views_by_name(reg_names, holdout_every)
    if not len(test_idx):
        raise ValueError("the holdout split is empty: nothing to evaluate")
    pos = {n: i for i, n in enumerate(names)}
    missing = [reg_names[k] for k in test_idx if reg_names[k] not in pos]
    if missing:
        raise ValueError(f"no photograph given for held-out views {missing}")
    rgb = rgb_u8[[pos[reg_names[k]] for k in test_idx]]
    if detail is not None:
        ev = evaluate_views(detail, cams[test_idx], rgb, focal, cfg, norm, stride=2,
                            max_views=max_eval_views, bg_sh=bg_sh, base_grid=grid)
    else:
        ev = evaluate_views(grid, cams[test_idx], rgb, focal, cfg, norm, stride=2,
                            max_views=max_eval_views, bg_sh=bg_sh)
    out = {
        "eval_only": True, "cascade": detail is not None,
        "test_psnr": ev["mean_psnr"],
        "test_psnr_per_view": [round(p, 2) for p in ev["per_view"]],
        "test_psnr_calibrated": ev["mean_psnr_calibrated"],
        "test_psnr_core": round(ev["psnr_core"], 2),
        "test_psnr_background": round(ev["psnr_background"], 2),
        "core_pixel_fraction": round(ev["core_pixel_fraction"], 3),
        "test_view_names": [reg_names[k] for k in test_idx],
    }
    # Held-out views whose sparse reprojection error is a robust outlier
    # have untrusted poses: a second mean without them, beside the first.
    pc = meta.get("per_camera_reproj_px") or {}
    if pc:
        vals = np.asarray(list(pc.values()))
        thr = float(np.median(vals) + 3 * 1.4826 * np.median(np.abs(vals - np.median(vals))))
        pv = ev["per_view"]
        tnames = [reg_names[k] for k in test_idx[: len(pv)]]
        ok = [i for i, n in enumerate(tnames) if pc.get(n, float("inf")) <= thr]
        if ok and len(ok) < len(pv):
            out["test_psnr_trusted"] = round(float(np.mean([pv[i] for i in ok])), 2)
    store.save_json("dense_result", out)
    return out


def _downscale(store: ArtifactStore, dense_downscale: int) -> int:
    meta = store.load_json("features_meta") or store.load_json("reconstruction_meta") or {}
    return int(meta.get("downscale", 1)) * dense_downscale


def _cmd_render(args) -> None:
    from PIL import Image

    from tpu3d_torch.io.images import load_images

    store = ArtifactStore(args.artifacts)
    ds = int((store.load_json("dense_meta") or {}).get("downscale")
             or _downscale(store, args.dense_downscale))
    names = (store.load_json("reconstruction_meta") or {}).get("registered_names") or []
    if not names:
        sys.exit("reconstruction_meta lacks registered_names")
    H, W = load_images(args.images, names[:1], ds)[1].shape[1:3]
    t0 = time.time()
    views = [int(s) for s in args.render_views.split(",") if s.strip()]
    frames = render_artifacts(store, (H, W), args.focal / ds, views, args.orbit,
                              args.render_stride, args.num_samples, args.device)
    out_dir = args.out or os.path.join(args.artifacts, "renders")
    os.makedirs(out_dir, exist_ok=True)
    for name, img in frames.items():
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(out_dir, name))
    print(json.dumps({"frames": len(frames), "out": out_dir, "hw": [int(H), int(W)],
                      "dc_only_colors": not store.has("dense_grid"),
                      "seconds": round(time.time() - t0, 1)}))


def _cmd_densify(args) -> None:
    from tpu3d_torch.io.images import load_images

    if not args.eval_only:
        sys.exit("tpu3d_torch: dense training is not ported yet; "
                 "`densify --eval-only` scores saved grids")
    store = ArtifactStore(args.artifacts)
    ds = _downscale(store, args.dense_downscale)
    _, names, _ = registered_views(store, args.include_low_confidence)
    rgb = load_images(args.images, names, ds)[1]
    out = densify_eval_only(store, rgb, names, args.focal / ds, args.holdout_every,
                            args.max_eval_views, args.include_low_confidence, args.device)
    print(json.dumps(out))


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(prog="tpu3d_torch",
                                description="tpu3d's dense render/eval path on the GPU")
    p.add_argument("command", choices=["densify", "render"])
    p.add_argument("--images", required=True)
    p.add_argument("--artifacts", default="artifacts")
    p.add_argument("--dense-downscale", type=int, default=4)
    p.add_argument("--focal", type=float, default=2378.98305085)
    p.add_argument("--num-samples", type=int, default=192)
    p.add_argument("--eval-only", action="store_true",
                   help="densify: score the saved dense_grid (+detail) on held-out views")
    p.add_argument("--holdout-every", type=int, default=8)
    p.add_argument("--max-eval-views", type=int, default=8)
    p.add_argument("--include-low-confidence", action="store_true")
    p.add_argument("--render-views", default="0,60,120,180",
                   help="render: comma-separated registered-view indices; '' to skip")
    p.add_argument("--orbit", type=int, default=0,
                   help="render: also N novel views along the registered trajectory")
    p.add_argument("--render-stride", type=int, default=1)
    p.add_argument("--out", default="", help="render: PNG directory (default ARTIFACTS/renders)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    {"densify": _cmd_densify, "render": _cmd_render}[args.command](args)


if __name__ == "__main__":
    main()
