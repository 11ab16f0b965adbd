"""The port's entry points: tpu3d's ``cli full`` (images to poses, points and
PLY, tpu3d/cli.py:1167-1223), ``cli densify`` (training, :417-820), ``cli
densify --eval-only`` (:847-920) and ``cli render`` (:1011-1115).

    python -m tpu3d_torch.cli full --images DIR --artifacts DIR [--downscale N]
        [--limit N] [--ply out.ply] [tpu3d's sparse-stage flags]
    python -m tpu3d_torch.cli densify --images DIR --artifacts DIR [--epochs N]
        [--ray-stride S] [--norm coremax|core|legacy] [--hierarchical]
        [--tv-sigma W --tv-sh W] [--sparsity-sigma W] [--exposure]
        [--sh-background] [--dense-optimizer adam|rmsprop]
        [--no-checkpoint [--final-grid]] [--resume]
    python -m tpu3d_torch.cli densify --eval-only --images DIR --artifacts DIR
    python -m tpu3d_torch.cli render --images DIR --artifacts DIR [--orbit N]

They read and write tpu3d's artifacts unchanged: ``full`` writes
``features_meta``, ``reconstruction`` and ``reconstruction_meta`` (then the
PLY) and prints tpu3d's JSON summary line; training reads
``reconstruction`` and ``reconstruction_meta`` and writes ``dense_ckpt``,
``dense_grid``, ``mesh_grid``, ``dense_meta`` and ``dense_result``; eval and
render take the normalization, band, sample count, per-ray box clipping and
contraction the grid was trained with from ``dense_meta``. ``densify``,
``full``, ``densify``, ``densify_eval_only`` and ``render_artifacts`` are
the functions behind the commands; they run on the card unless given
``device="cpu"``. Options that are not ported yet raise NotImplementedError
naming their ROADMAP item.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tpu3d_torch import resolve_device
from tpu3d_torch.config import (BAConfig, CameraConfig, DenseConfig, FrontendConfig,
                                MatchingConfig, PipelineConfig, RansacConfig, SfMConfig)
from tpu3d_torch.dense.eval import (dataset_from_views, evaluate_views, interpolate_poses,
                                    render_view, split_views_by_name)
from tpu3d_torch.dense.grid import grid_from_mesh_grid, grid_from_tpu3d
from tpu3d_torch.dense.train import (LAST_TRAIN_AUX, SceneNormalization, auto_near_far,
                                     normalize_scene, normalize_scene_contracted,
                                     normalize_scene_coremax, normalize_scene_legacy,
                                     train_plenoxel)
from tpu3d_torch.io.artifacts import ArtifactStore
from tpu3d_torch.io.ply import write_ply

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
    rgb = _photographs(rgb_u8, names, [reg_names[k] for k in test_idx])
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
    split = _trusted_split(meta, ev["per_view"], [reg_names[k] for k in test_idx])
    if split is not None:
        out["test_psnr_trusted"] = split[0]
    store.save_json("dense_result", out)
    return out


def _photographs(rgb_u8: np.ndarray, names: Sequence[str], wanted: Sequence[str]) -> np.ndarray:
    """The photographs named ``wanted``, in that order, from ``rgb_u8``
    (the image named names[i] in rgb_u8[i])."""
    pos = {n: i for i, n in enumerate(names)}
    missing = [n for n in wanted if n not in pos]
    if missing:
        raise ValueError(f"no photograph given for views {missing}")
    return rgb_u8[[pos[n] for n in wanted]]


def densify(artifacts: Artifacts, rgb_u8: np.ndarray, names: Sequence[str], focal: float, *,
            epochs: int = 1, ray_stride: int = 2, norm: str = "coremax",
            norm_core_q: float = 92.0, norm_margin: float = 1.15, coremax_q: float = 80.0,
            grid_resolution: int = 256, num_samples: int = 192, scene_scale: float = 0.0,
            optimizer: str = "adam", hierarchical: bool = False, tv_sigma: float = 0.0,
            tv_sh: float = 0.0, sparsity_sigma: float = 0.0, exposure: bool = False,
            sh_background: bool = False, holdout_every: int = 8, max_eval_views: int = 8,
            include_low_confidence: bool = False, no_checkpoint: bool = False,
            final_grid: bool = False, resume: bool = False, downscale: int = 1,
            log_every: int = 170, verbose: bool = False,
            renders: Optional[list] = None, device="cuda") -> dict:
    """Train the plenoxel grid of the registered views and score it, as
    tpu3d's ``cmd_densify`` with the same flags: normalize the scene
    (``norm``), take the sampling band from the sparse cloud, hold out the
    name-keyed test views, train (``train_plenoxel``, checkpointing each
    epoch into the store unless ``no_checkpoint``), save ``dense_grid``
    (unless ``no_checkpoint`` without ``final_grid``), ``mesh_grid`` and
    ``dense_meta``, evaluate the held-out views and write and return
    ``dense_result``.

    rgb_u8: (n, H, W, 3) photographs at the grid's image scale, the image
    named names[i] in rgb_u8[i]; it must hold every registered view. focal
    is at the same scale; ``downscale`` is that scale's factor, recorded in
    dense_meta. scene_scale 0 is tpu3d's auto (1.0 under coremax and core,
    else 1.5). ``renders``, if a list, receives the held-out renders."""
    dev = resolve_device(device)
    store = _store(artifacts)
    cams, reg_names, meta = registered_views(store, include_low_confidence)
    points = _load(store, "reconstruction", "run `reconstruct` first")["points"]
    rgb = _photographs(rgb_u8, names, reg_names)
    if norm == "coremax":
        nrm = normalize_scene_coremax(points, q=coremax_q)
    elif norm == "core":
        nrm = normalize_scene(points, core_q=norm_core_q, margin=norm_margin)
    elif norm == "legacy":
        nrm = normalize_scene_legacy(points)
    else:
        raise ValueError(f"unknown normalization {norm!r}: coremax, core or legacy")
    near, far = auto_near_far(cams, points, nrm)
    if scene_scale <= 0:
        scene_scale = 1.0 if norm in ("coremax", "core") else 1.5
    cfg = DenseConfig(epochs=epochs, grid_resolution=grid_resolution, num_samples=num_samples,
                      hierarchical=hierarchical, scene_scale=scene_scale, optimizer=optimizer,
                      near=near, far=far, tv_sigma=tv_sigma, tv_sh=tv_sh, exposure=exposure,
                      sh_background=sh_background, sparsity_sigma=sparsity_sigma)
    train_idx, test_idx = split_views_by_name(reg_names, holdout_every)
    dataset = dataset_from_views(cams, rgb, focal, train_idx, nrm, stride=ray_stride)
    if verbose:
        print(f"scene-derived sampling band: near={near:.3f} far={far:.3f}; "
              f"{len(dataset.origins)} rays from {len(train_idx)} train cameras "
              f"({len(test_idx)} held out)", flush=True)
    grid, losses = train_plenoxel(dataset, cfg, verbose=verbose, log_every=log_every,
                                  checkpoint_store=None if no_checkpoint else store,
                                  resume=resume, device=dev)
    bg_sh = LAST_TRAIN_AUX.get("background")
    bounds = dict(min_bound=grid.min_bound.cpu().numpy(), max_bound=grid.max_bound.cpu().numpy())
    if not no_checkpoint or final_grid:
        store.save("dense_grid", grid=grid.grid.cpu().numpy(), **bounds,
                   **({} if bg_sh is None else {"bg_sh": bg_sh}))
    # density and the SH DC of each colour, f16: what `cli mesh` reads
    store.save("mesh_grid", grid=grid.grid[..., [0, 1, 10, 19]].cpu().numpy().astype(np.float16),
               **bounds, contraction=np.asarray(False))
    store.save_json("dense_meta", {
        "model": "plenoxel", "near": float(near), "far": float(far),
        "num_samples": int(num_samples), "per_ray_aabb": bool(cfg.per_ray_aabb),
        "downscale": int(downscale), "contraction": False,
        "norm_center": np.asarray(nrm.center, np.float64).tolist(),
        "norm_scale": float(nrm.scale), "cascade_detail": None})
    out = {"final_loss": losses[-1] if losses else None,
           "psnr_train_proxy": float(-10 * np.log10(losses[-1])) if losses else None,
           "dropped_cameras": []}
    if len(test_idx):
        ev = evaluate_views(grid, cams[test_idx], rgb[test_idx], focal, cfg, nrm, stride=2,
                            max_views=max_eval_views,
                            bg_sh=None if bg_sh is None else torch.from_numpy(bg_sh).to(dev))
        out.update(test_psnr=ev["mean_psnr"],
                   test_psnr_per_view=[round(float(p), 2) for p in ev["per_view"]],
                   test_psnr_calibrated=ev["mean_psnr_calibrated"],
                   test_psnr_core=round(ev["psnr_core"], 2),
                   test_psnr_background=round(ev["psnr_background"], 2),
                   core_pixel_fraction=round(ev["core_pixel_fraction"], 3))
        split = _trusted_split(meta, ev["per_view"], [reg_names[k] for k in test_idx])
        if split is not None:
            out.update(test_psnr_trusted=split[0], untrusted_test_views=split[1])
        out["test_view_names"] = [reg_names[k] for k in test_idx]
        if renders is not None:
            renders.extend(ev["renders"])
    out["recipe"] = {"epochs": epochs, "coarse_epochs": 0, "grid_resolution": grid_resolution,
                     "contraction": False, "coremax_q": coremax_q, "detail_epochs": 0,
                     "model": "plenoxel"}
    store.save_json("dense_result", out)
    return out


def _trusted_split(meta: dict, per_view, names) -> Optional[Tuple[float, list]]:
    """Held-out views whose sparse reprojection error is a robust outlier
    have untrusted poses: (the mean PSNR without them, their names), or
    None when all are trusted or none is (tpu3d/cli.py:778-798). Views
    missing from per_camera_reproj_px have no BA observations and count as
    untrusted."""
    pc = meta.get("per_camera_reproj_px") or {}
    if not pc:
        return None
    vals = np.asarray(list(pc.values()))
    thr = float(np.median(vals) + 3 * 1.4826 * np.median(np.abs(vals - np.median(vals))))
    names = names[: len(per_view)]
    ok = [i for i, n in enumerate(names) if pc.get(n, float("inf")) <= thr]
    if not ok or len(ok) == len(per_view):
        return None
    return (round(float(np.mean([per_view[i] for i in ok])), 2),
            [n for i, n in enumerate(names) if i not in ok])


def full(images, artifacts: Artifacts, cfg: PipelineConfig, names: Optional[Sequence[str]] = None,
         downscale: int = 1, ply: str = "", mode: str = "incremental", verbose: bool = False,
         device="cuda") -> dict:
    """Images to poses, as tpu3d's ``cmd_full``: ``sfm.pipeline.reconstruct``
    (extract → retrieve → match → reconstruct on ``device``), then the
    artifacts ``features_meta``, ``reconstruction`` and
    ``reconstruction_meta`` — first, so that a PLY path inside the store
    cannot fail a finished run — then the PLY. ``images`` is a directory or
    the decoded ``(gray_u8, rgb_u8)`` arrays. Returns the summary that the
    command prints."""
    from tpu3d_torch.sfm import pipeline as P

    rec, timings = P.reconstruct(images, cfg, list(names) if names is not None else None,
                                 downscale, verbose=verbose, mode=mode, device=device)
    store = _store(artifacts)
    store.save_json("features_meta", {"names": list(rec.image_names), "downscale": downscale,
                                      "num_images": len(rec.image_names)})
    store.save("reconstruction", cams=rec.cams, registered=rec.registered, points=rec.points,
               colors_bgr=rec.colors_bgr, track_ids=rec.track_ids, extrinsics=rec.extrinsics())
    store.save_json("reconstruction_meta", {
        "registered_names": rec.registered_names(),
        "mean_reproj_px": rec.mean_reproj_px,
        "num_obs": rec.num_obs,
        "mode": mode,
        "downscale": downscale,
        "seconds": round(timings["total"], 1),
        "sfm_phase_seconds": P.LAST_SFM_TIMERS,
        "sfm_backend": cfg.sfm.backend,
        "low_confidence_names": [rec.image_names[i] for i in rec.low_confidence],
        "per_camera_reproj_px": {rec.image_names[i]: round(e, 3)
                                 for i, e in rec.per_cam_reproj_px.items()},
    })
    if ply:
        write_ply(ply, rec.points, rec.colors_bgr)
    return {
        "registered": len(rec.registered), "points": int(len(rec.points)),
        "mean_reproj_px": rec.mean_reproj_px,
        "stage_seconds": {k: round(v, 1) for k, v in timings.items()},
        "extract_timers": dict(P.LAST_EXTRACT_TIMERS),
        "match_timers": dict(P.LAST_MATCH_TIMERS),
    }


def build_config(args) -> PipelineConfig:
    """The pipeline config of tpu3d's ``_build_config`` (tpu3d/cli.py:26-63)
    from the command's flags; the focal length is divided by the
    downscale."""
    focal = args.focal / args.downscale
    scene_scale = args.scene_scale if args.scene_scale > 0 else (
        1.0 if args.norm in ("coremax", "core") and not args.rays_pkl else 1.5)
    return PipelineConfig(
        camera=CameraConfig(focal_length=focal),
        frontend=FrontendConfig(max_keypoints=args.max_keypoints, model=args.frontend,
                                weights=args.frontend_weights),
        matching=MatchingConfig(min_raw_matches=args.min_raw_matches, matcher=args.matcher,
                                weights=args.matcher_weights),
        sfm=SfMConfig(
            camera=CameraConfig(focal_length=focal),
            max_tracks=args.max_tracks,
            ransac=RansacConfig(num_hypotheses=args.ransac_hypotheses,
                                use_five_point=args.five_point),
            global_ba_every=args.global_ba_every,
            global_ba_growth=args.global_ba_growth,
            local_window=args.local_window,
            register_batch=args.register_batch,
            backend=args.sfm_backend,
            register_all=args.register_all,
            ba=BAConfig(midrun_refit=not args.no_midrun_refit),
        ),
        dense=DenseConfig(epochs=args.epochs, grid_resolution=args.grid_resolution,
                          num_samples=args.num_samples, hierarchical=args.hierarchical,
                          scene_scale=scene_scale, optimizer=args.dense_optimizer),
        image_dir=args.images,
        artifact_dir=args.artifacts,
    )


def _cmd_full(args) -> None:
    from tpu3d_torch.io.images import list_images

    for flag, bad, item in (("--mode global", args.mode == "global", "Queue 1 item 8"),
                            ("--register-all", args.register_all, "Queue 1 item 6b"),
                            (f"--frontend {args.frontend}", args.frontend != "classical",
                             "Queue 1 item 9"),
                            (f"--matcher {args.matcher}", args.matcher != "mnn", "Queue 1 item 9")):
        if bad:
            raise NotImplementedError(f"tpu3d_torch: full {flag} is not ported yet (ROADMAP {item})")
    names = list_images(args.images)
    if args.limit:
        names = names[: args.limit]
    out = full(args.images, args.artifacts, build_config(args), names, args.downscale, args.ply,
               args.mode, verbose=not args.quiet, device=args.device)
    print(json.dumps(out))


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


# Training flags the port does not have yet, with their ROADMAP items.
_UNPORTED_FLAGS = (
    ("occupancy", "--occupancy", "Queue 1 item 7c"),
    ("coarse_epochs", "--coarse-epochs", "Queue 1 item 7c"),
    ("camera_gate", "--camera-gate", "Queue 1 item 7c"),
    ("detail_epochs", "--detail-epochs", "Queue 1 item 7c"),
    ("detail_only", "--detail-only", "Queue 1 item 7c"),
    ("aniso_grid", "--aniso-grid", "Queue 1 item 7c"),
    ("contraction", "--contraction", "Queue 1 item 7c"),
    ("rays_pkl", "--rays-pkl", "Queue 1 item 7c"),
    ("model", "--model sdf", "Queue 1 item 7d"),
    ("mesh", "--mesh", "Queue 1 item 10"),
)


def _cmd_densify(args) -> None:
    from tpu3d_torch.io.images import load_images

    store = ArtifactStore(args.artifacts)
    ds = _downscale(store, args.dense_downscale)
    _, names, _ = registered_views(store, args.include_low_confidence)
    if args.eval_only:
        rgb = load_images(args.images, names, ds)[1]
        out = densify_eval_only(store, rgb, names, args.focal / ds, args.holdout_every,
                                args.max_eval_views, args.include_low_confidence, args.device)
        print(json.dumps(out))
        return
    for attr, flag, item in _UNPORTED_FLAGS:
        if getattr(args, attr) not in (False, 0, "", "plenoxel"):
            raise NotImplementedError(f"tpu3d_torch: densify {flag} is not ported yet "
                                      f"(ROADMAP {item})")
    rgb = load_images(args.images, names, ds)[1]
    renders: list = []
    out = densify(store, rgb, names, args.focal / ds, epochs=args.epochs,
                  ray_stride=args.ray_stride, norm=args.norm, norm_core_q=args.norm_core_q,
                  norm_margin=args.norm_margin, coremax_q=args.coremax_q,
                  grid_resolution=args.grid_resolution, num_samples=args.num_samples,
                  scene_scale=args.scene_scale, optimizer=args.dense_optimizer,
                  hierarchical=args.hierarchical, tv_sigma=args.tv_sigma, tv_sh=args.tv_sh,
                  sparsity_sigma=args.sparsity_sigma, exposure=args.exposure,
                  sh_background=args.sh_background, holdout_every=args.holdout_every,
                  max_eval_views=args.max_eval_views,
                  include_low_confidence=args.include_low_confidence,
                  no_checkpoint=args.no_checkpoint, final_grid=args.final_grid,
                  resume=args.resume, downscale=ds, verbose=not args.quiet, renders=renders,
                  device=args.device)
    if renders:
        from PIL import Image

        gt = rgb[names.index(out["test_view_names"][0])][::2, ::2]
        Image.fromarray((np.clip(renders[0], 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(args.artifacts, "test_render0.png"))
        Image.fromarray(gt).save(os.path.join(args.artifacts, "test_gt0.png"))
    print(json.dumps(out))


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(prog="tpu3d_torch",
                                description="tpu3d's pipeline (full) and dense stage (train, "
                                            "eval, render) on the GPU")
    p.add_argument("command", choices=["full", "densify", "render"])
    p.add_argument("--images", required=True)
    p.add_argument("--artifacts", default="artifacts")
    p.add_argument("--downscale", type=int, default=1)
    p.add_argument("--dense-downscale", type=int, default=4)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--focal", type=float, default=2378.98305085)
    # full: tpu3d's sparse-stage flags
    p.add_argument("--max-keypoints", type=int, default=2048)
    p.add_argument("--frontend", choices=["classical", "disk", "superpoint"], default="classical")
    p.add_argument("--frontend-weights", default="")
    p.add_argument("--matcher", choices=["mnn", "lightglue"], default="mnn")
    p.add_argument("--matcher-weights", default="")
    p.add_argument("--max-tracks", type=int, default=400_000)
    p.add_argument("--min-raw-matches", type=int, default=100)
    p.add_argument("--ransac-hypotheses", type=int, default=512)
    p.add_argument("--global-ba-every", type=int, default=8)
    p.add_argument("--global-ba-growth", type=float, default=1.12)
    p.add_argument("--register-batch", type=int, default=8)
    p.add_argument("--no-midrun-refit", action="store_true")
    p.add_argument("--register-all", action="store_true")
    p.add_argument("--sfm-backend", choices=["auto", "default", "cpu", "hybrid"], default="auto")
    p.add_argument("--local-window", type=int, default=25)
    p.add_argument("--mode", choices=["incremental", "global"], default="incremental")
    p.add_argument("--five-point", dest="five_point", action="store_true", default=True)
    p.add_argument("--eight-point", dest="five_point", action="store_false")
    p.add_argument("--ply", default="")
    p.add_argument("--num-samples", type=int, default=192)
    p.add_argument("--eval-only", action="store_true",
                   help="densify: score the saved dense_grid (+detail) on held-out views")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--ray-stride", type=int, default=2)
    p.add_argument("--norm", choices=["coremax", "core", "legacy"], default="coremax")
    p.add_argument("--norm-core-q", type=float, default=92.0)
    p.add_argument("--norm-margin", type=float, default=1.15)
    p.add_argument("--coremax-q", type=float, default=80.0)
    p.add_argument("--grid-resolution", type=int, default=256)
    p.add_argument("--scene-scale", type=float, default=0.0,
                   help="grid half-extent; 0 = 1.0 under coremax/core, else 1.5")
    p.add_argument("--dense-optimizer", choices=["adam", "rmsprop"], default="adam")
    p.add_argument("--hierarchical", action="store_true",
                   help="coarse->fine importance sampling in training")
    p.add_argument("--tv-sigma", type=float, default=0.0)
    p.add_argument("--tv-sh", type=float, default=0.0)
    p.add_argument("--sparsity-sigma", type=float, default=0.0)
    p.add_argument("--exposure", action="store_true", help="per-image exposure latents")
    p.add_argument("--sh-background", action="store_true",
                   help="learnable view-directional SH background")
    p.add_argument("--no-checkpoint", action="store_true",
                   help="no dense_ckpt per epoch, and no dense_grid unless --final-grid")
    p.add_argument("--final-grid", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="continue training after the epoch saved in dense_ckpt")
    p.add_argument("--quiet", action="store_true")
    # tpu3d's training options that the port refuses (NotImplementedError)
    p.add_argument("--occupancy", action="store_true")
    p.add_argument("--coarse-epochs", type=int, default=0)
    p.add_argument("--camera-gate", action="store_true")
    p.add_argument("--detail-epochs", type=int, default=0)
    p.add_argument("--detail-only", action="store_true")
    p.add_argument("--aniso-grid", action="store_true")
    p.add_argument("--contraction", action="store_true")
    p.add_argument("--rays-pkl", default="")
    p.add_argument("--model", choices=["plenoxel", "sdf"], default="plenoxel")
    p.add_argument("--mesh", default="")
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
    {"full": _cmd_full, "densify": _cmd_densify, "render": _cmd_render}[args.command](args)


if __name__ == "__main__":
    main()
