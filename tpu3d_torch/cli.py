"""The port's entry points: tpu3d's staged sparse commands ``cli extract``,
``match``, ``reconstruct`` and ``export`` (tpu3d/cli.py:147-229, :286-416,
:1118-1125), ``cli full`` (images to poses, points and PLY, :1167-1223),
``cli densify`` (training, :417-820, the plenoxel or the SDF model),
``cli densify --eval-only`` (:847-920), ``cli render`` (:1011-1115),
``cli mesh`` (:973-1008) and ``cli ingest`` (:1129-1164).

    python -m tpu3d_torch.cli extract --images DIR --artifacts DIR [--downscale N]
        [--limit N] [--frontend classical|disk|superpoint --frontend-weights W]
        [tpu3d's sparse-stage flags]
    python -m tpu3d_torch.cli match --images DIR --artifacts DIR
        [--matcher mnn|lightglue --matcher-weights W]
    python -m tpu3d_torch.cli reconstruct --images DIR --artifacts DIR
        [--from-matches] [--mode incremental|global] [--ply out.ply]
    python -m tpu3d_torch.cli export --images DIR --artifacts DIR [--out DIR]
    python -m tpu3d_torch.cli full --images DIR --artifacts DIR [--downscale N]
        [--limit N] [--mode incremental|global] [--register-all] [--ply out.ply]
        [--frontend ... --frontend-weights W] [--matcher ... --matcher-weights W]
        [tpu3d's sparse-stage flags]
    python -m tpu3d_torch.cli densify --images DIR --artifacts DIR [--model plenoxel|sdf]
        [--epochs N] [--ray-stride S] [--norm coremax|core|legacy] [--hierarchical]
        [--contraction [--norm-core-q Q --norm-core-radius R --band-core-radius B]]
        [--coarse-epochs N] [--occupancy] [--camera-gate --camera-gate-epoch E]
        [--aniso-grid] [--detail-epochs N [--detail-res R]] [--detail-only]
        [--tv-sigma W --tv-sh W] [--sparsity-sigma W] [--exposure]
        [--sh-background] [--dense-optimizer adam|rmsprop]
        [--no-checkpoint [--final-grid]] [--resume]
    python -m tpu3d_torch.cli densify --rays-pkl F [--test-rays-pkl F] [--near N --far F]
        [--model plenoxel|sdf] --images DIR --artifacts DIR
    python -m tpu3d_torch.cli densify --eval-only --images DIR --artifacts DIR
    python -m tpu3d_torch.cli render --images DIR --artifacts DIR [--orbit N]
    python -m tpu3d_torch.cli mesh --images DIR --artifacts DIR [--iso L] [--out F.ply]
    python -m tpu3d_torch.cli ingest (--frontend disk|superpoint --frontend-weights CKPT
        | --matcher-weights CKPT) [--out F.npz]

They read and write tpu3d's artifacts unchanged: ``extract`` writes
``features`` and ``features_meta``; ``match`` reads them and writes the
match artifacts (``pairs_meta.json`` + ``matches.npz``, io/matches.py);
``reconstruct`` reads the features and, with ``--from-matches``, the
matches (else it matches afresh and saves them), and like ``full`` writes
``reconstruction`` and ``reconstruction_meta`` (then the PLY); ``export``
writes the reference's ``output/`` protocol (io/reference_export.py). Each
sparse command prints tpu3d's summary as its last stdout line, in JSON; a
missing input artifact prints "run `extract` first" or "run `match`
first" and exits 1. Training reads
``reconstruction`` and ``reconstruction_meta`` and writes ``dense_ckpt``,
``dense_grid`` (and a cascade's ``dense_grid_detail``), ``mesh_grid``,
``dense_meta`` and ``dense_result``; eval and
render take the normalization, band, sample count, per-ray box clipping and
contraction the grid was trained with from ``dense_meta``; ``mesh`` reads
``mesh_grid`` and writes a PLY mesh. ``ingest`` converts one torch
checkpoint to tpu3d's .npz param store (the released checkpoints are not
in the repository). ``extract``, ``match``, ``reconstruct``, ``export``,
``full``, ``densify``, ``densify_from_rays``, ``densify_eval_only``,
``render_artifacts``, ``mesh`` and ``ingest`` are the functions behind the
commands; those that compute on a device run on the card unless given
``device="cpu"``. ``extract`` and ``full`` take a directory of images or the
decoded ``(gray_u8, rgb_u8)`` arrays.

Not ported: ``densify --mesh`` (tpu3d's device mesh) and extract's
multi-process branches (ROADMAP Queue 1 item 10; ``--mesh`` raises
NotImplementedError naming it), the SequentialPrematcher's
``prematch.npz`` memo (item 12; ``extract`` still removes a stale one, as
tpu3d's does), and tpu3d's XLA compile cache and dispatch counts, which are
XLA machinery.
"""
from __future__ import annotations

import argparse
import dataclasses
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
from tpu3d_torch.dense.contract import contract
from tpu3d_torch.dense.grid import VoxelGrid, create_grid, grid_from_mesh_grid, grid_from_tpu3d
from tpu3d_torch.dense.render import render_image
from tpu3d_torch.dense.train import (LAST_TRAIN_AUX, SceneNormalization, auto_near_far,
                                     core_points, normalize_scene, normalize_scene_contracted,
                                     normalize_scene_coremax, normalize_scene_legacy, psnr,
                                     train_plenoxel, train_sdf)
from tpu3d_torch.io.artifacts import ArtifactStore
from tpu3d_torch.io.ply import write_ply
from tpu3d_torch.io.raydata import load_ray_dataset

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


def _anisotropic_grid(points: np.ndarray, nrm: SceneNormalization, coremax_q: float, R: int,
                      dev) -> VoxelGrid:
    """tpu3d's --aniso-grid (tpu3d/cli.py:542-571): the box of the kept
    cloud (0.5-99.5 percentiles plus 5%) at the R^3 voxel budget, each axis'
    resolution proportional to its extent, a multiple of 8 in [32, 2R]."""
    kept = core_points(points, q=coremax_q, k=1.0)
    pn = nrm.apply(kept if len(kept) else points)
    lo = np.percentile(pn, 0.5, axis=0).astype(np.float32)
    hi = np.percentile(pn, 99.5, axis=0).astype(np.float32)
    pad = 0.05 * (hi - lo) + 1e-3
    lo, hi = lo - pad, hi + pad
    ext = hi - lo
    s = float((R**3 / np.prod(ext)) ** (1.0 / 3.0))
    mults = [8, 8, 8]
    res = tuple(int(np.clip(round(e * s / m) * m, max(32, m), 2 * R)) for e, m in zip(ext, mults))
    return create_grid(res, lo, hi, device=dev)


def _detail_box(points: np.ndarray, nrm: SceneNormalization, coremax_q: float,
                contraction: bool, base: VoxelGrid, Rd: int):
    """The cascade's detail grid (tpu3d/cli.py:638-658): the kept cloud's
    box in sample space (contracted under contraction), inside the base's,
    at the Rd^3 voxel budget. Returns (lo, hi, resolution)."""
    kept = core_points(points, q=coremax_q, k=1.0)
    pn = nrm.apply(kept if len(kept) else points).astype(np.float32)
    if contraction:
        pn = contract(torch.from_numpy(pn)).numpy()
    lo = np.percentile(pn, 0.5, axis=0).astype(np.float32)
    hi = np.percentile(pn, 99.5, axis=0).astype(np.float32)
    pad = 0.05 * (hi - lo) + 1e-3
    lo, hi = lo - pad, hi + pad
    lo = np.maximum(lo, base.min_bound.cpu().numpy())
    hi = np.minimum(hi, base.max_bound.cpu().numpy())
    ext = np.maximum(hi - lo, 1e-3)
    sfact = float((Rd**3 / np.prod(ext)) ** (1.0 / 3.0))
    return lo, hi, tuple(int(np.clip(round(e * sfact / 8) * 8, 32, 2 * Rd)) for e in ext)


def densify(artifacts: Artifacts, rgb_u8: np.ndarray, names: Sequence[str], focal: float, *,
            epochs: int = 1, ray_stride: int = 2, norm: str = "coremax",
            norm_core_q: float = 92.0, norm_margin: float = 1.15,
            norm_core_radius: float = 0.9, band_core_radius: float = 0.0,
            coremax_q: float = 80.0, contraction: bool = False, grid_resolution: int = 256,
            aniso_grid: bool = False, num_samples: int = 192, scene_scale: float = 0.0,
            optimizer: str = "adam", hierarchical: bool = False, occupancy: bool = False,
            coarse_epochs: int = 0, tv_sigma: float = 0.0, tv_sh: float = 0.0,
            sparsity_sigma: float = 0.0, exposure: bool = False, sh_background: bool = False,
            camera_gate: bool = False, camera_gate_epoch: int = 2, detail_epochs: int = 0,
            detail_res: int = 0, detail_only: bool = False, holdout_every: int = 8,
            max_eval_views: int = 8, include_low_confidence: bool = False,
            no_checkpoint: bool = False, final_grid: bool = False, resume: bool = False,
            downscale: int = 1, log_every: int = 170, verbose: bool = False,
            renders: Optional[list] = None, model: str = "plenoxel", device="cuda") -> dict:
    """Train the plenoxel (or SDF) grid of the registered views and score it, as
    tpu3d's ``cmd_densify`` with the same flags: normalize the scene
    (``norm``, or the contraction's normalization), take the sampling band
    from the sparse cloud, hold out the name-keyed test views, train
    (``train_plenoxel``, checkpointing each epoch into the store unless
    ``no_checkpoint``) with tpu3d's options (``occupancy``, ``coarse_epochs``,
    ``camera_gate``, ``aniso_grid``), then with ``detail_epochs`` a
    cascade detail grid against the frozen result; save ``dense_grid``
    (unless ``no_checkpoint`` without ``final_grid``), ``dense_grid_detail``,
    ``mesh_grid`` and ``dense_meta``, evaluate the held-out views (the pair
    for a cascade) and write and return ``dense_result``.

    ``model="sdf"`` trains the SDF grid instead (``train_sdf``, no
    checkpoints and no cascade, as in tpu3d) and scores and records it with
    its training band: near 1e-3, far 1e3, per-ray box clipping.

    Under ``contraction`` per-ray box clipping is off, ``occupancy`` is
    dropped (the disparity tail takes its place) and ``aniso_grid`` is
    ignored, as in tpu3d. ``detail_only`` loads the saved ``dense_grid`` as
    the base and trains only the detail layer (4 epochs unless
    ``detail_epochs`` says otherwise), with the normalization, band, box
    clipping and contraction that ``dense_meta`` recorded for it (tpu3d
    recomputes them from its flags); it saves no dense_grid and scores
    nothing (``densify_eval_only`` does). A cascade keeps the base's
    learned background and the cameras its gate dropped.

    rgb_u8: (n, H, W, 3) photographs at the grid's image scale, the image
    named names[i] in rgb_u8[i]; it must hold every registered view. focal
    is at the same scale; ``downscale`` is that scale's factor, recorded in
    dense_meta. scene_scale 0 is tpu3d's auto (1.0 under coremax and core,
    else 1.5). ``renders``, if a list, receives the held-out renders."""
    dev = resolve_device(device)
    if model not in ("plenoxel", "sdf"):
        raise ValueError(f"unknown dense model {model!r}: plenoxel or sdf")
    if model == "sdf" and detail_only:
        raise ValueError("--detail-only needs a saved dense_grid and the plenoxel model")
    store = _store(artifacts)
    cams, reg_names, meta = registered_views(store, include_low_confidence)
    points = _load(store, "reconstruction", "run `reconstruct` first")["points"]
    rgb = _photographs(rgb_u8, names, reg_names)
    per_ray_aabb = DenseConfig.per_ray_aabb
    if detail_only:
        dm = store.load_json("dense_meta")
        if dm is None:
            raise FileNotFoundError(f"no dense_meta in {store.root}: --detail-only needs the "
                                    "base densify's artifacts")
        nrm = SceneNormalization(np.asarray(dm["norm_center"], np.float32),
                                 float(dm["norm_scale"]))
        near, far = float(dm["near"]), float(dm["far"])
        contraction = bool(dm.get("contraction", False))
        per_ray_aabb = bool(dm["per_ray_aabb"])
    elif contraction:
        nrm = normalize_scene_contracted(points, core_q=norm_core_q, core_radius=norm_core_radius)
        band_pts = points
        if band_core_radius > 0:
            keep = np.linalg.norm(nrm.apply(band_pts), axis=1) <= band_core_radius
            if keep.sum() >= 100:
                band_pts = band_pts[keep]
        near, far = auto_near_far(cams, band_pts, nrm)
        per_ray_aabb = False
    else:
        if norm == "coremax":
            nrm = normalize_scene_coremax(points, q=coremax_q)
        elif norm == "core":
            nrm = normalize_scene(points, core_q=norm_core_q, margin=norm_margin)
        elif norm == "legacy":
            nrm = normalize_scene_legacy(points)
        else:
            raise ValueError(f"unknown normalization {norm!r}: coremax, core or legacy")
        near, far = auto_near_far(cams, points, nrm)
    if contraction and occupancy:
        print("--occupancy is ignored under --contraction (the disparity-tail sampler "
              "overrides occupancy-guided sampling)", file=sys.stderr)
        occupancy = False
    if scene_scale <= 0:
        scene_scale = 1.0 if norm in ("coremax", "core") else 1.5
    cfg = DenseConfig(epochs=epochs, grid_resolution=grid_resolution, num_samples=num_samples,
                      hierarchical=hierarchical, scene_scale=scene_scale, optimizer=optimizer,
                      near=near, far=far, per_ray_aabb=per_ray_aabb, contraction=contraction,
                      occupancy_prune=occupancy, coarse_epochs=coarse_epochs,
                      tv_sigma=tv_sigma, tv_sh=tv_sh, exposure=exposure,
                      sh_background=sh_background, sparsity_sigma=sparsity_sigma,
                      camera_gate=camera_gate, camera_gate_epoch=camera_gate_epoch)
    grid0 = None
    if aniso_grid and not contraction and not detail_only:
        grid0 = _anisotropic_grid(points, nrm, coremax_q, grid_resolution, dev)
        if verbose:
            print(f"anisotropic grid: {grid0.resolution} (budget {grid_resolution}^3)",
                  flush=True)
    train_idx, test_idx = split_views_by_name(reg_names, holdout_every)
    dataset = dataset_from_views(cams, rgb, focal, train_idx, nrm, stride=ray_stride)
    if verbose:
        print(f"scene-derived sampling band: near={near:.3f} far={far:.3f}; "
              f"{len(dataset.origins)} rays from {len(train_idx)} train cameras "
              f"({len(test_idx)} held out)", flush=True)
    if detail_only:
        grid, bg_sh = grid_from_tpu3d(_load(store, "dense_grid", "run the base densify with "
                                            "--final-grid first"), dev)
        losses, dropped = [], []
        detail_epochs = detail_epochs if detail_epochs > 0 else 4
    elif model == "sdf":
        grid, losses = train_sdf(dataset, cfg, verbose=verbose, log_every=log_every, grid=grid0,
                                 device=dev)
        del grid0
        bg = LAST_TRAIN_AUX.get("background")
        bg_sh = None if bg is None else torch.from_numpy(bg).to(dev)
        dropped = []
        # no cascade for the SDF model (tpu3d/cli.py:625); scored and recorded with the training band (tpu3d/cli.py:613-618)
        near, far, per_ray_aabb = 1e-3, 1e3, True
        cfg = dataclasses.replace(cfg, near=near, far=far, per_ray_aabb=per_ray_aabb)
    else:
        grid, losses = train_plenoxel(dataset, cfg, verbose=verbose, log_every=log_every,
                                      checkpoint_store=None if no_checkpoint else store,
                                      resume=resume, grid=grid0, device=dev)
        del grid0
        bg = LAST_TRAIN_AUX.get("background")
        bg_sh = None if bg is None else torch.from_numpy(bg).to(dev)
        dropped = list(LAST_TRAIN_AUX.get("dropped_cameras", []))
    detail = None
    if detail_epochs > 0 and model != "sdf":
        lo, hi, dres = _detail_box(points, nrm, coremax_q, contraction, grid,
                                   detail_res or grid_resolution)
        if verbose:
            print(f"[cascade] detail grid {dres} over box {np.round(lo, 2).tolist()}.."
                  f"{np.round(hi, 2).tolist()}", flush=True)
        det_cfg = dataclasses.replace(cfg, epochs=detail_epochs, coarse_epochs=0,
                                      camera_gate=False, exposure=False, sh_background=False,
                                      optimizer="rmsprop")
        detail, det_losses = train_plenoxel(dataset, det_cfg, verbose=verbose,
                                            log_every=log_every, base_grid=grid,
                                            grid=create_grid(dres, lo, hi, init=0.0, device=dev),
                                            device=dev)
        losses = losses + det_losses
        if not no_checkpoint or final_grid:
            store.save("dense_grid_detail", grid=detail.grid.cpu().numpy(), min_bound=lo,
                       max_bound=hi)
    bounds = dict(min_bound=grid.min_bound.cpu().numpy(), max_bound=grid.max_bound.cpu().numpy())
    if (not no_checkpoint or final_grid) and not detail_only:
        store.save("dense_grid", grid=grid.grid.cpu().numpy(), **bounds,
                   **({} if bg_sh is None else {"bg_sh": bg_sh.cpu().numpy()}))
    # density and the SH DC of each colour, f16: what `cli mesh` reads
    store.save("mesh_grid", grid=grid.grid[..., [0, 1, 10, 19]].cpu().numpy().astype(np.float16),
               **bounds, contraction=np.asarray(contraction))
    store.save_json("dense_meta", {
        "model": model, "near": float(near), "far": float(far),
        "num_samples": int(num_samples), "per_ray_aabb": bool(per_ray_aabb),
        "downscale": int(downscale), "contraction": bool(contraction),
        "norm_center": np.asarray(nrm.center, np.float64).tolist(),
        "norm_scale": float(nrm.scale),
        "cascade_detail": None if detail is None else {
            "res": [int(r) for r in detail.resolution], "min_bound": lo.tolist(),
            "max_bound": hi.tolist()}})
    out = {"final_loss": losses[-1] if losses else None,
           "psnr_train_proxy": float(-10 * np.log10(losses[-1])) if losses else None,
           "dropped_cameras": [reg_names[int(train_idx[c])] for c in dropped]}
    if len(test_idx) and not detail_only:
        if detail is not None:
            ev = evaluate_views(detail, cams[test_idx], rgb[test_idx], focal, cfg, nrm,
                                stride=2, max_views=max_eval_views, bg_sh=bg_sh, base_grid=grid)
        else:
            ev = evaluate_views(grid, cams[test_idx], rgb[test_idx], focal, cfg, nrm, stride=2,
                                max_views=max_eval_views, bg_sh=bg_sh)
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
    out["recipe"] = {"epochs": epochs, "coarse_epochs": coarse_epochs,
                     "grid_resolution": grid_resolution, "contraction": bool(contraction),
                     "coremax_q": coremax_q, "detail_epochs": detail_epochs, "model": model}
    store.save_json("dense_result", out)
    return out


def densify_from_rays(artifacts: Artifacts, rays_pkl: str, *, test_rays_pkl: str = "",
                      near: float = 0.0, far: float = 0.0, epochs: int = 1,
                      grid_resolution: int = 256, num_samples: int = 192,
                      hierarchical: bool = False, scene_scale: float = 0.0,
                      optimizer: str = "adam", occupancy: bool = False, tv_sigma: float = 0.0,
                      tv_sh: float = 0.0, no_checkpoint: bool = False, resume: bool = False,
                      log_every: int = 170, verbose: bool = False, model: str = "plenoxel",
                      device="cuda") -> dict:
    """tpu3d's ``densify --rays-pkl`` (_densify_from_rays, tpu3d/cli.py:923-970):
    train on an (N, 9) ray file (io/raydata.py) with the band [near, far]
    (the reference's 2 and 6 where 0) and the grid half-extent
    ``scene_scale`` (1.5 where 0); save ``dense_grid`` unless
    ``no_checkpoint``; with ``test_rays_pkl``, the PSNR of its rays
    rendered by the trained grid. ``model="sdf"`` trains the SDF grid
    (``train_sdf``: no checkpoints, no resume). Returns {final_loss,
    psnr_train_proxy[, test_psnr]}; writes no dense_result."""
    dev = resolve_device(device)
    store = _store(artifacts)
    dataset = load_ray_dataset(rays_pkl)
    if verbose:
        print(f"{len(dataset.origins)} rays from {rays_pkl}", flush=True)
    cfg = DenseConfig(epochs=epochs, grid_resolution=grid_resolution, num_samples=num_samples,
                      hierarchical=hierarchical, optimizer=optimizer,
                      scene_scale=scene_scale if scene_scale > 0 else 1.5,
                      near=near if near > 0 else DenseConfig.near,
                      far=far if far > 0 else DenseConfig.far, occupancy_prune=occupancy,
                      tv_sigma=tv_sigma, tv_sh=tv_sh)
    if model == "sdf":
        grid, losses = train_sdf(dataset, cfg, verbose=verbose, log_every=log_every, device=dev)
    else:
        grid, losses = train_plenoxel(dataset, cfg, verbose=verbose, log_every=log_every,
                                      checkpoint_store=None if no_checkpoint else store,
                                      resume=resume, device=dev)
    if not no_checkpoint:
        store.save("dense_grid", grid=grid.grid.cpu().numpy(),
                   min_bound=grid.min_bound.cpu().numpy(), max_bound=grid.max_bound.cpu().numpy())
    out = {"final_loss": losses[-1] if losses else None,
           "psnr_train_proxy": float(-10 * np.log10(losses[-1])) if losses else None}
    if test_rays_pkl:
        test = load_ray_dataset(test_rays_pkl)
        pred = render_image(grid, torch.from_numpy(test.origins).to(dev),
                            torch.from_numpy(test.dirs).to(dev), cfg.near, cfg.far,
                            cfg.num_samples, clip_aabb=cfg.per_ray_aabb)
        out["test_psnr"] = psnr(pred.cpu().numpy(), test.rgb)
    return out


def mesh(artifacts: Artifacts, iso: float = 0.0, out: str = "") -> dict:
    """tpu3d's ``cmd_mesh`` (tpu3d/cli.py:973-1008): the iso-surface of the
    saved ``mesh_grid``'s density by marching tetrahedra, its vertices
    merged, coloured by the SH DC term, unwarped by ``contract_inv`` when the
    grid was contracted, written as a PLY mesh to ``out`` (default
    ARTIFACTS/mesh.ply). iso <= 0 takes the 0.99 quantile of the positive
    densities. Host numpy, as tpu3d's. Returns {vertices, faces, iso, path}."""
    from tpu3d_torch.dense.contract import contract_inv
    from tpu3d_torch.dense.mesh import dedup_mesh, marching_tetrahedra
    from tpu3d_torch.io.ply import write_ply_mesh

    store = _store(artifacts)
    d = _load(store, "mesh_grid", "run `densify` first")
    sigma = d["grid"][..., 0].astype(np.float32)
    # channels [sigma, SH DC r, g, b]; the DC basis is 0.282095
    rgb = np.clip(d["grid"][..., 1:4].astype(np.float32) * 0.282095, 0.0, 1.0)
    if iso <= 0:
        pos = sigma[sigma > 0]
        iso = float(np.quantile(pos, 0.99)) if len(pos) else 0.0
        print(f"auto iso level: {iso:.3f}", file=sys.stderr)
    verts, faces, cols = marching_tetrahedra(sigma, iso, d["min_bound"], d["max_bound"], rgb)
    verts, faces, cols = dedup_mesh(verts, faces, cols)
    if bool(np.asarray(d.get("contraction", False))):
        verts = contract_inv(torch.from_numpy(np.asarray(verts, np.float32))).numpy()
    out = out or os.path.join(store.root, "mesh.ply")
    n = write_ply_mesh(out, verts, faces, cols)
    return {"vertices": int(len(verts)), "faces": int(n), "iso": round(iso, 4), "path": out}


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


def _save_reconstruction(store: ArtifactStore, rec, cfg: PipelineConfig, mode: str,
                         downscale: int, seconds: float, sfm_timers: dict) -> None:
    """``reconstruction`` and ``reconstruction_meta`` as tpu3d's
    cmd_reconstruct and cmd_full write them."""
    store.save("reconstruction", cams=rec.cams, registered=rec.registered, points=rec.points,
               colors_bgr=rec.colors_bgr, track_ids=rec.track_ids, extrinsics=rec.extrinsics())
    store.save_json("reconstruction_meta", {
        "registered_names": rec.registered_names(),
        "mean_reproj_px": rec.mean_reproj_px,
        "num_obs": rec.num_obs,
        "mode": mode,
        "downscale": downscale,
        "seconds": seconds,
        "sfm_phase_seconds": sfm_timers,
        "sfm_backend": cfg.sfm.backend,
        # --register-all cameras: in the pose set, out of the BA gauge and
        # (by default) out of dense training.
        "low_confidence_names": [rec.image_names[i] for i in rec.low_confidence],
        "per_camera_reproj_px": {rec.image_names[i]: round(e, 3)
                                 for i, e in rec.per_cam_reproj_px.items()},
    })


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
    _save_reconstruction(store, rec, cfg, mode, downscale, round(timings["total"], 1),
                         P.LAST_SFM_TIMERS)
    if ply:
        write_ply(ply, rec.points, rec.colors_bgr)
    return {
        "registered": len(rec.registered), "points": int(len(rec.points)),
        "mean_reproj_px": rec.mean_reproj_px,
        "stage_seconds": {k: round(v, 1) for k, v in timings.items()},
        "extract_timers": dict(P.LAST_EXTRACT_TIMERS),
        "match_timers": dict(P.LAST_MATCH_TIMERS),
    }


def extract(images, artifacts: Artifacts, cfg: PipelineConfig,
            names: Optional[Sequence[str]] = None, downscale: int = 1, verbose: bool = False,
            device="cuda") -> dict:
    """tpu3d's ``cmd_extract`` (its one-process branch): features of every
    image on ``device``, saved as ``features`` and ``features_meta``.
    ``images`` is a directory or the decoded ``(gray_u8, rgb_u8)`` arrays.
    A stale ``prematch.npz`` is removed, as tpu3d's extract does (the port
    writes none). Returns the summary the command prints."""
    from tpu3d_torch.sfm.pipeline import run_extraction

    store = _store(artifacts)
    t0 = time.time()
    try:
        os.remove(os.path.join(store.root, "prematch.npz"))
    except FileNotFoundError:
        pass
    timers: Dict[str, float] = {}
    feats = run_extraction(images, cfg, list(names) if names is not None else None, downscale,
                           verbose, device=device, timers=timers)
    store.save("features", keypoints=feats.keypoints, keypoints_px=feats.keypoints_px,
               descriptors=feats.descriptors, valid=feats.valid, colors_bgr=feats.colors_bgr,
               image_size=feats.image_size)
    seconds = time.time() - t0
    store.save_json("features_meta", {"names": feats.names, "downscale": downscale,
                                      "seconds": seconds})
    return {"images": len(feats.names), "seconds": round(seconds, 1),
            "extract_timers": {k: round(v, 2) for k, v in timers.items()}}


def load_features(artifacts: Artifacts, device="cuda"):
    """(ExtractedFeatures with its tensors on ``device``, features_meta)
    from the store; FileNotFoundError where ``extract`` has not run."""
    from tpu3d_torch.sfm.pipeline import ExtractedFeatures

    store = _store(artifacts)
    data = store.load("features")
    meta = store.load_json("features_meta")
    if data is None or meta is None:
        raise FileNotFoundError("no features artifact — run `extract` first")
    return ExtractedFeatures.from_numpy(
        meta["names"], data["keypoints"], data["keypoints_px"], data["valid"],
        data["colors_bgr"], data["image_size"], data["descriptors"], device=device), meta


def match(artifacts: Artifacts, cfg: PipelineConfig, verbose: bool = False,
          device="cuda") -> dict:
    """tpu3d's ``cmd_match``: retrieval and matching on ``device`` over the
    saved features, saved as the match artifacts. ``cfg``'s focal is at the
    features' scale (the command divides by their downscale). Returns the
    summary the command prints."""
    from tpu3d_torch.io.matches import save_matches
    from tpu3d_torch.sfm.pipeline import run_matching, run_retrieval

    store = _store(artifacts)
    t_load = time.time()
    feats, _ = load_features(store, device)
    t0 = time.time()
    adj = run_retrieval(feats, cfg, device=device)
    t_ret = time.time()
    timers: Dict[str, object] = {}
    regs, ts = run_matching(feats, adj, cfg, verbose=verbose, device=device, timers=timers)
    t_m = time.time()
    timers.update(load_upload=round(t0 - t_load, 2), retrieval=round(t_ret - t0, 2),
                  match_total=round(t_m - t_ret, 2))
    save_matches(store.root, regs, ts, adj, time.time() - t0)
    timers["save"] = round(time.time() - t_m, 2)
    return {"images": len(regs), "edges": sum(len(r.edges) for r in regs),
            "seconds": round(time.time() - t0, 1),
            "match_timers": {k: round(v, 2) if isinstance(v, float) else v
                             for k, v in timers.items()}}


def reconstruct(artifacts: Artifacts, cfg: PipelineConfig, mode: str = "incremental",
                from_matches: bool = False, ply: str = "", verbose: bool = False,
                device="cuda") -> dict:
    """tpu3d's ``cmd_reconstruct``: the saved features, and with
    ``from_matches`` the saved matches (else retrieval and matching afresh,
    then saved), through the incremental or global reconstruction on
    ``device``; writes ``reconstruction`` and ``reconstruction_meta``, then
    the PLY. ``cfg``'s focal is at the features' scale. FileNotFoundError
    where an input artifact is missing. Returns the summary the command
    prints."""
    from tpu3d_torch.io.matches import load_matches, save_matches
    from tpu3d_torch.sfm import pipeline as P

    store = _store(artifacts)
    feats, meta = load_features(store, device)
    t0 = time.time()
    if from_matches:
        loaded = load_matches(store.root, len(feats.names), feats.keypoints.shape[1],
                              cfg.sfm.max_tracks)
        if loaded is None:
            raise FileNotFoundError("no saved matches — run `match` first")
        regs, ts, adj = loaded
    else:
        adj = P.run_retrieval(feats, cfg, device=device)
        regs, ts = P.run_matching(feats, adj, cfg, verbose=verbose, device=device)
        save_matches(store.root, regs, ts, adj, time.time() - t0)
    run = P.run_global_reconstruction if mode == "global" else P.run_reconstruction
    rec = run(feats, regs, ts, cfg, verbose=verbose, adj=adj, device=device)
    _save_reconstruction(store, rec, cfg, mode, meta.get("downscale", 1), time.time() - t0,
                         P.LAST_SFM_TIMERS)
    if ply:
        n = write_ply(ply, rec.points, rec.colors_bgr)
        print(f"wrote {n} points -> {ply}")
    out = {"registered": len(rec.registered), "points": int(len(rec.points)),
           "mean_reproj_px": rec.mean_reproj_px, "seconds": round(time.time() - t0, 1)}
    if len(rec.low_confidence):
        out["low_confidence"] = len(rec.low_confidence)
    return out


def export(artifacts: Artifacts, out: str = "", device="cuda") -> dict:
    """tpu3d's ``cmd_export``: the reference's ``output/`` protocol from
    the saved artifacts into ``out`` (default ARTIFACTS/output)."""
    from tpu3d_torch.io.reference_export import export_reference_layout

    root = _store(artifacts).root
    out = out or os.path.join(root, "output")
    return {"out": out, "written": export_reference_layout(root, out, device)}


def ingest(frontend: str = "disk", frontend_weights: str = "", matcher_weights: str = "",
           out: str = "") -> dict:
    """tpu3d's ``cmd_ingest`` (tpu3d/cli.py:1129-1164): one torch checkpoint
    (DISK or SuperPoint with ``frontend_weights``, or LightGlue with
    ``matcher_weights``) converted to tpu3d's flat .npz param store at
    ``out`` (default: the checkpoint's path with .npz), which tpu3d and the
    port both load. Returns {model, source, out, arrays}."""
    from tpu3d_torch.features.learned import (count_arrays, load_frontend_params,
                                              load_matcher_params, save_params_npz)

    if bool(frontend_weights) == bool(matcher_weights):
        raise ValueError("ingest converts ONE checkpoint: give either --frontend-weights "
                         "or --matcher-weights")
    if matcher_weights:
        params, kind, src = load_matcher_params(matcher_weights), "lightglue", matcher_weights
    else:
        params = load_frontend_params(frontend, frontend_weights)
        kind, src = frontend, frontend_weights
    out = out or (os.path.splitext(src)[0] + ".npz")
    save_params_npz(out, params)
    return {"model": kind, "source": src, "out": out, "arrays": count_arrays(params)}


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


def _image_names(args) -> list:
    from tpu3d_torch.io.images import list_images

    names = list_images(args.images)
    return names[: args.limit] if args.limit else names


def _rescaled_config(args, meta: dict) -> PipelineConfig:
    """build_config with the focal at the saved features' scale
    (tpu3d/cli.py:332-341)."""
    cfg = build_config(args)
    cam = CameraConfig(focal_length=args.focal / meta.get("downscale", 1))
    return dataclasses.replace(cfg, camera=cam, sfm=dataclasses.replace(cfg.sfm, camera=cam))


def _features_meta(args) -> dict:
    meta = ArtifactStore(args.artifacts).load_json("features_meta")
    if meta is None:
        print("no features artifact — run `extract` first", file=sys.stderr)
        sys.exit(1)
    return meta


def _cmd_full(args) -> None:
    out = full(args.images, args.artifacts, build_config(args), _image_names(args),
               args.downscale, args.ply, args.mode, verbose=not args.quiet, device=args.device)
    print(json.dumps(out))


def _cmd_extract(args) -> None:
    out = extract(args.images, args.artifacts, build_config(args), _image_names(args),
                  args.downscale, verbose=not args.quiet, device=args.device)
    print(f"extracted {out['images']} images in {out['seconds']:.1f}s -> "
          f"{args.artifacts}/features.npz")
    print(json.dumps(out))


def _cmd_match(args) -> None:
    out = match(args.artifacts, _rescaled_config(args, _features_meta(args)),
                verbose=not args.quiet, device=args.device)
    print(f"matched {out['images']} images / {out['edges']} edges in {out['seconds']:.1f}s")
    print(json.dumps(out))


def _cmd_reconstruct(args) -> None:
    try:
        out = reconstruct(args.artifacts, _rescaled_config(args, _features_meta(args)),
                          args.mode, args.from_matches, args.ply, verbose=not args.quiet,
                          device=args.device)
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        sys.exit(1)
    print(json.dumps(out))


def _cmd_export(args) -> None:
    try:
        out = export(args.artifacts, args.out, args.device)
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        sys.exit(1)
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


def _cmd_mesh(args) -> None:
    try:
        out = mesh(args.artifacts, args.iso, args.out)
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        sys.exit(1)
    print(json.dumps(out))


def _cmd_ingest(args) -> None:
    try:
        out = ingest(args.frontend, args.frontend_weights, args.matcher_weights, args.out)
    except ValueError as e:
        print(e, file=sys.stderr)
        sys.exit(2)
    print(json.dumps(out))


def _cmd_densify(args) -> None:
    from tpu3d_torch.io.images import load_images

    if args.mesh:
        raise NotImplementedError(f"tpu3d_torch: densify --mesh {args.mesh} is not ported yet "
                                  "(ROADMAP Queue 1 item 10)")
    if args.detail_only and args.model == "sdf":
        print("--detail-only needs a saved dense_grid (run the base densify with --final-grid "
              "first) and the plenoxel model", file=sys.stderr)
        sys.exit(1)
    store = ArtifactStore(args.artifacts)
    if args.rays_pkl:
        out = densify_from_rays(store, args.rays_pkl, test_rays_pkl=args.test_rays_pkl,
                                near=args.near, far=args.far, epochs=args.epochs,
                                grid_resolution=args.grid_resolution,
                                num_samples=args.num_samples, hierarchical=args.hierarchical,
                                scene_scale=args.scene_scale, optimizer=args.dense_optimizer,
                                occupancy=args.occupancy, tv_sigma=args.tv_sigma,
                                tv_sh=args.tv_sh, no_checkpoint=args.no_checkpoint,
                                resume=args.resume, verbose=not args.quiet, model=args.model,
                                device=args.device)
        print(json.dumps(out))
        return
    ds = _downscale(store, args.dense_downscale)
    _, names, _ = registered_views(store, args.include_low_confidence)
    rgb = load_images(args.images, names, ds)[1]
    if args.eval_only:
        out = densify_eval_only(store, rgb, names, args.focal / ds, args.holdout_every,
                                args.max_eval_views, args.include_low_confidence, args.device)
        print(json.dumps(out))
        return
    renders: list = []
    out = densify(store, rgb, names, args.focal / ds, epochs=args.epochs,
                  ray_stride=args.ray_stride, norm=args.norm, norm_core_q=args.norm_core_q,
                  norm_margin=args.norm_margin, norm_core_radius=args.norm_core_radius,
                  band_core_radius=args.band_core_radius, coremax_q=args.coremax_q,
                  contraction=args.contraction, grid_resolution=args.grid_resolution,
                  aniso_grid=args.aniso_grid, num_samples=args.num_samples,
                  scene_scale=args.scene_scale, optimizer=args.dense_optimizer,
                  hierarchical=args.hierarchical, occupancy=args.occupancy,
                  coarse_epochs=args.coarse_epochs, tv_sigma=args.tv_sigma, tv_sh=args.tv_sh,
                  sparsity_sigma=args.sparsity_sigma, exposure=args.exposure,
                  sh_background=args.sh_background, camera_gate=args.camera_gate,
                  camera_gate_epoch=args.camera_gate_epoch, detail_epochs=args.detail_epochs,
                  detail_res=args.detail_res, detail_only=args.detail_only,
                  holdout_every=args.holdout_every, max_eval_views=args.max_eval_views,
                  include_low_confidence=args.include_low_confidence,
                  no_checkpoint=args.no_checkpoint, final_grid=args.final_grid,
                  resume=args.resume, downscale=ds, verbose=not args.quiet, renders=renders,
                  model=args.model, device=args.device)
    if renders:
        from PIL import Image

        gt = rgb[names.index(out["test_view_names"][0])][::2, ::2]
        Image.fromarray((np.clip(renders[0], 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(args.artifacts, "test_render0.png"))
        Image.fromarray(gt).save(os.path.join(args.artifacts, "test_gt0.png"))
    print(json.dumps(out))


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(prog="tpu3d_torch",
                                description="tpu3d's sparse stages (extract, match, "
                                            "reconstruct, export, full), dense stage "
                                            "(train, eval, render, mesh) and checkpoint "
                                            "ingest on the GPU")
    p.add_argument("command", choices=["extract", "match", "reconstruct", "export", "full",
                                       "densify", "render", "mesh", "ingest"])
    p.add_argument("--images", default="", help="image directory (every command but ingest)")
    p.add_argument("--artifacts", default="artifacts")
    p.add_argument("--downscale", type=int, default=1)
    p.add_argument("--dense-downscale", type=int, default=4)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--focal", type=float, default=2378.98305085)
    # full: tpu3d's sparse-stage flags
    p.add_argument("--max-keypoints", type=int, default=2048)
    p.add_argument("--frontend", choices=["classical", "disk", "superpoint"], default="classical",
                   help="keypoint frontend: the classical DoG/SIFT one or a learned model "
                        "(needs --frontend-weights)")
    p.add_argument("--frontend-weights", default="",
                   help="the learned frontend's weights: a converted .npz or a torch checkpoint")
    p.add_argument("--matcher", choices=["mnn", "lightglue"], default="mnn",
                   help="descriptor matcher: mutual-NN or LightGlue (needs --matcher-weights)")
    p.add_argument("--matcher-weights", default="",
                   help="LightGlue's weights: a converted .npz or a torch checkpoint")
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
    p.add_argument("--from-matches", action="store_true",
                   help="reconstruct: from the saved match artifacts (no re-matching)")
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
    p.add_argument("--contraction", action="store_true",
                   help="radial scene contraction: the grid spans [-2, 2]^3, the core linear")
    p.add_argument("--norm-core-radius", type=float, default=0.9,
                   help="contraction: normalized radius the core percentile lands at")
    p.add_argument("--band-core-radius", type=float, default=0.0,
                   help="contraction: the sampling band from points within this normalized "
                        "radius only (0 = off)")
    p.add_argument("--occupancy", action="store_true", help="occupancy-guided sampling")
    p.add_argument("--coarse-epochs", type=int, default=0,
                   help="coarse-to-fine: this many epochs on a 2x-downscaled grid first")
    p.add_argument("--camera-gate", action="store_true",
                   help="drop training cameras whose probe loss is a robust outlier")
    p.add_argument("--camera-gate-epoch", type=int, default=2)
    p.add_argument("--aniso-grid", action="store_true",
                   help="fit the grid box to the kept cloud at the same voxel budget")
    p.add_argument("--detail-epochs", type=int, default=0,
                   help="cascade: train a detail grid against the frozen base this many epochs")
    p.add_argument("--detail-res", type=int, default=0,
                   help="cascade: the detail grid's voxel budget (0 = --grid-resolution)")
    p.add_argument("--detail-only", action="store_true",
                   help="cascade: load the saved dense_grid as the base, train only the detail")
    p.add_argument("--rays-pkl", default="",
                   help="train from an (N, 9) [origin, dir, rgb] ray file instead")
    p.add_argument("--test-rays-pkl", default="", help="rays-pkl: held-out ray file")
    p.add_argument("--near", type=float, default=0.0, help="rays-pkl: band near (0 = 2)")
    p.add_argument("--far", type=float, default=0.0, help="rays-pkl: band far (0 = 6)")
    p.add_argument("--model", choices=["plenoxel", "sdf"], default="plenoxel",
                   help="densify: the plenoxel grid or the SDF grid")
    # tpu3d's device mesh: refused (NotImplementedError, ROADMAP Queue 1 item 10)
    p.add_argument("--mesh", default="")
    p.add_argument("--iso", type=float, default=0.0,
                   help="mesh: iso level of the density (0 = the 0.99 quantile of the "
                        "positive densities)")
    p.add_argument("--holdout-every", type=int, default=8)
    p.add_argument("--max-eval-views", type=int, default=8)
    p.add_argument("--include-low-confidence", action="store_true")
    p.add_argument("--render-views", default="0,60,120,180",
                   help="render: comma-separated registered-view indices; '' to skip")
    p.add_argument("--orbit", type=int, default=0,
                   help="render: also N novel views along the registered trajectory")
    p.add_argument("--render-stride", type=int, default=1)
    p.add_argument("--out", default="", help="render: PNG directory (default ARTIFACTS/renders); "
                   "export: destination (default ARTIFACTS/output); mesh: PLY path (default "
                   "ARTIFACTS/mesh.ply); ingest: .npz path (default the checkpoint's)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--cpu", dest="device", action="store_const", const="cpu",
                   help="the same as --device cpu")
    args = p.parse_args(argv)
    if args.command != "ingest" and not args.images:
        p.error("--images is required")
    {"extract": _cmd_extract, "match": _cmd_match, "reconstruct": _cmd_reconstruct,
     "export": _cmd_export, "full": _cmd_full, "densify": _cmd_densify,
     "render": _cmd_render, "mesh": _cmd_mesh, "ingest": _cmd_ingest}[args.command](args)


if __name__ == "__main__":
    main()
