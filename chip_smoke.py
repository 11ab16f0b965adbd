#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (tpu3d_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero:

  1. device  — the card's name and count, and nvidia-smi's name and power
               limit; no card exits 1.
  2. build   — nvcc builds every kernel from tpu3d_torch/csrc into
               build/tpu3d_torch, with ptxas' register/shared/spill lines.
  3. kernels — each kernel against its plain PyTorch version on the card at
               the shapes of the main path: max error, kernel ms (CUDA
               events over many launches), plain ms, library ms, bound ms.
  4. slice   — a synthetic 24-view scene (``make_scene``) through
               run_extraction -> run_retrieval -> run_matching on the card,
               with per-stage seconds, match statistics, the relative-rotation
               error against the scene's poses, peak memory and the kernels'
               launch counts; then the same stages once more under
               torch.profiler, for the device's busy share per stage.
  5. dense   — tpu3d's dense artifacts for the same scene with an analytic
               256^3 x 28 grid of its planes (``make_dense_artifacts``),
               scored by densify_eval_only on the card (held-out views 4,
               12, 20 at stride 2, 192 samples): PSNR against tpu3d's on the
               CPU, trilinear_kernel launches, peak memory, per-view render
               seconds, and one view under torch.profiler.
  6. train   — densify (training) on the card from a fresh directory holding
               only the scene's reconstruction, at tpu3d's default width
               (256^3 x 28, 192 samples, batch 2048, Adam) with ray stride 8
               (100 steps), then its held-out evaluation: steps, wall, rays/s
               after the first 10 steps, first and last logged loss, PSNR
               against tpu3d's on the CPU, peak memory, both kernels'
               launches; then one training step under torch.profiler: the
               device time of the forward kernel, the scatter with its fill,
               the Adam update and the elementwise kernels, and the busy share.
  7. full    — sfm.pipeline.reconstruct (extract -> retrieve -> match ->
               reconstruct) on the 24 views from arrays, at tpu3d's default
               PipelineConfig with the scene's focal, twice: the split
               descriptor, then fused_descriptor=True. Per run: seconds per
               stage and the engine's phase timers, registered cameras,
               points, mean reprojection px, camera-centre and rotation error
               after a similarity alignment to the scene's poses, peak memory
               and launches. Then the split run's reconstruct stage once more
               under torch.profiler, for its busy share and top kernels.

The kernel rows (phase 3): patch_sample_kernel, top2_kernel,
trilinear_kernel, trilinear_grad_kernel, orient_desc_kernel. The line before
the last is the kernel table as JSON; the last line is the device JSON. ``make_scene``, ``make_reconstruction_artifacts``,
``make_dense_artifacts`` and ``rotation_errors_deg`` are shared with the CPU
tests (tests/test_torch_slice.py, tests/test_torch_dense.py,
tests/test_torch_train.py).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# The main path's shapes: the benchmark's 24 images at downscale 2.
N_VIEWS, WIDTH, HEIGHT = 24, 968, 648
SCENE_SEED = 0
# Images tpu3d accepts on make_scene(SCENE_SEED) at these shapes, run on the
# CPU with the default PipelineConfig (focal set to the scene's), as
# `JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_slice.py` prints;
# the port must accept at least this many less one.
TPU3D_CPU_ACCEPTED = 24
MAX_MEDIAN_ROT_ERR_DEG = 0.5
H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12           # FP32 outside the tensor cores
# The dense phase: tpu3d's default DenseConfig width (256^3 x 28, 192
# samples, per-ray box clipping) on make_scene's views at stride 2, in
# evaluate_views' chunks of 8,192 rays.
PLANE_SIZE = 12.0
DENSE_RES = 256
DENSE_SIGMA = 2000.0              # density on the plane layers (normalized units)
DENSE_CHUNK = 8192
_SH_C0 = 0.282095
# Mean held-out PSNR (views 4, 12, 20) that tpu3d's evaluate_views gives on
# the CPU for make_dense_artifacts(make_scene(SCENE_SEED)), as
# `JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_dense.py` prints;
# the port must come within 0.05 dB of it.
TPU3D_CPU_DENSE_PSNR = 16.837276284315323
MAX_DENSE_PSNR_DIFF_DB = 0.05
# The train phase: tpu3d's densify at its default width (256^3 x 28, 192
# samples, batch 2048, Adam 1e-2, one epoch) on make_scene's 21 training
# views, every 8th pixel in each direction (tpu3d's --ray-stride, a depth
# cut: 205,821 rays, 100 steps). The loss is read back every 10 steps.
TRAIN_RAY_STRIDE = 8
TRAIN_LOG_EVERY = 10
# Mean held-out PSNR (views 4, 12, 20) of tpu3d's train_plenoxel (seed 0,
# what its densify uses) + evaluate_views on the CPU for the same artifacts
# and flags, as `JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_train.py`
# prints. Over seeds 0, 1, 2 tpu3d gives 11.8299 / 11.8347 / 11.9089 dB, a
# spread of 0.0789 dB; the port's random streams differ from tpu3d's, so it
# must come within twice that.
TPU3D_CPU_TRAIN_PSNR = 11.82993530895601
MAX_TRAIN_PSNR_DIFF_DB = 0.16
SLICE_KERNELS = ("patch_sample_kernel", "top2_kernel")
# The full phase: tpu3d's reconstruct on make_scene(SCENE_SEED) at these
# shapes on the CPU (default PipelineConfig, the scene's focal in camera and
# sfm.camera), over three seeds of its draws, as
# `JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_reconstruct.py`
# prints: the fewest cameras it registered, and its worst mean reprojection
# error plus twice the spread over the seeds (the port's draws differ).
# Seeds 0/1/2: 24/24 each, 0.160347 / 0.158472 / 0.160955 px.
TPU3D_CPU_REGISTERED = 24
MAX_FULL_REPROJ_PX = 0.165923
# orient_desc_kernel against its plain version: theta within 1e-5 rad and
# samples within orient_desc.sample_tolerance (1e-5 x max|g|, plus what the
# theta difference can move a sample) except at near ties (< 5%).
ORIENT_THETA_TOL = 1e-5
ORIENT_SAMPLE_TOL = 1e-5


# --------------------------------------------------------------------------
# The synthetic scene (numpy + scipy only).


def _look_at(center, target, up=(0.0, 1.0, 0.0)):
    """World->camera rotation whose z axis looks from center at target and
    whose y axis points up: rows (x, y, z) with x = y × z (a proper
    rotation; the pipeline's centered coords have y up)."""
    z = np.asarray(target, np.float64) - center
    z /= np.linalg.norm(z)
    y = np.asarray(up, np.float64) - z * np.dot(up, z)
    y /= np.linalg.norm(y)
    x = np.cross(y, z)
    return np.stack([x, y, z])


def _texture(rng, n, gain):
    """Multi-scale gaussian noise in [0.08, 0.92] * gain."""
    from scipy.ndimage import gaussian_filter

    tex = sum(gaussian_filter(rng.standard_normal((n, n)), s) * s ** 0.8
              for s in (1.0, 2.0, 4.0, 8.0, 16.0))
    lo, hi = np.percentile(tex, [1, 99])
    return gain * (0.08 + 0.84 * np.clip((tex - lo) / (hi - lo), 0.0, 1.0))


def make_scene(seed: int = SCENE_SEED, n_views: int = N_VIEWS,
               width: int = WIDTH, height: int = HEIGHT) -> dict:
    """Three textured planes forming a corner (x = 0, y = 0, z = 0, each
    for coordinates in [0, S]), seen by cameras on an arc that all look at
    the corner, rendered by ray–plane intersection.

    Returns {"gray": (N, H, W) uint8, "rgb": (N, H, W, 3) uint8,
    "R": (N, 3, 3), "t": (N, 3) world->camera, "focal": float,
    "planes": [(normal axis, (in-plane axes a, b), texture)],
    "texels": texels per unit}, in the pipeline's camera model: a pixel
    (x, y) is the centered point (x - W/2, -(y - H/2)) = focal * Xc[:2] /
    Xc[2]. A plane point (pa, pb) shows texture[pb * texels, pa * texels]."""
    from scipy.ndimage import map_coordinates

    rng = np.random.default_rng(seed)
    S = PLANE_SIZE
    focal = 0.9 * width
    dist = 5.6
    n_tex = int(S * focal / dist)           # about one texel per pixel
    texels = n_tex / S
    planes = [  # (axis of the normal, the two in-plane axes, texture)
        (0, (2, 1), _texture(rng, n_tex, 0.9)),
        (2, (0, 1), _texture(rng, n_tex, 1.0)),
        (1, (0, 2), _texture(rng, n_tex, 0.8)),
    ]
    target = np.array([1.5, 1.0, 1.5])
    px, py = np.meshgrid(np.arange(width, dtype=np.float64),
                         np.arange(height, dtype=np.float64))
    d_cam = np.stack([(px - width / 2.0) / focal, -(py - height / 2.0) / focal,
                      np.ones_like(px)], -1).reshape(-1, 3)
    grays, Rs, ts = [], [], []
    for phi in np.linspace(np.radians(15.0), np.radians(75.0), n_views):
        C = target + np.array([5.0 * np.cos(phi), 2.5, 5.0 * np.sin(phi)])
        R = _look_at(C, target)
        d = d_cam @ R                        # world directions, Rᵀ d_cam
        depth = np.full(d.shape[0], np.inf)
        img = np.full(d.shape[0], 0.5)
        for axis, (a, b), tex in planes:
            with np.errstate(divide="ignore", invalid="ignore"):
                lam = -C[axis] / d[:, axis]
            pa = C[a] + lam * d[:, a]
            pb = C[b] + lam * d[:, b]
            hit = ((lam > 0) & (lam < depth) & (pa >= 0) & (pa <= S)
                   & (pb >= 0) & (pb <= S))
            val = map_coordinates(tex, [pb[hit] * texels, pa[hit] * texels],
                                  order=1, mode="nearest")
            img[hit] = val
            depth[hit] = lam[hit]
        grays.append(img.reshape(height, width))
        Rs.append(R)
        ts.append(-R @ C)
    gray = (np.clip(np.stack(grays), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return {"gray": gray, "rgb": np.repeat(gray[..., None], 3, axis=-1),
            "R": np.stack(Rs), "t": np.stack(ts), "focal": float(focal),
            "planes": planes, "texels": texels}


def make_reconstruction_artifacts(root: str, scene: dict, seed: int = SCENE_SEED) -> dict:
    """Write what tpu3d's reconstruct stage leaves for ``densify`` into
    ``root``: ``reconstruction`` (cams = [so3_log(R), t] and 1,000 points
    on each plane) and ``reconstruction_meta`` (registered_names
    img_000.png ..., downscale 1). Returns {"cams", "points"}."""
    from tpu3d_torch.core.lie import so3_log_np
    from tpu3d_torch.io.artifacts import ArtifactStore

    rng = np.random.default_rng(seed)
    pts = []
    for axis, (a, b), _ in scene["planes"]:
        p = np.zeros((1000, 3))
        p[:, a], p[:, b] = rng.uniform(0, PLANE_SIZE, (2, 1000))
        pts.append(p)
    points = np.concatenate(pts).astype(np.float32)
    cams = np.stack([np.concatenate([so3_log_np(R), t])
                     for R, t in zip(scene["R"], scene["t"])]).astype(np.float32)
    store = ArtifactStore(root)
    store.save("reconstruction", cams=cams, points=points,
               registered=np.arange(len(cams), dtype=np.int32))
    store.save_json("reconstruction_meta", {
        "registered_names": [f"img_{i:03d}.png" for i in range(len(cams))], "downscale": 1})
    return {"cams": cams, "points": points}


def make_dense_artifacts(root: str, scene: dict, res: int = DENSE_RES,
                         seed: int = SCENE_SEED) -> dict:
    """Write tpu3d's dense-stage artifacts for ``scene`` into ``root``, as
    densify would leave them for ``densify --eval-only`` and ``render``:

      reconstruction,      as make_reconstruction_artifacts
      reconstruction_meta
      dense_meta           normalization, auto_near_far band, 192 samples,
                           per-ray box clipping, no contraction
      dense_grid           an analytic res^3 x 28 voxelization of the three
                           textured planes: density on the node layers at
                           each plane (+-1), SH DC = texture / 0.282095 on
                           +-2 layers, and bg_sh giving the scene's 0.5 grey

    The grid's box puts each plane on a node layer with ``m`` layers of
    margin; the recorded normalization maps that box to [-1, 1]^3. Returns
    the dense_grid arrays and the meta."""
    from scipy.ndimage import gaussian_filter, map_coordinates

    from tpu3d_torch.dense.train import SceneNormalization, auto_near_far
    from tpu3d_torch.io.artifacts import ArtifactStore

    S = PLANE_SIZE
    m = max(2, res // 32)                       # margin layers around the planes
    vox = S / (res - 1 - 2 * m)
    lo = -m * vox
    norm = SceneNormalization(np.full(3, lo + 0.5 * (res - 1) * vox, np.float32),
                              float(0.5 * (res - 1) * vox))
    inner = slice(m, res - m)                   # nodes over [0, S] in-plane
    w = lo + vox * np.arange(res)[inner]        # their world coordinates
    grid = np.zeros((res, res, res, 28), np.float32)
    for axis, (a, b), tex in scene["planes"]:
        # box-filter the texture to the voxel footprint, then sample it at
        # the nodes; the slab's two free axes are (a, b) in increasing order
        tex_v = gaussian_filter(tex, 0.5 * vox * scene["texels"])
        first, second = sorted((a, b))
        c1, c2 = np.meshgrid(w, w, indexing="ij")
        coord = {first: c1, second: c2}
        dc = map_coordinates(tex_v, [coord[b] * scene["texels"], coord[a] * scene["texels"]],
                             order=1, mode="nearest") / _SH_C0
        for layer in range(m - 2, m + 3):
            idx = [inner, inner, inner]
            idx[axis] = layer
            for ch in (1, 10, 19):              # SH DC of r, g, b
                grid[tuple(idx) + (ch,)] = dc
            if abs(layer - m) <= 1:
                grid[tuple(idx) + (0,)] = DENSE_SIGMA
    rec = make_reconstruction_artifacts(root, scene, seed)
    cams = rec["cams"]
    near, far = auto_near_far(cams, rec["points"], norm)
    bg_sh = np.zeros((3, 9), np.float32)
    bg_sh[:, 0] = 0.5 / _SH_C0
    arrays = dict(grid=grid, min_bound=np.full(3, -1.0, np.float32),
                  max_bound=np.full(3, 1.0, np.float32), bg_sh=bg_sh)
    meta = {"model": "plenoxel", "near": float(near), "far": float(far),
            "num_samples": 192, "per_ray_aabb": True, "downscale": 1,
            "contraction": False, "norm_center": norm.center.astype(np.float64).tolist(),
            "norm_scale": norm.scale, "cascade_detail": None}
    store = ArtifactStore(root)
    store.save_json("dense_meta", meta)
    store.save("dense_grid", **arrays)
    return dict(arrays, meta=meta, cams=cams)


def rotation_errors_deg(registrations, R) -> np.ndarray:
    """Angle between each accepted edge's relative rotation and the
    scene's R_new R_refᵀ, in degrees."""
    errs = []
    for reg in registrations:
        for e in reg.edges:
            gt = R[reg.img] @ R[e.ref_img].T
            c = (np.trace(np.asarray(e.rel_R, np.float64) @ gt.T) - 1.0) / 2.0
            errs.append(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))
    return np.asarray(errs)


# --------------------------------------------------------------------------
# Phases on the card.


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _time_ms(torch, fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def _check_patch_sample(torch, dev) -> dict:
    """patch_sample_kernel against its plain version at the frontend's
    shapes: one 4-image batch's gradient stack (4 images x 4 octaves x 3
    levels) and 4 x 2048 keypoints, at the orientation (121), descriptor
    (256) and detector (27, integer) sample counts."""
    import torch.nn.functional as F

    from tpu3d_torch.kernels import patch_sample as ps

    L, H, W, K = 48, HEIGHT, WIDTH, 4 * 2048
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    gx = torch.randn((L, H, W), generator=g, device=dev)
    gy = torch.randn((L, H, W), generator=g, device=dev)
    lvl = torch.randint(0, L, (K,), generator=g, device=dev, dtype=torch.int32)
    worst, rows = 0.0, []
    for S in (121, 256, 27):
        if S == 27:   # integer 3x3 neighbourhoods, level offsets -1..1
            cy = torch.randint(1, H - 1, (K, 1), generator=g, device=dev).float()
            cx = torch.randint(1, W - 1, (K, 1), generator=g, device=dev).float()
            off = torch.tensor([(dy, dx) for _ in range(3) for dy in (-1, 0, 1)
                                for dx in (-1, 0, 1)], device=dev, dtype=torch.float32)
            ys = (cy + off[None, :, 0]).contiguous()
            xs = (cx + off[None, :, 1]).contiguous()
            dlvl = torch.tensor([ds for ds in (-1, 0, 1) for _ in range(9)],
                                device=dev, dtype=torch.int32)
            lv = lvl.clamp(1, L - 2).contiguous()
            chans = (gx, None)
        else:         # inside the bounds, with a share exactly on the border
            ys = torch.rand((K, S), generator=g, device=dev) * (H - 1.001)
            xs = torch.rand((K, S), generator=g, device=dev) * (W - 1.001)
            ys[:, :8] = 0.0
            xs[:, 8:16] = W - 1.001
            ys[:, 16:24] = H - 1.001
            dlvl, lv, chans = None, lvl, (gx, gy)
        out = ps.sample_gradient_patches(*chans, ys, xs, lv, dlvl)
        ref = ps.sample_gradient_patches_plain(*chans, ys, xs, lv, dlvl)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        worst = max(worst, err)
        if not err <= 1e-5:
            _fail(f"patch_sample_kernel S={S}: max |err| {err:.3g} > 1e-5")
        ms = _time_ms(torch, lambda: ps.sample_gradient_patches(*chans, ys, xs, lv, dlvl), 50)
        plain_ms = _time_ms(torch, lambda: ps.sample_gradient_patches_plain(
            *chans, ys, xs, lv, dlvl), 10)
        # Library yardstick: one 5-D grid_sample (trilinear at an integer
        # level coordinate is the bilinear sample) over the channel stack.
        nch = 1 if chans[1] is None else 2
        vol = torch.stack([c for c in chans if c is not None])[None]   # (1, C, L, H, W)
        lz = lv[:, None].float() + (0.0 if dlvl is None else dlvl[None, :].float())
        grid = torch.stack([xs / (W - 1) * 2 - 1, ys / (H - 1) * 2 - 1,
                            lz.expand(K, S) / (L - 1) * 2 - 1], -1)[None, None]
        lib_ms = _time_ms(torch, lambda: F.grid_sample(
            vol, grid, mode="bilinear", align_corners=True), 10)
        # Bound: coordinates, levels and the output once, plus every texel
        # this run's coordinates touch (the 2x2 cells) once per channel.
        y0 = ys.floor().long().clamp(0, H - 2)
        x0 = xs.floor().long().clamp(0, W - 2)
        lf = (lv[:, None].long() + (0 if dlvl is None else dlvl[None, :].long())).clamp(0, L - 1)
        base = (lf * H + y0) * W + x0
        texels = torch.unique(torch.cat([base, base + 1, base + W, base + W + 1]).reshape(-1)).numel()
        nbytes = 4 * (2 * K * S + K + (0 if dlvl is None else S) + nch * K * S + nch * texels)
        flops = 11 * nch * K * S
        bound_ms = max(nbytes / H100_BYTES_PER_S, flops / H100_FP32_FLOPS) * 1e3
        rows.append(dict(S=S, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms,
                         bound_by="bytes" if nbytes / H100_BYTES_PER_S >= flops / H100_FP32_FLOPS
                         else "operations"))
        print(f"kernel patch_sample_kernel S={S}: max_abs_err={err:.3g} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} grid_sample_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} "
              f"(touched texels {texels})", flush=True)
    # The descriptor pass (S=256) is the main path's largest launch; report it.
    main = next(r for r in rows if r["S"] == 256)
    return dict(name="patch_sample_kernel", route="cuda",
                source="tpu3d_torch/csrc/patch_sample.cu",
                replaces="tpu3d/kernels/patch_sample.py:153",
                max_abs_err=worst, ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"])


def _check_top2(torch, dev) -> dict:
    """top2_kernel against its plain version at one match block: 32 pairs
    of 2048 x 2048 unit descriptors, D = 128, random validity masks."""
    from tpu3d_torch.kernels import distance as dist

    B, K, D = 32, 2048, 128
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    q = torch.nn.functional.normalize(torch.randn((B, K, D), generator=g, device=dev), dim=-1)
    k = torch.nn.functional.normalize(torch.randn((B, K, D), generator=g, device=dev), dim=-1)
    vq = (torch.rand((B, K), generator=g, device=dev) < 0.9).float()
    vk = (torch.rand((B, K), generator=g, device=dev) < 0.9).float()
    best, second, arg = dist.descriptor_top2(q, k, vq, vk)
    pb, ps_, pa = dist.descriptor_top2_plain(q, k, vq, vk)
    torch.cuda.synchronize()
    err = max(float((best - pb).abs().max()), float((second - ps_).abs().max()))
    if not err <= 1e-5:
        _fail(f"top2_kernel: max |err| of best/second {err:.3g} > 1e-5")
    # Rows of a masked query score -2 everywhere: both give column 0.
    clear = ((pb - ps_) > 1e-5) | (vq == 0)
    n_tie = int((~clear).sum())
    n_bad = int(((arg != pa) & clear).sum())
    if n_bad:
        _fail(f"top2_kernel: argmax differs on {n_bad} rows whose top-2 gap is > 1e-5")
    ms = _time_ms(torch, lambda: dist.descriptor_top2(q, k, vq, vk), 20)
    plain_ms = _time_ms(torch, lambda: dist.descriptor_top2_plain(q, k, vq, vk), 5)
    flops = 2.0 * B * K * K * D
    nbytes = 4.0 * (2 * B * K * D + 2 * B * K + 3 * B * K)
    bound_ms = max(flops / H100_FP32_FLOPS, nbytes / H100_BYTES_PER_S) * 1e3
    print(f"kernel top2_kernel B={B} K={K} D={D}: max_abs_err={err:.3g} near_ties={n_tie} "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
          f"({flops / ms / 1e9:.1f} TFLOP/s)", flush=True)
    return dict(name="top2_kernel", route="cuda", source="tpu3d_torch/csrc/top2.cu",
                replaces="tpu3d/kernels/distance.py:68", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by="operations",
                library_ms=None)


def _check_trilinear(torch, dev, scene, dense) -> dict:
    """trilinear_kernel against its plain version at one render launch of
    the dense phase: the 256^3 x 28 grid and the 8,192 x 192 = 1.57 M
    sample points of the first chunk of held-out view 4."""
    import torch.nn.functional as F

    from tpu3d_torch.dense.eval import view_rays
    from tpu3d_torch.dense.render import ray_samples
    from tpu3d_torch.dense.train import SceneNormalization
    from tpu3d_torch.kernels import trilinear as tri

    meta = dense["meta"]
    grid = torch.from_numpy(dense["grid"]).to(dev)
    mn = torch.from_numpy(dense["min_bound"]).to(dev)
    mx = torch.from_numpy(dense["max_bound"]).to(dev)
    norm = SceneNormalization(np.asarray(meta["norm_center"], np.float32), meta["norm_scale"])
    rays = view_rays(dense["cams"][4], HEIGHT, WIDTH, scene["focal"], norm, stride=2)
    ro, rd = (torch.from_numpy(a[:DENSE_CHUNK]).to(dev) for a in rays)
    pts = ray_samples(ro, rd, meta["near"], meta["far"], meta["num_samples"], mn, mx,
                      clip_aabb=True)[0].contiguous()
    out, inb = tri.trilinear_sample(grid, mn, mx, pts)
    ref, ref_inb = tri.trilinear_sample_plain(grid, mn, mx, pts)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    if not torch.equal(inb, ref_inb):
        _fail("trilinear_kernel: in-bounds flags differ from the plain version")
    if not err == 0.0:
        _fail(f"trilinear_kernel: max |err| {err:.3g} != 0 (kernel and plain version "
              "round the same operations in the same order)")
    ms = _time_ms(torch, lambda: tri.trilinear_sample(grid, mn, mx, pts), 50)
    plain_ms = _time_ms(torch, lambda: tri.trilinear_sample_plain(grid, mn, mx, pts), 5)
    # Library yardstick: grid_sample on a channels-first copy made beforehand;
    # its (x, y, z) coordinate order indexes (W, H, D) = (Z, Y, X).
    vol = grid.permute(3, 0, 1, 2).unsqueeze(0).contiguous()
    u = (pts - mn) / (mx - mn) * 2 - 1
    gs_grid = u.flip(-1).reshape(1, 1, 1, -1, 3).contiguous()
    lib_ms = _time_ms(torch, lambda: F.grid_sample(vol, gs_grid, mode="bilinear",
                                                   align_corners=True), 10)
    # (in the box only: grid_sample blends zero padding in beyond it)
    lib_diff = float((F.grid_sample(vol, gs_grid, mode="bilinear", align_corners=True)
                      .reshape(vol.shape[1], -1).T - ref)[inb].abs().max())
    del vol
    # Bound: points in, values and flags out, plus each grid row the
    # in-box samples need (the out-of-box ones need none), once.
    N, C = out.shape
    X, Y, Z = grid.shape[:3]
    i0 = tri._corner_setup((X, Y, Z), mn, mx, pts)[0][inb]
    base = (i0[:, 0] * Y + i0[:, 1]) * Z + i0[:, 2]
    offs = torch.tensor([0, 1, Z, Z + 1, Y * Z, Y * Z + 1, Y * Z + Z, Y * Z + Z + 1], device=dev)
    rows = torch.unique((base[:, None] + offs).reshape(-1)).numel()
    nbytes = 12 * N + 4 * C * N + N + 4 * C * rows + 24
    flops = N * (C * 21 + 18)
    bound_ms = max(nbytes / H100_BYTES_PER_S, flops / H100_FP32_FLOPS) * 1e3
    print(f"kernel trilinear_kernel grid {X}x{Y}x{Z}x{C} N={N} (in box {int(inb.sum())}): "
          f"max_abs_err={err:.3g} ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"grid_sample_ms={lib_ms:.4f} (max diff in the box {lib_diff:.3g}) "
          f"bound_ms={bound_ms:.4f} "
          f"(rows touched {rows}, "
          f"{nbytes / ms / 1e6:.0f} GB/s)", flush=True)
    return dict(name="trilinear_kernel", route="cuda", source="tpu3d_torch/csrc/trilinear.cu",
                replaces="tpu3d/kernels/trilinear.py:82", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if nbytes / H100_BYTES_PER_S >= flops / H100_FP32_FLOPS
                else "operations", library_ms=lib_ms)


def _train_inputs(root: str, scene: dict):
    """(DenseConfig, RayDataset) of the train phase, prepared as densify
    prepares them: coremax normalization, the sparse cloud's band, the
    name-keyed holdout, every TRAIN_RAY_STRIDE-th pixel of the train views."""
    from tpu3d_torch.cli import registered_views
    from tpu3d_torch.config import DenseConfig
    from tpu3d_torch.dense.eval import dataset_from_views, split_views_by_name
    from tpu3d_torch.dense.train import auto_near_far, normalize_scene_coremax
    from tpu3d_torch.io.artifacts import ArtifactStore

    cams, names, _ = registered_views(root)
    points = ArtifactStore(root).load("reconstruction")["points"]
    norm = normalize_scene_coremax(points)
    near, far = auto_near_far(cams, points, norm)
    train_idx, _ = split_views_by_name(names, 8)
    return (DenseConfig(scene_scale=1.0, near=near, far=far),
            dataset_from_views(cams, scene["rgb"], scene["focal"], train_idx, norm,
                               stride=TRAIN_RAY_STRIDE))


def _check_trilinear_grad(torch, dev, cfg, ds) -> dict:
    """trilinear_grad_kernel against its plain version at one training
    step's shape: the 256^3 x 28 grid and the 2,048 x 192 = 393,216 jittered
    sample points of the first batch of training rays, random cotangents."""
    import torch.nn.functional as F

    from tpu3d_torch.dense.render import ray_samples
    from tpu3d_torch.kernels import trilinear as tri
    from tpu3d_torch.kernels import trilinear_grad as tg

    R, B, S, C = cfg.grid_resolution, cfg.batch_size, cfg.num_samples, 28
    res = (R, R, R)
    mn = torch.full((3,), -cfg.scene_scale, device=dev)
    mx = torch.full((3,), cfg.scene_scale, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    ro, rd = (torch.from_numpy(a[:B]).to(dev) for a in (ds.origins, ds.dirs))
    pts = ray_samples(ro, rd, cfg.near, cfg.far, S, mn, mx, clip_aabb=True, perturb=True,
                      generator=g)[0].contiguous()
    ct = torch.randn((B * S, C), generator=g, device=dev)
    out = tg.trilinear_scatter_grad(ct, mn, mx, res, pts)
    ref = tg.trilinear_scatter_grad_plain(ct, mn, mx, res, pts)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    if not err <= 1e-5 * scale:
        _fail(f"trilinear_grad_kernel: max |err| {err:.3g} > 1e-5 x max|plain| {scale:.3g}")
    del out
    ms = _time_ms(torch, lambda: tg.trilinear_scatter_grad(ct, mn, mx, res, pts), 20)
    buf = torch.zeros((R, R, R, C), device=dev)
    scatter_ms = _time_ms(torch, lambda: tg.launch_scatter(ct, mn, mx, pts, buf), 20)
    fill_ms = _time_ms(torch, lambda: buf.zero_(), 20)
    del buf
    plain_ms = _time_ms(torch, lambda: tg.trilinear_scatter_grad_plain(ct, mn, mx, res, pts), 3)
    # Library yardstick: the backward of one grid_sample (channels-first copy,
    # align_corners) with respect to the grid alone; its (x, y, z) order
    # indexes (W, H, D) = (Z, Y, X). Inside the box it computes this gradient.
    vol = torch.zeros((1, C, R, R, R), device=dev, requires_grad=True)
    u = (pts - mn) / (mx - mn) * 2 - 1
    gs = F.grid_sample(vol, u.flip(-1).reshape(1, 1, 1, -1, 3), mode="bilinear",
                       align_corners=True)
    go = ct.T.reshape(1, C, 1, 1, -1).contiguous()
    lib_ms = _time_ms(torch, lambda: torch.autograd.grad(gs, vol, go, retain_graph=True), 10)
    lib = torch.autograd.grad(gs, vol, go)[0][0].permute(1, 2, 3, 0)
    lib_diff = float((lib - ref).abs().max())
    del vol, gs, go, lib, ref
    # Bounds, by bytes: the full call writes the whole gradient once (the
    # fill) and reads the cotangents and the points; the scatter alone reads
    # those and writes each row the in-box samples touch, once.
    N = B * S
    i0, _, inb = tri._corner_setup(res, mn, mx, pts)
    i0 = i0[inb]
    base = (i0[:, 0] * R + i0[:, 1]) * R + i0[:, 2]
    offs = torch.tensor([0, 1, R, R + 1, R * R, R * R + 1, R * R + R, R * R + R + 1], device=dev)
    rows = torch.unique((base[:, None] + offs).reshape(-1)).numel()
    in_bytes = 4 * C * N + 12 * N + 24
    bound_ms = (4 * C * R ** 3 + in_bytes) / H100_BYTES_PER_S * 1e3
    scatter_bound_ms = (in_bytes + 4 * C * rows) / H100_BYTES_PER_S * 1e3
    print(f"kernel trilinear_grad_kernel grid {R}^3x{C} N={N} (in box {int(inb.sum())}): "
          f"max_abs_err={err:.3g} (max|plain| {scale:.3g}, ratio {err / scale:.3g}) "
          f"ms={ms:.4f} with the zero fill (fill alone {fill_ms:.4f}) scatter_ms={scatter_ms:.4f} "
          f"plain_ms={plain_ms:.4f} grid_sample_backward_ms={lib_ms:.4f} (max diff "
          f"{lib_diff:.3g}) bound_ms={bound_ms:.4f} scatter_bound_ms={scatter_bound_ms:.4f} "
          f"(rows touched {rows})", flush=True)
    return dict(name="trilinear_grad_kernel", route="cuda",
                source="tpu3d_torch/csrc/trilinear_grad.cu",
                replaces="tpu3d/kernels/trilinear_grad.py:157", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes", library_ms=lib_ms)


def _orient_desc_inputs(torch, dev, scene, cfg):
    """The arguments the extract stage hands orient_and_describe for the
    first batch of make_scene's views (4 x 2048 = 8,192 keypoints, the
    unified gradient stack of 4 images x 4 octaves x 3 levels): captured
    from one extract_features call, in orient_desc_samples' order."""
    from tpu3d_torch.features import frontend

    seen = {}
    real = frontend.orient_and_describe

    def capture(*args, **kw):
        seen["args"] = args
        return real(*args, **kw)

    frontend.orient_and_describe = capture
    try:
        frontend.extract_features(torch.from_numpy(scene["gray"][: cfg.frontend.batch_size]),
                                  cfg.frontend, device=dev)
    finally:
        frontend.orient_and_describe = real
    gx, gy, kx, ky, lvl, sigma, ymax, xmax = seen["args"]
    return (gx, gy, ky.contiguous(), kx.contiguous(), lvl.contiguous(), sigma.contiguous(),
            ymax.contiguous(), xmax.contiguous())


def _check_orient_desc(torch, dev, scene, cfg) -> dict:
    """orient_desc_kernel against its plain version at the main path's
    shape: one extract batch (K = 8,192) with the real gradient stack."""
    from tpu3d_torch.kernels import orient_desc as od

    args = _orient_desc_inputs(torch, dev, scene, cfg)
    gx, gy, ky, kx, lvl, sigma, ymax, xmax = args
    gxs, gys, th = od.orient_desc_samples(*args)
    torch.cuda.synchronize()
    rgx, rgy, rth = od.orient_desc_samples_plain(*args)
    dth = (torch.remainder(th - rth + np.pi, 2 * np.pi) - np.pi).abs()
    ties = od.near_ties(*args)
    agree = dth <= ORIENT_THETA_TOL
    scale = max(gx.abs().max().item(), gy.abs().max().item())
    err = torch.maximum((gxs - rgx).abs(), (gys - rgy).abs())
    over = (err > od.sample_tolerance(gx, gy, sigma, dth, ORIENT_SAMPLE_TOL)) & agree[:, None]
    K = ky.shape[0]
    n_ties, n_flip = int(ties.sum()), int((~agree).sum())
    max_err = float(err[agree].max()) if bool(agree.any()) else 0.0
    theta_err = float(dth[agree].max()) if bool(agree.any()) else 0.0
    if bool((~agree & ~ties).any()):
        _fail(f"orient_desc_kernel: theta differs by > {ORIENT_THETA_TOL} rad on "
              f"{int((~agree & ~ties).sum())} keypoints that are not near ties")
    if not n_ties < 0.05 * K:
        _fail(f"orient_desc_kernel: {n_ties} near-tie keypoints of {K} (>= 5%)")
    if bool(over.any()):
        bad = over.any(1)
        _fail(f"orient_desc_kernel: samples beyond the tolerance on {int(bad.sum())} keypoints "
              f"(max |err| {max_err:.3g}, max|g| {scale:.3g}; their dtheta "
              f"{dth[bad].tolist()[:8]}, sigma {sigma[bad].tolist()[:8]}, err "
              f"{err[bad].max(1).values.tolist()[:8]})")
    ms = _time_ms(torch, lambda: od.orient_desc_samples(*args), 50)
    plain_ms = _time_ms(torch, lambda: od.orient_desc_samples_plain(*args), 3)
    # Bound, by bytes: the keypoint parameters and the outputs once, and
    # every texel of both planes that this run's 121 + 256 samples per
    # keypoint touch (their 2x2 cells), once.
    L, H, W = gx.shape
    ys, xs = (torch.cat(c, 1) for c in zip(od.orientation_coords(ky, kx, sigma, ymax, xmax),
                                           od.descriptor_coords(ky, kx, sigma, rth, ymax, xmax)))
    y0 = ys.floor().long().clamp(0, H - 2)
    x0 = xs.floor().long().clamp(0, W - 2)
    base = (lvl.long()[:, None].clamp(0, L - 1) * H + y0) * W + x0
    texels = torch.unique(torch.cat([base, base + 1, base + W, base + W + 1]).reshape(-1)).numel()
    nbytes = 2 * 4 * texels + K * (6 * 4 + (2 * 256 + 1) * 4) + 3 * 121 * 4
    per_sample_bytes = K * (377 * 4 * 2 * 4 + (2 * 256 + 1) * 4)
    # operations: 377 bilinear samples of 2 planes (11 each), 121 angle /
    # magnitude / bin evaluations (~35), 36 bins x 121 votes x 2, the
    # circulant (9 per bin), 256 rotated offsets (8 each)
    flops = K * (377 * 2 * 11 + 121 * 35 + 36 * 121 * 2 + 36 * 9 + 256 * 8)
    bound_ms = max(nbytes / H100_BYTES_PER_S, flops / H100_FP32_FLOPS) * 1e3
    print(f"kernel orient_desc_kernel K={K} stack {L}x{H}x{W}: max_abs_err={max_err:.3g} "
          f"(max|g| {scale:.3g}) theta_err={theta_err:.3g} rad; near ties {n_ties}, other peak "
          f"picked {n_flip}; ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
          f"(touched texels {texels}; every corner of every sample once "
          f"{per_sample_bytes / H100_BYTES_PER_S * 1e3:.4f} ms; "
          f"{nbytes / ms / 1e6:.0f} GB/s)", flush=True)
    return dict(name="orient_desc_kernel", route="cuda", source="tpu3d_torch/csrc/orient_desc.cu",
                replaces="tpu3d/kernels/orient_desc.py:214", max_abs_err=max_err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if nbytes / H100_BYTES_PER_S >= flops / H100_FP32_FLOPS
                else "operations", library_ms=None)


def _align(cams, R_gt, t_gt):
    """Camera-centre errors (relative to the spread of the scene's centres)
    and rotation errors (deg) of [rvec|t] cameras after the similarity that
    best maps their centres onto the scene's."""
    from tpu3d_torch.core.lie import so3_exp_np

    R = np.stack([so3_exp_np(c[:3]).astype(np.float64) for c in cams])
    C = np.einsum("nji,nj->ni", R, -np.asarray(cams, np.float64)[:, 3:6])
    G = np.einsum("nji,nj->ni", R_gt, -t_gt)
    ma, mb = C.mean(0), G.mean(0)
    A, B = C - ma, G - mb
    U, S, Vt = np.linalg.svd(B.T @ A)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    Rs = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / (A ** 2).sum()
    cen = np.linalg.norm(s * A @ Rs.T + mb - G, axis=1) / np.linalg.norm(B, axis=1).max()
    cos = (np.einsum("nij,nij->n", R @ Rs.T, R_gt) - 1.0) / 2.0
    return cen, np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))


def _full_config(scene):
    from tpu3d_torch.config import CameraConfig, PipelineConfig

    cfg = PipelineConfig()
    cam = CameraConfig(focal_length=scene["focal"])
    return dataclasses.replace(cfg, camera=cam, sfm=dataclasses.replace(cfg.sfm, camera=cam))


def _run_full(torch, dev, scene) -> dict:
    """reconstruct on the card twice (split descriptor, then fused), each
    with the launch counts set to 0 just before it and read just after.
    Returns the fused run's launches."""
    from tpu3d_torch.kernels import LAUNCHES, reset_launches
    from tpu3d_torch.sfm import pipeline as P

    base = _full_config(scene)
    runs = {}
    for name, fused in (("split", None), ("fused", True)):
        cfg = dataclasses.replace(base, frontend=dataclasses.replace(base.frontend,
                                                                   fused_descriptor=fused))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.time()
        rec, secs = P.reconstruct((scene["gray"], scene["rgb"]), cfg, verbose=False, device=dev)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        timers = dict(P.LAST_SFM_TIMERS)
        reg = rec.registered
        cen, rot = _align(rec.cams, scene["R"][reg], scene["t"][reg])
        runs[name] = dict(registered=len(reg), reproj=rec.mean_reproj_px, launches=launches)
        print(f"full ({name} descriptor): {wall:.3f} s; stage s "
              f"{ {k: round(v, 3) for k, v in secs.items()} }; engine s {timers}; registered "
              f"{len(reg)}/{N_VIEWS} (tpu3d on the CPU {TPU3D_CPU_REGISTERED}), points "
              f"{len(rec.points)}, observations {rec.num_obs}, mean reprojection "
              f"{rec.mean_reproj_px:.4f} px; camera centre error / spread median "
              f"{np.median(cen):.3g} max {cen.max():.3g}; rotation error median "
              f"{np.median(rot):.4f} max {rot.max():.4f} deg; peak memory "
              f"{peak / 2**30:.2f} GiB; launches {launches}", flush=True)
        if not np.isfinite(rec.mean_reproj_px) or not np.all(np.isfinite(rec.points)):
            _fail(f"full ({name}): reprojection error or points not finite")
        if len(reg) < TPU3D_CPU_REGISTERED - 1:
            _fail(f"full ({name}): {len(reg)} cameras registered < {TPU3D_CPU_REGISTERED} - 1 "
                  "(tpu3d on the CPU)")
    if not runs["split"]["reproj"] <= MAX_FULL_REPROJ_PX:
        _fail(f"full (split): mean reprojection {runs['split']['reproj']:.4f} px > "
              f"{MAX_FULL_REPROJ_PX} (tpu3d's worst over three seeds + twice their spread)")
    fused = runs["fused"]["launches"]
    if fused["orient_desc_kernel"] <= 0:
        _fail("full (fused): orient_desc_kernel was not launched")
    if not fused["patch_sample_kernel"] < runs["split"]["launches"]["patch_sample_kernel"]:
        _fail("full (fused): patch_sample_kernel launches not fewer than the split run's "
              f"({fused['patch_sample_kernel']} vs "
              f"{runs['split']['launches']['patch_sample_kernel']})")
    return fused


def _profile_reconstruct(torch, dev, scene) -> None:
    """The split run's stages once more; its reconstruct stage under
    torch.profiler: wall, device busy share, the engine's host share and
    the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu3d_torch.sfm import pipeline as P

    cfg = _full_config(scene)
    feats = P.run_extraction((scene["gray"], scene["rgb"]), cfg, verbose=False, device=dev)
    adj = P.run_retrieval(feats, cfg, device=dev)
    regs, ts = P.run_matching(feats, adj, cfg, verbose=False, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        P.run_reconstruction(feats, regs, ts, cfg, verbose=False, adj=adj, device=dev)
        torch.cuda.synchronize()
        wall = time.time() - t0
    timers = dict(P.LAST_SFM_TIMERS)
    per_kernel = _device_ms(prof)
    busy = sum(per_kernel.values())
    n_kernels = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False))
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    print(f"profile reconstruct: wall {wall:.3f} s (profiled), device busy {busy:.1f} ms "
          f"({busy / (wall * 1e3):.1%}), {n_kernels} device events; engine host "
          f"{timers['host']} s ({timers['host'] / wall:.1%} of the wall), timers {timers}; "
          "top kernels: "
          + "; ".join(f"{k[:60]} {v:.2f} ms" for k, v in top), flush=True)


def _run_dense(torch, dev, scene, root) -> dict:
    """densify_eval_only on the card over the artifacts in ``root``, with the
    launch counts set to 0 just before it and read just after; then each
    held-out view rendered once more for its time, and one view under
    torch.profiler for the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    from tpu3d_torch.cli import densify_eval_only
    from tpu3d_torch.config import DenseConfig
    from tpu3d_torch.dense.eval import render_view
    from tpu3d_torch.dense.grid import grid_from_tpu3d
    from tpu3d_torch.dense.train import SceneNormalization
    from tpu3d_torch.io.artifacts import ArtifactStore
    from tpu3d_torch.kernels import LAUNCHES, reset_launches

    names = [f"img_{i:03d}.png" for i in range(N_VIEWS)]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    out = densify_eval_only(root, scene["rgb"], names, scene["focal"], device=dev)
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    store = ArtifactStore(root)
    dm = store.load_json("dense_meta")
    grid, bg_sh = grid_from_tpu3d(store.load("dense_grid"), dev)
    norm = SceneNormalization(np.asarray(dm["norm_center"], np.float32), dm["norm_scale"])
    cfg = DenseConfig(near=dm["near"], far=dm["far"], num_samples=dm["num_samples"],
                      per_ray_aabb=dm["per_ray_aabb"])
    cams = store.load("reconstruction")["cams"]
    views = [names.index(n) for n in out["test_view_names"]]
    view_secs = []
    for v in views:
        t1 = time.time()
        render_view(grid, cams[v], HEIGHT, WIDTH, scene["focal"], cfg, norm,
                    stride=2, chunk=DENSE_CHUNK, bg_sh=bg_sh)
        view_secs.append(time.time() - t1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.time()
        render_view(grid, cams[views[0]], HEIGHT, WIDTH, scene["focal"], cfg, norm,
                    stride=2, chunk=DENSE_CHUNK, bg_sh=bg_sh)
        prof_wall = time.time() - t1
    per_kernel = _device_ms(prof)
    busy = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    mean = float(out["test_psnr"])
    n_rays = len(range(0, HEIGHT, 2)) * len(range(0, WIDTH, 2))
    print(f"dense: densify_eval_only {secs:.3f} s (grid load included); views "
          f"{out['test_view_names']} PSNR {[float(p) for p in out['test_psnr_per_view']]} "
          f"mean {mean:.4f} dB "
          f"(tpu3d on the CPU {TPU3D_CPU_DENSE_PSNR}); calibrated "
          f"{out['test_psnr_calibrated']:.4f}; per-view render s "
          f"{[round(s, 4) for s in view_secs]}; {n_rays} rays x {dm['num_samples']} samples "
          f"per view; peak memory {peak / 2**30:.2f} GiB; launches {launches}", flush=True)
    if busy == 0.0:
        print(f"profile dense view: wall {prof_wall:.3f} s; device time not measured "
              "(the profiler recorded no CUDA activity)", flush=True)
    else:
        print(f"profile dense view: wall {prof_wall * 1e3:.1f} ms (profiled), device busy "
              f"{busy:.1f} ms ({busy / (prof_wall * 1e3):.1%}); top kernels: "
              + "; ".join(f"{k[:70]} {v:.2f} ms" for k, v in top), flush=True)
    want = len(views) * -(-n_rays // DENSE_CHUNK)
    if launches["trilinear_kernel"] != want:
        _fail(f"trilinear_kernel launched {launches['trilinear_kernel']} times on the dense "
              f"path, expected {want}")
    if not all(np.isfinite(out["test_psnr_per_view"])):
        _fail(f"dense PSNRs not finite: {out['test_psnr_per_view']}")
    if not abs(mean - TPU3D_CPU_DENSE_PSNR) <= MAX_DENSE_PSNR_DIFF_DB:
        _fail(f"dense mean PSNR {mean:.4f} dB is not within {MAX_DENSE_PSNR_DIFF_DB} dB of "
              f"tpu3d's {TPU3D_CPU_DENSE_PSNR}")
    return launches


def _device_ms(prof) -> dict:
    """Device time (ms) by kernel name from a torch.profiler run (kernels
    and copies; not the ranges that annotate them, such as an optimizer's
    step)."""
    from torch.autograd import DeviceType

    per_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return per_kernel


def _run_train(torch, dev, scene, root) -> dict:
    """densify (training) on the card over the artifacts in ``root``, with
    the launch counts set to 0 just before it and read just after."""
    from tpu3d_torch.cli import densify
    from tpu3d_torch.dense.train import LAST_TRAIN_AUX
    from tpu3d_torch.kernels import LAUNCHES, reset_launches

    names = [f"img_{i:03d}.png" for i in range(N_VIEWS)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    out = densify(root, scene["rgb"], names, scene["focal"], ray_stride=TRAIN_RAY_STRIDE,
                  no_checkpoint=True, final_grid=True, log_every=TRAIN_LOG_EVERY, device=dev)
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log, steps = LAST_TRAIN_AUX["log"], LAST_TRAIN_AUX["steps"]
    at10 = next(e for e in log if e["step"] == TRAIN_LOG_EVERY)
    rays_s = (log[-1]["step"] - at10["step"]) * 2048 / (log[-1]["seconds"] - at10["seconds"])
    first, last = log[0]["loss"], log[-1]["loss"]
    mean = float(out["test_psnr"])
    n_rays = len(range(0, HEIGHT, 2)) * len(range(0, WIDTH, 2))
    eval_launches = len(out["test_view_names"]) * -(-n_rays // DENSE_CHUNK)
    print(f"train: densify {secs:.3f} s (training, grid save and eval); {steps} steps, "
          f"training {log[-1]['seconds']:.3f} s to the last logged step; {rays_s:.0f} rays/s "
          f"over steps {at10['step']}-{log[-1]['step']}; loss {first:.5f} (step 0) -> "
          f"{last:.5f} (step {log[-1]['step']}); views {out['test_view_names']} PSNR "
          f"{out['test_psnr_per_view']} mean {mean:.4f} dB (tpu3d on the CPU "
          f"{TPU3D_CPU_TRAIN_PSNR}); peak memory {peak / 2**30:.2f} GiB; launches {launches}",
          flush=True)
    if launches["trilinear_grad_kernel"] != steps:
        _fail(f"trilinear_grad_kernel launched {launches['trilinear_grad_kernel']} times in "
              f"{steps} training steps")
    if launches["trilinear_kernel"] != steps + eval_launches:
        _fail(f"trilinear_kernel launched {launches['trilinear_kernel']} times, expected "
              f"{steps} steps + {eval_launches} eval chunks")
    if not all(np.isfinite([first, last, *out["test_psnr_per_view"]])):
        _fail(f"train loss or PSNR not finite: {first}, {last}, {out['test_psnr_per_view']}")
    if not last < first:
        _fail(f"the last logged loss {last} is not below the first {first}")
    if not abs(mean - TPU3D_CPU_TRAIN_PSNR) <= MAX_TRAIN_PSNR_DIFF_DB:
        _fail(f"train mean PSNR {mean:.4f} dB is not within {MAX_TRAIN_PSNR_DIFF_DB} dB of "
              f"tpu3d's {TPU3D_CPU_TRAIN_PSNR}")
    return launches


def _profile_train_step(torch, dev, cfg, ds) -> None:
    """Training steps at the train phase's shapes on a fresh 256^3 state:
    10 timed with CUDA events after 3 warm-ups, then one under
    torch.profiler, its device time split by kernel family."""
    from torch.profiler import ProfilerActivity, profile

    from tpu3d_torch import f32_scope
    from tpu3d_torch.dense.grid import create_grid
    from tpu3d_torch.dense.train import init_state, train_step

    s = cfg.scene_scale
    B = cfg.batch_size
    spe = len(ds.origins) // B
    state = init_state(cfg, create_grid(cfg.grid_resolution, (-s,) * 3, (s,) * 3, device=dev),
                       spe)
    o, d, c = (torch.from_numpy(a).to(dev) for a in (ds.origins, ds.dirs, ds.rgb))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def step(i):
        sl = slice(i % spe * B, (i % spe + 1) * B)
        return train_step(state, cfg, o[sl], d[sl], c[sl], generator=gen)

    with f32_scope():
        for i in range(3):
            step(i)
        step_ms = _time_ms(torch, lambda: step(3), 10)
        torch.cuda.synchronize()
        t1 = time.time()
        step(1)
        host_ms = (time.time() - t1) * 1e3     # enqueue only: no sync inside a step
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.time()
            step(0)
            torch.cuda.synchronize()
            wall = time.time() - t1
    per_kernel = _device_ms(prof)
    busy = sum(per_kernel.values())
    if busy == 0.0:
        print(f"profile train step: {step_ms:.3f} ms per step (CUDA events), host enqueue "
              f"{host_ms:.3f} ms; wall {wall:.3f} s; device time not measured (the profiler "
              "recorded no CUDA activity)", flush=True)
        return
    groups = {"trilinear_kernel": 0.0, "trilinear_grad_kernel": 0.0, "fill": 0.0,
              "adam": 0.0, "other": 0.0}
    for name, ms in per_kernel.items():
        low = name.lower()
        key = ("trilinear_grad_kernel" if "trilinear_grad_kernel" in name
               else "trilinear_kernel" if "trilinear_kernel" in name
               else "adam" if "adam" in low
               else "fill" if "fill" in low or "memset" in low else "other")
        groups[key] += ms
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    print(f"profile train step: {step_ms:.3f} ms per step (CUDA events, 10 steps), host "
          f"enqueue {host_ms:.3f} ms per step; one step profiled: wall {wall * 1e3:.1f} ms, device busy {busy:.2f} ms "
          f"({busy / (wall * 1e3):.1%}); device ms: forward trilinear_kernel "
          f"{groups['trilinear_kernel']:.3f}, scatter trilinear_grad_kernel "
          f"{groups['trilinear_grad_kernel']:.3f} + fills {groups['fill']:.3f}, Adam "
          f"{groups['adam']:.3f}, elementwise and other {groups['other']:.3f}; top kernels: "
          + "; ".join(f"{k[:70]} {v:.3f} ms" for k, v in top), flush=True)


def _run_stages(torch, scene, cfg, dev, around=None):
    """extract -> retrieve -> match on the card, each stage timed on the
    host clock up to a synchronize; ``around(stage)`` is a context manager
    put around each stage."""
    from tpu3d_torch.sfm.pipeline import run_extraction, run_matching, run_retrieval

    around = around or (lambda name: contextlib.nullcontext())
    secs, timers = {}, {}

    def stage(name, fn):
        with around(name):
            t0 = time.time()
            out = fn()
            torch.cuda.synchronize()
            secs[name] = time.time() - t0
        return out

    feats = stage("extract", lambda: run_extraction(
        (scene["gray"], scene["rgb"]), cfg, verbose=False, device=dev))
    adj = stage("retrieve", lambda: run_retrieval(feats, cfg, device=dev))
    regs, ts = stage("match", lambda: run_matching(
        feats, adj, cfg, verbose=False, device=dev, timers=timers))
    return feats, regs, ts, secs, timers


def _run_slice(torch, dev, scene, cfg) -> dict:
    """The port's main path on the 24-view scene, with the launch counts
    set to 0 just before it and read just after."""
    from tpu3d_torch.kernels import LAUNCHES, reset_launches

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launches()
    feats, regs, ts, secs, timers = _run_stages(torch, scene, cfg, dev)
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    for name in ("descriptors_dev", "valid_dev", "keypoints_dev"):
        if getattr(feats, name).device.type != "cuda":
            _fail(f"feature tensor {name} is on {getattr(feats, name).device}")
    for name in SLICE_KERNELS:
        if launches[name] <= 0:
            _fail(f"{name} was not launched on the main path")
    errs = rotation_errors_deg(regs, scene["R"])
    n_edges = sum(len(r.edges) for r in regs)
    kpts = feats.valid.sum(axis=1)
    print(f"slice: extract {secs['extract']:.3f} s, retrieve {secs['retrieve']:.3f} s, "
          f"match {secs['match']:.3f} s (gate blocks {timers['gate_blocks']:.3f} s); "
          f"keypoints/image min {kpts.min()} median {int(np.median(kpts))}; "
          f"edges gated {timers['n_edges']}; images accepted {len(regs)}/{N_VIEWS}; "
          f"edges {n_edges}; tracks {ts.next_track}; "
          f"rot err median {np.median(errs):.4f} max {errs.max():.4f} deg; "
          f"peak memory {peak / 2**30:.2f} GiB; launches {launches}", flush=True)
    if not np.median(errs) <= MAX_MEDIAN_ROT_ERR_DEG:
        _fail(f"median relative-rotation error {np.median(errs):.3f} deg > "
              f"{MAX_MEDIAN_ROT_ERR_DEG}")
    if len(regs) < TPU3D_CPU_ACCEPTED - 1:
        _fail(f"{len(regs)} images accepted < {TPU3D_CPU_ACCEPTED} - 1 (tpu3d on the CPU)")
    return launches


# Batched small-matrix solvers of the gate (cuSOLVER on the card).
_LINALG_OPS = ("aten::_linalg_eigh", "aten::_linalg_svd", "aten::linalg_cholesky_ex",
               "aten::cholesky_solve", "aten::_linalg_det", "aten::_linalg_check_errors")


def _profile_slice(torch, dev, scene, cfg) -> None:
    """The slice once more, each stage under torch.profiler: the device's
    busy time (the sum of kernel and copy times) against the stage's wall
    time, the kernels that take the most of it, and the batched linalg
    operators' device and host time."""
    from torch.profiler import ProfilerActivity, profile

    profs = {}

    @contextlib.contextmanager
    def around(name):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            yield
        profs[name] = prof

    secs = _run_stages(torch, scene, cfg, dev, around)[3]
    for name, prof in profs.items():
        per_kernel = _device_ms(prof)
        busy_ms = sum(per_kernel.values())
        if busy_ms == 0.0:
            print(f"profile {name}: wall {secs[name]:.3f} s; device time not measured "
                  "(the profiler recorded no CUDA activity)", flush=True)
            continue
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
        linalg = {a.key.split("::")[-1]: (getattr(a, "device_time_total", 0.0) / 1e3,
                                          a.cpu_time_total / 1e3)
                  for a in prof.key_averages() if a.key in _LINALG_OPS}
        print(f"profile {name}: wall {secs[name] * 1e3:.1f} ms (profiled), device busy "
              f"{busy_ms:.1f} ms ({busy_ms / (secs[name] * 1e3):.1%}); top kernels: "
              + "; ".join(f"{k[:70]} {v:.2f} ms" for k, v in top)
              + "; linalg (device ms, host ms): "
              + (", ".join(f"{k} {d:.2f}/{h:.2f}" for k, (d, h) in linalg.items()) or "none"),
              flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from tpu3d_torch import f32_scope
    from tpu3d_torch.config import CameraConfig, PipelineConfig
    from tpu3d_torch.kernels import _build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} count={torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda}", flush=True)

    t0 = time.time()
    _build.build(force=True)
    ptxas = [ln.strip() for ln in _build.BUILD_LOG["ptxas"].splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    print(f"build: {time.time() - t0:.1f} s; " + " | ".join(ptxas), flush=True)
    _build.library()

    t0 = time.time()
    scene = make_scene()
    print(f"scene: {N_VIEWS} views {WIDTH}x{HEIGHT} focal {scene['focal']:.1f} "
          f"rendered in {time.time() - t0:.1f} s", flush=True)
    dense_root = Path(__file__).resolve().parent / "build" / "chip_smoke_dense"
    train_root = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
    t0 = time.time()
    dense = make_dense_artifacts(str(dense_root), scene)
    shutil.rmtree(train_root, ignore_errors=True)
    make_reconstruction_artifacts(str(train_root), scene)
    train_cfg, train_ds = _train_inputs(str(train_root), scene)
    print(f"dense artifacts: {DENSE_RES}^3 x 28 analytic grid, band near "
          f"{dense['meta']['near']:.4f} far {dense['meta']['far']:.4f}; train inputs: "
          f"{len(train_ds.origins)} rays, band near {train_cfg.near:.4f} far "
          f"{train_cfg.far:.4f}; written in {time.time() - t0:.1f} s", flush=True)

    try:
        with f32_scope():
            print(f"tf32: cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
                  f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
            kernels = [_check_patch_sample(torch, dev), _check_top2(torch, dev),
                       _check_trilinear(torch, dev, scene, dense),
                       _check_trilinear_grad(torch, dev, train_cfg, train_ds),
                       _check_orient_desc(torch, dev, scene, _full_config(scene))]
        del dense
        torch.cuda.empty_cache()

        cfg = dataclasses.replace(PipelineConfig(),
                                  camera=CameraConfig(focal_length=scene["focal"]))
        launches = _run_slice(torch, dev, scene, cfg)
        _profile_slice(torch, dev, scene, cfg)
        _run_dense(torch, dev, scene, str(dense_root))
        # The forward and the scatter rows report the train phase, this
        # slice's path (the dense phase's count is on its own line).
        train = _run_train(torch, dev, scene, str(train_root))
        launches.update(trilinear_kernel=train["trilinear_kernel"],
                        trilinear_grad_kernel=train["trilinear_grad_kernel"])
        _profile_train_step(torch, dev, train_cfg, train_ds)
        # The orient_desc row reports the fused full run (the only path
        # that launches it).
        launches["orient_desc_kernel"] = _run_full(torch, dev, scene)["orient_desc_kernel"]
        _profile_reconstruct(torch, dev, scene)
    finally:
        shutil.rmtree(dense_root, ignore_errors=True)
        shutil.rmtree(train_root, ignore_errors=True)
    for row in kernels:
        row["launches"] = launches[row["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in kernels]}))
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
