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

The line before the last is the kernel table as JSON; the last line is the
device JSON. ``make_scene`` and ``rotation_errors_deg`` are shared with the
CPU tests (tests/test_torch_slice.py).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time

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
    "R": (N, 3, 3), "t": (N, 3) world->camera, "focal": float}, in the
    pipeline's camera model: a pixel (x, y) is the centered point
    (x - W/2, -(y - H/2)) = focal * Xc[:2] / Xc[2]."""
    from scipy.ndimage import map_coordinates

    rng = np.random.default_rng(seed)
    S = 12.0
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
            "R": np.stack(Rs), "t": np.stack(ts), "focal": float(focal)}


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
    for name, n in launches.items():
        if n <= 0:
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    profs = {}

    @contextlib.contextmanager
    def around(name):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            yield
        profs[name] = prof

    secs = _run_stages(torch, scene, cfg, dev, around)[3]
    for name, prof in profs.items():
        per_kernel = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
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

    with f32_scope():
        print(f"tf32: cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
              f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
        kernels = [_check_patch_sample(torch, dev), _check_top2(torch, dev)]

    t0 = time.time()
    scene = make_scene()
    print(f"scene: {N_VIEWS} views {WIDTH}x{HEIGHT} focal {scene['focal']:.1f} "
          f"rendered in {time.time() - t0:.1f} s", flush=True)
    cfg = dataclasses.replace(PipelineConfig(), camera=CameraConfig(focal_length=scene["focal"]))
    launches = _run_slice(torch, dev, scene, cfg)
    _profile_slice(torch, dev, scene, cfg)
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
