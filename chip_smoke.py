#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (tpu3d_torch) on one NVIDIA GPU.

    python3 chip_smoke.py             # every phase
    python3 chip_smoke.py --kernels   # phases 1-3 only
    python3 chip_smoke.py --dense     # phases 1-2 and 5-8 only
    python3 chip_smoke.py --full      # phases 1-2 and 9 only
    python3 chip_smoke.py --sfm       # phases 1-2 and 10 only
    python3 chip_smoke.py --sdf       # phases 1-2 and 11 only
    python3 chip_smoke.py --learned   # phases 1-2 and 12 only
    python3 chip_smoke.py --dist      # phases 1-2 and 13 only
    python3 chip_smoke.py --dvgo      # phases 1-2 and 14 only

Phases, one line each, any failure exits non-zero:

  1. device  — the card's name and count, and nvidia-smi's name and power
               limit; no card exits 1.
  2. build   — nvcc builds every kernel from tpu3d_torch/csrc into
               build/tpu3d_torch, with ptxas' register/shared/spill lines;
               g++ builds the native track store (tpu3d_torch/native) there,
               and it must load.
  3. kernels — each kernel against its plain PyTorch version on the card at
               the shapes and inputs of the main path (patch_sample at the
               detector's and the descriptor's calls on one real extract
               batch, trilinear at the render, the train and the recipe's
               hierarchical fine shape, and once on a 432^3 x 28 grid, past
               2^31 values, where the kernel takes int64 offsets; the
               scatter at one training step's shape and on 1,500 points in
               one cell, bit for bit against its plain version on a CPU copy
               of the inputs, two launches bit for bit, and the call's
               pieces alone: keys, sort, offsets, kernel; shade_composite at
               a render chunk, one grid and a cascade, against the eager
               path it replaces, timed beside it; view_rays at a render
               cell's view, 1936 x 1296 at stride 2, against numpy
               view_rays and the upload it replaces, timed beside it): max
               error, bound ms, and for the kernel, its plain version and
               one library call three numbers each (``_times``): device ms
               per launch (torch.profiler), wall ms per back-to-back launch
               (CUDA events) and host µs per call (the enqueue).
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
               seconds (each view's rays built on the card: one
               view_rays_kernel launch a view, none in densify_eval_only,
               whose views take host rays), and one view under
               torch.profiler.
  6. train   — densify (training) on the card from a fresh directory holding
               only the scene's reconstruction, at tpu3d's default width
               (256^3 x 28, 192 samples, batch 2048, Adam) with ray stride 8
               (100 steps), then its held-out evaluation: steps, wall, rays/s
               after the first 10 steps, first and last logged loss, PSNR
               against tpu3d's on the CPU, peak memory (allocated and
               reserved), both kernels' launches (each graph replay credited
               with its capture's), and how the chunks of 16 steps ran: graph
               replays (at least one, in every training phase of phases
               6-8 and 11), eager warm-up chunks, capture seconds; then
               ``_profile_train_step`` at the same shapes: two eager runs
               and make_multi_step's graph after two chunks on the same
               draws, bit for bit, three chunks of each in turns
               (ms per step, host ms per chunk), and one eager step and one
               replayed chunk under torch.profiler: the device time of the
               forward kernel, the scatter, the Adam update and the
               elementwise kernels, and the busy share.
  7. recipe  — densify at tpu3d's dense recipe of record (RECIPE_FLAGS:
               contraction at core_q 70, hierarchical 64 + 64 samples,
               256^3 x 28, a coarse 128^3 epoch, two fine epochs, then the
               cascade's detail grid at the 256^3 budget for one epoch
               against the frozen result) at ray stride 8: per phase its
               steps, rays/s and first and last logged loss; the detail
               grid's shape and box; the PSNR of the fine grid alone and
               of the base + detail pair against tpu3d's on the CPU; the
               training views scored with the base alone and with the pair
               (the detail phase must raise their PSNR: it lowers its loss
               by less than its logged single batches differ); each
               phase's step through ``_profile_train_step`` (phase 6);
               peak memory; both kernels' launches against the counts the
               steps give.
  8. options — densify --hierarchical --occupancy --camera-gate
               --camera-gate-epoch 1 for 2 epochs at ray stride 4: the
               occupancy refreshes' steps (tpu3d's cadence, step 513 among
               them) and occupied share, the gate's probe MSEs and dropped
               cameras, the PSNR, launches; one held-out view rendered with
               and without occupancy pruning (PSNR and wall); the run's
               step (hierarchical, guided by the trained grid's occupancy)
               through ``_profile_train_step`` (phase 6); then a
               --rays-pkl run on ray files of the same views at stride 16,
               2 epochs.
  9. full    — sfm.pipeline.reconstruct (extract -> retrieve -> match ->
               reconstruct) on the 24 views from arrays, at tpu3d's default
               PipelineConfig with the scene's focal, twice: the split
               descriptor, then fused_descriptor=True. Per run: seconds per
               stage and the engine's phase timers, registered cameras,
               points, mean reprojection px, camera-centre and rotation error
               after a similarity alignment to the scene's poses, peak memory,
               launches, the dispatch counts (utils/dispatch.py, with the BA
               read-backs), the batched local BA solves and their problems,
               and the native track store's calls (each must be > 0). Then
               the split run's largest chunk of local BA problems solved
               batched and one by one on the card (the same iterations,
               within 1e-5, two batched runs bit-identical, at most LM steps
               + 2 synchronizing calls a solve); the split run's reconstruct
               stage once more under torch.profiler, for its busy share and
               top kernels; and cli full through the CLI's traced runner,
               whose trace must hold the command's and the four stages'
               spans.
 10. sfm     — the SfM entry points on the same 24 views from arrays, at the
               same config: (a) the staged functions cli.extract -> match ->
               reconstruct(from_matches=True) -> export into a temporary
               store, each stage's files and tpu3d's keys checked, the result
               held equal (registered set, points, mean reprojection) to a
               one-process reconstruct in the same process; (b)
               reconstruct(mode="global"): pose-graph component, registered,
               points, reprojection, centre and rotation error, stage
               seconds, peak memory, launches, then its reconstruct stage
               under torch.profiler; (c) cli.full with register_all and the
               edge-consistency gate: dropped and low-confidence cameras,
               finite poses; (d) refine_focal from 1.25x the scene's focal on
               (a)'s one-process observations: the focal within 1%. (b) and
               (d) print their BA read-backs.
 11. sdf     — densify --model sdf on the card from a fresh directory holding
               only the scene's reconstruction, at tpu3d's default width (256^3
               x 28, 192 samples, batch 2048, Adam) with ray stride 8 (100
               steps), scored with the SDF's training band: steps, rays/s,
               first and last logged loss, PSNR against tpu3d's on the CPU,
               both kernels' launches against the step counts, peak memory,
               graph replays; the SDF step through ``_profile_train_step``
               (phase 6); cli mesh on the saved mesh_grid
               (vertices, faces, iso level, seconds); voxel_traversal on the
               card against the CPU (8,192 rays x 256 steps, indices equal).
 12. learned — the learned frontends and matcher with seeded random weights
               written as tpu3d-layout .npz and loaded through the config: (a)
               DiskUNet on a 4-view 976x656 batch and the 9-layer LightGlue on
               one K=2048 pair, card against CPU, TF32 off; (b) run_extraction
               with DISK over the 24 views (seconds, keypoints, peak memory,
               device ms per batch); (c) run_retrieval + run_matching with
               LightGlue at pair_batch 32 (pairs, raw matches, ms per block,
               one profiled block, peak memory); (d) reconstruct with DISK and
               the mutual-NN matcher (top2 at D = 128 launched; registered
               cameras recorded); (e) SuperPoint and one mutual-NN block: top2
               at D = 256 against its plain version, with its times and bound.
 14. dvgo    — DVGO's training step (dense/dvgo.py) at the dvgo-160.train
               cell's sizes (160^3 x 13 grid, 8,192 rays, 558 samples a ray)
               through make_multi_step: three chunks of 16 (eager, captured
               and replayed, replayed), both kernels' launches against the
               steps, the losses finite, peak memory; then one more step
               with its scatter's cotangents and points recorded, and
               trilinear_kernel and trilinear_grad_kernel (13 channels: the
               scalar path) held against their plain versions bit for bit on
               that step's own points and cotangents, timed, with their
               bounds. The full run appends both as the ``dvgo`` shape of
               the two kernels' rows, with the phase's launch counts. The
               colour MLP's kernels (kernels/rgbnet.py) on that step's own
               coloured rows and colour cotangents: forward and backward
               against the plain version on the card, two runs bit for bit,
               timed beside their FLOP bounds, the plain version, cuBLAS
               over the same compacted rows with the count known on the host
               (the library yardstick) and cuBLAS over every sample (the
               dense path the kernels replaced); each rgbnet kernel launched
               once a step.

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
# The recipe phase: tpu3d's dense recipe of record (BASELINE.md:530-538:
# contraction with the cloud's 70th-percentile radius at 0.9, hierarchical
# 64 + 64 samples, 256^3 x 28, coarse-to-fine) and its two-level cascade
# (a detail grid at the 256^3 budget against the frozen result), cut in
# depth: every 8th pixel, 3 epochs of which 1 coarse, 1 detail epoch.
RECIPE_FLAGS = dict(contraction=True, norm_core_q=70.0, hierarchical=True, epochs=3,
                    coarse_epochs=1, detail_epochs=1, ray_stride=TRAIN_RAY_STRIDE)
# Mean held-out PSNR (views 4, 12, 20) of the fine phase's grid alone (the
# cascade's base) from tpu3d's train_plenoxel (seed 0, what its densify
# uses) + evaluate_views on the CPU for the same artifacts and flags, as
# `JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_dense_options.py`
# prints. Over seeds 0, 1, 2 tpu3d gives 16.4618 / 16.4641 / 16.5134 dB, a
# spread of 0.0516 dB; the port's random streams differ from tpu3d's, so it
# must come within twice that. The same for the base + detail pair after
# tpu3d's detail phase (its Pallas kernels in interpret mode on the CPU):
# 16.4620 / 16.4642 / 16.5136 dB, a spread of 0.0516 dB.
TPU3D_CPU_RECIPE_PSNR = 16.461823946615507
MAX_RECIPE_PSNR_DIFF_DB = 0.104
TPU3D_CPU_CASCADE_PSNR = 16.46198424475713
MAX_CASCADE_PSNR_DIFF_DB = 0.104
# The options phase: the README's `densify --hierarchical --occupancy` with
# the camera gate after epoch 1, 2 epochs at every 4th pixel (823,284 rays,
# 401 steps an epoch): tpu3d's default occupancy cadence (500 steps, scan
# chunks of 16) refreshes the occupancy grid at global step 513. Then a
# --rays-pkl run on the same views' rays at every 16th pixel, 2 epochs of 25
# steps (a chunk of 16 and a tail of 9: each length's first chunk is a
# CUDA graph's warm-up, so a second epoch is what replays them).
OPTIONS_FLAGS = dict(hierarchical=True, occupancy=True, camera_gate=True, camera_gate_epoch=1,
                     epochs=2, ray_stride=4)
OPTIONS_REFRESH_STEP = 513
RAYS_PKL_STRIDE, RAYS_PKL_EPOCHS = 16, 2
# A trilinear row on a grid of more than 2^31 values, which takes the
# kernel's int64 offsets (what --detail-res 432 would train).
INT64_RES = 432
SLICE_KERNELS = ("patch_sample_kernel", "top2_kernel")
# The split full run before the match kernel's redesign and the fixed-order
# BA sums (chip_smoke.py on an H100, commit 820136c): registered, points,
# observations, mean reprojection px as printed. Printed beside this run's;
# a difference is reported, not failed (the BA's sums now add in another
# order).
PR5_FULL_SPLIT = (24, 5250, 46605, "0.1599")
# The full phase: tpu3d's reconstruct on make_scene(SCENE_SEED) at these
# shapes on the CPU (default PipelineConfig, the scene's focal in camera and
# sfm.camera), over three seeds of its draws, as
# `JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_reconstruct.py`
# prints: the fewest cameras it registered, and its worst mean reprojection
# error plus twice the spread over the seeds (the port's draws differ).
# Seeds 0/1/2: 24/24 each, 0.160347 / 0.158472 / 0.160955 px.
TPU3D_CPU_REGISTERED = 24
MAX_FULL_REPROJ_PX = 0.165923
# The sfm phase: tpu3d's run_global_reconstruction on make_scene(SCENE_SEED)
# at these shapes on the CPU (default PipelineConfig, the scene's focal), over
# three seeds of its draws, as
# `JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_reconstruct.py global`
# prints: seeds 0/1/2 registered 24/24 each, 4,627 / 5,259 / 3,951 points,
# 0.161105 / 0.158679 / 0.163634 px. The port's global mode must register at
# least the fewest less one, at a mean reprojection error no worse than the
# worst plus twice the spread.
TPU3D_CPU_GLOBAL_REGISTERED = 24
MAX_GLOBAL_REPROJ_PX = 0.173545
# refine_focal on the split one-process run's final observations, started at
# 1.25x the scene's focal (tests/test_ba.py's 25% error), tpu3d's default
# search (24 golden-section steps, BA max_iters 12, cg_iters 24): within 1%.
FOCAL_START = 1.25
MAX_FOCAL_ERR = 0.01
# The sdf phase: tpu3d's densify --model sdf at its default width (256^3 x
# 28, 192 samples, batch 2048, Adam 1e-2, one epoch) on the train phase's
# rays (ray stride 8, 100 steps), scored with the SDF's training band (near
# 1e-3, far 1e3, box-clipped). That band ends on the box's exit face, so
# every ray's last sample (whose segment is 1e10) lies on the face, and
# whether it counts as inside depends on how o + t d rounds: XLA fuses some
# of those products into FMAs, eager torch none, so tpu3d's scorer and the
# port's differ on the same grid. Mean held-out PSNR (views 4, 12, 20) of
# tpu3d's train_sdf (seed 0, what its densify uses) on the CPU for the same
# artifacts and flags, scored by tpu3d's evaluate_views (recorded) and by the
# port's on the same grid (the limit), as `JAX_PLATFORMS=cpu PYTHONPATH=.
# python tests/test_torch_sdf.py` prints. tpu3d's scorer over seeds 0, 1,
# 2: 11.908293 / 11.880223 / 11.892850 dB; the port's scorer on the same
# grids 13.065261 / 13.016655 / 13.026674 dB, a spread of 0.048605 dB. The
# port's random streams differ from tpu3d's, so it must come within twice
# that of seed 0's.
TPU3D_CPU_SDF_PSNR = 11.908293336689672
TPU3D_SDF_PORT_SCORED_PSNR = 13.065260680802488
MAX_SDF_PSNR_DIFF_DB = 0.0973
# voxel_traversal on the card against the CPU: the first 8,192 training rays
# through the 256^3 grid, 256 steps each.
TRAVERSAL_RAYS, TRAVERSAL_STEPS = 8192, 256
# The learned phase: seeded random weights (the released checkpoints are not
# in the repository), 4 views a DISK batch. DiskUNet's map on the card within
# 1e-4 of its largest value of the CPU's, at least 99% of the valid keypoints
# in both sets (a score within rounding of a window neighbour's can flip an
# NMS decision), LightGlue's scores within 1e-4 x max(1, max |score|): f32
# products summed in another order over 9 layers (the CPU tests see 1.8e-5 of
# the value between tpu3d and the port).
LEARNED_SEED, LEARNED_BATCH = 0, 4
DISK_MAP_REL_TOL, DISK_KP_AGREE, LG_SCORE_REL_TOL = 1e-4, 0.99, 1e-4
# The staged commands' artifacts and the keys each must hold (tpu3d's).
STAGED_KEYS = {
    "features.npz": {"keypoints", "keypoints_px", "descriptors", "valid", "colors_bgr",
                     "image_size"},
    "features_meta.json": {"names", "downscale", "seconds"},
    "pairs_meta.json": {"registrations", "adjacency", "next_track", "seconds"},
    "matches.npz": {"kp_track", "parent", "r0_e0_idx_ref", "r0_e0_idx_new", "r0_e0_track",
                    "r0_e0_uv_ref", "r0_e0_uv_new", "r0_e0_colors", "r0_e0_relRt"},
    "reconstruction.npz": {"cams", "registered", "points", "colors_bgr", "track_ids",
                           "extrinsics"},
    "reconstruction_meta.json": {"registered_names", "mean_reproj_px", "num_obs", "mode",
                                 "downscale", "seconds", "sfm_phase_seconds", "sfm_backend",
                                 "low_confidence_names", "per_camera_reproj_px"},
}
EXPORT_FILES = ("img_list.txt", "all_points.npy", "all_descriptors.npy", "all_colors.npy",
                "img_size.npy", "img_pairs.npy", "all_matches.npy", "reconstructed_img.txt",
                "cameras_extrinsic.npy", "points_3d.npy", "result.ply")
# Phase 13, dist: (a) densify --mesh 1x1 on the train phase's artifacts and
# flags (ray stride 8, 100 steps) in a world of one over NCCL. Its trainer is
# tpu3d's train_dense_tp, whose trajectory does not depend on the mesh; its
# mean held-out PSNR (views 4, 12, 20) on the CPU for seed 0 (what densify
# uses), as `JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_dist.py`
# prints. Over seeds 0-5 tpu3d gives 11.828047 / 11.834771 / 11.836333 /
# 11.872776 / 11.879398 / 11.857508 dB, a spread of 0.051351 dB (seeds 0-2
# alone: 0.008286, narrower than the small scene's and the plain trainer's
# seeds show, so six); the port's draws differ from tpu3d's, so it must come
# within twice that spread. The port's own seeds 0-5 on the card give
# 11.760138-11.896594 dB, all within it (scripts/torch_tp_seed_spread.py).
TPU3D_CPU_TP_PSNR = 11.828047228967955
MAX_TP_PSNR_DIFF_DB = 0.1027
# (b): DIST_STEPS injected steps of each mesh's step against the 1 x 1
# step's; every rank of a part must finish within DIST_TIMEOUT_S.
DIST_STEPS = 5
DIST_TIMEOUT_S = 420
# make_multi_step's CUDA graph against the eager loop at each profiled
# step's shapes: two chunks (the graph's warm-up, then a replay) on the same
# draws, bit for bit (every sum of the step, the scatter's too, has a fixed
# order); then GRAPH_TURNS chunks of each, in turns.
GRAPH_TURNS = 3
# orient_desc_kernel against its plain version: theta within 1e-5 rad and
# samples within orient_desc.sample_tolerance (1e-5 x max|g|, plus what the
# theta difference can move a sample) except at near ties (< 5%).
ORIENT_THETA_TOL = 1e-5
ORIENT_SAMPLE_TOL = 1e-5
# Phase 14: the dvgo-160.train cell's step (densify --model dvgo
# --grid-resolution 160 --dense-batch 8192), in chunks of 16 steps.
DVGO_RES, DVGO_BATCH, DVGO_CHUNK = 160, 8192, 16
# The colour MLP's FLOPs a coloured row (portbench/counts_dvgo.py): the
# forward, and the backward's weight gradients and the input gradients the
# step needs (layers 3 and 2, layer 1's 12 k0 columns).
RGBNET_FWD_FLOPS = 2 * (39 * 128 + 128 * 128 + 128 * 3)
RGBNET_BWD_FLOPS = RGBNET_FWD_FLOPS + 2 * (3 * 128 + 128 * 128 + 128 * 12)
RGBNET_KERNELS = ("rgbnet_count_kernel", "rgbnet_compact_kernel", "rgbnet_forward_kernel",
                  "rgbnet_backward_kernel", "rgbnet_reduce_kernel")


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
    """Print the failure on both streams (a caller that keeps only the end of
    one of them still sees it) and exit 1."""
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
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


def _times(torch, fn, iters: int, prefix: str = "") -> dict:
    """The three numbers of a kernel row, for one callable (a kernel's
    wrapper, its plain version or a library call), after 3 warm-ups:

      ms       device ms per call: torch.profiler's CUDA events (kernels
               and copies) over ``iters`` calls, summed, over ``iters``
      wall_ms  wall ms per back-to-back call: CUDA events around ``iters``
               calls, the median of 5 such batches
      host_us  host µs per call: the host clock around ``iters`` calls,
               read before the synchronize (the enqueue alone), the median
               of 5 batches (the host is shared and noisy)

    When the device outruns the host, wall_ms measures the enqueue and
    only ms is the kernel's. ``ms`` is None if the profiler saw no CUDA
    activity."""
    import statistics

    from torch.profiler import ProfilerActivity, profile

    walls, hosts = [], []
    for _ in range(5):
        walls.append(_time_ms(torch, fn, iters))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        hosts.append((time.perf_counter() - t0) / iters * 1e6)
        torch.cuda.synchronize()
    wall, host = statistics.median(walls), statistics.median(hosts)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev_ms = sum(_device_ms(prof).values()) / iters
    return {f"{prefix}ms": dev_ms or None, f"{prefix}wall_ms": wall, f"{prefix}host_us": host}


_NO_LIBRARY = {"library_ms": None, "library_wall_ms": None, "library_host_us": None}


def _fmt_times(row: dict) -> str:
    def f(x, unit=""):
        return "not measured" if x is None else f"{x:.4f}{unit}"
    out = []
    for who, pre in (("kernel", ""), ("plain", "plain_"), ("library", "library_"),
                     ("product", "product_")):
        if f"{pre}wall_ms" in row and row[f"{pre}wall_ms"] is not None:
            out.append(f"{who} device {f(row[pre + 'ms'])} ms / wall {f(row[pre + 'wall_ms'])} "
                       f"ms / host {row[pre + 'host_us']:.1f} us")
    return "; ".join(out)


def _patch_sample_calls(torch, dev, scene, cfg) -> list:
    """The arguments of every sample_gradient_patches call that one
    extract_features call (split descriptor) makes on the first batch of
    make_scene's views: the detector's 3x3x3 fetch on each octave's DoG
    stack (S = 27), then the orientation (121) and descriptor (256) passes
    on the unified gradient stack at the coordinates that
    features/descriptor.py::_sample_gradients builds."""
    from tpu3d_torch.features import descriptor, detector, frontend

    real = detector.sample_gradient_patches
    calls = []

    def record(*args):
        calls.append(args + (None,) * (6 - len(args)))    # (gx, gy, ys, xs, lvl, dlvl)
        return real(*args)

    detector.sample_gradient_patches = descriptor.sample_gradient_patches = record
    try:
        frontend.extract_features(torch.from_numpy(scene["gray"][: cfg.frontend.batch_size]),
                                  dataclasses.replace(cfg.frontend, fused_descriptor=None),
                                  device=dev)
    finally:
        detector.sample_gradient_patches = descriptor.sample_gradient_patches = real
    return calls


def _patch_sample_shape(torch, label, gx, gy, ys, xs, lvl, dlvl) -> dict:
    """One patch_sample shape: the kernel against its plain version (max
    |err| must be 0), the three numbers for the kernel, the plain version
    and one 5-D grid_sample, and the bound."""
    import torch.nn.functional as F

    from tpu3d_torch.kernels import patch_sample as ps

    args = (gx, gy, ys, xs, lvl, dlvl)
    K, S = ys.shape
    L, H, W = gx.shape
    out = ps.sample_gradient_patches(*args)
    ref = ps.sample_gradient_patches_plain(*args)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    if not err == 0.0:
        _fail(f"patch_sample_kernel {label}: max |err| {err:.3g} != 0 (kernel and plain "
              "version round the same operations in the same order)")
    row = dict(shape=label, K=K, S=S, max_abs_err=err)
    row.update(_times(torch, lambda: ps.sample_gradient_patches(*args), 100))
    row.update(_times(torch, lambda: ps.sample_gradient_patches_plain(*args), 10, "plain_"))
    # Library yardstick: one 5-D grid_sample (trilinear at an integer level
    # coordinate is the bilinear sample) over the channel stack.
    chans = [c for c in (gx, gy) if c is not None]
    nch = len(chans)
    vol = torch.stack(chans)[None]                                   # (1, C, L, H, W)
    lz = lvl[:, None].float() + (0.0 if dlvl is None else dlvl[None, :].float())
    grid = torch.stack([xs / (W - 1) * 2 - 1, ys / (H - 1) * 2 - 1,
                        lz.expand(K, S) / (L - 1) * 2 - 1], -1)[None, None]
    row.update(_times(torch, lambda: F.grid_sample(vol, grid, mode="bilinear",
                                                   align_corners=True), 100, "library_"))
    del vol, grid
    # Bound: coordinates, levels and the output once, plus every texel
    # this run's coordinates touch (the 2x2 cells) once per channel.
    y0 = ys.floor().long().clamp(0, H - 2)
    x0 = xs.floor().long().clamp(0, W - 2)
    lf = (lvl[:, None].long() + (0 if dlvl is None else dlvl[None, :].long())).clamp(0, L - 1)
    base = (lf * H + y0) * W + x0
    texels = torch.unique(torch.cat([base, base + 1, base + W, base + W + 1]).reshape(-1)).numel()
    nbytes = 4 * (2 * K * S + K + (0 if dlvl is None else S) + nch * K * S + nch * texels)
    flops = 11 * nch * K * S
    row.update(bound_ms=max(nbytes / H100_BYTES_PER_S, flops / H100_FP32_FLOPS) * 1e3,
               bound_by="bytes" if nbytes / H100_BYTES_PER_S >= flops / H100_FP32_FLOPS
               else "operations")
    print(f"kernel patch_sample_kernel {label} K={K} S={S} C={nch} stack {L}x{H}x{W}: "
          f"max_abs_err={err:.3g} bound_ms={row['bound_ms']:.4f} (touched texels {texels}); "
          + _fmt_times(row), flush=True)
    return row


def _check_patch_sample(torch, dev, scene, cfg) -> dict:
    """patch_sample_kernel against its plain version at the main path's
    shapes and coordinates (one extract batch of make_scene: 4 x 2048
    keypoints): S = 27 on each octave's DoG stack (4 x 5 levels), S = 121
    and 256 on the unified gradient stack (4 images x 4 octaves x 3
    levels, two channels). Then, as a stress case, S = 121 and 256 at
    coordinates drawn uniformly over the whole image, which the main path
    never sends (each sample's 2x2 cell in its own sectors)."""
    calls = _patch_sample_calls(torch, dev, scene, cfg)
    rows = []
    for args in calls:
        S = args[2].shape[1]
        label = f"octave {len(rows)}" if S == 27 else "descriptor" if S == 256 else "orientation"
        rows.append(_patch_sample_shape(torch, label, *args))
    gx, gy = calls[-1][0], calls[-1][1]
    L, H, W = gx.shape
    K = calls[-1][2].shape[0]
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    lvl = torch.randint(0, L, (K,), generator=g, device=dev, dtype=torch.int32)
    for S in (121, 256):     # inside the bounds, with a share exactly on the border
        ys = torch.rand((K, S), generator=g, device=dev) * (H - 1.001)
        xs = torch.rand((K, S), generator=g, device=dev) * (W - 1.001)
        ys[:, :8] = 0.0
        xs[:, 8:16] = W - 1.001
        ys[:, 16:24] = H - 1.001
        rows.append(_patch_sample_shape(torch, "stress uniform", gx, gy, ys, xs, lvl, None))
    # The descriptor pass (S=256) is the main path's largest launch; the row
    # reports it, and every shape under "shapes".
    main = next(r for r in rows if r["shape"] == "descriptor")
    return dict(main, name="patch_sample_kernel", route="cuda",
                source="tpu3d_torch/csrc/patch_sample.cu",
                replaces="tpu3d/kernels/patch_sample.py:153",
                max_abs_err=max(r["max_abs_err"] for r in rows), shapes=rows)


def _check_top2(torch, dev) -> dict:
    """top2_kernel against its plain version at one match block: 32 pairs
    of 2048 x 2048 unit descriptors, D = 128, random validity masks,
    through mutual_top2 (the matcher's call: both directions, one launch).
    Rows and columns: the argmax must agree wherever the top-2 gap exceeds
    1e-5. Beside the kernel, the plain version, and as a yardstick the
    full-f32 torch.bmm of the same product alone (``product_``): not the
    same function (no masks, no top-2, the matrix stored)."""
    from tpu3d_torch.kernels import distance as dist

    B, K, D = 32, 2048, 128
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    q = torch.nn.functional.normalize(torch.randn((B, K, D), generator=g, device=dev), dim=-1)
    k = torch.nn.functional.normalize(torch.randn((B, K, D), generator=g, device=dev), dim=-1)
    vq = (torch.rand((B, K), generator=g, device=dev) < 0.9).float()
    vk = (torch.rand((B, K), generator=g, device=dev) < 0.9).float()
    best, second, arg, col = dist.mutual_top2(q, k, vq, vk)
    pb, ps_, pa, pc = dist.mutual_top2_plain(q, k, vq, vk)
    cb, cs, _ = dist.descriptor_top2_plain(k, q, vk, vq)
    torch.cuda.synchronize()
    err = max(float((best - pb).abs().max()), float((second - ps_).abs().max()))
    if not err <= 1e-5:
        _fail(f"top2_kernel: max |err| of best/second {err:.3g} > 1e-5")
    # Rows of a masked query (columns of a masked key) score -2 everywhere:
    # both give index 0.
    clear = ((pb - ps_) > 1e-5) | (vq == 0)
    cclear = ((cb - cs) > 1e-5) | (vk == 0)
    n_tie, n_ctie = int((~clear).sum()), int((~cclear).sum())
    n_bad = int(((arg != pa) & clear).sum())
    n_cbad = int(((col != pc) & cclear).sum())
    if n_bad or n_cbad:
        _fail(f"top2_kernel: argmax differs on {n_bad} rows and col_arg on {n_cbad} columns "
              "whose top-2 gap is > 1e-5")
    del pb, ps_, pa, pc, cb, cs
    row = dict(_times(torch, lambda: dist.mutual_top2(q, k, vq, vk), 20),
               **_times(torch, lambda: dist.mutual_top2_plain(q, k, vq, vk), 5, "plain_"),
               **_times(torch, lambda: torch.bmm(q, k.transpose(1, 2)), 20, "product_"),
               **_NO_LIBRARY)
    flops = 2.0 * B * K * K * D
    # q and k, both masks, the rows' (best, second, arg), the columns' keys
    nbytes = 4.0 * (2 * B * K * D + 2 * B * K + 3 * B * K) + 8.0 * B * K
    bound_ms = max(flops / H100_FP32_FLOPS, nbytes / H100_BYTES_PER_S) * 1e3
    ms = row["ms"] or row["wall_ms"]
    print(f"kernel top2_kernel B={B} K={K} D={D} (both directions): max_abs_err={err:.3g} "
          f"near_ties rows {n_tie} columns {n_ctie} bound_ms={bound_ms:.4f} "
          f"({flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.0%} of the bound); "
          + _fmt_times(row), flush=True)
    return dict(row, name="top2_kernel", route="cuda", source="tpu3d_torch/csrc/top2.cu",
                replaces="tpu3d/kernels/distance.py:68", max_abs_err=err,
                bound_ms=bound_ms, bound_by="operations")


def _trilinear_shape(torch, label, grid, vol, mn, mx, pts) -> dict:
    """One trilinear shape: the kernel against its plain version (max |err|
    0, identical in-bounds flags), the three numbers for the kernel, the
    plain version and grid_sample on ``vol`` (a channels-first copy of the
    grid made beforehand), and the bound."""
    import torch.nn.functional as F

    from tpu3d_torch.kernels import trilinear as tri

    out, inb = tri.trilinear_sample(grid, mn, mx, pts)
    ref, ref_inb = tri.trilinear_sample_plain(grid, mn, mx, pts)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    if not torch.equal(inb, ref_inb):
        _fail(f"trilinear_kernel {label}: in-bounds flags differ from the plain version")
    if not err == 0.0:
        _fail(f"trilinear_kernel {label}: max |err| {err:.3g} != 0 (kernel and plain version "
              "round the same operations in the same order)")
    row = dict(shape=label, N=pts.shape[0], max_abs_err=err)
    row.update(_times(torch, lambda: tri.trilinear_sample(grid, mn, mx, pts), 50))
    row.update(_times(torch, lambda: tri.trilinear_sample_plain(grid, mn, mx, pts), 5, "plain_"))
    # Library yardstick: grid_sample's (x, y, z) coordinate order indexes
    # (W, H, D) = (Z, Y, X).
    u = (pts - mn) / (mx - mn) * 2 - 1
    gs_grid = u.flip(-1).reshape(1, 1, 1, -1, 3).contiguous()
    row.update(_times(torch, lambda: F.grid_sample(vol, gs_grid, mode="bilinear",
                                                   align_corners=True), 20, "library_"))
    # (in the box only: grid_sample blends zero padding in beyond it)
    lib_diff = float((F.grid_sample(vol, gs_grid, mode="bilinear", align_corners=True)
                      .reshape(vol.shape[1], -1).T - ref)[inb].abs().max())
    del ref, gs_grid
    # Bound: points in, values and flags out, plus each grid row the
    # in-box samples need (the out-of-box ones need none), once.
    N, C = out.shape
    X, Y, Z = grid.shape[:3]
    i0 = tri._corner_setup((X, Y, Z), mn, mx, pts)[0][inb]
    base = (i0[:, 0] * Y + i0[:, 1]) * Z + i0[:, 2]
    offs = torch.tensor([0, 1, Z, Z + 1, Y * Z, Y * Z + 1, Y * Z + Z, Y * Z + Z + 1],
                        device=pts.device)
    rows = torch.unique((base[:, None] + offs).reshape(-1)).numel()
    nbytes = 12 * N + 4 * C * N + N + 4 * C * rows + 24
    flops = N * (C * 21 + 18)
    row.update(bound_ms=max(nbytes / H100_BYTES_PER_S, flops / H100_FP32_FLOPS) * 1e3,
               bound_by="bytes" if nbytes / H100_BYTES_PER_S >= flops / H100_FP32_FLOPS
               else "operations")
    ms = row["ms"] or row["wall_ms"]
    print(f"kernel trilinear_kernel {label} grid {X}x{Y}x{Z}x{C} N={N} (in box "
          f"{int(inb.sum())}): max_abs_err={err:.3g} (grid_sample's max diff in the box "
          f"{lib_diff:.3g}) bound_ms={row['bound_ms']:.4f} (rows touched {rows}, "
          f"{nbytes / ms / 1e6:.0f} GB/s); " + _fmt_times(row), flush=True)
    return row


def _train_points(torch, dev, cfg, ds):
    """The 2,048 x 192 = 393,216 jittered sample points of the first batch
    of training rays (a training step's shape), and the train box."""
    from tpu3d_torch.dense.render import ray_samples

    mn = torch.full((3,), -cfg.scene_scale, device=dev)
    mx = torch.full((3,), cfg.scene_scale, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    ro, rd = (torch.from_numpy(a[:cfg.batch_size]).to(dev) for a in (ds.origins, ds.dirs))
    pts = ray_samples(ro, rd, cfg.near, cfg.far, cfg.num_samples, mn, mx, clip_aabb=True,
                      perturb=True, generator=g)[0].contiguous()
    return pts, mn, mx, g


def _check_trilinear(torch, dev, scene, dense, cfg, ds, recipe_cfg, recipe_ds) -> dict:
    """trilinear_kernel against its plain version at the shapes it
    launches at on the 256^3 x 28 grid: one render launch of the dense
    phase (the 8,192 x 192 = 1.57 M sample points of the first chunk of
    held-out view 4), one training step's forward (2,048 x 192) and the
    recipe's hierarchical fine pass (2,048 x 128 contracted points, the
    grid over [-2, 2]^3); then once on a 432^3 x 28 grid (2.26e9 values),
    which takes the kernel's int64 offsets."""
    from tpu3d_torch.dense.eval import view_rays
    from tpu3d_torch.dense.render import ray_samples
    from tpu3d_torch.dense.train import SceneNormalization

    meta = dense["meta"]
    grid = torch.from_numpy(dense["grid"]).to(dev)
    mn = torch.from_numpy(dense["min_bound"]).to(dev)
    mx = torch.from_numpy(dense["max_bound"]).to(dev)
    norm = SceneNormalization(np.asarray(meta["norm_center"], np.float32), meta["norm_scale"])
    rays = view_rays(dense["cams"][4], HEIGHT, WIDTH, scene["focal"], norm, stride=2)
    ro, rd = (torch.from_numpy(a[:DENSE_CHUNK]).to(dev) for a in rays)
    pts = ray_samples(ro, rd, meta["near"], meta["far"], meta["num_samples"], mn, mx,
                      clip_aabb=True)[0].contiguous()
    vol = grid.permute(3, 0, 1, 2).unsqueeze(0).contiguous()
    render = _trilinear_shape(torch, "render", grid, vol, mn, mx, pts)
    tpts, tmn, tmx, _ = _train_points(torch, dev, cfg, ds)
    train = _trilinear_shape(torch, "train", grid, vol, tmn, tmx, tpts)
    fpts, fmn, fmx = _recipe_points(torch, dev, grid, recipe_cfg, recipe_ds)
    fine = _trilinear_shape(torch, "recipe fine", grid, vol, fmn, fmx, fpts)
    del vol, grid
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    big = torch.empty((INT64_RES,) * 3 + (28,), device=dev).uniform_(-1.0, 1.0, generator=g)
    big_vol = big.permute(3, 0, 1, 2).unsqueeze(0).contiguous()
    # the first chunk's render points, over the same box: 5% fall outside it
    int64 = _trilinear_shape(torch, "int64", big, big_vol, mn, mx, pts)
    del big, big_vol
    torch.cuda.empty_cache()
    return dict(render, name="trilinear_kernel", route="cuda",
                source="tpu3d_torch/csrc/trilinear.cu", replaces="tpu3d/kernels/trilinear.py:82",
                shapes=[render, train, fine, int64])


def _recipe_points(torch, dev, grid, cfg, ds):
    """The 2,048 x 128 contracted sample points of the recipe's first
    training batch in its hierarchical fine pass: 64 jittered coarse
    depths (48 stratified, 16 in the disparity tail), 64 importance depths
    from the coarse pass's weights on ``grid`` over [-2, 2]^3, merged."""
    from tpu3d_torch.dense.contract import contract
    from tpu3d_torch.dense.render import composite_weights, ray_samples
    from tpu3d_torch.dense.sdf import sample_pdf
    from tpu3d_torch.kernels.trilinear import trilinear_sample_plain

    mn, mx = torch.full((3,), -2.0, device=dev), torch.full((3,), 2.0, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    ro, rd = (torch.from_numpy(a[:cfg.batch_size]).to(dev) for a in (ds.origins, ds.dirs))
    B = ro.shape[0]
    pts_c, _, z_c = ray_samples(ro, rd, cfg.near, cfg.far, cfg.n_coarse, mn, mx, contract=True,
                                perturb=True, generator=g)
    vals, inb = trilinear_sample_plain(grid, mn, mx, pts_c.contiguous())
    w = composite_weights((torch.relu(vals[:, 0]) * inb).reshape(B, -1), z_c)
    z = torch.sort(torch.cat([z_c, sample_pdf(z_c, w, cfg.n_fine, generator=g)], -1), -1).values
    pts = contract(ro[:, None, :] + z[..., None] * rd[:, None, :]).reshape(-1, 3).contiguous()
    return pts, mn, mx


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


def _recipe_inputs(root: str, scene: dict):
    """(DenseConfig, RayDataset) of the recipe phase's fine phase, prepared
    as densify prepares them under RECIPE_FLAGS: the contraction's
    normalization, the sparse cloud's band, the name-keyed holdout."""
    from tpu3d_torch.cli import registered_views
    from tpu3d_torch.config import DenseConfig
    from tpu3d_torch.dense.eval import dataset_from_views, split_views_by_name
    from tpu3d_torch.dense.train import auto_near_far, normalize_scene_contracted
    from tpu3d_torch.io.artifacts import ArtifactStore

    cams, names, _ = registered_views(root)
    points = ArtifactStore(root).load("reconstruction")["points"]
    norm = normalize_scene_contracted(points, core_q=RECIPE_FLAGS["norm_core_q"])
    near, far = auto_near_far(cams, points, norm)
    train_idx, _ = split_views_by_name(names, 8)
    return (DenseConfig(near=near, far=far, hierarchical=True, contraction=True,
                        per_ray_aabb=False),
            dataset_from_views(cams, scene["rgb"], scene["focal"], train_idx, norm,
                               stride=RECIPE_FLAGS["ray_stride"]))


def _scatter_bits(torch, what, c, mn, mx, res, p) -> float:
    """trilinear_grad_kernel on cotangents ``c`` at points ``p`` against
    its plain version on a CPU copy of the inputs, bit for bit, and two
    launches bit for bit (fails otherwise); returns the max |diff|."""
    from tpu3d_torch.kernels import trilinear_grad as tg

    out = tg.trilinear_scatter_grad(c, mn, mx, res, p)
    again = tg.trilinear_scatter_grad(c.clone(), mn.clone(), mx.clone(), res, p.clone())
    torch.cuda.synchronize()
    repeat = torch.equal(out, again)
    del again
    out = out.cpu()
    ref = tg.trilinear_scatter_grad_plain(c.cpu(), mn.cpu(), mx.cpu(), res, p.cpu())
    bits = torch.equal(out.view(torch.int32), ref.view(torch.int32))
    err = float((out - ref).abs().max())
    print(f"kernel trilinear_grad_kernel {what} (N={len(p)}, C={c.shape[1]}): against the "
          f"plain version on the CPU bit for bit {'yes' if bits else 'NO'} (max |diff| "
          f"{err:.3g}, max|plain| {float(ref.abs().max()):.3g}); two launches bit for bit "
          f"{'yes' if repeat else 'NO'}", flush=True)
    del out, ref
    if not (bits and repeat):
        _fail(f"trilinear_grad_kernel ({what}): bit for bit against the plain version on "
              f"the CPU {bits}, two launches {repeat} (max |diff| {err:.3g})")
    return err


def _check_trilinear_grad(torch, dev, cfg, ds) -> dict:
    """trilinear_grad_kernel against its plain version at one training
    step's shape: the 256^3 x 28 grid and the 2,048 x 192 = 393,216 jittered
    sample points of the first batch of training rays, random cotangents;
    then 1,500 points in one cell of that grid (every sample in one run).
    The kernel sums in the plain version's order on the CPU, so it must
    equal the plain version on a CPU copy of the inputs bit for bit (the
    plain version's index_add_ on the card sums in no fixed order), and a
    second launch on copies of the inputs must give the same bits."""
    import torch.nn.functional as F

    from tpu3d_torch.kernels import trilinear_grad as tg

    R, B, S, C = cfg.grid_resolution, cfg.batch_size, cfg.num_samples, 28
    res = (R, R, R)
    pts, mn, mx, g = _train_points(torch, dev, cfg, ds)
    ct = torch.randn((B * S, C), generator=g, device=dev)
    cell = (mx - mn) / (R - 1)
    lump = mn + (torch.tensor([100.0, 120.0, 140.0], device=dev)
                 + torch.rand((1500, 3), generator=g, device=dev) * 0.9 + 0.05) * cell
    lump_ct = torch.randn((1500, C), generator=g, device=dev)
    err = max(_scatter_bits(torch, what, c, mn, mx, res, p)
              for what, p, c in (("training step", pts, ct),
                                 ("1,500 points in one cell", lump, lump_ct)))
    row = _times(torch, lambda: tg.trilinear_scatter_grad(ct, mn, mx, res, pts), 20)
    # The pieces of the call, each alone (CUDA events, wall per launch).
    keys, weights = tg.launch_keys(mn, mx, res, pts)
    binned = tg.bins(keys, res)
    buf = torch.empty((R, R, R, C), device=dev)
    pieces = {
        "keys": _time_ms(torch, lambda: tg.launch_keys(mn, mx, res, pts), 20),
        "sort": _time_ms(torch, lambda: torch.sort(keys, stable=True), 20),
        "offsets": _time_ms(torch, lambda: torch.searchsorted(
            binned[0], torch.arange(R * R + 1, dtype=torch.int32, device=dev) * R,
            out_int32=True), 20),
        "kernel": _time_ms(torch, lambda: tg.launch_scatter(ct, weights, *binned, buf), 20)}
    del buf, keys, weights, binned
    row.update(_times(torch, lambda: tg.trilinear_scatter_grad_plain(ct, mn, mx, res, pts), 3,
                      "plain_"))
    # Library yardstick: the backward of one grid_sample (channels-first copy,
    # align_corners) with respect to the grid alone; its (x, y, z) order
    # indexes (W, H, D) = (Z, Y, X). Inside the box it computes this gradient.
    vol = torch.zeros((1, C, R, R, R), device=dev, requires_grad=True)
    u = (pts - mn) / (mx - mn) * 2 - 1
    gs = F.grid_sample(vol, u.flip(-1).reshape(1, 1, 1, -1, 3), mode="bilinear",
                       align_corners=True)
    go = ct.T.reshape(1, C, 1, 1, -1).contiguous()
    row.update(_times(torch, lambda: torch.autograd.grad(gs, vol, go, retain_graph=True), 10,
                      "library_"))
    lib = torch.autograd.grad(gs, vol, go)[0][0].permute(1, 2, 3, 0)
    lib_diff = float((lib - tg.trilinear_scatter_grad(ct, mn, mx, res, pts)).abs().max())
    del vol, gs, go, lib
    # Bound, by bytes: the call writes the whole gradient once and reads the
    # cotangents, the points and the box.
    N = B * S
    bound_ms = (4 * C * R ** 3 + 4 * C * N + 12 * N + 24) / H100_BYTES_PER_S * 1e3
    print(f"kernel trilinear_grad_kernel grid {R}^3x{C} N={N}: max_abs_err={err:.3g}; "
          f"the call's pieces alone (wall ms) "
          + ", ".join(f"{k} {v:.4f}" for k, v in pieces.items())
          + f"; library = grid_sample's backward (max diff {lib_diff:.3g}); "
          f"bound_ms={bound_ms:.4f}; " + _fmt_times(row), flush=True)
    if row["ms"] is not None and row["library_ms"] is not None and \
            not row["ms"] < row["library_ms"]:
        _fail(f"trilinear_grad_kernel: the call's {row['ms']:.4f} device ms is not below "
              f"grid_sample's backward {row['library_ms']:.4f} ms")
    return dict(row, name="trilinear_grad_kernel", route="cuda",
                source="tpu3d_torch/csrc/trilinear_grad.cu",
                replaces="tpu3d/kernels/trilinear_grad.py:157", max_abs_err=err,
                bound_ms=bound_ms, bound_by="bytes")


def _run_dvgo(torch, dev) -> dict:
    """Phase 14: DVGO's training step at the dvgo-160.train cell's sizes
    through make_multi_step, on a seeded grid (every channel 0.1 N(0, 1),
    so alpha is near alpha_init, as at the start of training) and rays from
    about (0, 0, -3) into [-1, 1]^3, some missing it: three chunks of 16
    with the launch counts set to 0 just before them and read just after;
    then one more step with its scatter's cotangents and points recorded,
    and both kernels against their plain versions on them. Returns the
    ``dvgo`` shapes of the trilinear_kernel and trilinear_grad_kernel rows,
    {"trilinear_kernel": row, "trilinear_grad_kernel": row}."""
    import torch.nn.functional as F

    from tpu3d_torch.config import DenseConfig
    from tpu3d_torch.dense import dvgo
    from tpu3d_torch.dense.grid import VoxelGrid
    from tpu3d_torch.dense.train import make_multi_step
    from tpu3d_torch.kernels import LAUNCHES, reset_launches
    from tpu3d_torch.kernels import trilinear_grad as tg

    R, B, K = DVGO_RES, DVGO_BATCH, DVGO_CHUNK
    S = dvgo.n_samples((R,) * 3)
    cfg = DenseConfig(grid_resolution=R, batch_size=B, near=0.1, far=6.0, scene_scale=1.0,
                      scan_chunk=K)
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    n = (3 * K + 1) * B
    o = (torch.tensor([0.0, 0.0, -3.0], device=dev)
         + 0.4 * torch.randn((n, 3), generator=g, device=dev))
    d = F.normalize(torch.tensor([0.0, 0.0, 1.0], device=dev)
                    + 0.3 * torch.randn((n, 3), generator=g, device=dev), dim=-1)
    rgb = torch.rand((n, 3), generator=g, device=dev)
    lo, hi = torch.full((3,), -1.0, device=dev), torch.full((3,), 1.0, device=dev)
    grid = 0.1 * torch.randn((R, R, R, dvgo.CHANNELS), generator=g, device=dev)
    state = dvgo.init_state(cfg, VoxelGrid(grid, lo, hi), 3 * K, seed=5)
    multi = make_multi_step(dvgo.dvgo_train_step, with_occ=False)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    losses = [multi(state, cfg, torch.arange(c * K * B, (c + 1) * K * B, device=dev).view(K, B),
                    o, d, rgb, generator=g) for c in range(3)]
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = {k: LAUNCHES[k] for k in ("trilinear_kernel", "trilinear_grad_kernel",
                                          *RGBNET_KERNELS)}
    replays, eager = multi.replays, multi.eager_chunks
    multi.release()
    losses = torch.cat(losses).cpu().numpy()
    peak = _peak_memory(torch)
    print(f"dvgo: {3 * K} steps of DVGO's step at {R}^3 x {dvgo.CHANNELS}, {B} rays x {S} "
          f"samples ({B * S} points a step) through make_multi_step in {secs:.3f} s (eager "
          f"chunks {eager}, graph replays {replays}); loss {losses[0]:.6f} (step 1) -> "
          f"{losses[-1]:.6f} (step {3 * K}); peak memory {peak}; launches {launches}",
          flush=True)
    if (eager, replays) != (1, 2):
        _fail(f"dvgo: {eager} eager chunks and {replays} graph replays, expected 1 and 2")
    for name, got in launches.items():
        if got != 3 * K:
            _fail(f"dvgo: {name} launched {got} times in {3 * K} steps")
    if not np.isfinite(losses).all():
        _fail(f"dvgo: a loss is not finite: {losses}")
    # One more step, eager, with the scatter's and the MLP's inputs recorded.
    seen = {}
    scatter, mlp_fwd, mlp_bwd = tg.trilinear_scatter_grad, dvgo.rgbnet_forward, dvgo.rgbnet_backward

    def recording(ct, mn, mx, res, pts):
        seen.update(ct=ct.clone(), mn=mn, mx=mx, res=res, pts=pts.clone())
        return scatter(ct, mn, mx, res, pts)

    def recording_fwd(k0, emb, coloured, params, save=True):
        seen.update(vals=k0._base.detach().clone(), emb=emb.clone(), coloured=coloured.clone())
        return mlp_fwd(k0, emb, coloured, params, save)

    def recording_bwd(gc, saved, params):
        seen.update(g=gc.clone())
        return mlp_bwd(gc, saved, params)

    tg.trilinear_scatter_grad = recording
    dvgo.rgbnet_forward, dvgo.rgbnet_backward = recording_fwd, recording_bwd
    try:
        ix = torch.arange(3 * K * B, n, device=dev)
        dvgo.dvgo_train_step(state, cfg, o[ix], d[ix], rgb[ix], generator=g)
        torch.cuda.synchronize()
    finally:
        tg.trilinear_scatter_grad = scatter
        dvgo.rgbnet_forward, dvgo.rgbnet_backward = mlp_fwd, mlp_bwd
    ct, mn, mx, res, pts = (seen[k] for k in ("ct", "mn", "mx", "res", "pts"))
    if ct.shape != (B * S, dvgo.CHANNELS) or res != (R,) * 3:
        _fail(f"dvgo: the step scattered {tuple(ct.shape)} cotangents into {res}")
    del o, d, rgb, multi
    mlp = _check_rgbnet(torch, [p.detach() for p in state.params], seen.pop("vals"),
                        seen.pop("emb"), seen.pop("coloured"), seen.pop("g"))
    vals = state.grid.grid.detach()
    vol = vals.permute(3, 0, 1, 2).unsqueeze(0).contiguous()
    fwd = _trilinear_shape(torch, "dvgo", vals, vol, mn, mx, pts)
    del vol
    err = _scatter_bits(torch, "dvgo step", ct, mn, mx, res, pts)
    row = dict(shape="dvgo", N=B * S, max_abs_err=err)
    row.update(_times(torch, lambda: tg.trilinear_scatter_grad(ct, mn, mx, res, pts), 20))
    row.update(_times(torch, lambda: tg.trilinear_scatter_grad_plain(ct, mn, mx, res, pts), 3,
                      "plain_"))
    C = dvgo.CHANNELS
    row["bound_ms"] = (4 * C * R ** 3 + 4 * C * B * S + 12 * B * S + 24) / H100_BYTES_PER_S * 1e3
    print(f"kernel trilinear_grad_kernel dvgo grid {R}^3x{C} N={B * S}: max_abs_err={err:.3g} "
          f"bound_ms={row['bound_ms']:.4f}; " + _fmt_times(row), flush=True)
    del state, ct, pts, vals
    torch.cuda.empty_cache()
    return {"trilinear_kernel": dict(fwd, launches=launches["trilinear_kernel"]),
            "trilinear_grad_kernel": dict(row, launches=launches["trilinear_grad_kernel"]),
            **{name: dict(r, launches=launches[name]) for name, r in mlp.items()}}


def _mlp_chain(torch, x, params, g=None):
    """The colour MLP as cuBLAS products and eager passes over the rows of
    x (R, 39): the forward, and with the colours' cotangent ``g`` (R, 3)
    the backward of the dense path that the kernels replaced (the leaves'
    gradients and the 12 k0 columns of the input's)."""
    w1, b1, w2, b2, w3, b3 = params
    h1 = torch.addmm(b1, x, w1.t()).relu_()
    h2 = torch.addmm(b2, h1, w2.t()).relu_()
    c = torch.sigmoid(torch.addmm(b3, h2, w3.t()))
    if g is None:
        return c
    gl = g * (1 - c) * c
    gw3, gb3 = gl.t().mm(h2), gl.sum(0)
    gh = torch.ops.aten.threshold_backward(gl.mm(w3), h2, 0.0)
    gw2, gb2 = gh.t().mm(h1), gh.sum(0)
    gh = torch.ops.aten.threshold_backward(gh.mm(w2), h1, 0.0)
    return gh.mm(w1[:, :12]), gh.t().mm(x), gh.sum(0), gw2, gb2, gw3, gb3


def _check_rgbnet(torch, params, vals, emb, coloured, g) -> dict:
    """The colour MLP's kernels on one DVGO step's own coloured rows and
    colour cotangents: forward (the compaction with it) and backward
    against the plain version on the card, two runs bit for bit, each
    timed beside its FLOP bound, the plain version, cuBLAS over the same
    compacted rows with the count known on the host, and cuBLAS over every
    sample. Returns the rgbnet_forward_kernel and rgbnet_backward_kernel
    rows."""
    from tpu3d_torch.kernels import rgbnet as K

    k0 = vals[:, 1:]
    R, S = k0.shape[0], k0.shape[0] // emb.shape[0]
    mask = coloured.reshape(-1)
    n = int(mask.sum())
    c, count, saved = K.rgbnet_forward(k0, emb, coloured, params, True)
    gk0, grads = K.rgbnet_backward(g, saved, params)
    c2, count2, saved2 = K.rgbnet_forward(k0, emb, coloured, params, True)
    gk02, grads2 = K.rgbnet_backward(g, saved2, params)
    torch.cuda.synchronize()
    bits = (torch.equal(c, c2) and torch.equal(gk0, gk02)
            and all(torch.equal(a, b) for a, b in zip(grads, grads2)))
    want_c, _, want_saved = K.rgbnet_forward_plain(k0, emb, coloured, params)
    want_gk0, want_grads = K.rgbnet_backward_plain(g, want_saved, params)
    err_c = float((c - want_c).abs().max())
    err_gk0 = float((gk0 - want_gk0).abs().max()) / max(float(want_gk0.abs().max()), 1e-30)
    err_w = max(float((a - b).norm()) / max(float(b.norm()), 1e-30)
                for a, b in zip(grads, want_grads))
    zeros = bool((c[~mask].view(torch.int32) == 0).all()
                 and (gk0[~mask].view(torch.int32) == 0).all())
    del c2, saved2, gk02, grads2, want_saved, want_c, want_gk0, want_grads
    print(f"rgbnet: {n} of {R} rows coloured ({100 * n / R:.2f}%, count {int(count)}): against "
          f"the plain version c max_abs_err={err_c:.3g}, gk0 {err_gk0:.3g} of its largest, the "
          f"leaves' gradients {err_w:.3g} of their norm (worst); +0 at every uncoloured row "
          f"{'yes' if zeros else 'NO'}; two runs bit for bit {'yes' if bits else 'NO'}",
          flush=True)
    if not (bits and zeros and int(count) == n and err_c <= 2e-6 and err_gk0 <= 1e-4
            and err_w <= 1e-4):
        _fail("rgbnet: the kernels do not match the plain version")
    del c, gk0, grads
    fwd_flops, bwd_flops = n * RGBNET_FWD_FLOPS, n * RGBNET_BWD_FLOPS
    rows = K.compact(coloured)[0][:n].long()
    x = torch.cat([k0[rows], emb[rows // S]], -1)
    gr = g[rows].contiguous()
    x_dense = torch.cat([k0, emb[:, None, :].expand(-1, S, -1).reshape(R, -1)], -1)
    out = {}
    for name, bound, fns in (
            ("rgbnet_forward_kernel", fwd_flops,
             (lambda: K.rgbnet_forward(k0, emb, coloured, params, True),
              lambda: K.rgbnet_forward_plain(k0, emb, coloured, params),
              lambda: _mlp_chain(torch, x, params), lambda: _mlp_chain(torch, x_dense, params))),
            ("rgbnet_backward_kernel", bwd_flops,
             (lambda: K.rgbnet_backward(g, saved, params),
              lambda: K.rgbnet_backward_plain(g, K.rgbnet_forward_plain(
                  k0, emb, coloured, params)[2], params),
              lambda: _mlp_chain(torch, x, params, gr),
              lambda: _mlp_chain(torch, x_dense, params, g)))):
        row = dict(name=name, route="cuda", source="tpu3d_torch/csrc/rgbnet.cu", replaces=None,
                   bound_by="operations", max_abs_err=err_c if "forward" in name else err_gk0,
                   shape="dvgo", N=R, rows=n, bound_ms=bound / H100_FP32_FLOPS * 1e3)
        for prefix, fn in zip(("", "plain_", "library_", "dense_"), fns):
            row.update(_times(torch, fn, 5, prefix))
        out[name] = row
        dense = row["dense_ms"]
        print(f"kernel {name} dvgo {R // S}x{S} ({n} rows coloured): bound_ms="
              f"{row['bound_ms']:.4f} ({100 * row['bound_ms'] / row['ms']:.1f}% of it); "
              + _fmt_times(row) + f"; dense (cuBLAS over all {R} rows) device "
              f"{'not measured' if dense is None else f'{dense:.4f}'} ms / wall "
              f"{row['dense_wall_ms']:.4f} ms", flush=True)
        torch.cuda.empty_cache()
    print("kernel rgbnet (backward includes the plain forward in its plain time; the "
          "library and dense rows' backward includes their forward)", flush=True)
    return out


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
    row = dict(_times(torch, lambda: od.orient_desc_samples(*args), 50),
               **_times(torch, lambda: od.orient_desc_samples_plain(*args), 3, "plain_"),
               **_NO_LIBRARY)
    ms = row["ms"] or row["wall_ms"]
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
          f"picked {n_flip}; bound_ms={bound_ms:.4f} "
          f"(touched texels {texels}; every corner of every sample once "
          f"{per_sample_bytes / H100_BYTES_PER_S * 1e3:.4f} ms; "
          f"{nbytes / ms / 1e6:.0f} GB/s); " + _fmt_times(row), flush=True)
    return dict(row, name="orient_desc_kernel", route="cuda",
                source="tpu3d_torch/csrc/orient_desc.cu",
                replaces="tpu3d/kernels/orient_desc.py:214", max_abs_err=max_err,
                bound_ms=bound_ms,
                bound_by="bytes" if nbytes / H100_BYTES_PER_S >= flops / H100_FP32_FLOPS
                else "operations")


def _check_rmsprop(torch, dev) -> dict:
    """rmsprop_kernel against its plain version at the detail grid's
    shape (256^3 x 28), on the same inputs on the card, the lr a 0-d device
    tensor: nu bit for bit, p within one ulp (the largest difference in
    ulps is printed), and a second launch on copies of the inputs the same
    bits. The timed calls update one set of tensors in place (the same
    bytes whatever the values)."""
    from tpu3d_torch.kernels.rmsprop import rmsprop_update, rmsprop_update_plain

    shape, decay, eps = (256, 256, 256, 28), 0.95, 1e-8
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    g = torch.randn(shape, generator=gen, device=dev) * 1e-2
    g[::7] = 0.0
    p0 = torch.randn(shape, generator=gen, device=dev) * 0.3
    nu0 = torch.rand(shape, generator=gen, device=dev) * 1e-4
    lr = torch.tensor(1e-2, device=dev)
    p, nu = p0.clone(), nu0.clone()
    rmsprop_update_plain(p, g, nu, lr, decay, eps)
    outs = []
    for _ in range(2):
        pk, nk = p0.clone(), nu0.clone()
        rmsprop_update(pk, g, nk, lr, decay, eps)
        outs.append((pk, nk))
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    pk, nk = outs[0]
    ulp = torch.nextafter(p.abs(), torch.tensor(float("inf"), device=dev)) - p.abs()
    p_ulps = float(((pk - p).abs() / ulp).max())
    nu_equal, p_equal = torch.equal(nk, nu), torch.equal(pk, p)
    err = float((pk - p).abs().max())
    if not (same and nu_equal and p_ulps <= 1.0):
        _fail(f"rmsprop_kernel: two launches bit for bit {same}, nu bit for bit {nu_equal}, "
              f"p within {p_ulps} ulp (1 allowed)")
    row = dict(_times(torch, lambda: rmsprop_update(p, g, nu, lr, decay, eps), 10),
               **_times(torch, lambda: rmsprop_update_plain(p, g, nu, lr, decay, eps), 3,
                        "plain_"), **_NO_LIBRARY)
    # Bound, by bytes: g, nu and p read once, nu and p written once.
    nbytes = 5 * 4 * g.numel()
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    ms = row["ms"] or row["wall_ms"]
    print(f"kernel rmsprop_kernel grid {'x'.join(map(str, shape))}: against the plain version "
          f"on the card nu bit for bit {'yes' if nu_equal else 'NO'}, p bit for bit "
          f"{'yes' if p_equal else 'no'} (max_abs_err={err:.3g}, {p_ulps:g} ulp); two launches "
          f"bit for bit {'yes' if same else 'NO'}; bound_ms={bound_ms:.4f} "
          f"({nbytes / ms / 1e6:.0f} GB/s); " + _fmt_times(row), flush=True)
    return dict(row, name="rmsprop_kernel", route="cuda", source="tpu3d_torch/csrc/rmsprop.cu",
                replaces=None, max_abs_err=err, bound_ms=bound_ms, bound_by="bytes")


def _shade_inputs(torch, dev, n, S, cascade):
    """A render chunk's trilinear output as shade_composite takes it: raw
    channels (N(0, 1) SH; densities |N(0, 1)| times 0.01 to 30 by ray), in-box
    flags (a quarter out), sorted depths, unit directions, a per-ray
    background, and a cascade base's channels and flags."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def values():
        v = torch.randn((n, S, 28), generator=gen, device=dev)
        scale = torch.tensor([0.01, 0.3, 3.0, 30.0], device=dev)[torch.arange(n, device=dev) % 4]
        v[..., 0] = torch.randn((n, S), generator=gen, device=dev).abs() * scale[:, None]
        return v.reshape(n * S, 28), (torch.rand((n * S,), generator=gen, device=dev) > 0.25)

    vals, in_b = values()
    z = torch.sort(torch.rand((n, S), generator=gen, device=dev) * 4 + 0.5, dim=-1).values
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen, device=dev), dim=-1)
    bg = torch.rand((n, 3), generator=gen, device=dev)
    bvals, bin_b = values() if cascade else (None, None)
    return vals, in_b, z, d, bg, bvals, bin_b


def _check_shade_composite(torch, dev) -> dict:
    """shade_composite_kernel at a render chunk's shape (8,192 rays x 192
    samples, a per-ray background), on one grid's values and on a
    cascade's: against the eager path it replaces on the card (render
    parity, 1e-5 a pixel; dense/render.py's _sample composition, _shade,
    composite), against the plain version run on the card (bit for bit, or
    the largest gap), and two launches bit for bit. Timed against the eager
    path, which the row reports as its plain version."""
    from tpu3d_torch.dense.render import _dirs, _shade, composite
    from tpu3d_torch.kernels.shade_composite import shade_composite, shade_composite_plain

    n, S = DENSE_CHUNK, 192

    def eager(vals, in_b, z, d, bg, bvals, bin_b):
        if bvals is not None:
            vals = bvals * bin_b[:, None] + vals * in_b[:, None]
            in_b = torch.ones_like(in_b)
        sigma, rgb = _shade(vals, in_b, _dirs(d, S))
        return composite(sigma.reshape(n, S), rgb.reshape(n, S, 3), z, True, bg)

    rows = []
    for cascade in (False, True):
        args = _shade_inputs(torch, dev, n, S, cascade)
        vals, in_b, z, d, bg, bvals, bin_b = args
        got = shade_composite(vals, in_b, z, d, True, bg, bvals, bin_b)
        again = shade_composite(vals, in_b, z, d, True, bg, bvals, bin_b)
        ref = eager(*args)
        plain = shade_composite_plain(vals, in_b, z, d, True, bg, bvals, bin_b)
        torch.cuda.synchronize()
        same, err = torch.equal(got, again), float((got - ref).abs().max())
        plain_gap = float((got - plain).abs().max())
        if not (same and err <= 1e-5):
            _fail(f"shade_composite_kernel ({'cascade' if cascade else 'grid'}): two launches "
                  f"bit for bit {same}, max |kernel - eager| {err:.3g} (1e-5 allowed)")
        row = dict(_times(torch, lambda: shade_composite(vals, in_b, z, d, True, bg, bvals,
                                                         bin_b), 10),
                   **_times(torch, lambda: eager(*args), 3, "plain_"), **_NO_LIBRARY)
        # Bound, by bytes: a sample's 28 channels, in-box flag and depth (the
        # base's channels and flag besides), a ray's direction, background
        # and colour, each once.
        nbytes = n * S * (4 * 28 + 1 + 4 + (4 * 28 + 1 if cascade else 0)) + n * 3 * 4 * 3
        row.update(bound_ms=nbytes / H100_BYTES_PER_S * 1e3, max_abs_err=err,
                   shape=f"{n}x{S}{' cascade' if cascade else ''}")
        ms = row["ms"] or row["wall_ms"]
        print(f"kernel shade_composite_kernel {row['shape']}: against the eager path on the "
              f"card max_abs_err={err:.3g}; against the plain version on the card "
              f"{'bit for bit' if plain_gap == 0 else f'max gap {plain_gap:.3g}'}; two launches "
              f"bit for bit {'yes' if same else 'NO'}; bound_ms={row['bound_ms']:.4f} "
              f"({nbytes / ms / 1e6:.0f} GB/s, {row['bound_ms'] / ms:.1%} of the bound); "
              + _fmt_times(row).replace("plain device", "eager device"), flush=True)
        rows.append(row)
    first = rows[0]
    return dict(first, name="shade_composite_kernel", route="cuda",
                source="tpu3d_torch/csrc/shade_composite.cu", replaces=None, bound_by="bytes",
                max_abs_err=max(r["max_abs_err"] for r in rows),
                shapes=[{"S": S, "N": n, **{k: r[k] for k in ("shape", "max_abs_err", "ms",
                                                               "wall_ms", "host_us", "plain_ms",
                                                               "bound_ms")}}
                        for r in rows])


def _check_view_rays(torch, dev) -> dict:
    """view_rays_kernel at a render cell's view (1936 x 1296 at stride 2:
    627,264 rays): against its plain version run on the card (bit for bit)
    and numpy view_rays (directions within 4 ulp of 1, and whether bit for
    bit, as they are where numpy's sgemm is an fma chain; origins bit for bit),
    two launches bit for bit. Timed against what the card path replaces,
    numpy view_rays and the upload of its two arrays, which the row
    reports as its plain version."""
    from tpu3d_torch.dense.eval import view_pose
    from tpu3d_torch.dense.eval import view_rays as numpy_rays
    from tpu3d_torch.dense.train import SceneNormalization
    from tpu3d_torch.kernels.view_rays import view_rays, view_rays_plain

    H, W, stride = 1296, 1936, 2
    cam, focal = np.array([0.3, -0.7, 0.2, 0.4, -1.1, 3.2]), 0.9 * W
    norm = SceneNormalization(np.array([0.3, -0.2, 0.9], np.float32), 2.7)
    R, o = view_pose(cam, norm)
    got = view_rays(R, o, H, W, focal, stride, dev)
    again = view_rays(R, o, H, W, focal, stride, dev)
    plain = view_rays_plain(R, o, H, W, focal, stride, dev)
    torch.cuda.synchronize()
    o_np, d_np = numpy_rays(cam, H, W, focal, norm, stride)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    p_equal = all(torch.equal(a, b) for a, b in zip(got, plain))
    err = float(np.abs(got[1].cpu().numpy() - d_np).max())
    n_equal = np.array_equal(got[1].cpu().numpy(), d_np)
    o_equal = np.array_equal(got[0].cpu().numpy(), o_np)
    if not (same and p_equal and o_equal and err <= 4 * 2.0 ** -23):
        _fail(f"view_rays_kernel: two launches bit for bit {same}, against the plain version "
              f"{p_equal}, origins as numpy's {o_equal}, max |dir - numpy| {err:.3g} "
              f"(4 ulp of 1 allowed)")

    def replaced():
        ro, rd = numpy_rays(cam, H, W, focal, norm, stride)
        return torch.from_numpy(ro).to(dev), torch.from_numpy(rd).to(dev)

    row = dict(_times(torch, lambda: view_rays(R, o, H, W, focal, stride, dev), 20),
               **_times(torch, replaced, 3, "plain_"), **_NO_LIBRARY)
    n = len(range(0, H, stride)) * len(range(0, W, stride))
    nbytes = n * 2 * 3 * 4          # each ray's origin and direction, written once
    row.update(bound_ms=nbytes / H100_BYTES_PER_S * 1e3, max_abs_err=err,
               shape=f"{H}x{W}/{stride} ({n} rays)")
    ms = row["ms"] or row["wall_ms"]
    print(f"kernel view_rays_kernel {row['shape']}: against the plain version on the card "
          f"bit for bit {'yes' if p_equal else 'NO'}; against numpy view_rays max_abs_err="
          f"{err:.3g} (bit for bit {'yes' if n_equal else 'no'}), origins bit for bit "
          f"{'yes' if o_equal else 'NO'}; two launches bit for "
          f"bit {'yes' if same else 'NO'}; bound_ms={row['bound_ms']:.4f} "
          f"({nbytes / ms / 1e6:.0f} GB/s, {row['bound_ms'] / ms:.1%} of the bound); "
          + _fmt_times(row).replace("plain device", "numpy build + upload device"), flush=True)
    return dict(row, name="view_rays_kernel", route="cuda", source="tpu3d_torch/csrc/view_rays.cu",
                replaces=None, bound_by="bytes")


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


def _build_native() -> None:
    """Phase 2's second half: g++ builds the native track store from the
    checkout; a failed build raises, and the library must then load."""
    from tpu3d_torch import native
    from tpu3d_torch.native import build as native_build

    t0 = time.time()
    path = native_build.build(verbose=False)
    if not native.available():
        _fail(f"build: the native track store built at {path} does not load")
    print(f"build: native track store {native.library_path()} in {time.time() - t0:.1f} s",
          flush=True)


@contextlib.contextmanager
def _capture_local_ba(store: list):
    """Record the problems of the engine's batched local BA call with the
    most problems (their host arrays, as the engine stacks them)."""
    from tpu3d_torch.sfm import engine as E

    orig = E.stack_ba_problems

    def recording(problems):
        if len(problems) > len(store[0] if store else ()):
            store[:] = [[tuple(np.copy(a) for a in p) for p in problems]]
        return orig(problems)

    E.stack_ba_problems = recording
    try:
        yield
    finally:
        E.stack_ba_problems = orig


def _sync_calls(torch, fn):
    """(fn(), the synchronizing CUDA calls it made): torch's sync debug mode
    warns at each one (a read-back, a blocking copy, a synchronize)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum(1 for w in caught if "synchroniz" in str(w.message))


def _check_local_ba_batch(torch, dev, problems) -> None:
    """One registration chunk's local BA problems from the full run, solved
    on the card batched and one by one with the engine's arguments: per
    problem the same iterations, cameras and points within 1e-5, cost
    within 1e-5 relative; two batched runs bit-identical; at most LM steps
    + 2 synchronizing calls per solve (the stop rules run on the card)."""
    from tpu3d_torch.ba.lm import bundle_adjust, bundle_adjust_batch
    from tpu3d_torch.config import BAConfig
    from tpu3d_torch.sfm.engine import stack_ba_problems

    kw = dict(max_iters=BAConfig.max_iters // 2, cg_iters=8, stall_tol=1e-4)
    if len(problems) < 2:
        _fail(f"local BA (batched): the full run's largest chunk held {len(problems)} problems")
    stacked = [torch.from_numpy(a).to(dev) for a in stack_ba_problems(problems)]
    solo_args = [[torch.from_numpy(a).to(dev) for a in p] for p in problems]
    runs = []
    for _ in range(2):
        t0 = time.time()
        st, syncs = _sync_calls(torch, lambda: bundle_adjust_batch(*stacked, **kw))
        torch.cuda.synchronize()
        runs.append((st, syncs, time.time() - t0))
    # the second run's count: the first one's includes the card's one-time set-up
    (st, first_syncs, batch_s), (st2, syncs, _) = runs
    same = all(torch.equal(getattr(st, k), getattr(st2, k))
               for k in ("cams", "points", "cost", "lam", "n_iters"))
    iters = st.n_iters.tolist()
    steps = max(iters)
    t0 = time.time()
    solos = [_sync_calls(torch, lambda a=a: bundle_adjust(*a, **kw)) for a in solo_args]
    torch.cuda.synchronize()
    solo_s = time.time() - t0
    worst = {"cams": 0.0, "points": 0.0, "cost": 0.0}
    for b, (p, (s, s_syncs)) in enumerate(zip(problems, solos)):
        C, P = len(p[0]), len(p[1])
        worst["cams"] = max(worst["cams"], (st.cams[b, :C] - s.cams).abs().max().item())
        worst["points"] = max(worst["points"], (st.points[b, :P] - s.points).abs().max().item())
        worst["cost"] = max(worst["cost"], abs(st.cost[b].item() - s.cost.item())
                            / max(s.cost.item(), 1e-30))
        if s.n_iters != iters[b]:
            _fail(f"local BA (batched): problem {b} took {iters[b]} iterations batched, "
                  f"{s.n_iters} alone")
        if s_syncs > s.n_iters + 2:
            _fail(f"local BA (one by one): problem {b} made {s_syncs} synchronizing calls for "
                  f"{s.n_iters} LM steps (limit steps + 2)")
    sizes = [(len(p[0]), len(p[1]), len(p[2])) for p in problems]
    print(f"local BA (batched vs one by one): {len(problems)} problems (cameras, points, "
          f"observations) {sizes}; iterations {iters}, the same alone; max difference cameras "
          f"{worst['cams']:.3g} points {worst['points']:.3g} cost {worst['cost']:.3g} relative "
          f"(limits 1e-5); two batched runs bit-identical: {'yes' if same else 'no'}; "
          f"synchronizing calls batched {syncs} for {steps} LM steps (the first run "
          f"{first_syncs}), one by one "
          f"{[n for _, n in solos]} for {[s.n_iters for s, _ in solos]}; wall batched "
          f"{batch_s * 1e3:.1f} ms, one by one {solo_s * 1e3:.1f} ms", flush=True)
    if not same:
        _fail("local BA (batched): two runs on the card differ")
    if max(worst.values()) > 1e-5:
        _fail(f"local BA (batched): differs from the solves one by one by {worst} (limit 1e-5)")
    if syncs > steps + 2:
        _fail(f"local BA (batched): {syncs} synchronizing calls for {steps} LM steps "
              "(limit steps + 2)")


def _run_trace(torch, dev, scene, root: Path) -> None:
    """cli full from the scene's arrays through the CLI's traced runner (what
    ``--trace T`` does; the command line needs image files, and the card's
    machine has no image decoder): T must hold the command's span and the
    pipeline's four stage spans."""
    from tpu3d_torch import cli
    from tpu3d_torch.utils import trace

    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    trace._GLOBAL = None
    path = root / "full_trace.json"
    cli.traced("full", lambda: cli.full((scene["gray"], scene["rgb"]), str(root / "art"),
                                        _full_config(scene), device=dev),
               trace=str(path), device="cuda")
    events = json.loads(path.read_text())["traceEvents"]
    names = [e["name"] for e in events]
    print("full (trace): spans " + ", ".join(f"{e['name']} {e['dur'] / 1e6:.3f} s {e['args']}"
                                            for e in events), flush=True)
    shutil.rmtree(root, ignore_errors=True)
    if names != ["extract", "retrieve", "match", "reconstruct", "full"]:
        _fail(f"full (trace): spans {names}, not the command's and the four stages'")


def _run_full(torch, dev, scene) -> dict:
    """reconstruct on the card twice (split descriptor, then fused), each
    with the launch counts set to 0 just before it and read just after.
    Returns the fused run's launches."""
    from tpu3d_torch import native
    from tpu3d_torch.kernels import LAUNCHES, reset_launches
    from tpu3d_torch.sfm import pipeline as P
    from tpu3d_torch.utils import dispatch

    base = _full_config(scene)
    runs = {}
    chunk: list = []
    for name, fused in (("split", None), ("fused", True)):
        cfg = dataclasses.replace(base, frontend=dataclasses.replace(base.frontend,
                                                                   fused_descriptor=fused))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        reset_launches()
        dispatch.reset()
        native.reset_calls()
        t0 = time.time()
        with _capture_local_ba(chunk if name == "split" else []):
            rec, secs = P.reconstruct((scene["gray"], scene["rgb"]), cfg, verbose=False,
                                      device=dev)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(LAUNCHES)
        counts = dispatch.snapshot()
        calls = dict(native.CALLS)
        peak = torch.cuda.max_memory_allocated()
        timers = dict(P.LAST_SFM_TIMERS)
        reg = rec.registered
        cen, rot = _align(rec.cams, scene["R"][reg], scene["t"][reg])
        runs[name] = dict(registered=len(reg), reproj=rec.mean_reproj_px, launches=launches)
        same = (len(reg), len(rec.points), rec.num_obs,
                f"{rec.mean_reproj_px:.4f}") == PR5_FULL_SPLIT
        print(f"full ({name} descriptor): {wall:.3f} s; stage s "
              f"{ {k: round(v, 3) for k, v in secs.items()} }; engine s {timers}; registered "
              f"{len(reg)}/{N_VIEWS} (tpu3d on the CPU {TPU3D_CPU_REGISTERED}), points "
              f"{len(rec.points)}, observations {rec.num_obs}, mean reprojection "
              f"{rec.mean_reproj_px:.4f} px; camera centre error / spread median "
              f"{np.median(cen):.3g} max {cen.max():.3g}; rotation error median "
              f"{np.median(rot):.4f} max {rot.max():.4f} deg; peak memory "
              f"{peak / 2**30:.2f} GiB; launches {launches}; registered, points, "
              f"observations and reprojection as PR 5's split run {PR5_FULL_SPLIT}: "
              f"{'yes' if same else 'no'}; dispatches {counts}; local BA "
              f"{timers['calls'].get('local_ba', 0)} batched solves of "
              f"{timers['calls'].get('local_ba_problems', 0)} problems; native track store "
              f"calls {calls}", flush=True)
        if min(calls.values()) <= 0:
            _fail(f"full ({name}): the track store or the engine did not take the native "
                  f"path (calls {calls})")
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
    _check_local_ba_batch(torch, dev, chunk[0] if chunk else [])
    return fused


def _profile_reconstruct(torch, dev, scene, mode: str = "incremental") -> None:
    """The split run's stages once more; its reconstruct stage (in ``mode``)
    under torch.profiler: wall, device busy share, the engine's host share
    and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu3d_torch.sfm import pipeline as P

    cfg = _full_config(scene)
    feats = P.run_extraction((scene["gray"], scene["rgb"]), cfg, verbose=False, device=dev)
    adj = P.run_retrieval(feats, cfg, device=dev)
    regs, ts = P.run_matching(feats, adj, cfg, verbose=False, device=dev)
    run = P.run_global_reconstruction if mode == "global" else P.run_reconstruction
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run(feats, regs, ts, cfg, verbose=False, adj=adj, device=dev)
        torch.cuda.synchronize()
        wall = time.time() - t0
    timers = dict(P.LAST_SFM_TIMERS)
    per_kernel = _device_ms(prof)
    busy = sum(per_kernel.values())
    n_kernels = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False))
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    label = "" if mode == "incremental" else f" ({mode})"
    print(f"profile reconstruct{label}: wall {wall:.3f} s (profiled), device busy {busy:.1f} ms "
          f"({busy / (wall * 1e3):.1%}), {n_kernels} device events; engine host "
          f"{timers['host']} s ({timers['host'] / wall:.1%} of the wall), timers {timers}; "
          "top kernels: "
          + "; ".join(f"{k[:60]} {v:.2f} ms" for k, v in top), flush=True)


def _check_artifacts(art: Path) -> None:
    """Each staged command's files exist and hold tpu3d's keys; export
    wrote the reference's output/ files (the codebook where joblib is
    installed)."""
    import importlib.util

    for name, want in STAGED_KEYS.items():
        path = art / name
        if not path.exists():
            _fail(f"sfm (staged): {name} was not written")
        if name.endswith(".npz"):
            with np.load(path) as z:
                keys = set(z.files)
        else:
            keys = set(json.loads(path.read_text()))
        if not want <= keys:
            _fail(f"sfm (staged): {name} lacks {sorted(want - keys)}")
    files = EXPORT_FILES + (("bow_codebook.plk",) if importlib.util.find_spec("joblib") else ())
    missing = [f for f in files if not (art / "output" / f).exists()]
    if missing:
        _fail(f"sfm (export): {missing} not written")


def _run_sfm(torch, dev, scene, root: Path) -> None:
    """The port's SfM entry points on the 24-view scene from arrays, each
    path with the launch counts set to 0 just before it and read just
    after: (a) the staged functions extract -> match -> reconstruct
    (from_matches, incremental) -> export into ``root``, held equal to the
    one-process run; (b) reconstruct(mode="global"), then its reconstruct
    stage under torch.profiler; (c) full with register_all and the
    edge-consistency gate; (d) refine_focal on (a)'s one-process
    observations."""
    from tpu3d_torch import cli
    from tpu3d_torch.ba.focal import refine_focal
    from tpu3d_torch.kernels import LAUNCHES, reset_launches
    from tpu3d_torch.sfm import pipeline as P
    from tpu3d_torch.utils import dispatch

    cfg = _full_config(scene)
    images = (scene["gray"], scene["rgb"])
    shutil.rmtree(root, ignore_errors=True)
    art = root / "staged"

    def run(fn):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t0, torch.cuda.max_memory_allocated() / 2**30

    def launched(label, launches):
        for name in SLICE_KERNELS:
            if launches[name] <= 0:
                _fail(f"sfm ({label}): {name} was not launched")

    # (a) the staged path, then the one-process run it must equal
    reset_launches()
    secs = {}
    for name, fn in (("extract", lambda: cli.extract(images, str(art), cfg, device=dev)),
                     ("match", lambda: cli.match(str(art), cfg, device=dev)),
                     ("reconstruct", lambda: cli.reconstruct(str(art), cfg, from_matches=True,
                                                             device=dev)),
                     ("export", lambda: cli.export(str(art), device=dev))):
        out, secs[name], peak = run(fn)
        if name == "reconstruct":
            staged = out
    launches = dict(LAUNCHES)
    launched("staged", launches)
    _check_artifacts(art)
    with np.load(art / "reconstruction.npz") as z:
        staged_reg = z["registered"]
    (rec, _), one_s, _ = run(lambda: P.reconstruct(images, cfg, verbose=False, device=dev))
    same = (np.array_equal(staged_reg, rec.registered) and staged["points"] == len(rec.points)
            and staged["mean_reproj_px"] == rec.mean_reproj_px)
    print(f"sfm (staged): stage s { {k: round(v, 3) for k, v in secs.items()} }; registered "
          f"{staged['registered']}/{N_VIEWS}, points {staged['points']}, mean reprojection "
          f"{staged['mean_reproj_px']:.6f} px; one-process run ({one_s:.3f} s) registered "
          f"{len(rec.registered)}, points {len(rec.points)}, mean reprojection "
          f"{rec.mean_reproj_px:.6f} px; equal: {'yes' if same else 'no'}; artifacts and "
          f"export files present; launches {launches}", flush=True)
    if not same:
        _fail("sfm (staged): the staged path's registered set, points or mean reprojection "
              "differ from the one-process run's on the same card")

    # (b) global mode
    reset_launches()
    dispatch.reset()
    (grec, gsecs), g_s, g_peak = run(lambda: P.reconstruct(images, cfg, verbose=False,
                                                           mode="global", device=dev))
    glaunches = dict(LAUNCHES)
    gcounts = dispatch.snapshot()
    timers = dict(P.LAST_SFM_TIMERS)
    reg = grec.registered
    cen, rot = _align(grec.cams, scene["R"][reg], scene["t"][reg])
    print(f"sfm (global): {g_s:.3f} s; stage s { {k: round(v, 3) for k, v in gsecs.items()} }; "
          f"pose graph component {timers['pose_graph_component']}/{N_VIEWS}; registered "
          f"{len(reg)}/{N_VIEWS} (tpu3d on the CPU {TPU3D_CPU_GLOBAL_REGISTERED}), points "
          f"{len(grec.points)}, observations {grec.num_obs}, mean reprojection "
          f"{grec.mean_reproj_px:.6f} px (limit {MAX_GLOBAL_REPROJ_PX}); camera centre error "
          f"/ spread median {np.median(cen):.3g} max {cen.max():.3g}; rotation error median "
          f"{np.median(rot):.4f} max {rot.max():.4f} deg; peak memory {g_peak:.2f} GiB; "
          f"engine s {timers}; launches {glaunches}; dispatches {gcounts} "
          f"({gcounts.get('ba_readback', 0)} BA read-backs over "
          f"{timers['calls']['global_ba']} global and {timers['calls']['windowed_ba']} windowed "
          "BA calls and the local BA)", flush=True)
    launched("global", glaunches)
    if len(reg) < TPU3D_CPU_GLOBAL_REGISTERED - 1:
        _fail(f"sfm (global): {len(reg)} cameras registered < {TPU3D_CPU_GLOBAL_REGISTERED} "
              "- 1 (tpu3d on the CPU)")
    if not grec.mean_reproj_px <= MAX_GLOBAL_REPROJ_PX:
        _fail(f"sfm (global): mean reprojection {grec.mean_reproj_px:.6f} px > "
              f"{MAX_GLOBAL_REPROJ_PX} (tpu3d's worst over three seeds + twice their spread)")
    _profile_reconstruct(torch, dev, scene, mode="global")

    # (c) both options on
    opts = dataclasses.replace(cfg, sfm=dataclasses.replace(cfg.sfm, register_all=True,
                                                            edge_consistency_gate=True))
    reset_launches()
    summary, o_s, _ = run(lambda: cli.full(images, str(root / "options"), opts, device=dev))
    olaunches = dict(LAUNCHES)
    dropped = P.LAST_SFM_TIMERS["edge_gate_dropped"]
    with np.load(root / "options" / "reconstruction.npz") as z:
        ocams, opoints, oreg = z["cams"], z["points"], z["registered"]
    ometa = json.loads((root / "options" / "reconstruction_meta.json").read_text())
    low = ometa["low_confidence_names"]
    as_staged = np.array_equal(oreg, staged_reg)
    print(f"sfm (register_all + edge gate): {o_s:.3f} s; edge gate dropped {dropped}, "
          f"low-confidence {len(low)} {low}; registered {summary['registered']}/{N_VIEWS} "
          f"(the staged run's set: {'yes' if as_staged else 'no'}), points {summary['points']}, "
          f"mean reprojection {summary['mean_reproj_px']:.6f} px; launches {olaunches}",
          flush=True)
    launched("options", olaunches)
    if not (np.isfinite(summary["mean_reproj_px"]) and np.isfinite(ocams).all()
            and np.isfinite(opoints).all()):
        _fail("sfm (register_all + edge gate): reprojection error, poses or points not finite")

    # (d) refine_focal on the one-process run's final observations
    f_true = scene["focal"]
    fixed = np.zeros(len(rec.cams), np.float32)
    fixed[0] = 1.0
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        rec.cams, rec.points, rec.obs_cam, rec.obs_point, rec.obs_uv_px,
        np.ones(len(rec.obs_cam), np.float32), fixed)]
    iters = 24
    dispatch.reset()
    (f, st), f_s, f_peak = run(lambda: refine_focal(*args, focal0=FOCAL_START * f_true,
                                                    iters=iters))
    readbacks = dispatch.snapshot().get("ba_readback", 0)
    err = abs(f - f_true) / f_true
    print(f"sfm (refine_focal): {len(rec.cams)} cameras, {len(rec.points)} points, "
          f"{len(rec.obs_cam)} observations; start {FOCAL_START * f_true:.3f}, refined "
          f"{f:.4f} against the scene's {f_true:.4f} (error {err:.4%}, limit "
          f"{MAX_FOCAL_ERR:.0%}); {iters + 4} BA solves in {f_s:.3f} s, {readbacks} BA "
          f"read-backs ({readbacks / (iters + 4):.1f} a solve); final cost "
          f"{float(st.cost):.6g}; peak memory {f_peak:.2f} GiB", flush=True)
    if not err <= MAX_FOCAL_ERR:
        _fail(f"sfm (refine_focal): focal {f:.4f} more than {MAX_FOCAL_ERR:.0%} from "
              f"{f_true:.4f}")
    shutil.rmtree(root, ignore_errors=True)


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
    # densify_eval_only's views take host rays (its core split reads
    # them); each view rendered here builds its rays on the card.
    eval_rays, launches["view_rays_kernel"] = launches["view_rays_kernel"], \
        LAUNCHES["view_rays_kernel"]
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
    for name in ("trilinear_kernel", "shade_composite_kernel"):
        if launches[name] != want:
            _fail(f"{name} launched {launches[name]} times on the dense path, expected {want}")
    if eval_rays != 0 or launches["view_rays_kernel"] != len(views) + 1:
        _fail(f"view_rays_kernel launched {eval_rays} times by densify_eval_only (expected 0) "
              f"and {launches['view_rays_kernel']} by {len(views) + 1} views (one each)")
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
    peak = _peak_memory(torch)
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
          f"{TPU3D_CPU_TRAIN_PSNR}); {_chunks(LAST_TRAIN_AUX['phases'][-1])}; peak memory "
          f"{peak}; launches {launches}", flush=True)
    _check_replays("train", LAST_TRAIN_AUX["phases"])
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


def _step_groups(per_kernel: dict, steps: int) -> dict:
    """Device ms per step by kernel family, from _device_ms over ``steps``
    steps."""
    groups = {"trilinear_kernel": 0.0, "trilinear_grad_kernel": 0.0, "fill": 0.0,
              "adam": 0.0, "rmsprop": 0.0, "other": 0.0}
    for name, ms in per_kernel.items():
        low = name.lower()
        key = ("trilinear_grad_kernel" if "trilinear_grad" in name
               else "trilinear_kernel" if "trilinear_kernel" in name
               else "adam" if "adam" in low
               else "rmsprop" if "rmsprop" in low
               else "fill" if "fill" in low or "memset" in low else "other")
        groups[key] += ms / steps
    return groups


def _fmt_groups(groups: dict) -> str:
    return (f"forward trilinear_kernel {groups['trilinear_kernel']:.3f}, scatter "
            f"trilinear_grad_keys + trilinear_grad_kernel {groups['trilinear_grad_kernel']:.3f} "
            f"(its sort and offsets under other), fills {groups['fill']:.3f}, Adam "
            f"{groups['adam']:.3f}, RMSprop {groups['rmsprop']:.3f}, elementwise and other "
            f"{groups['other']:.3f}")


def _profile_train_step(torch, dev, cfg, ds, label="train step", res=None, box=None,
                        base=None, sdf=False, occ=None) -> None:
    """Training steps at the train phase's shapes (or a ``res`` grid over
    ``box``, trained against a cascade ``base`` or guided by an occupancy
    grid ``occ``; the SDF step with ``sdf``) on three fresh states from one
    seed: two stepped by the eager loop (one step call at a time), one by
    make_multi_step in chunks of cfg.scan_chunk (a CUDA graph: its first
    chunk is the warm-up, run eagerly, its second captured and replayed).

    - After two chunks, the second eager run against the first, and the
      graph against the eager loop: losses, grid and optimizer state bit
      for bit (every sum in the step has a fixed order, the scatter's too),
      with the largest difference printed beside.
    - GRAPH_TURNS chunks of each in turns, eager then graph: ms per step
      (CUDA events around the chunk) and host ms per chunk (the host clock
      before the synchronize: the enqueue).
    - One eager step and one replayed chunk under torch.profiler, the
      device time per step split by kernel family."""
    from torch.profiler import ProfilerActivity, profile

    from tpu3d_torch import f32_scope
    from tpu3d_torch.dense.grid import create_grid
    from tpu3d_torch.dense.train import init_state, make_multi_step, sdf_train_step, train_step

    s = cfg.scene_scale
    lo, hi = box or ((-s,) * 3, (s,) * 3)
    B, K = cfg.batch_size, cfg.scan_chunk
    spe = len(ds.origins) // B
    step_fn = sdf_train_step if sdf else train_step
    kw = {} if sdf else {"base": base, "occ": occ}
    o, d, c = (torch.from_numpy(a).to(dev) for a in (ds.origins, ds.dirs, ds.rgb))
    rows = torch.arange(spe * B, device=dev)

    def block(i):
        b = i * K % (spe - K + 1)
        return rows[b * B:(b + K) * B].view(K, B)

    def fresh():
        st = init_state(cfg, create_grid(res or cfg.grid_resolution, lo, hi, device=dev), spe)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        return st, gen

    (eager, e_gen), (again, a_gen), (graph, g_gen) = fresh(), fresh(), fresh()
    multi = make_multi_step(step_fn, with_occ=not sdf)

    def eager_chunk(i, st=eager, gen=e_gen):
        return torch.stack([step_fn(st, cfg, o[ix], d[ix], c[ix], generator=gen, **kw)
                            for ix in block(i)])

    def graph_chunk(i):
        return multi(graph, cfg, block(i), o, d, c, generator=g_gen, **kw)

    def profiled(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.time()
            fn()
            torch.cuda.synchronize()
            wall = time.time() - t1
        return _device_ms(prof), wall

    def state_tensors(st):
        p = st.grid.grid
        return [p] + [v for v in st.optimizer.state[p].values() if v.dim()]

    def compare(got, ref):
        """(max |diff|, bit for bit) over pairs."""
        return (max((g - r).abs().max().item() for g, r in zip(got, ref)),
                all(torch.equal(g.view(torch.int32), r.view(torch.int32))
                    for g, r in zip(got, ref)))

    with f32_scope():
        losses = [(graph_chunk(i), eager_chunk(i), eager_chunk(i, again, a_gen))
                  for i in range(2)]
        torch.cuda.synchronize()
        loss_cmp = compare([g for g, _, _ in losses], [e for _, e, _ in losses])
        state_cmp = compare(state_tensors(graph), state_tensors(eager))
        floor_cmp = compare(state_tensors(again), state_tensors(eager))
        n_state = sum(t.numel() for t in state_tensors(eager))
        del again
        ms, host = {"graph": [], "eager": []}, {"graph": [], "eager": []}
        for i in range(2, 2 + GRAPH_TURNS):
            for name, fn in (("eager", eager_chunk), ("graph", graph_chunk)):
                torch.cuda.synchronize()
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                t1 = time.perf_counter()
                fn(i)
                host[name].append((time.perf_counter() - t1) * 1e3)
                b.record()
                b.synchronize()
                ms[name].append(a.elapsed_time(b) / K)
        i = 2 + GRAPH_TURNS
        ix = block(i)[0]
        per_kernel, wall = profiled(lambda: step_fn(eager, cfg, o[ix], d[ix], c[ix],
                                                    generator=e_gen, **kw))
        g_kernel, g_wall = profiled(lambda: graph_chunk(i))
    replays, captures = multi.replays, multi.capture_seconds
    multi.release()
    del eager, graph, multi, losses
    torch.cuda.empty_cache()
    busy, g_busy = sum(per_kernel.values()), sum(g_kernel.values())
    r = lambda xs: [round(x, 3) for x in xs]  # noqa: E731
    yes = {True: "yes", False: "NO"}
    print(f"profile {label}: eager loop {r(ms['eager'])} ms per step, graph replays "
          f"{r(ms['graph'])} (CUDA events around a chunk of {K}, in turns); host ms per chunk "
          f"eager {r(host['eager'])}, graph {r(host['graph'])} (enqueue); capture "
          f"{r(captures)} s; {replays} replays; after 2 chunks, bit for bit: "
          f"{yes[loss_cmp[1] and state_cmp[1] and floor_cmp[1]]} (graph against the eager "
          f"loop: losses {yes[loss_cmp[1]]} max |diff| {loss_cmp[0]:.3e}, grid and optimizer "
          f"state ({n_state} values) {yes[state_cmp[1]]} {state_cmp[0]:.3e}; the two eager "
          f"runs {yes[floor_cmp[1]]} {floor_cmp[0]:.3e})", flush=True)
    if not (loss_cmp[1] and state_cmp[1] and floor_cmp[1]):
        _fail(f"{label}: after 2 chunks not bit for bit: graph against the eager loop losses "
              f"{loss_cmp}, state {state_cmp}; the two eager runs {floor_cmp}")
    if busy == 0.0 or g_busy == 0.0:
        print(f"profile {label}: device time not measured (the profiler recorded no CUDA "
              f"activity: eager {busy}, graph {g_busy})", flush=True)
        return
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    print(f"profile {label}: one eager step profiled: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy:.2f} ms ({busy / (wall * 1e3):.1%}); device ms: "
          + _fmt_groups(_step_groups(per_kernel, 1)) + "; top kernels: "
          + "; ".join(f"{k[:70]} {v:.3f} ms" for k, v in top), flush=True)
    print(f"profile {label} (graph): one replayed chunk of {K} profiled: wall "
          f"{g_wall * 1e3:.1f} ms, device busy {g_busy:.2f} ms ({g_busy / (g_wall * 1e3):.1%}), "
          f"{g_busy / K:.3f} ms a step; device ms per step: "
          + _fmt_groups(_step_groups(g_kernel, K)), flush=True)


@contextlib.contextmanager
def _train_calls():
    """Collects LAST_TRAIN_AUX after each train_plenoxel call that densify
    makes (the base, then a cascade's detail phase)."""
    from tpu3d_torch import cli
    from tpu3d_torch.dense.train import LAST_TRAIN_AUX

    real, calls = cli.train_plenoxel, []

    def record(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(dict(LAST_TRAIN_AUX))
        return out

    cli.train_plenoxel = record
    try:
        yield calls
    finally:
        cli.train_plenoxel = real


def _peak_memory(torch) -> str:
    """The peak device memory since the last reset: allocated, and reserved
    (the caching allocator's segments, the graphs' pools among them)."""
    return (f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated, "
            f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB reserved")


def _chunks(phase: dict) -> str:
    """How a training phase ran its chunks of steps."""
    return (f"chunks: {phase['replays']} graph replays, {phase['eager_chunks']} eager, "
            f"captures {[round(x, 3) for x in phase['capture_seconds']]} s")


def _check_replays(label: str, phases: list) -> None:
    """Every training phase replayed a graph at least once: a run that
    silently steps eagerly fails."""
    for p in phases:
        if p["replays"] < 1:
            _fail(f"{label}: the {p['phase']} phase replayed no graph ({_chunks(p)})")


def _phase_summary(phase: dict, batch: int) -> str:
    """One training phase: grid, steps, rays/s between its second and last
    logged steps (the first pays for warm-up), first and last logged loss,
    how its chunks ran."""
    log = phase["log"]
    a, b = log[min(1, len(log) - 1)], log[-1]
    rate = ((b["update"] - a["update"]) * batch / (b["seconds"] - a["seconds"])
            if b["update"] > a["update"] else float("nan"))
    return (f"{phase['phase']} {'x'.join(map(str, phase['res']))}: {phase['steps']} steps, "
            f"{rate:.0f} rays/s, loss {log[0]['loss']:.5f} -> {b['loss']:.5f} "
            f"({phase['seconds']:.3f} s; {_chunks(phase)})")


def _check_phases(label: str, phases: list, psnrs, same_rays=None) -> None:
    """Every loss and PSNR finite, and each phase's last logged loss below
    its first. A phase named in ``same_rays`` ({phase: (PSNR before, PSNR
    after)} on one fixed set of its training rays) must raise that PSNR
    instead: its logged losses are single batches, whose spread hides a
    phase that lowers its loss by less than the batches differ."""
    _check_replays(label, phases)
    same_rays = same_rays or {}
    losses = [e["loss"] for p in phases for e in p["log"]]
    if not np.all(np.isfinite(losses + list(psnrs) + [v for b in same_rays.values() for v in b])):
        _fail(f"{label}: a loss or PSNR is not finite: {losses}, {list(psnrs)}, {same_rays}")
    for p in phases:
        if p["phase"] in same_rays:
            before, after = same_rays[p["phase"]]
            if not after > before:
                _fail(f"{label}: the {p['phase']} phase did not raise its training rays' PSNR "
                      f"({before} dB before, {after} after)")
        elif not p["log"][-1]["loss"] < p["log"][0]["loss"]:
            _fail(f"{label}: the {p['phase']} phase's last logged loss "
                  f"{p['log'][-1]['loss']} is not below its first {p['log'][0]['loss']}")


def _eval_chunks(n_views: int) -> int:
    """trilinear_kernel launches of evaluate_views over n_views views at
    stride 2 in chunks of DENSE_CHUNK rays, per grid it samples."""
    n_rays = len(range(0, HEIGHT, 2)) * len(range(0, WIDTH, 2))
    return n_views * -(-n_rays // DENSE_CHUNK)


def _run_recipe(torch, dev, scene, root, cfg, ds) -> dict:
    """densify at RECIPE_FLAGS on the card (coarse, fine, then the
    cascade's detail phase, then the pair's held-out evaluation), with the
    launch counts set to 0 just before it and read just after; then the
    fine phase's grid alone scored on the same views, and one profiled
    step of each phase at its shapes (``cfg``, ``ds``: _recipe_inputs)."""
    from tpu3d_torch.cli import densify
    from tpu3d_torch.config import DenseConfig
    from tpu3d_torch.dense.eval import evaluate_views, split_views_by_name
    from tpu3d_torch.dense.grid import grid_from_tpu3d
    from tpu3d_torch.dense.train import SceneNormalization
    from tpu3d_torch.io.artifacts import ArtifactStore
    from tpu3d_torch.kernels import LAUNCHES, reset_launches

    names = [f"img_{i:03d}.png" for i in range(N_VIEWS)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    with _train_calls() as calls:
        out = densify(root, scene["rgb"], names, scene["focal"], no_checkpoint=True,
                      final_grid=True, log_every=TRAIN_LOG_EVERY, device=dev, **RECIPE_FLAGS)
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = dict(LAUNCHES)
    peak = _peak_memory(torch)
    phases = calls[0]["phases"] + calls[1]["phases"]
    steps = {p["phase"]: p["steps"] for p in phases}
    store = ArtifactStore(root)
    dm = store.load_json("dense_meta")
    base, bg_sh = grid_from_tpu3d(store.load("dense_grid"), dev)
    cams = store.load("reconstruction")["cams"]
    train_idx, test_idx = split_views_by_name(names, 8)
    cfg = DenseConfig(near=dm["near"], far=dm["far"], num_samples=dm["num_samples"],
                      per_ray_aabb=dm["per_ray_aabb"], contraction=dm["contraction"])
    norm = SceneNormalization(np.asarray(dm["norm_center"], np.float32), dm["norm_scale"])
    ev = evaluate_views(base, cams[test_idx], scene["rgb"][test_idx], scene["focal"], cfg, norm,
                        stride=2, bg_sh=bg_sh)
    fine_psnr = float(ev["mean_psnr"])
    cd = dm["cascade_detail"]
    # The detail phase starts from a zero grid, i.e. from the base's render:
    # the training views at the training stride (the rays it trained on)
    # scored with the base alone and with base + detail.
    detail, _ = grid_from_tpu3d(store.load("dense_grid_detail"), dev)
    tr = [evaluate_views(g, cams[train_idx], scene["rgb"][train_idx], scene["focal"], cfg, norm,
                         stride=RECIPE_FLAGS["ray_stride"], bg_sh=bg_sh, base_grid=b)
          for g, b in ((base, None), (detail, base))]
    tr_gain = [y - x for x, y in zip(tr[0]["per_view"], tr[1]["per_view"])]
    want = {"trilinear_kernel": 2 * steps["coarse"] + 2 * steps["fine"] + 4 * steps["detail"]
            + 2 * _eval_chunks(len(out["test_view_names"])),
            "trilinear_grad_kernel": sum(steps.values()), "rmsprop_kernel": steps["detail"]}
    print(f"recipe: densify {secs:.3f} s (three phases, grid saves and the pair's eval); "
          + "; ".join(_phase_summary(p, 2048) for p in phases)
          + f"; detail grid {cd['res']} over {np.round(cd['min_bound'], 4).tolist()}.."
          f"{np.round(cd['max_bound'], 4).tolist()}; band near {dm['near']:.4f} far "
          f"{dm['far']:.4f}; PSNR views {out['test_view_names']}: fine grid alone "
          f"{[round(float(p), 4) for p in ev['per_view']]} mean {fine_psnr:.4f} dB (tpu3d on the "
          f"CPU {TPU3D_CPU_RECIPE_PSNR}), base + detail {out['test_psnr_per_view']} mean "
          f"{out['test_psnr']:.4f} dB (tpu3d on the CPU {TPU3D_CPU_CASCADE_PSNR}); detail phase "
          f"on its training rays ({len(train_idx)} views, every {RECIPE_FLAGS['ray_stride']}th "
          f"pixel): base alone {tr[0]['mean_psnr']:.6f} dB, base + detail "
          f"{tr[1]['mean_psnr']:.6f} ({tr[1]['mean_psnr'] - tr[0]['mean_psnr']:+.6f}; "
          f"{sum(g > 0 for g in tr_gain)} of {len(tr_gain)} views higher); peak memory "
          f"{peak}; launches {launches} (derived from the steps {want})",
          flush=True)
    for name, n in want.items():
        if launches[name] != n:
            _fail(f"recipe: {name} launched {launches[name]} times, expected {n} from the steps "
                  f"{steps} and the eval")
    _check_phases("recipe", phases, [fine_psnr, out["test_psnr"], *out["test_psnr_per_view"]],
                  same_rays={"detail": (float(tr[0]["mean_psnr"]), float(tr[1]["mean_psnr"]))})
    if not abs(fine_psnr - TPU3D_CPU_RECIPE_PSNR) <= MAX_RECIPE_PSNR_DIFF_DB:
        _fail(f"recipe: the fine grid's mean PSNR {fine_psnr:.4f} dB is not within "
              f"{MAX_RECIPE_PSNR_DIFF_DB} dB of tpu3d's {TPU3D_CPU_RECIPE_PSNR}")
    if not abs(out["test_psnr"] - TPU3D_CPU_CASCADE_PSNR) <= MAX_CASCADE_PSNR_DIFF_DB:
        _fail(f"recipe: the pair's mean PSNR {out['test_psnr']:.4f} dB is not within "
              f"{MAX_CASCADE_PSNR_DIFF_DB} dB of tpu3d's {TPU3D_CPU_CASCADE_PSNR}")
    box = ((-2.0,) * 3, (2.0,) * 3)
    for label, res, phase_box, optimizer, b in (
            ("coarse", 128, box, "adam", None), ("fine", 256, box, "adam", None),
            ("detail", cd["res"], (cd["min_bound"], cd["max_bound"]), "rmsprop", base)):
        _profile_train_step(torch, dev, dataclasses.replace(cfg, optimizer=optimizer), ds,
                            f"recipe {label} step", res, phase_box, b)
    return launches


def _tpu3d_refresh_steps(steps_per_epoch: int, epochs: int, chunk: int, every: int,
                         gate_epoch: int, kept_steps: int) -> list:
    """The global steps at which tpu3d's loop refreshes the occupancy grid
    (tpu3d/dense/train.py:823-868): the first scan-chunk boundary at or
    after each multiple of ``every``; the chunks restart each epoch, over
    ``kept_steps`` steps from the camera gate's epoch on."""
    out, step, due = [], 0, every
    for epoch in range(epochs):
        n = kept_steps if epoch >= gate_epoch else steps_per_epoch
        for b in range(0, n, chunk):
            if step >= due:
                out.append(step)
                due += every
            step += min(chunk, n - b)
    return out


def _run_options(torch, dev, scene, root) -> dict:
    """densify at OPTIONS_FLAGS on the card (occupancy refreshes, the camera
    gate, the held-out evaluation), with the launch counts set to 0 just
    before it and read just after; then one held-out view rendered with
    and without occupancy pruning, the run's step profiled, and a
    --rays-pkl run."""
    from tpu3d_torch.cli import densify, densify_from_rays
    from tpu3d_torch.config import DenseConfig
    from tpu3d_torch.dense.eval import dataset_from_views, split_views_by_name, view_rays
    from tpu3d_torch.dense.grid import grid_from_tpu3d
    from tpu3d_torch.dense.occupancy import occupancy_from_grid
    from tpu3d_torch.dense.render import render_image
    from tpu3d_torch.dense.train import LAST_TRAIN_AUX, SceneNormalization, psnr
    from tpu3d_torch.io.artifacts import ArtifactStore
    from tpu3d_torch.io.raydata import save_ray_dataset
    from tpu3d_torch.kernels import LAUNCHES, reset_launches

    names = [f"img_{i:03d}.png" for i in range(N_VIEWS)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    with _train_calls() as calls:
        out = densify(root, scene["rgb"], names, scene["focal"], no_checkpoint=True,
                      final_grid=True, log_every=TRAIN_LOG_EVERY, device=dev, **OPTIONS_FLAGS)
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = dict(LAUNCHES)
    peak = _peak_memory(torch)
    aux = calls[0]
    gate, refreshes = aux["camera_gate"], aux["occupancy_refreshes"]
    store = ArtifactStore(root)
    dm = store.load_json("dense_meta")
    cams = store.load("reconstruction")["cams"]
    train_idx, test_idx = split_views_by_name(names, 8)
    per_view = len(range(0, HEIGHT, OPTIONS_FLAGS["ray_stride"])) * len(
        range(0, WIDTH, OPTIONS_FLAGS["ray_stride"]))
    spe = len(train_idx) * per_view // 2048
    kept = (len(train_idx) - len(gate["dropped"])) * per_view // 2048 if gate else spe
    expect = _tpu3d_refresh_steps(spe, OPTIONS_FLAGS["epochs"], DenseConfig.scan_chunk,
                                  DenseConfig.occupancy_every, OPTIONS_FLAGS["camera_gate_epoch"],
                                  kept)
    probe = len(train_idx) * min(per_view, DenseConfig.camera_gate_probe_rays)
    want = {"trilinear_kernel": 2 * aux["steps"] + -(-probe // 8192)
            + _eval_chunks(len(out["test_view_names"])),
            "trilinear_grad_kernel": aux["steps"]}
    print(f"options: densify {secs:.3f} s; " + _phase_summary(aux["phases"][0], 2048)
          + f"; occupancy refreshes at steps {[r['step'] for r in refreshes]} (tpu3d's cadence "
          f"{expect}) occupied {[round(r['occupied'], 4) for r in refreshes]}; camera gate at "
          f"epoch {gate and gate['epoch']} step {gate and gate['step']}: probe MSE "
          f"{gate and [round(m, 5) for m in gate['probe_mse']]} threshold "
          f"{gate and round(gate['threshold'], 5)}, dropped {out['dropped_cameras']}; PSNR "
          f"{out['test_psnr_per_view']} mean {out['test_psnr']:.4f} dB; peak memory "
          f"{peak}; launches {launches} (derived {want})", flush=True)
    if gate is None:
        _fail("options: the camera gate did not run")
    if [r["step"] for r in refreshes] != expect or OPTIONS_REFRESH_STEP not in expect:
        _fail(f"options: occupancy refreshes at {[r['step'] for r in refreshes]}, tpu3d's "
              f"cadence {expect} (with step {OPTIONS_REFRESH_STEP})")
    for name, n in want.items():
        if launches[name] != n:
            _fail(f"options: {name} launched {launches[name]} times, expected {n}")
    _check_phases("options", aux["phases"], [out["test_psnr"], *out["test_psnr_per_view"]])
    # one held-out view with and without occupancy pruning
    grid, bg_sh = grid_from_tpu3d(store.load("dense_grid"), dev)
    norm = SceneNormalization(np.asarray(dm["norm_center"], np.float32), dm["norm_scale"])
    v = int(test_idx[0])
    ro, rd = (torch.from_numpy(a).to(dev) for a in view_rays(cams[v], HEIGHT, WIDTH,
                                                              scene["focal"], norm, stride=2))
    gt = scene["rgb"][v][::2, ::2].reshape(-1, 3) / 255.0
    views = {}
    for prune in (False, True, False, True):
        torch.cuda.synchronize()
        t1 = time.time()
        img = render_image(grid, ro, rd, dm["near"], dm["far"], dm["num_samples"], chunk=DENSE_CHUNK,
                           clip_aabb=dm["per_ray_aabb"], occ_prune=prune, bg_sh=bg_sh)
        torch.cuda.synchronize()
        views[prune] = (psnr(img.cpu().numpy(), gt), time.time() - t1)
    # the run's step: hierarchical, guided by the trained grid's occupancy
    ocfg = DenseConfig(scene_scale=1.0, near=dm["near"], far=dm["far"], hierarchical=True,
                       occupancy_prune=True)
    _profile_train_step(torch, dev, ocfg, dataset_from_views(
        cams, scene["rgb"], scene["focal"], train_idx, norm, stride=OPTIONS_FLAGS["ray_stride"]),
        "options step", occ=occupancy_from_grid(grid.grid, ocfg.occupancy_factor))
    # --rays-pkl: the same views' rays at every 16th pixel, in the run's frame
    train = dataset_from_views(cams, scene["rgb"], scene["focal"], train_idx, norm,
                               stride=RAYS_PKL_STRIDE)
    test = dataset_from_views(cams, scene["rgb"], scene["focal"], test_idx, norm,
                              stride=RAYS_PKL_STRIDE)
    save_ray_dataset(str(Path(root) / "train_rays.npy"), train)
    save_ray_dataset(str(Path(root) / "test_rays.npy"), test)
    t1 = time.time()
    rp = densify_from_rays(str(Path(root) / "rays"), str(Path(root) / "train_rays.npy"),
                           test_rays_pkl=str(Path(root) / "test_rays.npy"), near=dm["near"],
                           far=dm["far"], epochs=RAYS_PKL_EPOCHS, no_checkpoint=True,
                           device=dev)
    rp_phases = LAST_TRAIN_AUX["phases"]
    print(f"options: view {names[v]} PSNR unpruned {views[False][0]:.4f} dB in "
          f"{views[False][1]:.3f} s, occupancy-pruned {views[True][0]:.4f} dB in "
          f"{views[True][1]:.3f} s; --rays-pkl ({len(train.origins)} rays, {RAYS_PKL_EPOCHS} "
          f"epochs, {time.time() - t1:.3f} s): loss {rp['final_loss']:.5f}, test PSNR "
          f"{rp['test_psnr']:.4f} dB over {len(test.origins)} rays; {_chunks(rp_phases[-1])}",
          flush=True)
    _check_replays("options (--rays-pkl)", rp_phases)
    if not np.all(np.isfinite([*views[False], *views[True], rp["final_loss"],
                               rp["test_psnr"]])):
        _fail(f"options: the pruned render or the rays-pkl run is not finite: {views}, {rp}")
    return launches


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
    # one mutual top-2 launch per block of pairs: the gated edges, then any
    # pairs the 2-hop rescue matched afresh
    per = cfg.matching.pair_batch
    blocks = -(-timers["n_edges"] // per) + -(-timers.get("rescue_fresh", 0) // per)
    if launches["top2_kernel"] != blocks:
        _fail(f"top2_kernel launched {launches['top2_kernel']} times for {blocks} blocks "
              "of pairs (one launch per block)")
    errs = rotation_errors_deg(regs, scene["R"])
    n_edges = sum(len(r.edges) for r in regs)
    kpts = feats.valid.sum(axis=1)
    print(f"slice: extract {secs['extract']:.3f} s, retrieve {secs['retrieve']:.3f} s, "
          f"match {secs['match']:.3f} s (gate blocks {timers['gate_blocks']:.3f} s); "
          f"keypoints/image min {kpts.min()} median {int(np.median(kpts))}; "
          f"edges gated {timers['n_edges']} ({blocks} blocks); "
          f"images accepted {len(regs)}/{N_VIEWS}; "
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


def _run_sdf(torch, dev, scene, root) -> dict:
    """Phase 11: densify --model sdf on the card from a fresh directory
    holding only the scene's reconstruction, at tpu3d's default width, with
    the launch counts set to 0 just before it and read just after; then its
    held-out evaluation with the training band (in densify), one profiled
    SDF step, cli mesh on the saved mesh_grid, and voxel_traversal on the
    card against the CPU."""
    from tpu3d_torch.cli import densify, mesh
    from tpu3d_torch.dense import voxel_traversal
    from tpu3d_torch.dense.sdf import ray_aabb
    from tpu3d_torch.dense.train import LAST_TRAIN_AUX
    from tpu3d_torch.kernels import LAUNCHES, reset_launches

    names = [f"img_{i:03d}.png" for i in range(N_VIEWS)]
    shutil.rmtree(root, ignore_errors=True)
    make_reconstruction_artifacts(root, scene)
    cfg, ds = _train_inputs(root, scene)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    out = densify(root, scene["rgb"], names, scene["focal"], model="sdf",
                  ray_stride=TRAIN_RAY_STRIDE, no_checkpoint=True, final_grid=True,
                  log_every=TRAIN_LOG_EVERY, device=dev)
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = dict(LAUNCHES)
    peak = _peak_memory(torch)
    log, steps = LAST_TRAIN_AUX["log"], LAST_TRAIN_AUX["steps"]
    at10 = next(e for e in log if e["step"] == TRAIN_LOG_EVERY)
    rays_s = (log[-1]["step"] - at10["step"]) * 2048 / (log[-1]["seconds"] - at10["seconds"])
    first, last = log[0]["loss"], log[-1]["loss"]
    mean = float(out["test_psnr"])
    eval_launches = _eval_chunks(len(out["test_view_names"]))
    print(f"sdf: densify --model sdf {secs:.3f} s (training, grid save and eval); {steps} "
          f"steps, {rays_s:.0f} rays/s over steps {at10['step']}-{log[-1]['step']}; loss "
          f"{first:.5f} (step 0) -> {last:.5f} (step {log[-1]['step']}); views "
          f"{out['test_view_names']} PSNR {out['test_psnr_per_view']} mean {mean:.4f} dB "
          f"(tpu3d's grid on the CPU: {TPU3D_SDF_PORT_SCORED_PSNR} by the port's scorer, limit "
          f"{MAX_SDF_PSNR_DIFF_DB} dB; {TPU3D_CPU_SDF_PSNR} by tpu3d's); "
          f"{_chunks(LAST_TRAIN_AUX['phases'][-1])}; peak memory {peak}; launches {launches} "
          f"(expected trilinear {steps} + {eval_launches}, scatter {steps})", flush=True)
    _check_replays("sdf", LAST_TRAIN_AUX["phases"])
    if launches["trilinear_grad_kernel"] != steps:
        _fail(f"sdf: trilinear_grad_kernel launched {launches['trilinear_grad_kernel']} times "
              f"in {steps} steps")
    if launches["trilinear_kernel"] != steps + eval_launches:
        _fail(f"sdf: trilinear_kernel launched {launches['trilinear_kernel']} times, expected "
              f"{steps} steps + {eval_launches} eval chunks")
    if not all(np.isfinite([first, last, *out["test_psnr_per_view"]])):
        _fail(f"sdf: loss or PSNR not finite: {first}, {last}, {out['test_psnr_per_view']}")
    if not last < first:
        _fail(f"sdf: the last logged loss {last} is not below the first {first}")
    if not abs(mean - TPU3D_SDF_PORT_SCORED_PSNR) <= MAX_SDF_PSNR_DIFF_DB:
        _fail(f"sdf: mean PSNR {mean:.4f} dB is not within {MAX_SDF_PSNR_DIFF_DB} dB of "
              f"tpu3d's grid's {TPU3D_SDF_PORT_SCORED_PSNR} (the port's scorer)")
    _profile_train_step(torch, dev, cfg, ds, label="sdf step", sdf=True)

    t0 = time.time()
    m = mesh(root, out=str(Path(root) / "mesh.ply"))
    print(f"sdf (mesh): {m['vertices']} vertices, {m['faces']} faces, iso {m['iso']}, "
          f"{time.time() - t0:.3f} s (host numpy over the {DENSE_RES}^3 mesh_grid)", flush=True)
    if m["vertices"] <= 0 or m["faces"] <= 0:
        _fail(f"sdf (mesh): empty mesh {m}")

    n = TRAVERSAL_RAYS
    o, d = (torch.from_numpy(a[:n]).to(dev) for a in (ds.origins, ds.dirs))
    lo = torch.full((3,), -cfg.scene_scale, device=dev)
    hi = torch.full((3,), cfg.scene_scale, device=dev)
    t_near, t_far, _ = ray_aabb(o, d, lo, hi)
    vs = 2.0 * cfg.scene_scale / DENSE_RES
    res = (DENSE_RES,) * 3
    torch.cuda.synchronize()
    t0 = time.time()
    got = voxel_traversal(o, d, t_near, t_far, lo, vs, res, TRAVERSAL_STEPS)
    torch.cuda.synchronize()
    t_card = time.time() - t0
    t0 = time.time()
    ref = voxel_traversal(*(x.cpu() for x in (o, d, t_near, t_far, lo)), vs, res,
                          TRAVERSAL_STEPS)
    t_cpu = time.time() - t0
    n_diff = int((got.cpu() != ref).any(dim=-1).sum())
    visited = int((ref[..., 0] >= 0).sum())
    print(f"sdf (traversal): {n} rays x {TRAVERSAL_STEPS} steps on the {DENSE_RES}^3 grid; "
          f"{visited} voxels visited; card {t_card:.3f} s, CPU {t_cpu:.3f} s; slots that "
          f"differ {n_diff}", flush=True)
    if n_diff or visited == 0:
        _fail(f"sdf (traversal): {n_diff} slots differ from the CPU's, {visited} visited")
    return launches


def _learned_weights(torch, root: Path) -> dict:
    """Seeded random weights for DISK, SuperPoint and LightGlue (9 layers,
    width 256, 4 heads, input 128: DISK's descriptors), each written as a
    tpu3d-layout .npz under ``root``."""
    from tpu3d_torch.features.disk import DiskUNet
    from tpu3d_torch.features.learned import save_params_npz, tree_from_state_dict
    from tpu3d_torch.features.superpoint import SuperPointNet
    from tpu3d_torch.matching.lightglue import LightGlue

    root.mkdir(parents=True, exist_ok=True)
    paths = {}
    for k, (name, make) in enumerate((("disk", DiskUNet), ("superpoint", SuperPointNet),
                                      ("lightglue", lambda: LightGlue(128, 256, 9, 4)))):
        torch.manual_seed(LEARNED_SEED + k)
        paths[name] = str(root / f"{name}.npz")
        save_params_npz(paths[name], tree_from_state_dict(make().state_dict()))
    return paths


def _learned_config(scene, frontend="classical", weights="", matcher="mnn", m_weights=""):
    base = _full_config(scene)
    return dataclasses.replace(
        base, frontend=dataclasses.replace(base.frontend, model=frontend, weights=weights),
        matching=dataclasses.replace(base.matching, matcher=matcher, weights=m_weights))


def _padded_batch(torch, dev, scene, n):
    """The first ``n`` views as DISK reads them: RGB in [0, 1], zero-padded
    to multiples of 16 (976 x 656), (n, Hp, Wp, 3) on ``dev``."""
    hp, wp = -(-HEIGHT // 16) * 16, -(-WIDTH // 16) * 16
    img = torch.zeros((n, hp, wp, 3), device=dev)
    img[:, :HEIGHT, :WIDTH] = torch.from_numpy(scene["rgb"][:n]).to(dev).float() / 255.0
    return img


def _run_learned(torch, dev, scene, root: Path) -> None:
    """Phase 12: the learned frontends and matcher with seeded random
    weights (the released checkpoints are not in the repository), loaded
    through the config's weights path. (a) DISK and the 9-layer LightGlue
    on the card against the CPU; (b) run_extraction with DISK over the 24
    views; (c) retrieval and matching with LightGlue at pair_batch 32; (d)
    reconstruct with DISK and the mutual-NN matcher (top2 at D = 128); (e)
    SuperPoint and one mutual-NN match block (top2 at D = 256). Each run
    with the launch counts set to 0 just before it and read just after."""
    from torch.profiler import ProfilerActivity, profile

    from tpu3d_torch import f32_scope
    from tpu3d_torch.features.disk import extract_disk
    from tpu3d_torch.features.learned import frontend_module, load_frontend_params
    from tpu3d_torch.kernels import LAUNCHES, reset_launches
    from tpu3d_torch.kernels import distance as dist
    from tpu3d_torch.features.learned import load_matcher_params
    from tpu3d_torch.matching.lightglue import lightglue_from_tpu3d
    from tpu3d_torch.sfm import pipeline as P

    w = _learned_weights(torch, root)
    print(f"learned: weights (seeded, random) {sorted(w)}; tf32 "
          f"cuda.matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32} outside f32_scope", flush=True)

    # (a) the card against the CPU
    disk = frontend_module("disk", load_frontend_params("disk", w["disk"]), dev)
    x = _padded_batch(torch, dev, scene, LEARNED_BATCH)
    with f32_scope(), torch.no_grad():
        t0 = time.time()
        got = disk(x.permute(0, 3, 1, 2))
        torch.cuda.synchronize()
        t_card = time.time() - t0
        t0 = time.time()
        disk_cpu = frontend_module("disk", load_frontend_params("disk", w["disk"]), "cpu")
        ref = disk_cpu(x.cpu().permute(0, 3, 1, 2))
        t_cpu = time.time() - t0
        rel = float((got.cpu() - ref).abs().max()) / float(ref.abs().max())
        fg = extract_disk(disk, x, 2048)
        fc = extract_disk(disk_cpu, x.cpu(), 2048)
        del got, ref
        agree = []
        for b in range(LEARNED_BATCH):
            a = {tuple(p) for p in fg.keypoints[b][fg.valid[b]].cpu().tolist()}
            c = {tuple(p) for p in fc.keypoints[b][fc.valid[b]].tolist()}
            agree.append(len(a & c) / max(len(a | c), 1))
        lg = lightglue_from_tpu3d(load_matcher_params(w["lightglue"]), dev)
        lg_cpu = lightglue_from_tpu3d(load_matcher_params(w["lightglue"]), "cpu")
        size = torch.tensor([[float(WIDTH), float(HEIGHT)]], device=dev)
        args = (fg.keypoints[:1], fg.descriptors[:1], size, fg.keypoints[1:2],
                fg.descriptors[1:2], size, fg.valid[:1].float(), fg.valid[1:2].float())
        s_card = lg(*args)
        s_cpu = lg_cpu(*(a.cpu() for a in args))
        lg_err = float((s_card.cpu() - s_cpu).abs().max())
        lg_scale = float(s_cpu[s_cpu > -1e8].abs().max())     # not the masked -1e9 slots
    del fc, disk_cpu, lg_cpu, s_card, s_cpu
    print(f"learned (card vs CPU): DiskUNet {LEARNED_BATCH} x {x.shape[2]}x{x.shape[1]} map "
          f"max relative error {rel:.3g} (limit {DISK_MAP_REL_TOL}); card {t_card:.3f} s "
          f"(first call), CPU {t_cpu:.3f} s; keypoint sets (2048, valid slots) agree "
          f"{[round(a, 5) for a in agree]} (limit {DISK_KP_AGREE}); LightGlue 9 layers one "
          f"pair K=2048: scores max abs error {lg_err:.3g} over max |score| {lg_scale:.3g} "
          f"(limit {LG_SCORE_REL_TOL} x max(1, max |score|))", flush=True)
    if not rel <= DISK_MAP_REL_TOL:
        _fail(f"learned: DiskUNet map relative error {rel:.3g} > {DISK_MAP_REL_TOL}")
    if not min(agree) >= DISK_KP_AGREE:
        _fail(f"learned: DISK keypoint sets agree {min(agree):.4f} < {DISK_KP_AGREE}")
    if not lg_err <= LG_SCORE_REL_TOL * max(1.0, lg_scale):
        _fail(f"learned: LightGlue scores differ by {lg_err:.3g} > {LG_SCORE_REL_TOL} x "
              f"max(1, {lg_scale:.3g})")
    del disk, lg
    torch.cuda.empty_cache()

    # (b) DISK extraction over the 24 views
    cfg = _learned_config(scene, "disk", w["disk"], "lightglue", w["lightglue"])
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    feats = P.run_extraction((scene["gray"], scene["rgb"]), cfg, verbose=False, device=dev)
    torch.cuda.synchronize()
    secs = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(LAUNCHES)
    kpts = feats.valid.sum(axis=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        P.run_extraction((scene["gray"], scene["rgb"]), cfg, verbose=False, device=dev)
        torch.cuda.synchronize()
        prof_wall = time.time() - t0
    per_kernel = _device_ms(prof)
    n_batches = -(-N_VIEWS // cfg.frontend.batch_size)
    busy = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:5]
    print(f"learned (DISK extract): {N_VIEWS} views {WIDTH}x{HEIGHT} padded to "
          f"{x.shape[2]}x{x.shape[1]}, batch {cfg.frontend.batch_size}: {secs:.3f} s "
          f"(weights load and first calls included); keypoints/image min {kpts.min()} median "
          f"{int(np.median(kpts))} of {cfg.frontend.max_keypoints}; descriptors "
          f"{tuple(feats.descriptors_dev.shape)}; peak memory {peak / 2**30:.2f} GiB; launches "
          f"{launches}; profiled: wall {prof_wall:.3f} s, device {busy:.2f} ms, "
          f"{busy / n_batches:.2f} device ms per batch of {cfg.frontend.batch_size}; top "
          "kernels: " + "; ".join(f"{k[:60]} {v:.2f} ms" for k, v in top), flush=True)
    if kpts.min() <= 0:
        _fail("learned (DISK extract): an image without keypoints")
    del x

    # (c) retrieval and matching with LightGlue
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launches()
    timers, memo = {}, {}
    t0 = time.time()
    adj = P.run_retrieval(feats, cfg, device=dev)
    t_ret = time.time() - t0
    regs, ts = P.run_matching(feats, adj, cfg, verbose=False, memo=memo, device=dev,
                              timers=timers)
    torch.cuda.synchronize()
    secs = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    K = feats.keypoints.shape[1]
    raw = [int((row[:K * 3].reshape(K, 3)[:, 1] > 0).sum()) for row in memo.values()]
    blocks = -(-len(memo) // cfg.matching.pair_batch)
    edges = sorted(memo)[:cfg.matching.pair_batch]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.time()
        P._match_and_gate_block(feats, edges, 0, cfg)
        torch.cuda.synchronize()
        blk_wall = time.time() - t1
    per_kernel = _device_ms(prof)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:5]
    print(f"learned (LightGlue match): retrieval {t_ret:.3f} s; {len(memo)} pairs in {blocks} "
          f"blocks of {cfg.matching.pair_batch}; raw matches per pair median "
          f"{int(np.median(raw))} min {min(raw)} max {max(raw)}; match + retrieval "
          f"{secs:.3f} s, gate blocks {timers['gate_blocks']:.3f} s "
          f"({timers['gate_blocks'] * 1e3 / max(blocks, 1):.1f} ms per block); images "
          f"accepted {len(regs)}/{N_VIEWS}; peak memory {peak / 2**30:.2f} GiB; launches "
          f"{dict(LAUNCHES)}; one block profiled: wall {blk_wall * 1e3:.1f} ms, device "
          f"{sum(per_kernel.values()):.2f} ms; top kernels: "
          + "; ".join(f"{k[:60]} {v:.2f} ms" for k, v in top), flush=True)
    if not memo or not all(np.isfinite(r).all() for r in memo.values()):
        _fail("learned (LightGlue match): no pairs, or a result not finite")
    del feats, memo
    torch.cuda.empty_cache()

    # (d) DISK + the mutual-NN matcher: reconstruct
    cfg = _learned_config(scene, "disk", w["disk"])
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    rec, stage = P.reconstruct((scene["gray"], scene["rgb"]), cfg, verbose=False, device=dev)
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = dict(LAUNCHES)
    print(f"learned (DISK + MNN reconstruct): {secs:.3f} s; stage s "
          f"{ {k: round(v, 3) for k, v in stage.items()} }; registered "
          f"{len(rec.registered)}/{N_VIEWS}, points {len(rec.points)}, mean reprojection "
          f"{rec.mean_reproj_px:.4f} px (random weights: recorded, no limit); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}",
          flush=True)
    if launches["top2_kernel"] <= 0:
        _fail("learned (DISK + MNN): top2_kernel was not launched")

    # (e) SuperPoint + the mutual-NN matcher: one match block at D = 256
    cfg = _learned_config(scene, "superpoint", w["superpoint"])
    feats = P.run_extraction((scene["gray"], scene["rgb"]), cfg, verbose=False, device=dev)
    pairs = sorted(((i, j) for i in range(N_VIEWS) for j in range(i + 1, N_VIEWS)),
                   key=lambda p: (p[1] - p[0], p[0]))[:cfg.matching.pair_batch]
    torch.cuda.synchronize()
    reset_launches()
    P._batch_match_pairs(feats, pairs, cfg, 0, {})
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    d, v = feats.descriptors_dev, feats.valid_dev
    ii = torch.as_tensor([p[0] for p in pairs], device=dev)
    jj = torch.as_tensor([p[1] for p in pairs], device=dev)
    q, k, vq, vk = d[ii], d[jj], v[ii], v[jj]
    best, second, arg, col = dist.mutual_top2(q, k, vq, vk)
    pb, ps_, pa, pc = dist.mutual_top2_plain(q, k, vq, vk)
    cb, cs, _ = dist.descriptor_top2_plain(k, q, vk, vq)
    torch.cuda.synchronize()
    err = max(float((best - pb).abs().max()), float((second - ps_).abs().max()))
    clear = ((pb - ps_) > 1e-5) | (vq == 0)
    cclear = ((cb - cs) > 1e-5) | (vk == 0)
    n_bad = int(((arg != pa) & clear).sum()) + int(((col != pc) & cclear).sum())
    row = dict(_times(torch, lambda: dist.mutual_top2(q, k, vq, vk), 20),
               **_times(torch, lambda: dist.mutual_top2_plain(q, k, vq, vk), 5, "plain_"))
    B, Kq, D = q.shape
    flops = 2.0 * B * Kq * k.shape[1] * D
    bound_ms = flops / H100_FP32_FLOPS * 1e3
    ms = row["ms"] or row["wall_ms"]
    print(f"learned (SuperPoint + MNN): descriptors {tuple(d.shape)}; one block of {B} pairs "
          f"launched top2_kernel {launches['top2_kernel']} time(s); kernel top2_kernel B={B} "
          f"K={Kq} D={D}: max_abs_err={err:.3g} argmax differences where the gap > 1e-5 "
          f"{n_bad}; bound_ms={bound_ms:.4f} ({bound_ms / ms:.0%} of the bound); "
          + _fmt_times(row), flush=True)
    if launches["top2_kernel"] != 1:
        _fail(f"learned (SuperPoint + MNN): top2_kernel launched {launches['top2_kernel']} "
              "times for one block of pairs")
    if not err <= 1e-5 or n_bad:
        _fail(f"learned (SuperPoint + MNN): top2 at D={D} max |err| {err:.3g}, {n_bad} argmax "
              "differences")


# --------------------------------------------------------------------------
# Phase 13: dist/ as torch.distributed. Every rank is a subprocess of this
# script (``--dist-rank``); a rank that fails or runs past DIST_TIMEOUT_S
# fails the phase.


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_ranks(jobs, logdir: Path, timeout: float = DIST_TIMEOUT_S) -> list:
    """Start one process per (argv, env), each writing its output to its own
    file under ``logdir`` (never a pipe, which a rank could fill and then
    block on while another waits for it in a collective), and return each
    rank's DIST_RESULT object. A rank that exits non-zero or prints no
    result, or ranks still running after ``timeout``, fail the phase: every
    rank still running is killed and each rank's last output goes to stderr."""
    import os

    logdir.mkdir(parents=True, exist_ok=True)
    logs = [logdir / f"rank{r}.log" for r in range(len(jobs))]
    procs = []
    for (argv, env), log in zip(jobs, logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(argv, env=dict(os.environ, **env), stdout=f,
                                          stderr=subprocess.STDOUT))
    deadline = time.time() + timeout
    while time.time() < deadline:
        codes = [p.poll() for p in procs]
        if None not in codes or any(c not in (None, 0) for c in codes):
            break
        time.sleep(0.2)
    running = [r for r, p in enumerate(procs) if p.poll() is None]
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    outs = [log.read_text(errors="replace") for log in logs]
    results, why = [], ""
    for r, (p, out) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith("DIST_RESULT ")]
        if r in running:
            why = why or (f"dist: rank {r} still running after {timeout:.0f} s"
                          if time.time() >= deadline else
                          f"dist: rank {r} killed after another rank failed")
        elif p.returncode != 0 or not lines:
            why = f"dist: rank {r} exited {p.returncode} without a result"
        else:
            results.append(json.loads(lines[-1][len("DIST_RESULT "):]))
    if why:
        for r, out in enumerate(outs):
            print(f"--- dist rank {r} (exit {procs[r].returncode}), its last output:\n"
                  f"{out[-6000:]}", file=sys.stderr, flush=True)
        _fail(why)
    return results


def _rank_argv(part: str, ddir: Path, backend: str = "", n_images: int = 0) -> list:
    argv = [sys.executable, str(Path(__file__).resolve()), "--dist-rank", part, "--dist-dir",
            str(ddir)]
    return argv + (["--dist-backend", backend, "--dist-images", str(n_images)]
                   if backend else [])


def _run_dist(torch, dev, scene, root: Path) -> None:
    """Phase 13: (a) densify --mesh 1x1 in a world of one over NCCL, joined
    the way --distributed auto joins (torchrun's environment); (b) two
    ranks on the one card over Gloo with CUDA tensors: the collectives this
    build's Gloo takes on CUDA, the TP 1x2 and DP 2x1 steps against the 1x1
    step, sharded BA, the sharded match block and extract --distributed;
    (c) (b) over NCCL on up to 4 cards where there are two or more."""
    from tpu3d_torch.cli import extract
    from tpu3d_torch.sfm.pipeline import run_extraction

    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    torch.cuda.empty_cache()

    # (a)
    port = _free_port()
    res = _run_ranks([(_rank_argv("a", root / "a"), dict(
        RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
        MASTER_PORT=str(port)))], root / "logs_a")[0]
    log, steps, out = res["log"], res["steps"], res["out"]
    at10 = next(e for e in log if e["step"] == TRAIN_LOG_EVERY)
    per_step = (log[-1]["seconds"] - at10["seconds"]) / (log[-1]["step"] - at10["step"])
    first, last = log[0]["loss"], log[-1]["loss"]
    mean = float(out["test_psnr"])
    n_rays = len(range(0, HEIGHT, 2)) * len(range(0, WIDTH, 2))
    eval_launches = len(out["test_view_names"]) * -(-n_rays // DENSE_CHUNK)
    la = res["launches"]
    print(f"dist (1x1, {res['backend']}, --distributed auto): world {res['world']}; densify "
          f"--mesh 1x1 {res['seconds']:.3f} s; {steps} steps, {2048 / per_step:.0f} rays/s, "
          f"{per_step * 1e3:.3f} ms/step over steps {at10['step']}-{log[-1]['step']}; loss "
          f"{first:.5f} -> {last:.5f}; views {out['test_view_names']} PSNR "
          f"{out['test_psnr_per_view']} mean {mean:.4f} dB (tpu3d train_dense_tp on the CPU "
          f"{TPU3D_CPU_TP_PSNR}); psum {res['psum_bytes'] / 1e6:.3f} MB/step; peak memory "
          f"{res['peak'] / 2**30:.2f} GiB; launches {la}", flush=True)
    if res["backend"] != "nccl" or res["world"] != 1:
        _fail(f"dist (a) ran on {res['backend']} with {res['world']} ranks, not one NCCL rank")
    if not last < first:
        _fail(f"dist (a): the last logged loss {last} is not below the first {first}")
    if not abs(mean - TPU3D_CPU_TP_PSNR) <= MAX_TP_PSNR_DIFF_DB:
        _fail(f"dist (a): mean PSNR {mean:.4f} dB is not within {MAX_TP_PSNR_DIFF_DB} dB of "
              f"tpu3d's {TPU3D_CPU_TP_PSNR}")
    if la["trilinear_kernel"] != eval_launches:
        _fail(f"dist (a): trilinear_kernel launched {la['trilinear_kernel']} times, expected "
              f"{eval_launches} eval chunks (the brick step itself launches none)")

    # (b) and (c): the inputs, the one-process extract, then the ranks
    art = root / "art"
    make_reconstruction_artifacts(str(art), scene)
    cfg, ds = _train_inputs(str(art), scene)
    rng = np.random.default_rng(0)
    idx = rng.permutation(len(ds.origins))[:DIST_STEPS * 2048].reshape(DIST_STEPS, 2048)
    pcfg = _full_config(scene)
    feats = run_extraction((scene["gray"], scene["rgb"]), pcfg, verbose=False, device=dev)
    edges = np.array([(i, j) for i in range(N_VIEWS) for j in range(i + 1, min(i + 4, N_VIEWS))],
                     np.int64)
    names = [f"img_{i:03d}.png" for i in range(N_VIEWS)]
    np.savez(root / "in.npz", cfg=json.dumps(dataclasses.asdict(cfg)),
             o=ds.origins[idx], d=ds.dirs[idx], rgb=ds.rgb[idx],
             u=rng.random((DIST_STEPS, 2048, cfg.num_samples), np.float32),
             pipeline_cfg=json.dumps(dataclasses.asdict(pcfg)), kp=feats.keypoints,
             kp_px=feats.keypoints_px, valid=feats.valid, image_size=feats.image_size,
             desc=feats.descriptors, edges=edges, gray=scene["gray"], rgb_u8=scene["rgb"],
             names=np.array(names))
    del feats
    parts = [("gloo", 2)]
    if torch.cuda.device_count() >= 2:
        parts.append(("nccl", min(torch.cuda.device_count(), 4)))
    for backend, W in parts:
        n_ext = N_VIEWS if N_VIEWS % (4 * W) == 0 else 16
        one = root / f"one{W}"
        extract((scene["gray"][:n_ext], scene["rgb"][:n_ext]), str(one), pcfg, names[:n_ext],
                device=dev)
        ddir = root / f"{backend}{W}"
        ddir.mkdir()
        port = _free_port()
        rs = _run_ranks([(_rank_argv("b", ddir, backend, n_ext), dict(
            TPU3D_COORDINATOR=f"127.0.0.1:{port}", TPU3D_NUM_PROCESSES=str(W),
            TPU3D_PROCESS_ID=str(r))) for r in range(W)], root / f"logs_{backend}{W}")
        _check_dist_b(rs, backend, W, one, ddir / "multi")
    if torch.cuda.device_count() < 2:
        print(f"dist (nccl across cards): not run, torch.cuda.device_count() = "
              f"{torch.cuda.device_count()}", flush=True)


def _check_dist_b(rs, backend, W, one: Path, multi: Path) -> None:
    r0 = rs[0]
    tag = f"{backend}, {W} ranks"
    if backend == "gloo":
        pr = r0["probes"]
        print(f"dist (probe, {tag}): collectives on CUDA tensors: "
              + ", ".join(f"{k} {v}" for k, v in pr.items()), flush=True)
        if any(r["probes"]["all_reduce"] != "ok" or r["probes"]["barrier"] != "ok" for r in rs):
            _fail("dist (b): Gloo's all_reduce or barrier failed on CUDA tensors: the path "
                  "needs both")
    for key, label in (("tp", f"tp 1x{W}"), ("dp", f"dp {W}x1")):
        g = max(r[key]["grad_rel_err"] for r in rs)
        gm = max(r[key]["grad_max_err"] for r in rs)
        viol = max(r[key]["five_step_violation"] for r in rs)
        d = max(r[key]["five_step_max_abs"] for r in rs)
        mem = r0[key]["state_bytes"] / r0[key]["ref_state_bytes"]
        print(f"dist ({label}, {tag}): one step's grid gradient against the 1x1 step's: "
              f"relative L2 error {g:.3e} (limit 1e-6), max |diff| {gm:.3e} of max |g|; after "
              f"{DIST_STEPS} steps grid and moments max "
              f"|diff| {d:.3e} (rtol 2e-4, atol 5e-4: {'within' if viol <= 0 else 'beyond'}); "
              f"grid + moments per rank {r0[key]['state_bytes'] / 2**30:.3f} GiB against "
              f"{r0[key]['ref_state_bytes'] / 2**30:.3f} (x{mem:.3f}); {r0[key]['ms']:.3f} "
              f"ms/step (1x1 {r0[key]['ref_ms']:.3f}); psum {r0[key]['psum_mb']:.3f} MB/step; "
              f"peak {r0[key]['peak'] / 2**30:.2f} GiB; launches {r0[key]['launches']}",
              flush=True)
        if not g <= 1e-6:
            _fail(f"dist ({label}): the grid gradient's relative L2 error is {g:.3e} against "
                  "the 1x1 step's")
        if viol > 0:
            _fail(f"dist ({label}): {DIST_STEPS} steps beyond rtol 2e-4 / atol 5e-4 of 1x1")
        if key == "tp" and not mem <= 1.0 / W + 0.01:
            _fail(f"dist ({label}): each rank holds x{mem:.3f} of the 1x1 grid state")
        want = 0 if key == "tp" else DIST_STEPS     # the brick step is plain torch
        if any(r[key]["launches"][k] != want for r in rs
               for k in ("trilinear_kernel", "trilinear_grad_kernel")):
            _fail(f"dist ({label}): trilinear and its scatter not launched {want} times on "
                  "every rank")
    ck = [r["ckpt"] for r in rs]
    print(f"dist (tp checkpoint, {tag}): the whole grid and moments to rank 0's host, written "
          f"there in {max(c['seconds'] for c in ck):.3f} s; device memory per rank before "
          f"{[round(c['before'] / 2**30, 3) for c in ck]} GiB, peak during "
          f"{[round(c['peak'] / 2**30, 3) for c in ck]} GiB; each rank's rows read back in "
          f"{max(c['read_seconds'] for c in ck):.3f} s, equal to its brick and moments: "
          f"{'yes' if all(c['equal'] for c in ck) else 'no'}", flush=True)
    if any(c["peak"] > c["before"] for c in ck) or not all(c["equal"] for c in ck):
        _fail("dist (tp checkpoint): a rank's device memory grew during the save, or its rows "
              "read back differ from its brick")
    ba = [r["ba"] for r in rs]
    b0 = ba[0]
    print(f"dist (ba {W}x1, {tag}): {b0['obs']} observations, {b0['iters']} iterations, cost "
          f"{b0['cost']:.6e} against one rank's {b0['ref_cost']:.6e}, cameras max |diff| "
          f"{b0['cam_diff']:.3e}; {b0['seconds']:.3f} s (one rank {b0['ref_seconds']:.3f})",
          flush=True)
    same = [{k: b[k] for k in ("iters", "cost", "cam_diff")} for b in ba]
    if any(b != same[0] for b in same[1:]) or b0["iters"] != b0["ref_iters"] \
            or abs(b0["cost"] - b0["ref_cost"]) > 1e-4 * b0["ref_cost"] or b0["cam_diff"] > 1e-4:
        _fail(f"dist (ba): sharded BA differs from one rank's: {ba}")
    m = [r["match"] for r in rs]
    print(f"dist (match {W}x1, {tag}): {m[0]['edges']} edges in {m[0]['blocks']} blocks, rows "
          f"equal to one rank's on every rank: {'yes' if all(x['equal'] for x in m) else 'no'}; "
          f"top2 launches per rank {[x['top2'] for x in m]}", flush=True)
    if not all(x["equal"] for x in m) or not all(x["top2"] > 0 for x in m):
        _fail("dist (match): the sharded rows differ from one rank's, or a rank launched no top2")
    with np.load(one / "features.npz") as a, np.load(multi / "features.npz") as b:
        same = a.files == b.files and all(np.array_equal(a[k], b[k]) for k in a.files)
    e0 = rs[0]["extract"]
    print(f"dist (extract, {tag}): {e0['images']} images, features.npz equal to one "
          f"process': {'yes' if same else 'no'}; {max(r['extract']['seconds'] for r in rs):.1f} "
          f"s; patch_sample launches per rank {[r['extract']['launches'] for r in rs]}",
          flush=True)
    if not same or not all(r["extract"]["launches"] > 0 for r in rs):
        _fail("dist (extract): the merged features differ from one process', or a rank "
              "launched no patch_sample")


def _probe_collectives(torch, dist, dev, W: int) -> dict:
    """Which collectives this torch's Gloo takes on CUDA tensors, each with
    a check of its result. The phase's device collectives are all_reduce and
    barrier; the checkpoint sends host tensors."""
    r = dist.get_rank()
    x = torch.full((4 * W,), float(r + 1), device=dev)
    total = W * (W + 1) / 2

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        assert bool((y == total).all())

    def broadcast():
        y = x.clone()
        dist.broadcast(y, 0)
        assert bool((y == 1).all())

    def all_gather():
        ys = [torch.empty_like(x) for _ in range(W)]
        dist.all_gather(ys, x)
        assert all(bool((y == k + 1).all()) for k, y in enumerate(ys))

    def all_gather_into_tensor():
        y = torch.empty(4 * W * W, device=dev)
        dist.all_gather_into_tensor(y, x)
        assert bool((y.view(W, -1)[:, 0] == torch.arange(1, W + 1, device=dev)).all())

    def reduce_scatter_tensor():
        y = torch.empty(4, device=dev)
        dist.reduce_scatter_tensor(y, x)
        assert bool((y == total).all())

    out = {}
    for f in (all_reduce, broadcast, all_gather, all_gather_into_tensor, reduce_scatter_tensor,
              dist.barrier):
        try:
            f()
            torch.cuda.synchronize()
            out[f.__name__] = "ok"
        except (RuntimeError, ValueError, AssertionError, NotImplementedError) as e:
            out[f.__name__] = f"no ({type(e).__name__}: {str(e).splitlines()[0][:100]})"
    dist.barrier()
    return out


def _dist_rank(opts) -> int:
    """One rank of phase 13 (``--dist-rank a|b``): prints DIST_RESULT and the
    result as JSON, exits 0; any error exits non-zero."""
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("chip_smoke: a dist rank needs a CUDA device", file=sys.stderr)
        return 1
    ddir = Path(opts.dist_dir)
    res = _dist_rank_a(torch, dist, ddir) if opts.dist_rank == "a" else \
        _dist_rank_b(torch, dist, ddir, opts.dist_backend, opts.dist_images)
    dist.destroy_process_group()
    print("DIST_RESULT " + json.dumps(res, default=float), flush=True)
    return 0


def _dist_rank_a(torch, dist, root: Path) -> dict:
    """(a): join as --distributed auto does (torchrun's environment; NCCL on
    the card), then densify --mesh 1x1 at the train phase's width."""
    from tpu3d_torch.cli import densify
    from tpu3d_torch.dense.train import LAST_TRAIN_AUX
    from tpu3d_torch.dist.runtime import join_process_group
    from tpu3d_torch.kernels import LAUNCHES, reset_launches

    if not join_process_group("auto", device="cuda"):
        raise RuntimeError("joined no process group")
    scene = make_scene()
    make_reconstruction_artifacts(str(root), scene)
    names = [f"img_{i:03d}.png" for i in range(N_VIEWS)]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    out = densify(str(root), scene["rgb"], names, scene["focal"], ray_stride=TRAIN_RAY_STRIDE,
                  no_checkpoint=True, log_every=TRAIN_LOG_EVERY, mesh="1x1", device="cuda")
    torch.cuda.synchronize()
    return dict(backend=dist.get_backend(), world=dist.get_world_size(), out=out,
                log=LAST_TRAIN_AUX["log"], steps=LAST_TRAIN_AUX["steps"],
                psum_bytes=LAST_TRAIN_AUX["psum_bytes_per_step"], launches=dict(LAUNCHES),
                peak=torch.cuda.max_memory_allocated(), seconds=time.time() - t0)


def _state_bytes(state) -> int:
    p = state.grid.grid
    return p.numel() * 4 + sum(v.numel() * v.element_size()
                               for v in state.optimizer.state[p].values() if v.dim() == 4)


def _steps(torch, step, state, batches, take):
    """DIST_STEPS steps: (the first step's gradient, ms per later step)."""
    step.keep_grad = True
    step(state, *batches(0))
    g1 = take(step.last_grad)
    step.keep_grad = False
    torch.cuda.synchronize()
    t0 = time.time()
    for i in range(1, DIST_STEPS):
        step(state, *batches(i))
    torch.cuda.synchronize()
    return g1, (time.time() - t0) * 1e3 / (DIST_STEPS - 1)


def _compare_states(a, b, take) -> tuple:
    """(max of |x - y| - (5e-4 + 2e-4 |y|), max |x - y|) over the grid and
    its moments: <= 0 is within Queue 3's five-step limits."""
    pa, pb = a.grid.grid, b.grid.grid
    pairs = [(pa.detach(), take(pb.detach()))] + [
        (v, take(b.optimizer.state[pb][k])) for k, v in a.optimizer.state[pa].items()
        if v.dim() == 4]
    viol = max(float(((x - y).abs() - (5e-4 + 2e-4 * y.abs())).max()) for x, y in pairs)
    return viol, max(float((x - y).abs().max()) for x, y in pairs)


def _tp_checkpoint(torch, step, state, cfg, root: Path, dev) -> dict:
    """The TP state's dense_ckpt at full size: this rank's device memory
    just before the save and its peak during it (the bricks go to rank
    0's host, which alone writes), the seconds, and this rank's rows read
    back against its brick and moments."""
    from tpu3d_torch.dense.train import load_checkpoint
    from tpu3d_torch.dist import runtime
    from tpu3d_torch.dist.dense_tp import _save_tp_checkpoint
    from tpu3d_torch.io.artifacts import ArtifactStore

    store = ArtifactStore(str(root))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = dict(before=torch.cuda.memory_allocated())
    t0 = time.time()
    _save_tp_checkpoint(store, step, state, 0, [0.0])
    out.update(peak=torch.cuda.max_memory_allocated(), seconds=time.time() - t0)
    runtime.barrier()
    t0 = time.time()
    ck, _, _ = load_checkpoint(store, cfg, DIST_STEPS, dev, rows=(step.x_lo, step.x_lo + step.Xl))
    out["read_seconds"] = time.time() - t0
    p, q = state.grid.grid, ck.grid.grid
    out["equal"] = bool(torch.equal(p.detach(), q)) and all(
        bool(torch.equal(v, ck.optimizer.state[q][k]))
        for k, v in state.optimizer.state[p].items() if v.dim() == 4)
    del ck, p, q
    runtime.barrier()
    if runtime.process_index() == 0:
        shutil.rmtree(root)
    return out


def _dist_rank_b(torch, dist, ddir: Path, backend: str, n_images: int) -> dict:
    """(b) / (c): W ranks on the card(s): the probes (Gloo), TP 1xW and DP
    Wx1 against the 1x1 step on the same injected draws, sharded BA against
    one rank's, the sharded match block against one rank's blocks, and
    extract over the group (the first ``n_images`` views)."""
    from tpu3d_torch.ba.lm import bundle_adjust
    from tpu3d_torch.cli import extract
    from tpu3d_torch.config import DenseConfig, MeshConfig, PipelineConfig
    from tpu3d_torch.dense.grid import VoxelGrid
    from tpu3d_torch.dense.train import StepNoise
    from tpu3d_torch.dist import make_mesh, runtime
    from tpu3d_torch.dist.dense_tp import make_tp_dense_step, psum_bytes_per_step
    from tpu3d_torch.dist.mesh import Mesh, all_reduce_
    from tpu3d_torch.dist.sharding import (make_sharded_dense_step, make_sharded_match_block,
                                           match_blocks, sharded_bundle_adjust)
    from tpu3d_torch.kernels import LAUNCHES, reset_launches
    from tpu3d_torch.sfm.pipeline import ExtractedFeatures, _match_and_gate_block

    if not runtime.maybe_initialize_distributed(device="cuda", backend=backend):
        raise RuntimeError("joined no process group")
    rank, W = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    res = {"rank": rank, "world": W, "backend": dist.get_backend()}
    if backend == "gloo":
        res["probes"] = _probe_collectives(torch, dist, dev, W)
    inp = np.load(ddir.parent / "in.npz")
    cfg = DenseConfig(**json.loads(str(inp["cfg"])))
    shape = (DENSE_RES,) * 3 + (28,)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    g = torch.randn(shape, generator=gen, device=dev) * 0.3
    g[..., 0] = torch.randn(shape[:3], generator=gen, device=dev) * 2.0
    s = cfg.scene_scale
    vg = VoxelGrid(g, torch.full((3,), -s, device=dev), torch.full((3,), s, device=dev))
    o, d, rgb, u = (torch.from_numpy(inp[k]).to(dev) for k in ("o", "d", "rgb", "u"))

    meshes = {"tp": make_mesh(MeshConfig(data_parallel=1, model_parallel=W)),
              "dp": make_mesh(MeshConfig(data_parallel=W, model_parallel=1))}
    for key, mesh in meshes.items():
        nd = mesh.size("data")
        bl = 2048 // nd
        sl = slice(mesh.index("data") * bl, (mesh.index("data") + 1) * bl)
        if key == "tp":
            step, ref = (make_tp_dense_step(cfg, m, shape) for m in (mesh, Mesh(1, 1)))
            x_lo = step.x_lo

            def take(t, x_lo=x_lo, xl=step.Xl):
                return t[x_lo:x_lo + xl]

            def batches(i, sl=sl):
                return 0, o[i][sl], d[i][sl], rgb[i][sl], None, StepNoise(u[i][sl])

            def ref_batches(i):
                return 0, o[i], d[i], rgb[i], None, StepNoise(u[i])
        else:
            step, ref = (make_sharded_dense_step(cfg, m) for m in (mesh, Mesh(1, 1)))

            def take(t):
                return t

            def batches(i, sl=sl):
                return o[i][sl], d[i][sl], rgb[i][sl], StepNoise(u[i][sl])

            def ref_batches(i):
                return o[i], d[i], rgb[i], StepNoise(u[i])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        state = step.place(vg, DIST_STEPS)
        g1, ms = _steps(torch, step, state, batches, lambda t: t.clone())
        peak, launches = torch.cuda.max_memory_allocated(), dict(LAUNCHES)
        if key == "tp":
            res["ckpt"] = _tp_checkpoint(torch, step, state, cfg, ddir / "ckpt", dev)
        rstate = ref.place(vg, DIST_STEPS)
        r1, ref_ms = _steps(torch, ref, rstate, ref_batches, lambda t: (
            take(t).clone(), float(t.abs().max()), float(t.norm())))
        viol, dmax = _compare_states(state, rstate, take)
        # This rank's share of the squared difference: the relative L2 error
        # of the whole gradient sums the shares over the bricks (TP).
        dsq = float((g1 - r1[0]).double().pow(2).sum())
        if key == "tp":
            dsq = float(all_reduce_(torch.tensor(dsq, dtype=torch.float64, device=dev), mesh,
                                    "model"))
        res[key] = dict(grad_rel_err=dsq ** 0.5 / r1[2],
                        grad_max_err=float((g1 - r1[0]).abs().max()) / r1[1],
                        five_step_violation=viol, five_step_max_abs=dmax,
                        state_bytes=_state_bytes(state), ref_state_bytes=_state_bytes(rstate),
                        ms=ms, ref_ms=ref_ms, peak=peak, launches=launches,
                        psum_mb=psum_bytes_per_step(cfg, mesh.size("model"), nd) / 1e6)
        del state, rstate, g1, r1, step, ref

    # BA: 24 cameras (two frozen: the gauge) and 2,000 points, every point seen
    m_dp = meshes["dp"]
    rng = np.random.default_rng(3)
    C, P = 24, 2000
    X = np.stack([rng.uniform(-2, 2, P), rng.uniform(-2, 2, P), rng.uniform(5, 9, P)], -1)
    cams = np.zeros((C, 6))
    cams[:, 3] = np.linspace(-1.0, 1.0, C)
    ci, pi = np.repeat(np.arange(C), P), np.tile(np.arange(P), C)
    Xc = X[pi] + cams[ci, 3:]
    uv = Xc[:, :2] / Xc[:, 2:] + rng.normal(0, 3e-4, (C * P, 2))
    cams0 = cams + np.concatenate([np.zeros((2, 6)), rng.normal(0, 0.02, (C - 2, 6))])
    fixed = np.zeros(C)
    fixed[:2] = 1.0
    args = [torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in
            (cams0, X + rng.normal(0, 0.05, X.shape))] + \
        [torch.from_numpy(a).to(dev) for a in (ci, pi)] + \
        [torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in (uv, np.ones(C * P),
                                                                       fixed)]
    torch.cuda.synchronize()
    t0 = time.time()
    st = sharded_bundle_adjust(m_dp, *args, max_iters=6, cg_iters=32)
    t1 = time.time()
    one = bundle_adjust(*args, max_iters=6, cg_iters=32)
    t2 = time.time()
    res["ba"] = dict(obs=C * P, iters=st.n_iters, ref_iters=one.n_iters, cost=st.cost.item(),
                     ref_cost=one.cost.item(),
                     cam_diff=float((st.cams - one.cams).abs().max()), seconds=t1 - t0,
                     ref_seconds=t2 - t1)

    pcfg = PipelineConfig.from_dict(json.loads(str(inp["pipeline_cfg"])))
    names = [str(n) for n in inp["names"]]
    feats = ExtractedFeatures.from_numpy(
        names, inp["kp"], inp["kp_px"], inp["valid"],
        np.zeros(inp["kp"].shape[:2] + (3,), np.uint8), inp["image_size"], inp["desc"],
        device=dev)
    edges = [tuple(int(v) for v in e) for e in inp["edges"]]
    # blocks of 16 pairs: the 63 sequential edges give every rank of up to 4 a block
    mcfg = dataclasses.replace(pcfg, matching=dataclasses.replace(pcfg.matching, pair_batch=16))
    reset_launches()
    rows = make_sharded_match_block(m_dp, mcfg, 1)(feats, edges)
    top2 = LAUNCHES["top2_kernel"]
    blocks = match_blocks(edges, mcfg)
    one_rows = np.concatenate([_match_and_gate_block(feats, b, 1, mcfg) for b in blocks])
    res["match"] = dict(edges=len(edges), blocks=len(blocks), top2=top2,
                        equal=bool(np.array_equal(rows, one_rows)))

    n = n_images
    reset_launches()
    out = extract((inp["gray"][:n], inp["rgb_u8"][:n]), str(ddir / "multi"), pcfg, names[:n],
                  device=dev)
    res["extract"] = dict(images=out["images"], seconds=out["seconds"],
                          launches=LAUNCHES["patch_sample_kernel"])
    runtime.barrier()
    return res


def main(argv=()) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive tpu3d_torch on one NVIDIA GPU.")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--kernels", action="store_true",
                      help="phases 1-3 only: build, then the kernel rows (launches not counted)")
    mode.add_argument("--full", action="store_true",
                      help="phases 1-2 and 9 only: build, then the full runs and the profiled "
                      "reconstruct (no kernel table)")
    mode.add_argument("--sfm", action="store_true",
                      help="phases 1-2 and 10 only: build, then the SfM entry points (staged "
                      "commands, global mode, the options, refine_focal; no kernel table)")
    mode.add_argument("--sdf", action="store_true",
                      help="phases 1-2 and 11 only: build, then densify --model sdf, its "
                      "profiled step, mesh and the traversal (no kernel table)")
    mode.add_argument("--learned", action="store_true",
                      help="phases 1-2 and 12 only: build, then the learned frontends and "
                      "matcher with seeded random weights (no kernel table)")
    mode.add_argument("--dense", action="store_true",
                      help="phases 1-2 and 5-8 only: build, then the dense, train, recipe and "
                      "options phases (no kernel table)")
    mode.add_argument("--dist", action="store_true",
                      help="phases 1-2 and 13 only: build, then dist/ over torch.distributed "
                      "(no kernel table)")
    mode.add_argument("--dvgo", action="store_true",
                      help="phases 1-2 and 14 only: build, then DVGO's step at the dvgo-160 "
                      "cell's sizes, its launches and both kernels on its points (no kernel "
                      "table)")
    # one rank of phase 13, started by the phase itself
    mode.add_argument("--dist-rank", choices=["a", "b"], help=argparse.SUPPRESS)
    ap.add_argument("--dist-dir", help=argparse.SUPPRESS)
    ap.add_argument("--dist-backend", default="", help=argparse.SUPPRESS)
    ap.add_argument("--dist-images", type=int, default=0, help=argparse.SUPPRESS)
    opts = ap.parse_args(list(argv))
    if opts.dist_rank:
        return _dist_rank(opts)
    kernels_only = opts.kernels
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
    _build_native()

    t0 = time.time()
    scene = make_scene()
    print(f"scene: {N_VIEWS} views {WIDTH}x{HEIGHT} focal {scene['focal']:.1f} "
          f"rendered in {time.time() - t0:.1f} s", flush=True)
    build = Path(__file__).resolve().parent / "build"
    if opts.full:
        _run_full(torch, dev, scene)
        _profile_reconstruct(torch, dev, scene)
        _run_trace(torch, dev, scene, build / "chip_smoke_trace")
        print(smi[0] if smi else "nvidia-smi: no output", flush=True)
        return 0
    if opts.sfm:
        _run_sfm(torch, dev, scene, build / "chip_smoke_sfm")
        print(smi[0] if smi else "nvidia-smi: no output", flush=True)
        return 0
    if opts.dist:
        try:
            _run_dist(torch, dev, scene, build / "chip_smoke_dist")
        finally:
            shutil.rmtree(build / "chip_smoke_dist", ignore_errors=True)
        print(smi[0] if smi else "nvidia-smi: no output", flush=True)
        return 0
    if opts.dvgo:
        with f32_scope():
            _run_dvgo(torch, dev)
        print(smi[0] if smi else "nvidia-smi: no output", flush=True)
        return 0
    if opts.sdf or opts.learned:
        root = build / ("chip_smoke_sdf" if opts.sdf else "chip_smoke_learned")
        try:
            if opts.sdf:
                _run_sdf(torch, dev, scene, str(root))
            else:
                _run_learned(torch, dev, scene, root)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        print(smi[0] if smi else "nvidia-smi: no output", flush=True)
        return 0
    roots = {k: build / f"chip_smoke_{k}" for k in ("dense", "train", "recipe", "options")}
    t0 = time.time()
    dense = make_dense_artifacts(str(roots["dense"]), scene)
    for k in ("train", "recipe", "options"):
        shutil.rmtree(roots[k], ignore_errors=True)
        make_reconstruction_artifacts(str(roots[k]), scene)
    train_cfg, train_ds = _train_inputs(str(roots["train"]), scene)
    recipe_cfg, recipe_ds = _recipe_inputs(str(roots["recipe"]), scene)
    print(f"dense artifacts: {DENSE_RES}^3 x 28 analytic grid, band near "
          f"{dense['meta']['near']:.4f} far {dense['meta']['far']:.4f}; train inputs: "
          f"{len(train_ds.origins)} rays, band near {train_cfg.near:.4f} far "
          f"{train_cfg.far:.4f}; recipe inputs: {len(recipe_ds.origins)} rays, contracted band "
          f"near {recipe_cfg.near:.4f} far {recipe_cfg.far:.4f}; written in "
          f"{time.time() - t0:.1f} s", flush=True)

    try:
        if opts.dense:
            del dense
            _run_dense(torch, dev, scene, str(roots["dense"]))
            _run_train(torch, dev, scene, str(roots["train"]))
            _profile_train_step(torch, dev, train_cfg, train_ds)
            _run_recipe(torch, dev, scene, str(roots["recipe"]), recipe_cfg, recipe_ds)
            _run_options(torch, dev, scene, str(roots["options"]))
            print(smi[0] if smi else "nvidia-smi: no output", flush=True)
            return 0
        with f32_scope():
            print(f"tf32: cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
                  f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
            full_cfg = _full_config(scene)
            kernels = [_check_patch_sample(torch, dev, scene, full_cfg), _check_top2(torch, dev),
                       _check_trilinear(torch, dev, scene, dense, train_cfg, train_ds,
                                        recipe_cfg, recipe_ds),
                       _check_trilinear_grad(torch, dev, train_cfg, train_ds),
                       _check_orient_desc(torch, dev, scene, full_cfg), _check_rmsprop(torch, dev),
                       _check_shade_composite(torch, dev), _check_view_rays(torch, dev)]
        del dense
        torch.cuda.empty_cache()
        with f32_scope():
            # The trilinear rows gain the ``dvgo`` shape; the colour MLP's
            # kernels are rows of their own, with phase 14's launches.
            dvgo_rows, dvgo_launches = {}, {}
            for name, shape in _run_dvgo(torch, dev).items():
                row = next((row for row in kernels if row["name"] == name), None)
                if row is None:
                    dvgo_rows[name] = shape
                    dvgo_launches[name] = shape["launches"]
                else:
                    row.setdefault("shapes", []).append(shape)
            kernels.extend(dvgo_rows.values())

        if kernels_only:
            launches = {row["name"]: None for row in kernels}
        else:
            cfg = dataclasses.replace(PipelineConfig(),
                                      camera=CameraConfig(focal_length=scene["focal"]))
            launches = _run_slice(torch, dev, scene, cfg)
            _profile_slice(torch, dev, scene, cfg)
            # The shading and ray rows report the dense phase (one launch a
            # chunk; one a view rendered without precomputed rays).
            dense_launches = _run_dense(torch, dev, scene, str(roots["dense"]))
            for name in ("shade_composite_kernel", "view_rays_kernel"):
                launches[name] = dense_launches[name]
            # The forward and the scatter rows report the train phase (the
            # dense, recipe and options phases' counts are on their lines).
            train = _run_train(torch, dev, scene, str(roots["train"]))
            launches.update(trilinear_kernel=train["trilinear_kernel"],
                            trilinear_grad_kernel=train["trilinear_grad_kernel"])
            _profile_train_step(torch, dev, train_cfg, train_ds)
            # The RMSprop row reports the recipe (its detail phase).
            launches["rmsprop_kernel"] = _run_recipe(torch, dev, scene, str(roots["recipe"]),
                                                     recipe_cfg, recipe_ds)["rmsprop_kernel"]
            _run_options(torch, dev, scene, str(roots["options"]))
            # The orient_desc row reports the fused full run (the only path
            # that launches it).
            launches["orient_desc_kernel"] = _run_full(torch, dev, scene)["orient_desc_kernel"]
            _profile_reconstruct(torch, dev, scene)
            _run_trace(torch, dev, scene, build / "chip_smoke_trace")
            _run_sfm(torch, dev, scene, build / "chip_smoke_sfm")
            _run_sdf(torch, dev, scene, str(build / "chip_smoke_sdf"))
            _run_learned(torch, dev, scene, build / "chip_smoke_learned")
            _run_dist(torch, dev, scene, build / "chip_smoke_dist")
    finally:
        for root in [*roots.values(), *(build / f"chip_smoke_{k}"
                                        for k in ("sfm", "sdf", "learned", "dist", "trace"))]:
            shutil.rmtree(root, ignore_errors=True)
    launches.update(dvgo_launches)
    for row in kernels:
        row["launches"] = launches[row["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "wall_ms",
            "host_us", "plain_ms", "plain_wall_ms", "plain_host_us", "bound_ms", "bound_by",
            "library_ms", "library_wall_ms", "library_host_us")
    shape_keys = ("shape", "launches", "max_abs_err", "ms", "wall_ms", "host_us", "plain_ms", "bound_ms",
                  "library_ms", "library_wall_ms", "library_host_us")
    table = []
    for row in kernels:
        entry = {k: row[k] for k in keys}
        entry.update({k: row[k] for k in ("product_ms", "product_wall_ms", "product_host_us")
                      if k in row})
        if "shapes" in row:
            entry["shapes"] = [{k: s[k] for k in ("K", "S", "N") + shape_keys if k in s}
                               for s in row["shapes"]]
        table.append(entry)
    print(json.dumps({"kernels": table}))
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
