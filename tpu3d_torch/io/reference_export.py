"""The reference's ``output/`` artifact protocol (tpu3d/io/reference_export.py).

The reference's stages talk through files in one ``output/`` directory:
img_list.txt, all_points / all_descriptors / all_colors / img_size (.npy),
bow_codebook.plk, img_pairs / all_matches, reconstructed_img.txt,
cameras_extrinsic.npy, points_3d.npy and result.ply. This module writes
that protocol from the artifact store, so consumers built against the
reference work unchanged on the port's reconstructions. Per-image arrays
are object arrays of the valid rows, the reference's ragged layout.

The BoW codebook is k-means over the exported descriptors (k = 200, or the
descriptor count if smaller), its random rows drawn from a
``torch.Generator`` seeded 0, and saved with joblib in the reference's
(k, codebook) layout. Where joblib is not installed the codebook is skipped
and every other file is still written, as tpu3d does: that is the
reference's own dependency missing, not a fallback from the device.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from tpu3d_torch import f32_scope, resolve_device
from tpu3d_torch.io.artifacts import ArtifactStore
from tpu3d_torch.io.matches import load_matches
from tpu3d_torch.io.ply import write_ply
from tpu3d_torch.matching.bow import build_codebook, codebook_draws


def export_reference_layout(artifact_dir: str, out_dir: str, device="cuda") -> dict:
    """Write the reference's output/ protocol from saved artifacts: the
    features always (they must exist), the matches and the reconstruction
    where present. The codebook's k-means runs on ``device``. Returns a
    manifest of the files written."""
    store = ArtifactStore(artifact_dir)
    os.makedirs(out_dir, exist_ok=True)
    written = {}

    feats = store.load("features")
    fmeta = store.load_json("features_meta")
    if feats is None or fmeta is None:
        raise FileNotFoundError(f"no features artifact in {artifact_dir}")
    names = fmeta["names"]
    valid = feats["valid"]

    with open(os.path.join(out_dir, "img_list.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    written["img_list.txt"] = len(names)

    def ragged(field):
        return np.asarray([feats[field][i][valid[i]] for i in range(len(names))], dtype=object)

    # Keypoints centred at the principal point, y up: the reference's
    # convention and the port's.
    np.save(os.path.join(out_dir, "all_points.npy"), ragged("keypoints"), allow_pickle=True)
    np.save(os.path.join(out_dir, "all_descriptors.npy"), ragged("descriptors"),
            allow_pickle=True)
    np.save(os.path.join(out_dir, "all_colors.npy"), ragged("colors_bgr"), allow_pickle=True)
    np.save(os.path.join(out_dir, "img_size.npy"), feats["image_size"])
    written["all_points/descriptors/colors, img_size"] = int(valid.sum())

    try:
        import joblib
    except ImportError:
        joblib = None
    if joblib is not None:
        dev = resolve_device(device)
        k = min(200, int(valid.sum()))   # k-means needs k <= the descriptor count
        v = torch.from_numpy(valid.astype(np.float32)).to(dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        with f32_scope(), torch.no_grad():
            fill_idx, init_idx = codebook_draws(v, k, gen)
            codebook = build_codebook(torch.from_numpy(feats["descriptors"]).to(dev), v,
                                      fill_idx, init_idx).cpu().numpy()
        joblib.dump((k, codebook), os.path.join(out_dir, "bow_codebook.plk"))
        written["bow_codebook.plk"] = k

    regs = _load_regs(artifact_dir, len(names), feats["keypoints"].shape[1])
    if regs is not None:
        img_pairs = []
        all_matches = []
        for r in regs:
            for e in r.edges:
                img_pairs.append((e.ref_img, r.img))
                all_matches.append([e.idx_ref, e.idx_new, e.track])
        np.save(os.path.join(out_dir, "img_pairs.npy"), np.asarray(img_pairs))
        # (P, 3) ragged object array, filled element-wise: np.asarray would
        # broadcast same-length index arrays into a dense block.
        am = np.empty((len(all_matches), 3), dtype=object)
        for i, m in enumerate(all_matches):
            am[i, 0], am[i, 1], am[i, 2] = m
        np.save(os.path.join(out_dir, "all_matches.npy"), am, allow_pickle=True)
        written["img_pairs/all_matches"] = len(img_pairs)

    rec = store.load("reconstruction")
    rmeta = store.load_json("reconstruction_meta")
    if rec is not None and rmeta is not None:
        with open(os.path.join(out_dir, "reconstructed_img.txt"), "w") as f:
            f.write("\n".join(rmeta["registered_names"]) + "\n")
        np.save(os.path.join(out_dir, "cameras_extrinsic.npy"), rec["extrinsics"])
        np.save(os.path.join(out_dir, "points_3d.npy"), rec["points"])
        write_ply(os.path.join(out_dir, "result.ply"), rec["points"], rec["colors_bgr"])
        written["reconstructed_img/cameras_extrinsic/points_3d/result.ply"] = \
            int(len(rec["points"]))
    return written


def _load_regs(artifact_dir: str, n_images: int, kpts_per_image: int):
    """The saved registrations, or None where there is no readable match
    artifact."""
    try:
        loaded = load_matches(artifact_dir, n_images, kpts_per_image, max_tracks=4_000_000)
    except (OSError, KeyError, ValueError):
        return None
    return None if loaded is None else loaded[0]
