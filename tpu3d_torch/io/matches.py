"""Persistence of the matching stage's whole state (numpy copy of
tpu3d/io/matches.py): ``pairs_meta.json`` + ``matches.npz`` carry the
match indices and coordinates, colours, per-edge relative poses from the
E-gate, the union-find track store and the retrieval view graph, so a
reconstruction (incremental or global) can be re-run without re-matching.

The files are tpu3d's, key for key: tpu3d's ``match`` output loads here and
the port's loads in tpu3d. One difference on load: the relative pose comes
back as float64, the dtype the matching stage holds it in memory, so a
reconstruction from the files does the same host arithmetic as one in the
matching process (tpu3d returns the stored float32).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpu3d_torch.io.artifacts import ArtifactStore
from tpu3d_torch.matching.tracks import TrackStore
from tpu3d_torch.sfm.engine import EdgeObservations, ImageRegistration


def save_matches(artifact_dir: str, regs: List[ImageRegistration], ts: TrackStore,
                 adj: Dict[int, List[int]], seconds: float = 0.0) -> None:
    store = ArtifactStore(artifact_dir)
    store.save_json("pairs_meta", {
        "registrations": [
            {"img": r.img, "refs": [e.ref_img for e in r.edges],
             "edge_sizes": [len(e.idx_new) for e in r.edges]}
            for r in regs
        ],
        "adjacency": {str(k): list(map(int, v)) for k, v in adj.items()},
        "next_track": int(ts.next_track),
        "seconds": seconds,
    })
    arrays = {"kp_track": ts.kp_track, "parent": ts.parent[: max(ts.next_track, 1)]}
    for ri, r in enumerate(regs):
        for ei, e in enumerate(r.edges):
            pre = f"r{ri}_e{ei}"
            arrays[f"{pre}_idx_ref"] = e.idx_ref
            arrays[f"{pre}_idx_new"] = e.idx_new
            arrays[f"{pre}_track"] = e.track
            arrays[f"{pre}_uv_ref"] = e.uv_ref
            arrays[f"{pre}_uv_new"] = e.uv_new
            arrays[f"{pre}_colors"] = e.colors_ref
            if e.rel_R is not None:
                arrays[f"{pre}_relRt"] = np.concatenate(
                    [np.asarray(e.rel_R).ravel(), np.asarray(e.rel_t).ravel()]
                ).astype(np.float32)
    np.savez_compressed(os.path.join(artifact_dir, "matches.npz"), **arrays)


def load_matches(artifact_dir: str, n_images: int, kpts_per_image: int, max_tracks: int
                 ) -> Optional[Tuple[List[ImageRegistration], TrackStore, Dict[int, List[int]]]]:
    """(registrations, track store, adjacency), or None when the directory
    holds no match artifact."""
    meta = ArtifactStore(artifact_dir).load_json("pairs_meta")
    path = os.path.join(artifact_dir, "matches.npz")
    if meta is None or "adjacency" not in meta or not os.path.exists(path):
        return None
    with np.load(path) as data:
        ts = TrackStore(n_images, kpts_per_image, capacity=max_tracks)
        ts.kp_track = data["kp_track"]
        parent = data["parent"]
        ts.parent[: len(parent)] = parent
        ts.next_track = int(meta["next_track"])
        regs = []
        for ri, r in enumerate(meta["registrations"]):
            edges = []
            for ei, ref in enumerate(r["refs"]):
                pre = f"r{ri}_e{ei}"
                rel = (data[f"{pre}_relRt"].astype(np.float64) if f"{pre}_relRt" in data
                       else None)
                edges.append(EdgeObservations(
                    ref_img=int(ref),
                    idx_ref=data[f"{pre}_idx_ref"], idx_new=data[f"{pre}_idx_new"],
                    track=data[f"{pre}_track"],
                    uv_ref=data[f"{pre}_uv_ref"], uv_new=data[f"{pre}_uv_new"],
                    colors_ref=data[f"{pre}_colors"],
                    rel_R=rel[:9].reshape(3, 3) if rel is not None else None,
                    rel_t=rel[9:] if rel is not None else None,
                ))
            regs.append(ImageRegistration(img=int(r["img"]), edges=edges))
    adj = {int(k): v for k, v in meta["adjacency"].items()}
    return regs, ts, adj
