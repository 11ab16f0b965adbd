"""The pipeline (tpu3d/sfm/pipeline.py): extract → retrieve → match →
reconstruct, and ``reconstruct`` which runs them all.

  1. extract     — batched classical frontend (features/), on the device
  2. retrieve    — BoW codebook + tf-idf + top-k view graph (matching/bow)
  3. match       — every candidate edge matched (mutual-NN) and E-gated in
                   blocks of ``pair_batch`` pairs, then canonical reference
                   selection, retry and 2-hop rescue over the cached
                   results, with union-find tracks
  4. reconstruct — the incremental engine (sfm/engine.py) over the
                   registrations, in fixpoint rounds, then a re-matching
                   rescue of images still unregistered and the final BA

``run_matching`` returns ``(List[ImageRegistration], TrackStore)``, the
input of ``run_reconstruction``. tpu3d's vmap over a block of pairs is a
leading pair axis here. Random draws come from ``torch.Generator``s seeded
per edge from the caller's seed, so an edge's result does not depend on
which block it rides in.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tpu3d_torch import f32_scope, resolve_device
from tpu3d_torch.config import PipelineConfig, resolve_sfm_backend
from tpu3d_torch.features.frontend import extract_features, sample_colors
from tpu3d_torch.geometry.estimators import find_essential_ransac, lo_hypotheses
from tpu3d_torch.geometry.fivepoint import five_point_ransac
from tpu3d_torch.geometry.ransac import gumbel
from tpu3d_torch.io.images import list_images, load_images
from tpu3d_torch.matching.bow import (build_codebook, codebook_draws, tfidf_vectors,
                                      topk_similar, vector_quantize)
from tpu3d_torch.matching.mnn import match_descriptors
from tpu3d_torch.matching.pairs import build_view_graph
from tpu3d_torch.matching.tracks import TrackStore
from tpu3d_torch.sfm.engine import (MAX_REFS, EdgeObservations, ImageRegistration,
                                    IncrementalSfM)
from tpu3d_torch.sfm.scene import Reconstruction


@dataclasses.dataclass
class ExtractedFeatures:
    """Stage-1 output. Descriptors, validity and keypoints stay on the
    device (``_dev`` fields) for retrieval and matching; the small
    per-keypoint arrays the host bookkeeping reads are numpy."""

    names: List[str]
    keypoints: np.ndarray     # (N, K, 2) centered
    keypoints_px: np.ndarray  # (N, K, 2)
    valid: np.ndarray         # (N, K) bool
    colors_bgr: np.ndarray    # (N, K, 3)
    image_size: np.ndarray    # (N, 2) (W, H)
    descriptors_dev: torch.Tensor   # (N, K, 128) f32
    valid_dev: torch.Tensor         # (N, K) f32
    keypoints_dev: torch.Tensor     # (N, K, 2) f32

    @property
    def descriptors(self) -> np.ndarray:
        return self.descriptors_dev.cpu().numpy()

    def to(self, device) -> "ExtractedFeatures":
        """The same features with the device tensors on ``device``."""
        dev = torch.device(device)
        return dataclasses.replace(
            self, descriptors_dev=self.descriptors_dev.to(dev),
            valid_dev=self.valid_dev.to(dev),
            keypoints_dev=self.keypoints_dev.to(dev))

    @classmethod
    def from_numpy(cls, names: Sequence[str], keypoints, keypoints_px, valid,
                   colors_bgr, image_size, descriptors,
                   device="cuda") -> "ExtractedFeatures":
        """Features from host arrays (for instance another implementation's
        stage-1 output), with the device tensors on ``device``."""
        dev = resolve_device(device)
        kp = np.array(keypoints, np.float32)
        v = np.asarray(valid).astype(bool)
        return cls(
            names=list(names), keypoints=kp,
            keypoints_px=np.asarray(keypoints_px, np.float32), valid=v,
            colors_bgr=np.asarray(colors_bgr), image_size=np.asarray(image_size),
            descriptors_dev=torch.from_numpy(np.array(descriptors, np.float32)).to(dev),
            valid_dev=torch.as_tensor(v.astype(np.float32), device=dev),
            keypoints_dev=torch.as_tensor(kp, device=dev))


ImageSource = Union[str, os.PathLike, Tuple[np.ndarray, np.ndarray]]


def run_extraction(
    images: ImageSource,
    cfg: PipelineConfig,
    names: Optional[List[str]] = None,
    downscale: int = 1,
    verbose: bool = True,
    device="cuda",
    timers: Optional[Dict] = None,
) -> ExtractedFeatures:
    """Extract features of every image, ``cfg.frontend.batch_size`` images
    per device batch. ``images`` is a directory of image files, or the
    decoded ``(gray_u8 (N, H, W), rgb_u8 (N, H, W, 3))`` arrays.
    ``timers``, when given, gets the seconds spent loading images and in
    the frontend (each batch's keypoints are copied to the host, which
    waits for the device)."""
    dev = resolve_device(device)
    timers = {} if timers is None else timers
    timers.update(load=0.0, frontend=0.0)
    if cfg.frontend.model != "classical":
        raise NotImplementedError(
            f"frontend model {cfg.frontend.model!r} is not ported yet")
    B = cfg.frontend.batch_size
    if isinstance(images, (str, os.PathLike)):
        img_dir = os.fspath(images)
        names = names if names is not None else list_images(img_dir)

        def load_batch(s):
            gray, rgb = load_images(img_dir, names[s: s + B], downscale)
            return (gray * 255.0 + 0.5).astype(np.uint8), rgb
    else:
        gray_all, rgb_all = images
        names = names if names is not None else [f"{i:05d}" for i in range(len(gray_all))]

        def load_batch(s):
            return np.asarray(gray_all[s: s + B], np.uint8), np.asarray(rgb_all[s: s + B])

    kps, kp_px, valid, desc, sizes, colors = [], [], [], [], [], []
    for s in range(0, len(names), B):
        t0 = time.time()
        gray_u8, rgb = load_batch(s)
        t1 = time.time()
        fs = extract_features(torch.from_numpy(gray_u8), cfg.frontend, device=dev)
        kps.append(fs.keypoints)
        valid.append(fs.valid)
        desc.append(fs.descriptors)
        sizes.append(fs.image_size)
        px = fs.keypoints_px.cpu().numpy()
        kp_px.append(px)
        timers["load"] += t1 - t0
        timers["frontend"] += time.time() - t1
        colors.append(sample_colors(rgb[..., ::-1], px))   # BGR like cv2
        if verbose:
            print(f"[extract] {min(s + B, len(names))}/{len(names)} images", flush=True)
    keypoints_dev = torch.cat(kps)
    valid_dev = torch.cat(valid)
    return ExtractedFeatures(
        names=list(names),
        keypoints=keypoints_dev.cpu().numpy(),
        keypoints_px=np.concatenate(kp_px),
        valid=valid_dev.cpu().numpy(),
        colors_bgr=np.concatenate(colors),
        image_size=torch.cat(sizes).cpu().numpy(),
        descriptors_dev=torch.cat(desc),
        valid_dev=valid_dev.to(torch.float32),
        keypoints_dev=keypoints_dev,
    )


def _retrieval_draws(seed: int, valid: torch.Tensor, k: int):
    """The codebook's random rows (fill_idx, init_idx) from a generator
    seeded with ``seed``. A test replaces this function to feed tpu3d's
    draws."""
    gen = torch.Generator(device=valid.device)
    gen.manual_seed(seed)
    return codebook_draws(valid, k, gen)


def _retrieval_fused(d, v, k, iters, top_k, fill_idx, init_idx):
    """Codebook build + vector quantization + tf-idf + top-k similarity."""
    codebook = build_codebook(d, v, fill_idx, init_idx, iters)
    words = vector_quantize(d, codebook)
    tv = tfidf_vectors(words, v, k)
    return topk_similar(tv, top_k)


def run_retrieval(feats: ExtractedFeatures, cfg: PipelineConfig, seed: int = 0,
                  device="cuda") -> Dict[int, List[int]]:
    """BoW codebook + tf-idf retrieval + view graph. Returns the adjacency
    dict, with the sequential prior's (i, i+k) edges added."""
    dev = resolve_device(device)
    d = feats.descriptors_dev.to(dev)
    v = feats.valid_dev.to(dev)
    with f32_scope(), torch.no_grad():
        fill_idx, init_idx = _retrieval_draws(seed, v, cfg.retrieval.codebook_size)
        idx, sim = _retrieval_fused(d, v, cfg.retrieval.codebook_size,
                                    cfg.retrieval.kmeans_iters, cfg.retrieval.top_k,
                                    fill_idx, init_idx)
    adj = build_view_graph(idx.cpu().numpy(), sim.cpu().numpy(),
                           cfg.retrieval.similarity_threshold,
                           cfg.retrieval.min_neighbors)
    n = len(feats.names)
    for k in range(1, cfg.retrieval.sequential_prior + 1):
        for i in range(n - k):
            j = i + k
            if j not in adj[i]:
                adj[i].append(j)
            if i not in adj[j]:
                adj[j].append(i)
    return adj


def edge_seed(seed: int, i: int, j: int) -> int:
    """Seed of the generator that draws edge (i, j)'s RANSAC samples."""
    return ((seed * 1_000_003 + i) * 1_000_003 + j) % (1 << 62)


def _gate_noise(seed: int, edges: Sequence[Tuple[int, int]], shapes, device):
    """The gate's Gumbel draws for a block of edges: one generator per edge,
    seeded by :func:`edge_seed`, so an edge's draws do not depend on the
    block it rides in. Returns one (len(edges), *shape) tensor per shape.
    A test replaces this function to feed tpu3d's draws."""
    out = [[] for _ in shapes]
    for i, j in edges:
        g = torch.Generator(device=device)
        g.manual_seed(edge_seed(seed, i, j))
        for lst, shp in zip(out, shapes):
            lst.append(gumbel(g, shp, device))
    return [torch.stack(lst) for lst in out]


def gate_noise_shapes(num_hypotheses: int, K: int):
    """Shapes of an edge's draws: five-point samples, 8-point samples and
    the LO-RANSAC round's samples, each over the K match slots."""
    return [(max(num_hypotheses // 4, 64), K), (num_hypotheses, K),
            (lo_hypotheses(num_hypotheses), K)]


def _match_and_gate_body(d0, d1, v0, v1, kp0, kp1, noise, focal, thr_px,
                         ratio, five_point=False):
    """Match + E-RANSAC gate of a block of pairs (leading axis), packed into
    one (B, 3K + 14) array: per keypoint of image 0 (matched index, raw
    match, gated inlier), then (raw count, cheirality count), R, t.
    ``noise`` holds the block's draws, shaped as :func:`gate_noise_shapes`."""
    B, K = d0.shape[:2]
    res = match_descriptors(d0, d1, v0, v1, ratio=ratio)
    uv0 = kp0   # slot k of the match result is keypoint k of image 0
    uv1 = torch.gather(kp1, 1, res.idx1.long()[..., None].expand(B, K, 2))
    mvalid = res.valid.to(torch.float32)
    n5, n8, nlo = noise
    if five_point:
        # Nistér's minimal solver for the consensus set, then the 8-point
        # refit and cheirality machinery on the 5-point inliers.
        _, inl5, _ = five_point_ransac(uv0, uv1, mvalid, focal, n5, threshold_px=thr_px)
        gate_valid = torch.where(inl5.sum(dim=-1, keepdim=True) >= 8,
                                 inl5.to(torch.float32), mvalid)
    else:
        gate_valid = mvalid
    eres = find_essential_ransac(uv0, uv1, gate_valid, focal, (n8, nlo), threshold_px=thr_px)
    sel = (res.valid & eres.inliers).to(torch.float32)
    per_kpt = torch.stack([res.idx1.to(torch.float32), mvalid, sel], dim=-1)
    stats = torch.stack([mvalid.sum(dim=-1), eres.front.sum(dim=-1).to(torch.float32)], dim=-1)
    return torch.cat([per_kpt.reshape(B, -1), stats, eres.R.reshape(B, 9), eres.t], dim=-1)


def _match_and_gate_block(feats: ExtractedFeatures, edges, seed, cfg) -> np.ndarray:
    """Gate the (i, j) pairs of ``edges`` in one block; returns host rows."""
    d = feats.descriptors_dev
    ii = torch.as_tensor([e[0] for e in edges], dtype=torch.int64, device=d.device)
    jj = torch.as_tensor([e[1] for e in edges], dtype=torch.int64, device=d.device)
    v = feats.valid_dev
    kp = feats.keypoints_dev
    with f32_scope(), torch.no_grad():
        noise = _gate_noise(seed, edges, gate_noise_shapes(
            int(cfg.sfm.ransac.num_hypotheses), d.shape[1]), d.device)
        flat = _match_and_gate_body(
            d[ii], d[jj], v[ii], v[jj], kp[ii], kp[jj], noise,
            float(cfg.camera.focal_length), float(cfg.matching.ransac_threshold_px),
            float(cfg.matching.ratio_threshold), five_point=cfg.sfm.ransac.use_five_point)
    return flat.cpu().numpy()


def _batch_match_pairs(feats, pairs, cfg, seed, memo, verbose=False):
    """Match + E-gate the given pairs (canonical i<j direction) in blocks of
    ``cfg.matching.pair_batch``, filling ``memo`` {(i, j): packed row}.
    Pairs already in the memo are skipped."""
    edges = sorted({(min(i, j), max(i, j)) for i, j in pairs if i != j} - set(memo))
    if not edges:
        return memo
    if cfg.matching.matcher != "mnn":
        raise NotImplementedError(f"matcher {cfg.matching.matcher!r} is not ported yet")
    B = max(int(cfg.matching.pair_batch), 1)
    t0 = time.time()
    for s in range(0, len(edges), B):
        blk = edges[s: s + B]
        flat = _match_and_gate_block(feats, blk, seed, cfg)
        for b, e in enumerate(blk):
            memo[e] = flat[b]
        if verbose:
            done = min(s + B, len(edges))
            print(f"[match] gated {done}/{len(edges)} candidate edges "
                  f"({done / max(time.time() - t0, 1e-9):.1f} edges/s)", flush=True)
    return memo


def _precompute_pair_cache(feats, adj, cfg, seed, verbose=True, memo=None):
    """Match + E-gate every candidate view-graph edge."""
    pairs = [(i, j) for i in adj for j in adj.get(i, []) if i != j]
    return _batch_match_pairs(feats, pairs, cfg, seed,
                              memo if memo is not None else {}, verbose=verbose)


def _decode_pair(feats, flat, i, j, reverse, cfg):
    """Unpack one packed result into (sel, idx0, idx1, uv0, uv1, n_raw,
    n_front, rel_R, rel_t) for direction (ref=i, new=j). reverse=True means
    the row holds (j, i): mutual-NN matches are an unordered pair set, so
    the reversed view is an index permutation and the relative pose
    inverts. sel is None when the pair fails the raw-match or inlier gate."""
    K = feats.keypoints.shape[1]
    per_kpt = flat[: K * 3].reshape(K, 3)
    idx1 = per_kpt[:, 0].astype(np.int64)
    mvalid = per_kpt[:, 1] > 0
    sel = per_kpt[:, 2] > 0
    n_raw = int(mvalid.sum())
    n_front = int(flat[K * 3 + 1])
    rel_R = flat[K * 3 + 2: K * 3 + 11].reshape(3, 3).astype(np.float64)
    rel_t = flat[K * 3 + 11: K * 3 + 14].astype(np.float64)
    if reverse:
        idx1_rev = np.zeros(K, np.int64)
        mvalid_rev = np.zeros(K, bool)
        sel_rev = np.zeros(K, bool)
        src = np.nonzero(mvalid)[0]
        dst = idx1[src]
        idx1_rev[dst] = src
        mvalid_rev[dst] = True
        sel_rev[dst] = sel[src]
        idx1, mvalid, sel = idx1_rev, mvalid_rev, sel_rev
        rel_R, rel_t = rel_R.T, -rel_R.T @ rel_t
    idx0 = np.arange(K)
    uv0 = feats.keypoints[i]
    uv1 = feats.keypoints[j][idx1]
    if n_raw < cfg.matching.min_raw_matches or n_front <= cfg.matching.min_inliers:
        return None, idx0, idx1, uv0, uv1, n_raw, n_front, None, None
    return sel, idx0, idx1, uv0, uv1, n_raw, n_front, rel_R, rel_t


def _match_one_pair(feats, i, j, cfg, seed):
    """Match + E-gate one pair in direction (i, j), outside any cache."""
    flat = _match_and_gate_block(feats, [(i, j)], seed, cfg)[0]
    return _decode_pair(feats, flat, i, j, reverse=False, cfg=cfg)


def _match_pair_cached(feats, i, j, cfg, seed, cache):
    """Cache-backed pair result; a miss (pair_batch=1) runs the pair."""
    a, b = min(i, j), max(i, j)
    if cache is not None and (a, b) in cache:
        return _decode_pair(feats, cache[(a, b)], i, j, reverse=(i != a), cfg=cfg)
    return _match_one_pair(feats, i, j, cfg, seed)


def run_matching(
    feats: ExtractedFeatures,
    adj: Dict[int, List[int]],
    cfg: PipelineConfig,
    seed: int = 1,
    verbose: bool = True,
    memo: Optional[Dict] = None,
    device="cuda",
    timers: Optional[Dict] = None,
) -> Tuple[List[ImageRegistration], TrackStore]:
    """Matching with multi-reference edges: every candidate edge is gated
    first (blocks of ``pair_batch``), then references are selected from the
    cached results — canonically (ranked by cheirality inliers, the
    default) or by the legacy BFS consume — followed by a retry pass and a
    2-hop rescue for images still unreached. ``timers``, when given, gets
    the seconds of each phase."""
    dev = resolve_device(device)
    feats = feats.to(dev)
    timers = {} if timers is None else timers
    n_img, K = feats.keypoints.shape[:2]
    ts = TrackStore(n_img, K, capacity=cfg.sfm.max_tracks)
    accepted: List[ImageRegistration] = []
    if not adj or all(len(v) == 0 for v in adj.values()):
        adj = {i: ([i - 1] if i else []) + ([i + 1] if i + 1 < n_img else [])
               for i in range(n_img)}
    _t0 = time.time()
    cache = (_precompute_pair_cache(feats, adj, cfg, seed, verbose=verbose, memo=memo)
             if cfg.matching.pair_batch > 1 else None)
    timers["gate_blocks"] = time.time() - _t0
    timers["n_edges"] = len(cache) if cache else 0
    _t0 = time.time()
    start = max(adj, key=lambda i: len(adj[i]))
    visited = {start}
    queue = [start]
    first = True
    qi = 0

    def make_edge(i, j, sel, idx0, idx1, uv0, uv1, rel_R, rel_t):
        track_sel = ts.union_pair(i, j, idx0[sel], idx1[sel])
        return EdgeObservations(
            ref_img=i,
            idx_ref=idx0[sel], idx_new=idx1[sel], track=track_sel,
            uv_ref=uv0[sel].astype(np.float32), uv_new=uv1[sel].astype(np.float32),
            colors_ref=feats.colors_bgr[i][idx0[sel]],
            rel_R=rel_R, rel_t=rel_t,
        )

    def decode(i, j):
        return _match_pair_cached(feats, i, j, cfg, seed, cache)

    use_canonical = cache is not None and cfg.matching.canonical_select
    track_refs: set = set()   # images already carrying track unions
    if use_canonical:
        # Order-free selection: every decision is a pure function of the
        # cached per-edge results. References are ranked by cheirality-
        # inlier count (index tiebreak), the bootstrap pair is the strongest
        # passing edge, and images are emitted in capture order.
        passing = {}   # (ref, new) -> (n_front, n_raw), all directed pairs
        for (a, b) in cache:
            for i, j in ((a, b), (b, a)):
                sel, _, _, _, _, n_raw, n_front, rel_R, _ = decode(i, j)
                if sel is not None and rel_R is not None:
                    passing[(i, j)] = (int(n_front), int(n_raw))
        boot = None
        for (i, j), (nf, nr) in sorted(passing.items(), key=lambda kv: (-kv[1][0], kv[0])):
            if nr < cfg.matching.min_pair_matches:
                continue
            sel, *_ = decode(i, j)
            if int(sel.sum()) >= cfg.matching.min_first_pair_inliers:
                boot = (i, j)
                break
        if boot is None:
            use_canonical = False   # degenerate set: legacy consume below
        else:
            by_new = {}
            for (w, jj), (nf, nr) in passing.items():
                by_new.setdefault(jj, []).append((-nf, w, nr))
            order = [boot[1]] + [v for v in range(n_img) if v != boot[1]]
            for j in order:
                edges = []
                for negnf, w, nr in sorted(by_new.get(j, [])):
                    if len(edges) >= MAX_REFS:
                        break
                    if j == boot[1] and not edges and w != boot[0]:
                        continue   # the seed image's first edge IS the seed
                    sel, idx0, idx1, uv0, uv1, _, nf_, rR, rt = decode(w, j)
                    if not edges and j != boot[1]:
                        # The primary edge carries the pair-size and track-
                        # overlap gates; the overlap gate binds only when the
                        # ref side already carries tracks.
                        if nr < cfg.matching.min_pair_matches:
                            pass_primary = False
                        else:
                            overlap = ts.overlap_fraction(w, j, idx0[sel], idx1[sel])
                            pass_primary = (w not in track_refs
                                            or overlap >= cfg.matching.min_track_overlap)
                        if not pass_primary:
                            continue
                    edges.append(make_edge(w, j, sel, idx0, idx1, uv0, uv1, rR, rt))
                    track_refs.add(w)
                    track_refs.add(j)
                if edges:
                    accepted.append(ImageRegistration(img=j, edges=edges))
                    visited.add(j)
            visited.add(boot[0])
            first = len(accepted) == 0
            if verbose:
                print(f"[match] canonical selection: {len(accepted)} images, "
                      f"{sum(len(r.edges) for r in accepted)} edges "
                      f"(bootstrap {boot})", flush=True)
    while qi < len(queue) and not use_canonical:
        u = queue[qi]
        qi += 1
        for vtx in adj[u]:
            if vtx in visited:
                continue
            ref = u
            for w in adj[vtx]:
                if w == u:
                    break
                if w in visited:
                    ref = w
                    break
            i, j = ref, vtx
            sel, idx0, idx1, uv0, uv1, n_raw, n_front, rel_R, rel_t = decode(i, j)
            if sel is None:
                if verbose:
                    print(f"[match] ({i},{j}) rejected: raw={n_raw} front={n_front}", flush=True)
                continue
            if n_raw < cfg.matching.min_pair_matches:
                if verbose:
                    print(f"[match] ({i},{j}) rejected: raw={n_raw} < min_pair_matches", flush=True)
                continue
            if first:
                # The bootstrap pair defines the global frame and scale.
                if int(sel.sum()) < cfg.matching.min_first_pair_inliers:
                    if verbose:
                        print(f"[match] ({i},{j}) rejected: weak bootstrap "
                              f"({int(sel.sum())} inliers)", flush=True)
                    continue
            else:
                overlap = ts.overlap_fraction(i, j, idx0[sel], idx1[sel])
                if overlap < cfg.matching.min_track_overlap:
                    if verbose:
                        print(f"[match] ({i},{j}) rejected: overlap {overlap:.2f}", flush=True)
                    continue
            edges = [make_edge(i, j, sel, idx0, idx1, uv0, uv1, rel_R, rel_t)]
            # Secondary reference edges: other already-visited neighbors.
            for w in [w for w in adj[vtx] if w in visited and w != i][: MAX_REFS - 1]:
                sel2, i0b, i1b, u0b, u1b, _, nf2, rR2, rt2 = decode(w, j)
                if sel2 is not None and nf2 > cfg.matching.min_inliers:
                    edges.append(make_edge(w, j, sel2, i0b, i1b, u0b, u1b, rR2, rt2))
            accepted.append(ImageRegistration(img=j, edges=edges))
            first = False
            visited.add(vtx)
            queue.append(vtx)
            if verbose:
                print(f"[match] img {j} accepted: refs {[e.ref_img for e in edges]} "
                      f"edges {[len(e.idx_new) for e in edges]}", flush=True)
    timers["bfs_consume"] = time.time() - _t0
    _t0 = time.time()
    # Retry pass: images never reached get one more attempt against every
    # visited neighbor with only the E-gate applied.
    for vtx in range(n_img):
        if vtx in visited or first:
            continue
        edges = []
        for w in adj.get(vtx, []):
            if w not in visited or len(edges) >= MAX_REFS:
                continue
            sel2, i0b, i1b, u0b, u1b, _, nf2, rR2, rt2 = decode(w, vtx)
            if sel2 is not None and nf2 > cfg.matching.min_inliers:
                edges.append(make_edge(w, vtx, sel2, i0b, i1b, u0b, u1b, rR2, rt2))
        if edges:
            accepted.append(ImageRegistration(img=vtx, edges=edges))
            visited.add(vtx)
            if verbose:
                print(f"[match] img {vtx} accepted on retry: "
                      f"refs {[e.ref_img for e in edges]}", flush=True)
    timers["retry_pass"] = time.time() - _t0
    _t0 = time.time()
    # 2-hop rescue: gate visited 2-hop view-graph neighbours of every image
    # still missing, in one batched pass, and accept edges like the retry.
    missing = [v_ for v_ in range(n_img) if v_ not in visited and not first]
    if missing and cache is not None and cfg.matching.rescue_candidates > 0:
        cand_map: Dict[int, List[int]] = {}
        fresh_pairs = []
        for vtx in missing:
            direct = set(adj.get(vtx, []))
            cands: List[int] = [w for w in adj.get(vtx, []) if w in visited]
            for w in adj.get(vtx, []):
                for w2 in adj.get(w, []):
                    if w2 != vtx and w2 in visited and w2 not in direct and w2 not in cands:
                        cands.append(w2)
            cands = cands[: cfg.matching.rescue_candidates]
            cand_map[vtx] = cands
            for w in cands:
                e = (min(w, vtx), max(w, vtx))
                if e not in cache:
                    fresh_pairs.append(e)
        timers["rescue_missing"] = len(missing)
        timers["rescue_fresh"] = len(fresh_pairs)
        if fresh_pairs:
            _batch_match_pairs(feats, fresh_pairs, cfg, seed, cache, verbose=False)
        for vtx in missing:
            edges = []
            for w in cand_map[vtx]:
                if len(edges) >= MAX_REFS:
                    break
                sel2, i0b, i1b, u0b, u1b, _, nf2, rR2, rt2 = decode(w, vtx)
                if sel2 is not None and nf2 > cfg.matching.min_inliers:
                    edges.append(make_edge(w, vtx, sel2, i0b, i1b, u0b, u1b, rR2, rt2))
            if edges:
                accepted.append(ImageRegistration(img=vtx, edges=edges))
                visited.add(vtx)
                if verbose:
                    print(f"[match] img {vtx} accepted on 2-hop rescue: "
                          f"refs {[e.ref_img for e in edges]}", flush=True)
    timers["rescue_2hop"] = time.time() - _t0
    timers["unmatched"] = sorted(v_ for v_ in range(n_img) if v_ not in visited)
    return accepted, ts


# ----------------------------------------------------------------------------
# Stage 4: reconstruct.

# The most recent run's engine phase timers and counters, and the extract
# and match timers of the most recent ``reconstruct``.
LAST_SFM_TIMERS: Dict[str, object] = {}
LAST_EXTRACT_TIMERS: Dict[str, float] = {}
LAST_MATCH_TIMERS: Dict[str, object] = {}


def _engine_devices(cfg: PipelineConfig, dev: torch.device):
    """(registration device, BA device) for SfMConfig.backend (see
    config.resolve_sfm_backend)."""
    backend = resolve_sfm_backend(cfg.sfm.backend)
    cpu = torch.device("cpu")
    if backend == "cpu":
        return cpu, cpu
    if backend == "hybrid":
        return cpu, dev
    return dev, dev


def run_reconstruction(
    feats: ExtractedFeatures,
    registrations: List[ImageRegistration],
    ts: TrackStore,
    cfg: PipelineConfig,
    verbose: bool = True,
    adj: Optional[Dict[int, List[int]]] = None,
    seed: int = 3,
    device="cuda",
) -> Reconstruction:
    """The incremental engine over the match stage's registrations: edge
    cap from the p90 edge size, reverse edges for weakly anchored images,
    chunked registration in fixpoint rounds (a round with no progress falls
    back to one sequential round), then — with ``adj`` — the re-matching
    rescue, and the final BA and gates. ``seed`` seeds the rescue's gate
    draws; the engine's PnP draws come from its own generator (seed 0, as
    tpu3d's engine key)."""
    dev = resolve_device(device)
    if cfg.sfm.edge_consistency_gate:
        raise NotImplementedError("SfMConfig.edge_consistency_gate is not ported yet "
                                  "(ROADMAP Queue 1 item 6c); it is off by default")
    reg_dev, ba_dev = _engine_devices(cfg, dev)
    engine = IncrementalSfM(n_images=len(feats.names), config=cfg.sfm, device=reg_dev,
                            ba_device=ba_dev)
    pending = list(registrations)
    for reg in pending:
        # Canonicalize track ids (unions may have merged since creation).
        for e in reg.edges:
            e.track = ts.resolve(e.track)
    # Triangulation capacity from the 90th-percentile edge size: the
    # densest tenth of edges is truncated (tpu3d/sfm/pipeline.py:1047-1053).
    sizes = [len(e.idx_new) for r in pending for e in r.edges]
    if sizes:
        engine.set_edge_cap(int(np.percentile(sizes, 90)))
    pending = _symmetrize_weak_registrations(pending, feats, verbose)
    batch = max(int(cfg.sfm.register_batch), 1)
    for round_ in range(64):
        infos = engine.register_batch(pending, batch=batch)
        failed = []
        for reg, info in zip(pending, infos):
            if verbose:
                print(f"[sfm] {info}", flush=True)
            if info.get("status") != "registered":
                failed.append(reg)
        if not failed:
            break
        if len(failed) == len(pending):
            # A batched round can stall on intra-chunk staleness that a
            # sequential pass resolves: one batch=1 round before giving up.
            if batch > 1:
                batch = 1
                if verbose:
                    print("[sfm] no batched progress — sequential fallback round", flush=True)
                continue
            break
        batch = max(int(cfg.sfm.register_batch), 1)
        pending = failed
        if verbose:
            print(f"[sfm] retry round {round_ + 1}: {len(pending)} images", flush=True)
    if adj:
        registrations = list(registrations) + _rescue_pass(engine, feats, ts, adj, cfg,
                                                           verbose, seed, dev)
    rec = engine.finalize(feats.names, registrations=registrations, verbose=verbose)
    global LAST_SFM_TIMERS
    LAST_SFM_TIMERS = {**{k: round(v, 2) for k, v in engine.timers.items()},
                       "calls": dict(engine.counters), "edge_cap": engine._edge_cap}
    if verbose:
        print("[sfm] phase seconds: "
              + json.dumps({k: round(v, 1) for k, v in engine.timers.items()})
              + " calls: " + json.dumps(engine.counters), flush=True)
    return rec


def _symmetrize_weak_registrations(registrations, feats, verbose: bool, weak_total: int = 100):
    """Reverse edges for weakly anchored images: an image whose own edges
    total fewer than ``weak_total`` matches gets reversed copies of its
    strongest incoming edges (where it is the reference), up to MAX_REFS."""
    by_img = {r.img: r for r in registrations}
    incoming: Dict[int, list] = {}
    for r in registrations:
        for e in r.edges:
            incoming.setdefault(e.ref_img, []).append((r.img, e))
    out = list(registrations)
    for j, inc in incoming.items():
        reg = by_img.get(j)
        own = sum(len(e.idx_new) for e in reg.edges) if reg else 0
        if own >= weak_total:
            continue
        have = {e.ref_img for e in reg.edges} if reg else set()
        added = 0
        for other, e in sorted(inc, key=lambda t: -len(t[1].idx_new)):
            if other in have or (reg and len(reg.edges) >= MAX_REFS):
                continue
            rev = EdgeObservations(
                ref_img=other, idx_ref=e.idx_new, idx_new=e.idx_ref, track=e.track,
                uv_ref=e.uv_new, uv_new=e.uv_ref, colors_ref=feats.colors_bgr[other][e.idx_ref],
                rel_R=None if e.rel_R is None else np.asarray(e.rel_R).T,
                rel_t=None if e.rel_R is None else -np.asarray(e.rel_R).T @ np.asarray(e.rel_t))
            if reg is None:
                reg = ImageRegistration(img=j, edges=[])
                by_img[j] = reg
                out.append(reg)
            reg.edges.append(rev)
            have.add(other)
            added += 1
        if added and verbose:
            print(f"[sfm] img {j}: +{added} reverse edges (own anchors {own} matches)",
                  flush=True)
    return out


def _rescue_pass(engine, feats, ts, adj, cfg, verbose: bool, seed: int = 3, device="cuda",
                 rounds: int = 64, deregister_round: int = 2) -> List[ImageRegistration]:
    """Re-match every still-unregistered image against its registered
    view-graph neighbours (fresh edges, fresh tracks) and register, round
    after round until a round makes no progress; at ``deregister_round``
    weak cameras are dropped so their slots are retried. The pair gates of
    round r draw from seed ``seed * 1000 + r`` (tpu3d splits a key per
    round) and are kept in a memo across rounds. Returns the rescue
    registrations."""
    rescued: List[ImageRegistration] = []
    batch = max(int(cfg.sfm.register_batch), 1)
    memo: Dict[Tuple[int, int], np.ndarray] = {}
    feats = feats.to(device)
    for rescue_round in range(rounds):
        if rescue_round == deregister_round:
            dropped = engine.deregister_weak_cameras()
            if dropped and verbose:
                print(f"[sfm] deregistered {len(dropped)} weak cameras mid-rescue: {dropped}",
                      flush=True)
        todo = [v for v in range(len(feats.names)) if not engine.has_cam[v]]
        ref_sets = {v: [r for r in adj.get(v, []) if engine.has_cam[r]][:MAX_REFS] for v in todo}
        _batch_match_pairs(feats, [(r, v) for v in todo for r in ref_sets[v]], cfg,
                           seed * 1000 + rescue_round, memo)
        round_regs = []
        for v in todo:
            edges = []
            for r in ref_sets[v]:
                a, b = min(r, v), max(r, v)
                sel, i0, i1, u0, u1, _, nf, rR, rt = _decode_pair(
                    feats, memo[(a, b)], r, v, reverse=(r != a), cfg=cfg)
                if sel is not None and nf > cfg.matching.min_inliers:
                    edges.append(EdgeObservations(
                        ref_img=r, idx_ref=i0[sel], idx_new=i1[sel],
                        track=ts.resolve(ts.union_pair(r, v, i0[sel], i1[sel])),
                        uv_ref=u0[sel].astype(np.float32), uv_new=u1[sel].astype(np.float32),
                        colors_ref=feats.colors_bgr[r][i0[sel]], rel_R=rR, rel_t=rt))
            if edges:
                round_regs.append(ImageRegistration(img=v, edges=edges))
        infos = engine.register_batch(round_regs, batch=batch)
        progressed = 0
        for reg_v, info in zip(round_regs, infos):
            if info.get("status") == "registered":
                progressed += 1
                rescued.append(reg_v)
            if verbose:
                print(f"[sfm-rescue] {info}", flush=True)
        if verbose:
            print(f"[sfm] rescue round {rescue_round}: +{progressed} registered", flush=True)
        if progressed == 0:
            if batch > 1:
                batch = 1
                continue
            break
        batch = max(int(cfg.sfm.register_batch), 1)
    return rescued


def reconstruct(
    images: ImageSource,
    cfg: Optional[PipelineConfig] = None,
    names: Optional[List[str]] = None,
    downscale: int = 1,
    verbose: bool = True,
    mode: str = "incremental",
    device="cuda",
) -> Tuple[Reconstruction, Dict[str, float]]:
    """The full pipeline: extract → retrieve → match → reconstruct on
    ``device``. ``images`` is a directory of image files or the decoded
    ``(gray_u8, rgb_u8)`` arrays. Returns (reconstruction, stage seconds);
    each stage's time ends in a synchronize."""
    if mode != "incremental":
        raise NotImplementedError(f"reconstruct mode {mode!r} is not ported yet (ROADMAP "
                                  "Queue 1 item 8: global mode)")
    cfg = cfg or PipelineConfig()
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    timings: Dict[str, float] = {}
    ext_timers: Dict[str, float] = {}
    match_timers: Dict[str, object] = {}
    t0 = time.time()
    feats = run_extraction(images, cfg, names, downscale, verbose, device=dev, timers=ext_timers)
    sync()
    timings["extract"] = time.time() - t0
    t0 = time.time()
    adj = run_retrieval(feats, cfg, device=dev)
    sync()
    timings["retrieve"] = time.time() - t0
    t0 = time.time()
    regs, ts = run_matching(feats, adj, cfg, verbose=verbose, device=dev, timers=match_timers)
    sync()
    timings["match"] = time.time() - t0
    t0 = time.time()
    rec = run_reconstruction(feats, regs, ts, cfg, verbose=verbose, adj=adj, device=dev)
    sync()
    timings["reconstruct"] = time.time() - t0
    timings["total"] = sum(timings.values())
    LAST_EXTRACT_TIMERS.clear()
    LAST_EXTRACT_TIMERS.update({k: round(v, 2) for k, v in ext_timers.items()})
    LAST_MATCH_TIMERS.clear()
    LAST_MATCH_TIMERS.update({k: round(v, 2) if isinstance(v, float) else v
                              for k, v in match_timers.items()})
    return rec, timings
