"""Incremental SfM engine — multi-reference image registration
(tpu3d/sfm/engine.py).

The registration chain is sequential, so the loop lives on the host; each
step's solves are batched tensor programs on the engine's device:

  per chunk of images: PnP-RANSAC over the union of known tracks of every
              reference edge, then per-edge DLT + GN triangulation with
              cheirality and reprojection gates (one batched step), then a
              local Schur-LM BA of each new camera and its new points;
  periodic:   global Schur-LM BA with residual pruning, or a windowed BA
              over the most recent cameras.

The host state (cameras, points, the first-wins observation table) is
numpy, as tpu3d's. tpu3d pads every device input to fixed capacities so
that XLA compiles once; the port keeps only the caps that drop data, since
those change decisions: MAX_REFS reference edges per image, PNP_CAP
anchors, BA_CAP_P / BA_CAP_O in the local BA, and the per-edge
triangulation cap (``set_edge_cap``). The shape ladders, the tunnel's
device contexts and the register-step forensics are not ported.

Random draws: tpu3d splits a ``jax.random`` key per registration; the
engine here draws each registration's PnP Gumbel noise from a
``torch.Generator`` seeded with ``seed`` (``_pnp_draws``, which a test
replaces to feed tpu3d's draws).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu3d_torch import f32_scope
from tpu3d_torch.ba.lm import bundle_adjust
from tpu3d_torch.ba.residuals import reprojection_residuals
from tpu3d_torch.config import SfMConfig
from tpu3d_torch.core.lie import so3_exp, so3_exp_np, so3_log, so3_log_np
from tpu3d_torch.geometry.estimators import find_essential_ransac, lo_hypotheses
from tpu3d_torch.geometry.pnp import pnp_ransac
from tpu3d_torch.geometry.ransac import gumbel
from tpu3d_torch.geometry.triangulate import refine_triangulation_gn, triangulate_dlt
from tpu3d_torch.sfm.scene import Reconstruction

PNP_CAP = 4096    # max known-track anchors per image registration
EDGE_CAP = 2048   # max inlier matches per edge (= keypoint budget)
BA_CAP_P = 4096   # max points in the local BA
BA_CAP_O = 8192   # max observations in the local BA
MAX_REFS = 3      # reference views per image


@dataclasses.dataclass
class EdgeObservations:
    """Inlier matches of one (registered_ref, new) image edge, produced by
    the matching stage. Variable-length host arrays (M,)."""

    ref_img: int
    idx_ref: np.ndarray
    idx_new: np.ndarray
    track: np.ndarray       # resolved global track ids
    uv_ref: np.ndarray      # (M, 2) centered coords
    uv_new: np.ndarray
    colors_ref: np.ndarray  # (M, 3) uint8 BGR sampled at ref keypoints
    rel_R: Optional[np.ndarray] = None  # world->new given ref=I (from E)
    rel_t: Optional[np.ndarray] = None


@dataclasses.dataclass
class ImageRegistration:
    img: int
    edges: List[EdgeObservations]


@dataclasses.dataclass
class PairObservations:
    """One matched pair in flat form; ``to_registration`` converts it."""

    img0: int
    img1: int
    idx0: np.ndarray
    idx1: np.ndarray
    track: np.ndarray
    uv0: np.ndarray
    uv1: np.ndarray
    valid: np.ndarray
    colors0: np.ndarray
    rel_R: Optional[np.ndarray] = None
    rel_t: Optional[np.ndarray] = None

    def to_registration(self) -> ImageRegistration:
        sel = self.valid
        return ImageRegistration(
            img=self.img1,
            edges=[EdgeObservations(
                ref_img=self.img0,
                idx_ref=self.idx0[sel], idx_new=self.idx1[sel],
                track=self.track[sel],
                uv_ref=self.uv0[sel], uv_new=self.uv1[sel],
                colors_ref=self.colors0[sel],
                rel_R=self.rel_R, rel_t=self.rel_t,
            )],
        )


def _safe(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)


def triangulate_and_gate(cam_i, cam_j, uv0n, uv1n, focal: float, thr_px: float):
    """DLT + 2 GN steps, then the quality gate: positive depth in both
    views and both reprojection errors below (2 thr_px / focal)². cam_i,
    cam_j (..., 6); uv (..., N, 2) focal-normalized. Returns (X (..., N, 3),
    good (..., N) bool)."""
    Ri, ti = so3_exp(cam_i[..., :3]), cam_i[..., 3:6]
    Rj, tj = so3_exp(cam_j[..., :3]), cam_j[..., 3:6]
    X = triangulate_dlt(Ri, ti, Rj, tj, uv0n, uv1n)
    X = refine_triangulation_gn(Ri, ti, Rj, tj, uv0n, uv1n, X, iters=2)
    Xci = torch.einsum("...ij,...nj->...ni", Ri, X) + ti[..., None, :]
    Xcj = torch.einsum("...ij,...nj->...ni", Rj, X) + tj[..., None, :]
    err_i = ((Xci[..., :2] / _safe(Xci[..., 2:3]) - uv0n) ** 2).sum(-1)
    err_j = ((Xcj[..., :2] / _safe(Xcj[..., 2:3]) - uv1n) ** 2).sum(-1)
    thr = (thr_px * 2.0 / focal) ** 2
    good = (Xci[..., 2] > 1e-4) & (Xcj[..., 2] > 1e-4) & (err_i < thr) & (err_j < thr)
    return X, good


def _stack_padded(arrays: Sequence[np.ndarray], n: int) -> np.ndarray:
    """Stack (m_i, ...) arrays into (len, n, ...), zero-padded or cut to n."""
    out = np.zeros((len(arrays), n, *arrays[0].shape[1:]), np.float32)
    for k, a in enumerate(arrays):
        m = min(len(a), n)
        out[k, :m] = a[:m]
    return out


class IncrementalSfM:
    def __init__(self, n_images: int, config: Optional[SfMConfig] = None, seed: int = 0,
                 device="cpu", ba_device=None):
        """``device`` runs the registration step and the local BA;
        ``ba_device`` (default: the same) the windowed and global BA."""
        self.cfg = config or SfMConfig()
        self.focal = float(self.cfg.camera.focal_length)
        self.n_images = n_images
        self.device = torch.device(device)
        self.ba_device = torch.device(ba_device) if ba_device is not None else self.device
        cap = self.cfg.max_tracks
        self.cams = np.zeros((n_images, 6), np.float32)
        self.has_cam = np.zeros(n_images, bool)
        self.points = np.zeros((cap, 3), np.float32)
        self.point_valid = np.zeros(cap, bool)
        self.point_color = np.zeros((cap, 3), np.uint8)
        # First-wins observation table keyed by (img, kpt), dense: slot =
        # img * K + kpt.
        K = self.cfg.match_capacity
        self._K = K
        self.obs_valid = np.zeros(n_images * K, np.uint8)
        self.obs_track = np.zeros(n_images * K, np.int64)
        self.obs_uv = np.zeros((n_images * K, 2), np.float32)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.num_registered = 0
        self.reg_order: List[int] = []
        self.pair_log: List[dict] = []
        # Cumulative wall-clock per phase; device work ends in a host copy
        # inside each phase, so these include it.
        self.timers: Dict[str, float] = {
            "pnp": 0.0, "triangulate": 0.0, "local_ba": 0.0,
            "global_ba": 0.0, "windowed_ba": 0.0, "host": 0.0,
        }
        self.counters: Dict[str, int] = {"global_ba": 0, "windowed_ba": 0}
        self._edge_cap = EDGE_CAP
        self._last_gba_n = 0

    # ------------------------------------------------------------------
    def set_edge_cap(self, max_matches: int) -> None:
        """Per-edge triangulation capacity: the smallest power of two >=
        max_matches (floor 256, ceiling EDGE_CAP). Matches of an edge
        beyond it are not triangulated from that edge (a data cut, kept
        from tpu3d because it changes which points exist)."""
        cap = 256
        while cap < min(int(max_matches), EDGE_CAP):
            cap *= 2
        self._edge_cap = min(cap, EDGE_CAP)

    def _pnp_draws(self, n: int) -> torch.Tensor:
        """One registration's PnP Gumbel noise: (num_hypotheses // 2, n)."""
        return gumbel(self.gen, (self.cfg.ransac.num_hypotheses // 2, n), self.device)

    def _essential_draws(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The bootstrap's E-RANSAC draws when an edge has no relative pose."""
        m = self.cfg.ransac.num_hypotheses
        return (gumbel(self.gen, (m, EDGE_CAP), self.device),
                gumbel(self.gen, (lo_hypotheses(m), EDGE_CAP), self.device))

    def _record_obs(self, img: int, idx: np.ndarray, track: np.ndarray, uv: np.ndarray):
        """First-wins insert into the dense observation table: within the
        batch the first occurrence of a keypoint wins, and occupied slots
        are kept."""
        if len(idx) == 0:
            return
        idx = np.asarray(idx, np.int64)
        uniq, first = np.unique(idx, return_index=True)
        slots = img * self._K + uniq
        free = self.obs_valid[slots] == 0
        slots = slots[free]
        sel = first[free]
        self.obs_valid[slots] = 1
        self.obs_track[slots] = np.asarray(track, np.int64)[sel]
        self.obs_uv[slots] = np.asarray(uv, np.float32)[sel]

    def _device_time(self) -> float:
        t = self.timers
        return t["pnp"] + t["triangulate"] + t["local_ba"] + t["global_ba"] + t["windowed_ba"]

    # ------------------------------------------------------------------
    def register_image(self, reg: ImageRegistration) -> dict:
        t_enter = time.time()
        dev_before = self._device_time()
        info = self._register_image(reg)
        self.timers["host"] += (time.time() - t_enter) - (self._device_time() - dev_before)
        return info

    def register_batch(self, regs: Sequence[ImageRegistration], batch: int = 8) -> List[dict]:
        """Register images in chunks of ``batch``: each chunk's members are
        prepared against the pre-chunk state and go through one batched
        PnP + triangulation step; an image whose anchors would come from an
        earlier member of the same chunk fails this round and succeeds on
        the caller's next fixpoint round. Local BA and the global/windowed
        BA cadence run once per chunk."""
        t_enter = time.time()
        dev_before = self._device_time()
        infos: List[dict] = []
        i = 0
        # Bootstrap sequentially until the first pair defines the frame.
        while i < len(regs) and self.num_registered == 0:
            infos.append(self._register_image(regs[i]))
            i += 1
        while i < len(regs):
            chunk = regs[i: i + batch]
            i += len(chunk)
            n0 = self.num_registered
            preps = [self._prepare_register(r) for r in chunk]
            for p in preps:
                p["defer_ba"] = True
            dev = [p for p in preps if p["status"] == "device"]
            outs = dict(zip(map(id, dev), self._register_step(dev))) if dev else {}
            for p in preps:
                infos.append(self._commit_register(p, outs.get(id(p))))
            self._catch_up_triangulation(preps)
            jobs = [p["_ba_job"] for p in preps if "_ba_job" in p]
            if self.cfg.run_pair_ba and jobs:
                self._local_ba_chunk(jobs)
            cfg = self.cfg
            if (cfg.run_global_ba and self.num_registered > n0
                    and self.num_registered // cfg.global_ba_every > n0 // cfg.global_ba_every):
                if self.num_registered >= self._last_gba_n * cfg.global_ba_growth:
                    self.global_ba()
                    self._last_gba_n = self.num_registered
                else:
                    self.windowed_ba(window=cfg.local_window)
        self.timers["host"] += (time.time() - t_enter) - (self._device_time() - dev_before)
        return infos

    def _register_step(self, preps: List[dict]) -> List[tuple]:
        """The fused step for prepared images: PnP-RANSAC of each image's
        camera, then DLT + GN triangulation and gating of each of its
        reference edges against that camera, batched over the images.
        Returns per image (cam (6,), inlier count, X (E, N, 3), good (E, N))."""
        cfg = self.cfg
        dev = self.device
        n = max(len(p["inputs"][0]) for p in preps)
        E = max(len(p["inputs"][3]) for p in preps)
        N = max(max(len(u) for u in p["inputs"][4]) for p in preps)
        noise = torch.zeros((len(preps), cfg.ransac.num_hypotheses // 2, n), device=dev)
        for b, p in enumerate(preps):
            noise[b, :, : p["noise"].shape[1]] = p["noise"]
        Xk = _stack_padded([p["inputs"][0] for p in preps], n)
        uvk = _stack_padded([p["inputs"][1] for p in preps], n)
        wk = _stack_padded([p["inputs"][2] for p in preps], n)
        cams_i = np.zeros((len(preps), E, 6), np.float32)
        uv_r = np.zeros((len(preps), E, N, 2), np.float32)
        uv_n = np.zeros((len(preps), E, N, 2), np.float32)
        for b, p in enumerate(preps):
            ci, ur, un = p["inputs"][3:]
            cams_i[b, : len(ci)] = ci
            uv_r[b, : len(ci)] = _stack_padded(ur, N)
            uv_n[b, : len(ci)] = _stack_padded(un, N)
        t0 = time.time()
        with f32_scope(), torch.no_grad():
            R, t, _, cnt = pnp_ransac(noise, *(torch.from_numpy(a).to(dev) for a in (Xk, uvk, wk)),
                                      preps[0]["pnp_thr"])
            cam_j = torch.cat([so3_log(R), t], dim=-1)
            X, good = triangulate_and_gate(
                torch.from_numpy(cams_i).to(dev), cam_j[:, None, :].expand(-1, E, 6),
                torch.from_numpy(uv_r).to(dev), torch.from_numpy(uv_n).to(dev),
                self.focal, cfg.ransac.threshold_px * 2.0)
            cam_j, cnt, X, good = (a.cpu().numpy() for a in (cam_j, cnt, X, good))
        self.timers["pnp"] += time.time() - t0
        return [(cam_j[b], int(cnt[b]), X[b], good[b]) for b in range(len(preps))]

    def _catch_up_triangulation(self, preps: List[dict]) -> None:
        """Triangulate edges the chunk's prepare-time snapshot skipped
        because their reference registered inside the same chunk, in one
        batched step."""
        catch = []
        for p in preps:
            if p["info"].get("status") != "registered" or p["status"] == "bootstrap":
                continue
            done = {id(e) for e in p.get("tri_edges", [])}
            for e in p["edges"]:
                if id(e) not in done and self.has_cam[e.ref_img]:
                    catch.append((p["img"], e))
        if not catch:
            return
        cap = self._edge_cap
        N = min(cap, max(len(e.uv_ref) for _, e in catch))
        ci = torch.from_numpy(np.stack([self.cams[e.ref_img] for _, e in catch]))
        cj = torch.from_numpy(np.stack([self.cams[j] for j, _ in catch]))
        u0 = _stack_padded([e.uv_ref.astype(np.float32) / self.focal for _, e in catch], N)
        u1 = _stack_padded([e.uv_new.astype(np.float32) / self.focal for _, e in catch], N)
        t0 = time.time()
        with f32_scope(), torch.no_grad():
            X, good = triangulate_and_gate(
                ci.to(self.device), cj.to(self.device), torch.from_numpy(u0).to(self.device),
                torch.from_numpy(u1).to(self.device), self.focal, self.cfg.ransac.threshold_px * 2.0)
            X, good = X.cpu().numpy(), good.cpu().numpy()
        self.timers["triangulate"] += time.time() - t0
        for k, (jimg, e) in enumerate(catch):
            self._commit_tri_edge(jimg, e, X[k], good[k])

    def _register_image(self, reg: ImageRegistration) -> dict:
        prep = self._prepare_register(reg)
        out = self._register_step([prep])[0] if prep["status"] == "device" else None
        return self._commit_register(prep, out)

    def _prepare_register(self, reg: ImageRegistration) -> dict:
        """Read-only half of registration: gather the anchors and the
        triangulation inputs against the current state, and snapshot the
        edges to triangulate (so batched commits stay aligned with the
        step's outputs when other chunk members register their references
        in between)."""
        cfg = self.cfg
        f = self.focal
        j = reg.img
        edges = [e for e in reg.edges if len(e.idx_new) >= 4][:MAX_REFS]
        info = {"img": j, "n_edges": len(edges), "edge_sizes": [len(e.idx_new) for e in edges]}
        prep = {"reg": reg, "info": info, "edges": edges, "img": j}

        if self.num_registered == 0:
            e0 = edges[0] if edges else None
            if e0 is None:
                info["status"] = "rejected_no_bootstrap_pose"
                prep["status"] = "reject"
                return prep
            if e0.rel_R is None:
                # No relative pose attached (synthetic callers): recover it.
                m = min(len(e0.idx_new), EDGE_CAP)
                dev = self.device
                with f32_scope(), torch.no_grad():
                    eres = find_essential_ransac(
                        torch.from_numpy(_stack_padded([e0.uv_ref.astype(np.float32)], EDGE_CAP)[0]).to(dev),
                        torch.from_numpy(_stack_padded([e0.uv_new.astype(np.float32)], EDGE_CAP)[0]).to(dev),
                        torch.from_numpy((np.arange(EDGE_CAP) < m).astype(np.float32)).to(dev),
                        f, self._essential_draws(), threshold_px=cfg.ransac.threshold_px)
                if int(eres.num_inliers) < 8:
                    info["status"] = "rejected_no_bootstrap_pose"
                    prep["status"] = "reject"
                    return prep
                e0 = dataclasses.replace(e0, rel_R=eres.R.cpu().numpy(), rel_t=eres.t.cpu().numpy())
            prep["status"] = "bootstrap"
            prep["e0"] = e0
            return prep

        # PnP over the union of known tracks across ALL edges: anchors need
        # valid 3D tracks, not registered reference cameras.
        X_list, uv_list = [], []
        seen_kpts = set()
        for e in edges:
            tr = np.clip(e.track, 0, self.points.shape[0] - 1)
            known = (e.track >= 0) & self.point_valid[tr]
            for m in np.nonzero(known)[0]:
                k = int(e.idx_new[m])
                if k in seen_kpts:
                    continue
                seen_kpts.add(k)
                X_list.append(self.points[tr[m]])
                uv_list.append(e.uv_new[m])
        n_known = len(X_list)
        if n_known < 10 and not any(self.has_cam[e.ref_img] for e in edges):
            info["status"] = "rejected_no_registered_refs"
            info["n_known"] = n_known
            prep["status"] = "reject"
            return prep
        info["n_known"] = n_known
        prep["tri_edges"] = [e for e in edges if self.has_cam[e.ref_img]]
        if n_known < 10:
            prep["status"] = "fallback"
            return prep
        n = min(n_known, PNP_CAP)           # anchors beyond PNP_CAP are dropped
        Xk = np.asarray(X_list[:n], np.float32)
        uvk = np.asarray(uv_list[:n], np.float32) / f
        wk = np.ones(n, np.float32)
        # The triangulation inputs do not depend on the PnP result, so they
        # ride in the same step; with no registered reference edge, one
        # dummy edge whose outputs the commit ignores.
        tri = prep["tri_edges"]
        if tri:
            cams_i = np.stack([self.cams[e.ref_img] for e in tri])
            uv_r = [e.uv_ref[: self._edge_cap].astype(np.float32) / f for e in tri]
            uv_n = [e.uv_new[: self._edge_cap].astype(np.float32) / f for e in tri]
        else:
            cams_i = np.zeros((1, 6), np.float32)
            uv_r = uv_n = [np.zeros((1, 2), np.float32)]
        prep["status"] = "device"
        prep["inputs"] = (Xk, uvk, wk, cams_i, uv_r, uv_n)
        prep["pnp_thr"] = (2.0 * cfg.ransac.threshold_px / f) ** 2
        prep["noise"] = self._pnp_draws(n)
        return prep

    def _commit_register(self, prep: dict, out=None) -> dict:
        """Write half: camera, point and observation commits, then local BA
        and the BA cadence (deferred to the chunk in register_batch). ``out``
        is the step's (cam, inlier count, per-edge X, per-edge gate)."""
        cfg = self.cfg
        info = prep["info"]
        j = prep["img"]
        edges = prep["edges"]
        if prep["status"] == "reject":
            return info
        fused = None
        if prep["status"] == "bootstrap":
            e0 = prep["e0"]
            self.cams[e0.ref_img] = 0.0
            self.has_cam[e0.ref_img] = True
            cam_j = np.concatenate([so3_log_np(e0.rel_R), e0.rel_t]).astype(np.float32)
            self.num_registered += 1
            self.reg_order.append(e0.ref_img)
            edges = [e0]
            tri_snapshot = [e0]
        else:
            tri_snapshot = prep["tri_edges"]
            cam_j = None
            if prep["status"] == "device" and out is not None:
                cam_dev, pnp_cnt, X_dev, good_dev = out
                info["n_pnp_inliers"] = pnp_cnt
                if pnp_cnt > cfg.min_pnp_inliers:
                    cam_j = np.asarray(cam_dev)
                    if tri_snapshot:
                        fused = (X_dev, good_dev)
            if cam_j is None:
                # Relative-pose fallback: PnP failed or too few anchors.
                cam_j = self._relative_pose_fallback(j, edges, info)
                if cam_j is None:
                    info["status"] = info.get("status", "rejected_pnp")
                    return info

        self.cams[j] = cam_j
        if not self.has_cam[j]:
            self.has_cam[j] = True
            self.num_registered += 1
            self.reg_order.append(j)

        n_new_total = 0
        ba_edges = []
        tri_edges = []
        tri_ids = {id(e) for e in tri_snapshot}
        for e in edges:
            if id(e) not in tri_ids:
                # Reference not registered at prepare time: record this
                # image's observations of already-valid tracks only.
                tr2 = np.clip(e.track, 0, self.points.shape[0] - 1)
                live = (e.track >= 0) & self.point_valid[tr2]
                if live.any():
                    self._record_obs(j, e.idx_new[live], e.track[live], e.uv_new[live])
                    self._record_obs(e.ref_img, e.idx_ref[live], e.track[live], e.uv_ref[live])
                continue
            tri_edges.append(e)
        if tri_edges and fused is not None:
            X_all, good_all = fused
        elif tri_edges:
            f = self.focal
            N = min(self._edge_cap, max(len(e.uv_ref) for e in tri_edges))
            t0 = time.time()
            with f32_scope(), torch.no_grad():
                X_all, good_all = triangulate_and_gate(
                    torch.from_numpy(np.stack([self.cams[e.ref_img] for e in tri_edges])).to(self.device),
                    torch.from_numpy(cam_j).to(self.device).expand(len(tri_edges), 6),
                    torch.from_numpy(_stack_padded([e.uv_ref.astype(np.float32) / f
                                                    for e in tri_edges], N)).to(self.device),
                    torch.from_numpy(_stack_padded([e.uv_new.astype(np.float32) / f
                                                    for e in tri_edges], N)).to(self.device),
                    f, cfg.ransac.threshold_px * 2.0)
                X_all, good_all = X_all.cpu().numpy(), good_all.cpu().numpy()
            self.timers["triangulate"] += time.time() - t0
        for k, e in enumerate(tri_edges):
            accept, n_new = self._commit_tri_edge(j, e, X_all[k], good_all[k])
            n_new_total += n_new
            ba_edges.append((e, accept))

        info.update(status="registered", n_new_points=n_new_total)
        if prep.get("defer_ba"):
            prep["_ba_job"] = (j, ba_edges)
            self.pair_log.append(info)
            return info

        if cfg.run_pair_ba:
            t0 = time.time()
            self._local_ba(j, ba_edges)
            self.timers["local_ba"] += time.time() - t0
        if cfg.run_global_ba and self.num_registered % cfg.global_ba_every == 0:
            if self.num_registered >= self._last_gba_n * cfg.global_ba_growth:
                self.global_ba()
                self._last_gba_n = self.num_registered
                info["global_ba"] = True
            else:
                self.windowed_ba(window=cfg.local_window)
                info["windowed_ba"] = True
        self.pair_log.append(info)
        return info

    def _commit_tri_edge(self, j: int, e, X_row: np.ndarray, good_row: np.ndarray):
        """Accept newly triangulated tracks on edge (e.ref_img, j) and record
        observations of every live match (first-wins makes re-recording
        idempotent). Only the edge's first ``_edge_cap`` matches can create
        points."""
        tr = np.clip(e.track, 0, self.points.shape[0] - 1)
        new = (e.track >= 0) & ~self.point_valid[tr]
        m = min(len(e.idx_new), self._edge_cap)
        accept = np.zeros(len(e.idx_new), bool)
        accept[:m] = good_row[:m] & new[:m]
        n_new = int(accept.sum())
        if n_new:
            ids = e.track[accept]
            self.points[ids] = X_row[:m][accept[:m]]
            self.point_valid[ids] = True
            self.point_color[ids] = e.colors_ref[accept]
        live = (e.track >= 0) & self.point_valid[tr]
        if live.any():
            self._record_obs(e.ref_img, e.idx_ref[live], e.track[live], e.uv_ref[live])
            self._record_obs(j, e.idx_new[live], e.track[live], e.uv_new[live])
        return accept, n_new

    # ------------------------------------------------------------------
    def _relative_pose_fallback(self, j: int, edges, info: dict, relaxed: bool = False):
        """world->j from a registered reference's camera and the edge's
        relative pose (from E), the translation scale from shared valid
        tracks: x_new = rel_R x_ref + s rel_t, s the median depth ratio of
        the known points against their unit-baseline midpoint
        triangulation. Gated on the ratios' spread and on most anchors
        reprojecting within 8 thresholds. Numpy, as tpu3d's. ``relaxed``
        (the --register-all pass) skips the spread gate, takes the best
        candidate whatever its support, and with none chains the first
        registered reference's relative pose at scale 1."""

        def midpoint_np(Rrel, trel, xr, xn):
            d0 = np.concatenate([xr, np.ones((len(xr), 1), np.float32)], -1)
            d1 = np.concatenate([xn, np.ones((len(xn), 1), np.float32)], -1)
            d1 = d1 @ Rrel
            d0 = d0 / np.linalg.norm(d0, axis=-1, keepdims=True)
            d1 = d1 / np.linalg.norm(d1, axis=-1, keepdims=True)
            c1 = -Rrel.T @ trel
            d01 = np.sum(d0 * d1, -1)
            denom = np.maximum(1.0 - d01**2, 1e-9)
            bd0 = d0 @ c1
            bd1 = d1 @ c1
            s0 = (bd0 - d01 * bd1) / denom
            s1 = (d01 * bd0 - bd1) / denom
            return 0.5 * (s0[:, None] * d0 + (c1[None, :] + s1[:, None] * d1))

        f = self.focal
        best = None
        for e in edges:
            if e.rel_R is None or not self.has_cam[e.ref_img]:
                continue
            tr = np.clip(e.track, 0, self.points.shape[0] - 1)
            known = (e.track >= 0) & self.point_valid[tr]
            if known.sum() < 3:
                continue
            R_r = so3_exp_np(self.cams[e.ref_img, :3])
            t_r = self.cams[e.ref_img, 3:6]
            Xw = self.points[tr[known]]
            X_ref = Xw @ R_r.T + t_r
            # Only anchors that reproject onto their own observation in the
            # reference camera vote on the scale.
            zr = X_ref[:, 2]
            pred_r = f * X_ref[:, :2] / np.where(np.abs(zr[:, None]) < 1e-9, 1e-9, zr[:, None])
            err_r = np.linalg.norm(pred_r - e.uv_ref[known], axis=1)
            consistent = (zr > 1e-4) & (err_r < 6.0 * self.cfg.ransac.threshold_px)
            if consistent.sum() >= 6:
                known_idx = np.nonzero(known)[0][consistent]
                known = np.zeros_like(known)
                known[known_idx] = True
                Xw = self.points[tr[known]]
                X_ref = Xw @ R_r.T + t_r
            uv_r = e.uv_ref[known].astype(np.float32) / f
            uv_n = e.uv_new[known].astype(np.float32) / f
            X_rel = midpoint_np(e.rel_R.astype(np.float32), e.rel_t.astype(np.float32), uv_r, uv_n)
            z_ratio = X_ref[:, 2] / np.where(np.abs(X_rel[:, 2]) < 1e-9, 1e-9, X_rel[:, 2])
            z_ratio = z_ratio[(z_ratio > 1e-6) & np.isfinite(z_ratio)]
            if len(z_ratio) < 6:
                continue
            s = float(np.median(z_ratio))
            mad = float(np.median(np.abs(z_ratio - s))) / max(abs(s), 1e-9)
            if mad > 0.25 and not relaxed:
                continue
            R_j = e.rel_R @ R_r
            t_j = e.rel_R @ t_r + s * e.rel_t
            Xc = Xw @ R_j.T + t_j
            ok_z = Xc[:, 2] > 1e-4
            pred = f * Xc[:, :2] / np.where(np.abs(Xc[:, 2:3]) < 1e-9, 1e-9, Xc[:, 2:3])
            err = np.linalg.norm(pred - e.uv_new[known], axis=1)
            good = int(np.sum(ok_z & (err < 8.0 * self.cfg.ransac.threshold_px)))
            if best is None or good > best[0]:
                best = (good, R_j, t_j, len(err))
        if relaxed:
            if best is None:
                for e in edges:
                    if e.rel_R is None or not self.has_cam[e.ref_img]:
                        continue
                    R_r = so3_exp_np(self.cams[e.ref_img, :3])
                    t_r = self.cams[e.ref_img, 3:6]
                    info["fallback_relpose_inliers"] = "chained_s1"
                    return np.concatenate([so3_log_np(e.rel_R @ R_r),
                                           e.rel_R @ t_r + e.rel_t]).astype(np.float32)
                return None
            info["fallback_relpose_inliers"] = f"{best[0]}/{best[3]} (relaxed)"
            return np.concatenate([so3_log_np(best[1]), best[2]]).astype(np.float32)
        if best is None or best[0] < 6 or best[0] < 0.5 * best[3]:
            return None
        info["fallback_relpose_inliers"] = f"{best[0]}/{best[3]}"
        return np.concatenate([so3_log_np(best[1]), best[2]]).astype(np.float32)

    # ------------------------------------------------------------------
    def _local_ba_prepare(self, j: int, ba_edges):
        """The local BA problem of camera j: the live tracks of its edges
        (at most BA_CAP_P points, BA_CAP_O observations), residuals in j and
        every reference; only camera j and the new points move."""
        f = self.focal
        track_slot: Dict[int, int] = {}
        pts, pt_new, obs = [], [], []
        cams_list = [self.cams[j]]
        cam_slot = {j: 0}
        for e, accept in ba_edges:
            if e.ref_img not in cam_slot:
                cam_slot[e.ref_img] = len(cams_list)
                cams_list.append(self.cams[e.ref_img])
            cs = cam_slot[e.ref_img]
            tr = np.clip(e.track, 0, self.points.shape[0] - 1)
            live = (e.track >= 0) & self.point_valid[tr]
            for m in np.nonzero(live)[0]:
                t = int(e.track[m])
                if t not in track_slot:
                    if len(pts) >= BA_CAP_P:
                        continue
                    track_slot[t] = len(pts)
                    pts.append(self.points[t])
                    pt_new.append(bool(accept[m]))
                ps = track_slot[t]
                if len(obs) < BA_CAP_O - 1:
                    obs.append((0, ps, e.uv_new[m, 0] / f, e.uv_new[m, 1] / f))
                    obs.append((cs, ps, e.uv_ref[m, 0] / f, e.uv_ref[m, 1] / f))
        if len(obs) < 16 or not pts:
            return None
        cam_fixed = np.ones(len(cams_list), np.float32)
        cam_fixed[0] = 0.0
        obs_arr = np.asarray(obs, np.float32)
        arrays = (np.stack(cams_list).astype(np.float32), np.asarray(pts, np.float32),
                  obs_arr[:, 0].astype(np.int64), obs_arr[:, 1].astype(np.int64),
                  np.ascontiguousarray(obs_arr[:, 2:4]), np.ones(len(obs), np.float32),
                  cam_fixed, (~np.asarray(pt_new)).astype(np.float32))
        return arrays, track_slot, pt_new

    def _local_ba_commit(self, j: int, cams_out, pts_out, track_slot, pt_new):
        self.cams[j] = cams_out[0]
        for t, s in track_slot.items():
            if pt_new[s]:
                self.points[t] = pts_out[s]

    def _solve_local(self, arrays, stall_tol: float):
        st = bundle_adjust(*(torch.from_numpy(a).to(self.device) for a in arrays),
                           max_iters=self.cfg.ba.max_iters // 2, cg_iters=8, stall_tol=stall_tol)
        return st.cams.cpu().numpy(), st.points.cpu().numpy()

    def _local_ba(self, j: int, ba_edges) -> None:
        """Camera j and the points just triangulated, with residuals in j
        and every (frozen) reference camera."""
        prep = self._local_ba_prepare(j, ba_edges)
        if prep is not None:
            arrays, track_slot, pt_new = prep
            self._local_ba_commit(j, *self._solve_local(arrays, 1e-5), track_slot, pt_new)

    def _local_ba_chunk(self, jobs) -> None:
        """A registration chunk's local BAs: independent problems, solved
        one after the other (tpu3d vmaps them; its batched solve uses stall
        tolerance 1e-4, the single one 1e-5)."""
        t0 = time.time()
        for j, ba_edges in jobs:
            prep = self._local_ba_prepare(j, ba_edges)
            if prep is not None:
                arrays, track_slot, pt_new = prep
                self._local_ba_commit(j, *self._solve_local(arrays, 1e-4), track_slot, pt_new)
        self.timers["local_ba"] += time.time() - t0

    # ------------------------------------------------------------------
    def _gather_global_problem(self):
        """The live observations (registered camera, valid point) of the
        dense table, sorted by point. Returns (cam_slots, cam_idx,
        uniq_tracks, pt_idx, uv, keys) or None; keys are table slots."""
        slots = np.flatnonzero(self.obs_valid)
        if len(slots) == 0:
            return None
        img_ids = (slots // self._K).astype(np.int64)
        tracks = self.obs_track[slots]
        uv = self.obs_uv[slots] / self.focal
        live = (self.point_valid[np.clip(tracks, 0, len(self.point_valid) - 1)]
                & self.has_cam[img_ids])
        slots, img_ids, tracks, uv = slots[live], img_ids[live], tracks[live], uv[live]
        if len(img_ids) == 0:
            return None
        cam_slots = np.flatnonzero(self.has_cam)
        cam_map = np.full(self.n_images, -1, np.int64)
        cam_map[cam_slots] = np.arange(len(cam_slots))
        cam_idx = cam_map[img_ids]
        uniq_tracks, pt_idx = np.unique(tracks, return_inverse=True)
        order = np.argsort(pt_idx, kind="stable")
        return (cam_slots, cam_idx[order], uniq_tracks, pt_idx[order].astype(np.int64),
                uv[order].astype(np.float32), slots[order])

    def _ba(self, cams, pts, ci, pi, uv, w, cam_fixed, pt_fixed, **kw):
        dev = self.ba_device
        return bundle_adjust(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                               for a in (cams, pts, ci, pi, uv, w, cam_fixed, pt_fixed)), **kw)

    def _robust(self) -> Optional[float]:
        rb = self.cfg.ba.robust_huber_px
        return (rb / self.focal) if rb else None

    def windowed_ba(self, window: int = 25, max_iters: Optional[int] = None):
        """Refine the most recent ``window`` registered cameras and the
        tracks they observe, every other observer of those tracks frozen."""
        t0 = time.time()
        self.counters["windowed_ba"] += 1
        self._windowed_ba(window, max_iters)
        self.timers["windowed_ba"] += time.time() - t0

    def _windowed_ba(self, window: int, max_iters: Optional[int]):
        recent = [i for i in self.reg_order if self.has_cam[i]][-window:]
        if len(recent) < 2:
            return
        recent_set = np.zeros(self.n_images, bool)
        recent_set[recent] = True
        prob = self._gather_global_problem()
        if prob is None:
            return
        cam_slots, cam_idx, uniq_tracks, pt_idx, uv, _ = prob
        win_tracks = np.zeros(len(uniq_tracks), bool)
        win_tracks[pt_idx[recent_set[cam_slots[cam_idx]]]] = True
        keep = win_tracks[pt_idx]
        cam_idx, pt_idx, uv = cam_idx[keep], pt_idx[keep], uv[keep]
        used_cams = np.unique(cam_idx)
        cmap = np.full(len(cam_slots), -1, np.int64)
        cmap[used_cams] = np.arange(len(used_cams))
        cam_idx = cmap[cam_idx]
        used_tracks = np.unique(pt_idx)
        pmap = np.full(len(uniq_tracks), -1, np.int64)
        pmap[used_tracks] = np.arange(len(used_tracks))
        pt_idx = pmap[pt_idx]
        cam_fixed = (~recent_set[cam_slots[used_cams]]).astype(np.float32)
        if cam_fixed.min() == 1.0:
            return
        if cam_fixed.max() == 0.0:      # gauge: freeze the oldest moving camera
            cam_fixed[0] = 1.0
        st = self._ba(self.cams[cam_slots[used_cams]], self.points[uniq_tracks[used_tracks]],
                      cam_idx, pt_idx, uv, np.ones(len(cam_idx), np.float32), cam_fixed,
                      np.zeros(len(used_tracks), np.float32),
                      max_iters=max_iters or self.cfg.ba.mid_max_iters,
                      cg_iters=self.cfg.ba.mid_cg_iters, robust_delta=self._robust(),
                      stall_tol=1e-4)
        new_cams = st.cams.cpu().numpy()
        moving = cam_fixed == 0.0
        self.cams[cam_slots[used_cams[moving]]] = new_cams[moving]
        self.points[uniq_tracks[used_tracks]] = st.points.cpu().numpy()

    def global_ba(self, max_iters: Optional[int] = None, prune: bool = True, final: bool = False):
        """Global BA with one round of residual-based pruning (observations
        beyond 3 thresholds go; tracks left with < 2 die) and a refit.
        Mid-run solves use a loose stall tolerance; ``final`` the tight one."""
        t0 = time.time()
        self.counters["global_ba"] += 1
        self._global_ba(max_iters, prune, final)
        self.timers["global_ba"] += time.time() - t0

    def _global_ba(self, max_iters: Optional[int], prune: bool, final: bool):
        prob = self._gather_global_problem()
        if prob is None:
            return
        cam_slots, cam_idx, uniq_tracks, pt_idx, uv, keys = prob
        C, P = len(cam_slots), len(uniq_tracks)
        w = np.ones(len(cam_idx), np.float32)
        cam_fixed = np.zeros(C, np.float32)
        cam_fixed[0] = 1.0
        pt_fixed = np.zeros(P, np.float32)
        kw = dict(max_iters=max_iters or (self.cfg.ba.max_iters if final
                                          else self.cfg.ba.mid_max_iters),
                  cg_iters=32 if final else self.cfg.ba.mid_cg_iters,
                  robust_delta=self._robust(), stall_tol=1e-5 if final else 1e-4)
        st = self._ba(self.cams[cam_slots], self.points[uniq_tracks], cam_idx, pt_idx, uv, w,
                      cam_fixed, pt_fixed, **kw)
        self.counters["gba_lm_iters_main"] = self.counters.get("gba_lm_iters_main", 0) + st.n_iters
        if prune:
            thr_px = 3.0 * self.cfg.ransac.threshold_px
            bad = self._residual_px(st.cams, st.points, cam_idx, pt_idx, uv) > thr_px
            if bad.any():
                self.obs_valid[keys[bad]] = 0
                w[bad] = 0.0
                live_counts = np.bincount(pt_idx[w > 0], minlength=P)
                dead = np.nonzero(live_counts < 2)[0]
                if len(dead):
                    self.point_valid[uniq_tracks[dead]] = False
                    pt_fixed[dead] = 1.0
                if final or self.cfg.ba.midrun_refit:
                    st = self._ba(st.cams.cpu().numpy(), st.points.cpu().numpy(), cam_idx,
                                  pt_idx, uv, w, cam_fixed, pt_fixed, **kw)
        self.cams[cam_slots] = st.cams.cpu().numpy()
        keep = self.point_valid[uniq_tracks]
        self.points[uniq_tracks[keep]] = st.points.cpu().numpy()[keep]
        self.counters["gba_lm_iters"] = self.counters.get("gba_lm_iters", 0) + st.n_iters

    # ------------------------------------------------------------------
    def _residual_px(self, cams, points, cam_idx, pt_idx, uv) -> np.ndarray:
        """(O,) reprojection error in pixels on the BA device."""
        dev = self.ba_device
        with f32_scope(), torch.no_grad():
            r = reprojection_residuals(
                torch.as_tensor(cams, device=dev), torch.as_tensor(points, device=dev),
                torch.from_numpy(cam_idx).to(dev), torch.from_numpy(pt_idx).to(dev),
                torch.from_numpy(uv).to(dev), torch.ones(len(cam_idx), device=dev))
            return (torch.linalg.vector_norm(r, dim=-1) * self.focal).cpu().numpy()

    def _current_errors(self):
        prob = self._gather_global_problem()
        if prob is None:
            return None
        cam_slots, cam_idx, uniq_tracks, pt_idx, uv, keys = prob
        err = self._residual_px(self.cams[cam_slots], self.points[uniq_tracks], cam_idx,
                                pt_idx, uv)
        return cam_slots, cam_idx, keys, err

    def mean_reprojection_error(self) -> Tuple[float, int]:
        cur = self._current_errors()
        if cur is None:
            return float("nan"), 0
        err = cur[3]
        return float(err.mean()), len(err)

    def per_camera_reproj(self) -> Dict[int, float]:
        """Mean reprojection error (px) per registered image."""
        cur = self._current_errors()
        if cur is None:
            return {}
        cam_slots, cam_idx, _, err = cur
        sums = np.bincount(cam_idx, weights=err, minlength=len(cam_slots))
        cnts = np.maximum(np.bincount(cam_idx, minlength=len(cam_slots)), 1)
        return {int(img): float(s / c) for img, s, c in zip(cam_slots, sums, cnts)}

    def _snapshot_state(self) -> dict:
        return {"cams": self.cams.copy(), "has_cam": self.has_cam.copy(),
                "points": self.points.copy(), "point_valid": self.point_valid.copy(),
                "obs_valid": self.obs_valid.copy(), "num_registered": self.num_registered}

    def _restore_state(self, snap: dict) -> None:
        self.cams[:] = snap["cams"]
        self.has_cam[:] = snap["has_cam"]
        self.points[:] = snap["points"]
        self.point_valid[:] = snap["point_valid"]
        self.obs_valid[:] = snap["obs_valid"]
        self.num_registered = snap["num_registered"]

    def deregister_weak_cameras(self, min_obs: int = 8, max_median_px: float = 8.0,
                                lenient: Optional[set] = None) -> List[int]:
        """Drop cameras with fewer than ``min_obs`` surviving observations or
        a median error above ``max_median_px``; ``lenient`` images are
        judged at min_obs // 2 and 1.5 x max_median_px. Tracks left with
        < 2 observations die with them. Returns the dropped image ids."""
        cur = self._current_errors()
        if cur is None:
            return []
        cam_slots, cam_idx, keys, err = cur
        dropped = []
        for ci, img in enumerate(cam_slots):
            sel = cam_idx == ci
            n = int(sel.sum())
            lo, hi = min_obs, max_median_px
            if lenient and int(img) in lenient:
                lo, hi = max(2, min_obs // 2), 1.5 * max_median_px
            if n < lo or (n and float(np.median(err[sel])) > hi):
                self.has_cam[img] = False
                self.num_registered -= 1
                dropped.append(int(img))
                self.obs_valid[keys[np.nonzero(sel)[0]]] = 0
        if dropped:
            slots = np.flatnonzero(self.obs_valid)
            counts = np.bincount(self.obs_track[slots], minlength=len(self.point_valid))
            self.point_valid &= counts[: len(self.point_valid)] >= 2
        return dropped

    def finalize(self, image_names: Sequence[str],
                 registrations: Optional[Sequence[ImageRegistration]] = None,
                 verbose: bool = False) -> Reconstruction:
        """Final BA, the weak-camera gate and its retry rounds (each
        dropped camera gets one re-registration, re-gated leniently; the
        best gated state is kept), one last full-budget BA, then the
        reconstruction."""
        if self.cfg.run_global_ba:
            self.global_ba(final=True)
            dropped = self.deregister_weak_cameras()
            if dropped and verbose:
                print(f"[sfm] finalize dropped weak cameras: {dropped}", flush=True)
            if dropped:
                if registrations is not None:
                    by_img = {r.img: r for r in registrations}
                    pending = list(dropped)
                    best = (self.num_registered, self._snapshot_state())
                    reentered: set = set()
                    attempted: set = set()
                    for _ in range(3):
                        if not pending:
                            break
                        self.global_ba()
                        retry = [by_img[i] for i in pending if i in by_img and i not in attempted]
                        if not retry:
                            break
                        attempted.update(r.img for r in retry)
                        infos = self.register_batch(retry)
                        back = [i["img"] for i in infos if i.get("status") == "registered"]
                        if not back:
                            break
                        if verbose:
                            print(f"[sfm] finalize re-registered: {back}", flush=True)
                        reentered.update(back)
                        self.global_ba()
                        pending = self.deregister_weak_cameras(lenient=reentered)
                        if pending and verbose:
                            print(f"[sfm] finalize re-dropped: {pending}", flush=True)
                        if self.num_registered > best[0]:
                            best = (self.num_registered, self._snapshot_state())
                    if self.num_registered < best[0]:
                        if verbose:
                            print(f"[sfm] finalize restoring best gated state ({best[0]} "
                                  "cameras)", flush=True)
                        self._restore_state(best[1])
                self.global_ba(final=True)
        mean_err, n_obs = self.mean_reprojection_error()
        per_cam = self.per_camera_reproj()
        low_conf: List[int] = []
        if self.cfg.register_all and registrations:
            low_conf = self.register_low_confidence(registrations, verbose=verbose)
        track_ids = np.flatnonzero(self.point_valid)
        registered = np.flatnonzero(self.has_cam)
        prob = self._gather_global_problem()
        obs = {}
        if prob is not None:
            cam_slots, cam_idx, uniq_tracks, pt_idx, _, keys = prob
            obs = dict(obs_cam=np.searchsorted(registered, cam_slots[cam_idx]),
                       obs_point=np.searchsorted(track_ids, uniq_tracks[pt_idx]),
                       obs_uv_px=self.obs_uv[keys].copy())
        return Reconstruction(
            image_names=list(image_names), registered=registered,
            cams=self.cams[registered].copy(), points=self.points[track_ids].copy(),
            colors_bgr=self.point_color[track_ids].copy(), track_ids=track_ids,
            mean_reproj_px=mean_err, num_obs=n_obs,
            low_confidence=np.asarray(sorted(low_conf), np.int64), per_cam_reproj_px=per_cam,
            **obs)

    def register_low_confidence(self, registrations, verbose: bool = False) -> List[int]:
        """The --register-all pass (SfMConfig.register_all): after the final
        BA, place every still-unregistered image by relaxed relative-pose
        chaining. Placed cameras record no observations, so they move
        neither the gauge, the points nor the reported reprojection error.
        Three chained rounds let an image whose only edges point at another
        placed camera follow one round later. Returns the placed images."""
        by_img = {r.img: r for r in registrations}
        placed: List[int] = []
        for _ in range(3):
            progress = False
            for img, reg in by_img.items():
                if self.has_cam[img]:
                    continue
                info: dict = {"img": img}
                cam = self._relative_pose_fallback(img, reg.edges, info, relaxed=True)
                if cam is None:
                    continue
                self.cams[img] = cam
                self.has_cam[img] = True
                self.num_registered += 1
                self.reg_order.append(img)
                placed.append(img)
                progress = True
                if verbose:
                    print(f"[sfm] low-confidence registration: img {img} "
                          f"({info.get('fallback_relpose_inliers')})", flush=True)
            if not progress:
                break
        return placed
