"""Global feature-track bookkeeping (numpy copy of tpu3d/matching/tracks.py):
union-find in the native library's C loops (``tpu3d_torch.native``) where it
built, else in Python.

The reference assigns global 3D point ids to matched keypoints with a
python double loop (matching.py:161-172) that contains a latent indexing
bug: the `all_points3d[id][p1]` branch at matching.py:169-170 reads index
p1 from the *wrong image* and writes its value to p2's slot, silently
cross-wiring tracks. Here the same semantics are vectorized over each
pair's match arrays and the "both endpoints already tracked" case is
handled properly with union-find merging (the reference simply overwrote
one side).

This store is host-side on purpose: it is inherently sequential (a few
hundred pair events on arrays of ≤2048 matches — microseconds of numpy),
while everything that scales (matching, RANSAC, triangulation, BA) stays
on-device. Track ids index the fixed-capacity on-device point arrays of
the SfM engine.
"""
from __future__ import annotations

import numpy as np

from tpu3d_torch import native


class TrackStore:
    def __init__(self, num_images: int, kpts_per_image: int, capacity: int = 400_000,
                 use_native: bool = True):
        self.kp_track = np.full((num_images, kpts_per_image), -1, np.int64)
        self.parent = np.arange(capacity, dtype=np.int64)
        self.capacity = capacity
        self.next_track = 0
        self._native = use_native and native.available()

    # -- union-find ---------------------------------------------------------
    def _find(self, t: int) -> int:
        root = t
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[t] != root:
            self.parent[t], t = root, self.parent[t]
        return root

    def resolve(self, ids: np.ndarray) -> np.ndarray:
        """Canonicalize track ids after merges. -1 passes through."""
        if self._native:
            return native.resolve(self.parent, np.asarray(ids))
        out = np.asarray(ids).copy()
        for i, t in enumerate(out.ravel()):
            if t >= 0:
                out.ravel()[i] = self._find(int(t))
        return out

    # -- pair union ---------------------------------------------------------
    def union_pair(self, img0: int, img1: int, idx0: np.ndarray, idx1: np.ndarray) -> np.ndarray:
        """Assign/propagate track ids for one matched pair.

        idx0/idx1: (M,) keypoint indices (already filtered to valid
        matches). Returns (M,) canonical track ids for each match."""
        idx0 = np.asarray(idx0, np.int64)
        idx1 = np.asarray(idx1, np.int64)
        if self._native:
            out, self.next_track = native.union_pair(
                self.parent, self.kp_track, img0, img1, idx0, idx1, self.next_track)
            return out
        t0 = self.resolve(self.kp_track[img0, idx0])
        t1 = self.resolve(self.kp_track[img1, idx1])

        out = np.full(len(idx0), -1, np.int64)

        both_new = (t0 < 0) & (t1 < 0)
        n_new = int(both_new.sum())
        if self.next_track + n_new > self.capacity:
            raise RuntimeError("TrackStore capacity exceeded")
        fresh = np.arange(self.next_track, self.next_track + n_new, dtype=np.int64)
        self.next_track += n_new
        out[both_new] = fresh

        only0 = (t0 >= 0) & (t1 < 0)
        out[only0] = t0[only0]
        only1 = (t1 >= 0) & (t0 < 0)
        out[only1] = t1[only1]

        both = (t0 >= 0) & (t1 >= 0)
        for i in np.nonzero(both)[0]:
            a = self._find(int(t0[i]))
            b = self._find(int(t1[i]))
            if a != b:
                # merge newer into older (older id keeps its 3D estimate)
                lo, hi = (a, b) if a < b else (b, a)
                self.parent[hi] = lo
                out[i] = lo
            else:
                out[i] = a

        self.kp_track[img0, idx0] = out
        self.kp_track[img1, idx1] = out
        return out

    def num_tracked(self, img: int, idx: np.ndarray) -> int:
        """How many of these keypoints already carry a track id — the
        reference's "interlaced" overlap count (matching.py:146-158)."""
        return int(np.sum(self.kp_track[img, np.asarray(idx, np.int64)] >= 0))

    def overlap_fraction(self, img0: int, img1: int, idx0: np.ndarray, idx1: np.ndarray) -> float:
        """Fraction of matches with at least one tracked endpoint — the
        acceptance gate ratio of matching.py:160 (with the p1/p2 bug fixed)."""
        t0 = self.kp_track[img0, np.asarray(idx0, np.int64)]
        t1 = self.kp_track[img1, np.asarray(idx1, np.int64)]
        if len(idx0) == 0:
            return 0.0
        return float(np.mean((t0 >= 0) | (t1 >= 0)))
