"""Global pose-graph initialization: rotation + translation averaging
(numpy copy of tpu3d/sfm/posegraph.py, on the port's core.lie).

The incremental chain (ref sfm.py and our engine) propagates scale/pose
errors camera-by-camera; a weak link either blocks registration or plants
a wrongly-scaled island. This module initializes ALL cameras jointly from
the pairwise relative poses the matching stage already computed (one per
accepted edge):

  1. rotation averaging — chordal relaxation: minimize
     Σ ||M_j − R_ij M_i||_F² over unconstrained 3x3 blocks via the three
     smallest eigenvectors of the (3N, 3N) connection Laplacian, then
     project each block onto SO(3);
  2. translation averaging — with global rotations fixed, each edge gives
     the world-frame baseline direction d_ij = −R_jᵀ t_ij^rel; camera
     centers and per-edge scales solve the LUD-style convex QP
     min Σ w_e ||C_j − C_i − s_e d_e||² s.t. s_e ≥ 1 (exact active-set
     solver + IRLS; see average_translations for why weaker
     formulations collapse).

Small dense numpy by design: N ≈ hundreds of cameras means a 3Nx3N
eigensolve and a 3N least squares — milliseconds on the host, and the
heavy work (triangulation, BA) stays in the batched device kernels.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from tpu3d_torch.core import lie


def _project_so3(M: np.ndarray) -> np.ndarray:
    U, _, Vt = np.linalg.svd(M)
    d = np.sign(np.linalg.det(U @ Vt))
    return U @ np.diag([1.0, 1.0, d]) @ Vt


def largest_component(n: int, edges: Sequence[Tuple[int, int]]) -> np.ndarray:
    """Node mask of the largest connected component."""
    parent = np.arange(n)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for i, j in edges:
        a, b = find(i), find(j)
        if a != b:
            parent[b] = a
    roots = np.array([find(i) for i in range(n)])
    vals, counts = np.unique(roots, return_counts=True)
    big = vals[np.argmax(counts)]
    return roots == big


def average_rotations(
    n: int,
    edges: Sequence[Tuple[int, int]],
    rel_R: Sequence[np.ndarray],
    mask: Optional[np.ndarray] = None,
    irls_rounds: int = 3,
) -> np.ndarray:
    """Chordal rotation averaging with IRLS outlier down-weighting.
    rel_R[e] maps cam_i coords to cam_j coords (R_j = rel_R R_i,
    world->cam convention). L2 chordal averaging is poisoned by even a few
    wrong relative poses (real match graphs have them), so edges are
    reweighted by their consistency residual over a few rounds.
    Returns (n, 3, 3) global rotations (identity outside the mask)."""
    if mask is None:
        mask = np.ones(n, bool)
    idx_of = -np.ones(n, np.int64)
    nodes = np.flatnonzero(mask)
    idx_of[nodes] = np.arange(len(nodes))
    m = len(nodes)
    weights = np.ones(len(edges))
    for round_ in range(irls_rounds):
        L = np.zeros((3 * m, 3 * m))
        for w_e, (i, j), Rij in zip(weights, edges, rel_R):
            a, b = idx_of[i], idx_of[j]
            if a < 0 or b < 0:
                continue
            # w·||M_b - R_ij M_a||² contributes: L_aa += wI, L_bb += wI,
            # L_ab += -w R_ijᵀ, L_ba += -w R_ij
            L[3 * a : 3 * a + 3, 3 * a : 3 * a + 3] += w_e * np.eye(3)
            L[3 * b : 3 * b + 3, 3 * b : 3 * b + 3] += w_e * np.eye(3)
            L[3 * a : 3 * a + 3, 3 * b : 3 * b + 3] -= w_e * Rij.T
            L[3 * b : 3 * b + 3, 3 * a : 3 * a + 3] -= w_e * Rij
        w, V = np.linalg.eigh(L)
        if round_ < irls_rounds - 1:
            # Residual per edge from the current solution, Cauchy weights.
            X = V[:, :3]
            dets = [np.linalg.det(X[3 * k : 3 * k + 3]) for k in range(m)]
            if np.median(dets) < 0:
                X = X.copy()
                X[:, 0] *= -1.0
            Rs = [_project_so3(X[3 * k : 3 * k + 3]) for k in range(m)]
            sigma = 0.2  # ~11 deg chordal scale
            for eidx, ((i, j), Rij) in enumerate(zip(edges, rel_R)):
                a, b = idx_of[i], idx_of[j]
                if a < 0 or b < 0:
                    continue
                r = np.linalg.norm(Rs[b] - Rij @ Rs[a])
                weights[eidx] = 1.0 / (1.0 + (r / sigma) ** 2)
    X = V[:, :3]  # (3m, 3): columns span the block-rotation solution
    # The blocks are R_i G for one shared mixing matrix G. If det(G) < 0,
    # per-block SO(3) projection flips the (noise-dependent!) smallest
    # singular direction inconsistently across blocks — flip one column of
    # X globally so every block determinant turns positive coherently.
    dets = [np.linalg.det(X[3 * k : 3 * k + 3]) for k in range(m)]
    if np.median(dets) < 0:
        X = X.copy()
        X[:, 0] *= -1.0
    R_out = np.tile(np.eye(3), (n, 1, 1))
    # Normalize the gauge so node 0's block is a proper rotation; then
    # every other block is projected individually.
    R0 = _project_so3(X[:3])
    for k, node in enumerate(nodes):
        R_out[node] = _project_so3(X[3 * k : 3 * k + 3]) @ R0.T
    return R_out


def refine_rotations(
    n: int,
    edges: Sequence[Tuple[int, int]],
    rel_R: Sequence[np.ndarray],
    R_init: np.ndarray,
    mask: Optional[np.ndarray] = None,
    iters: int = 8,
) -> np.ndarray:
    """Lie-algebra Gauss-Newton refinement of averaged rotations
    (Chatterjee & Govindu-style iteration). The chordal eigensolve is a
    RELAXATION — its solution drifts with graph diameter; here each
    iteration solves the linearized consistency system

        min_ω Σ_e w_e ||r_e + ω_i − ω_j||²,   r_e = Log(R_jᵀ Z_e R_i)

    (three independent graph-Laplacian solves) with Cauchy IRLS weights,
    then retracts R_i ← R_i Exp(ω_i)."""
    if mask is None:
        mask = np.ones(n, bool)
    nodes = np.flatnonzero(mask)
    idx_of = -np.ones(n, np.int64)
    idx_of[nodes] = np.arange(len(nodes))
    m = len(nodes)
    ea, eb, Zs = [], [], []
    for (i, j), Z in zip(edges, rel_R):
        a, b = idx_of[i], idx_of[j]
        if a < 0 or b < 0:
            continue
        ea.append(a)
        eb.append(b)
        Zs.append(np.asarray(Z, np.float64))
    if not ea:
        return R_init.copy()
    ea = np.asarray(ea)
    eb = np.asarray(eb)
    R = R_init.copy()
    for _ in range(iters):
        r = np.stack([
            lie.so3_log_np(R[nodes[eb[k]]].T @ Zs[k] @ R[nodes[ea[k]]])
            for k in range(len(ea))
        ])
        nr = np.linalg.norm(r, axis=1)
        sigma = max(float(np.median(nr)) * 1.4826, 1e-4)
        w = 1.0 / (1.0 + (nr / sigma) ** 2)
        L = np.zeros((m, m))
        rhs = np.zeros((m, 3))
        np.add.at(L, (ea, ea), w)
        np.add.at(L, (eb, eb), w)
        np.add.at(L, (ea, eb), -w)
        np.add.at(L, (eb, ea), -w)
        # residual model r + ω_i − ω_j = 0  ⇒  normal eqs rhs
        np.add.at(rhs, ea, -w[:, None] * r)
        np.add.at(rhs, eb, w[:, None] * r)
        L[0, :] = 0.0
        L[0, 0] = 1.0
        rhs[0] = 0.0
        omega = np.linalg.solve(L + 1e-12 * np.eye(m), rhs)
        step = np.linalg.norm(omega, axis=1).max()
        for k, node in enumerate(nodes):
            R[node] = R[node] @ lie.so3_exp_np(omega[k])
        if step < 1e-8:
            break
    return R


def average_translations(
    n: int,
    edges: Sequence[Tuple[int, int]],
    rel_t: Sequence[np.ndarray],
    R_global: np.ndarray,
    mask: Optional[np.ndarray] = None,
    init_weights: Optional[np.ndarray] = None,
    irls_rounds: int = 8,
    trim: float = 4.0,
) -> np.ndarray:
    """LUD-style translation averaging (Özyeşil & Singer, CVPR'15 pattern).

    The textbook cross-product LS ((C_j − C_i) × d_ij = 0) is unusable on
    real graphs: with NOISY directions the all-centers-equal collapse has
    exactly zero residual on every cross row while the true geometry does
    not, so least squares returns the collapse (observed on the full
    ystad_kloster graph: median consecutive step 0.0, one 591x outlier
    step absorbing the scale constraint). A Σ_e s_e = E equality gauge
    fails differently: one stretched outlier edge satisfies the scale row
    while everything else collapses. What survives both real data and
    noise is per-edge lower-bounded scales,

        min_{C, s}  Σ_e w_e ||C_j − C_i − s_e d_e||²
        s.t.        s_e ≥ 1,   C_gauge = 0,

    solved EXACTLY by a primal active-set method (each round one linear
    KKT solve; constraints exchanged by multiplier sign / violation —
    coordinate descent on this QP needs thousands of rounds, the exact
    solve a handful). A Cauchy-IRLS outer loop (optionally seeded by
    rotation-consistency weights) down-weights outlier directions, with
    hard trimming once the solution has shape. Returns (n, 3) camera
    centers, gauge C[first node] = 0."""
    if mask is None:
        mask = np.ones(n, bool)
    nodes = np.flatnonzero(mask)
    idx_of = -np.ones(n, np.int64)
    idx_of[nodes] = np.arange(len(nodes))
    m = len(nodes)

    # Edge list in component-local indices with unit world directions.
    ea, eb, dirs, w0 = [], [], [], []
    for k, ((i, j), t) in enumerate(zip(edges, rel_t)):
        a, b = idx_of[i], idx_of[j]
        if a < 0 or b < 0:
            continue
        d = -R_global[j].T @ t
        nd = np.linalg.norm(d)
        if nd < 1e-9:
            continue
        ea.append(a)
        eb.append(b)
        dirs.append(d / nd)
        w0.append(1.0 if init_weights is None else float(init_weights[k]))
    if not ea:
        return np.zeros((n, 3))
    ea = np.asarray(ea)
    eb = np.asarray(eb)
    D = np.asarray(dirs)          # (E, 3)
    w = np.asarray(w0)
    E = len(ea)

    def solve_qp(w, max_as_rounds=40):
        """Exact primal active-set solve of the convex QP

            min_{C,s} Σ w_e ||C_b − C_a − s_e d_e||²  s.t. s_e ≥ 1, C_0 = 0.

        Each round solves the equality-KKT for the current working set W
        (s_k = 1 for k ∈ W), then exchanges constraints: release k ∈ W
        whose multiplier 2w(1 − proj) < 0 (objective wants s_k > 1), add
        k ∉ W whose free s_k fell below 1. Starts from W = all edges (the
        all-unit-lengths solution)."""
        nv = 3 * m + E
        active = np.ones(E, bool)
        live = w > 1e-9
        C = np.zeros((m, 3))
        for _ in range(max_as_rounds):
            A = np.zeros((nv, nv))
            b = np.zeros(nv)
            for k in range(E):
                a3, b3 = 3 * ea[k], 3 * eb[k]
                sk = 3 * m + k
                wk = w[k]
                I3 = wk * np.eye(3)
                A[a3 : a3 + 3, a3 : a3 + 3] += I3
                A[b3 : b3 + 3, b3 : b3 + 3] += I3
                A[a3 : a3 + 3, b3 : b3 + 3] -= I3
                A[b3 : b3 + 3, a3 : a3 + 3] -= I3
                wd = wk * D[k]
                A[b3 : b3 + 3, sk] -= wd
                A[a3 : a3 + 3, sk] += wd
                if active[k] or not live[k]:
                    A[sk, sk] = 1.0
                    b[sk] = 1.0
                else:
                    A[sk, b3 : b3 + 3] = -wd
                    A[sk, a3 : a3 + 3] = wd
                    A[sk, sk] = wk
            A[:3, :] = 0.0
            A[:3, :3] = np.eye(3)
            b[:3] = 0.0
            x = np.linalg.solve(A + 1e-10 * np.eye(nv), b)
            C = x[: 3 * m].reshape(m, 3)
            s = x[3 * m :]
            proj = np.einsum("ed,ed->e", C[eb] - C[ea], D)
            release = active & live & (proj > 1.0)
            add = ~active & live & (s < 1.0)
            if not release.any() and not add.any():
                break
            active = (active & ~release) | add
        return C

    C = None
    for irls in range(irls_rounds):
        C = solve_qp(w)
        bvec = C[eb] - C[ea]
        s = np.maximum(np.einsum("ed,ed->e", bvec, D), 1e-3)
        r = np.linalg.norm(bvec - s[:, None] * D, axis=1) / s
        sigma = max(float(np.median(r)) * 1.4826, 1e-3)
        w = np.asarray(w0) / (1.0 + (r / sigma) ** 2)
        # Trim gross outliers outright once the solution has shape.
        if irls >= 2:
            w[r > trim * sigma] = 0.0
    C_out = np.zeros((n, 3))
    for k, node in enumerate(nodes):
        C_out[node] = C[k]
    return C_out


def pose_graph_init(
    n_images: int,
    edges: Sequence[Tuple[int, int]],
    rel_R: Sequence[np.ndarray],
    rel_t: Sequence[np.ndarray],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full initialization. Returns (cams (n, 6) [rvec|t], has_cam mask,
    component mask)."""
    mask = largest_component(n_images, edges)
    R = average_rotations(n_images, edges, rel_R, mask)
    R = refine_rotations(n_images, edges, rel_R, R, mask)
    # Rotation-consistency weights seed the translation IRLS: an edge whose
    # relative ROTATION disagrees with the global solution almost surely
    # has a bogus translation direction too.
    w0 = np.ones(len(edges))
    for k, ((i, j), Rij) in enumerate(zip(edges, rel_R)):
        if mask[i] and mask[j]:
            r = np.linalg.norm(R[j] - Rij @ R[i])
            w0[k] = 1.0 / (1.0 + (r / 0.2) ** 2)
    C = average_translations(n_images, edges, rel_t, R, mask, init_weights=w0)
    cams = np.zeros((n_images, 6), np.float32)
    for i in range(n_images):
        if not mask[i]:
            continue
        cams[i, :3] = lie.so3_log_np(R[i])
        cams[i, 3:6] = -R[i] @ C[i]
    return cams, mask.copy(), mask
