"""Levenberg-Marquardt bundle adjustment with a camera-reduced Schur
complement, solved matrix-free by block-Jacobi preconditioned conjugate
gradients (tpu3d/ba/lm.py).

The normal equations have the arrow structure [[U, W], [Wᵀ, V]] with U
block-diagonal over cameras (6x6) and V over points (3x3). CG runs on
S = U - W V⁻¹ Wᵀ without forming it: one S·x is two segment sums over the
observations and two batched block products. A rejected step keeps the
previous blocks, since the state did not move.

One solver serves one problem and a batch of them: ``bundle_adjust_batch``
takes B problems stacked on a leading axis (tpu3d's vmapped
``_local_ba_batch``, tpu3d/sfm/engine.py:153), each with its own damping,
cost, stall count, iteration count and active mask. A problem that has
stopped is frozen with ``torch.where``, so each follows the iterates it
follows alone; ``bundle_adjust`` is the batch of one. The problems lie side
by side: camera, point and observation indices are offset into one flat
segment space.

Every sum adds in a fixed order that depends neither on the device nor on
the batch. A segment's rows (``_segments``) are its observations in
ascending order, zero-padded to a power-of-four width, and ``_tree_sum``
adds them four neighbours at a time; zeros appended to a row (a wider
batch) leave every partial sum as it was. The per-problem sums of CG and of
the cost are the same tree over each problem's own entries. So a solve on
the card gives the same bits on every run (``index_add_``'s atomics would
not, and one flipped LM accept changes the whole trajectory), and a problem
solved in a batch gives the bits it gives alone on the CPU. Observations of
weight 0 (padding, pruned outliers) add exact zeros and are left out of the
segments.

The stop rules run on the device, as tpu3d's while loops do: each problem
carries its LM and CG state, and an iteration masks the update of every
problem whose CG has reached cg_tol or whose LM loop has stopped. A solve
reads back the segment widths once and one set of flags per LM step
(``utils.dispatch``'s ``ba_readback``), taken after the step's first CG
iterations, as many as the step before last needed: is any problem still
active (if not, the loop ends there: the begun step has changed nothing),
is any CG still running (then the step runs its remaining iterations,
masked), and the last step's CG count. No CG iteration reads anything
back. On the card (without ``reduce``) a solve captures one CG iteration as
a CUDA graph after its first run and replays it (``_SchurCG``): the same
kernels, so the same bits, for one launch instead of some sixty.

tpu3d's ``seg_matmul`` (cam-axis sums as one-hot matmuls) and
``flat_layout`` (component-packed blocks) are variants it measured and
rejected on the TPU (tpu3d/ba/lm.py:177-199); they are not ported and
raise if asked for.
"""
from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from tpu3d_torch import f32_scope
from tpu3d_torch.ba.residuals import _mv, observation_jacobians, reprojection_residuals
from tpu3d_torch.utils.cuda_graph import capture
from tpu3d_torch.utils.dispatch import tick


class BAState(NamedTuple):
    cams: torch.Tensor     # (C, 6) [rvec | t]; (B, C, 6) for a batch
    points: torch.Tensor   # (P, 3); (B, P, 3)
    cost: torch.Tensor     # final (robustified) cost; (B,)
    lam: torch.Tensor      # final damping; (B,)
    n_iters: Union[int, torch.Tensor]  # LM iterations run; (B,) int64 for a batch


def ba_cost(cams, points, cam_idx, pt_idx, uv, w) -> torch.Tensor:
    r = reprojection_residuals(cams, points, cam_idx, pt_idx, uv, w)
    return torch.sum(r * r)


def _pow4(m: int) -> int:
    """The smallest power of four >= max(m, 1)."""
    p = 1
    while p < m:
        p *= 4
    return p


def _counts(idx: torch.Tensor, num: int, w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(num + 1,) observations per segment; the last bin holds those of
    weight 0, which no segment takes."""
    seg = idx if w is None else torch.where(w != 0, idx, num)
    return torch.zeros(num + 1, dtype=torch.int64, device=idx.device).index_add_(
        0, seg, torch.ones_like(seg))


def _peak(counts: torch.Tensor) -> torch.Tensor:
    return counts[:-1].max() if counts.numel() > 1 else counts.new_zeros(())


def _rows(idx: torch.Tensor, counts: torch.Tensor, width: int,
          w: Optional[torch.Tensor] = None) -> torch.Tensor:
    n = idx.shape[0]
    num = counts.shape[0] - 1
    if n == 0:
        return torch.zeros((num, width), dtype=torch.int64, device=idx.device)
    seg = idx if w is None else torch.where(w != 0, idx, num)
    order = torch.argsort(seg, stable=True)
    c = counts[:-1]
    slot = torch.arange(width, device=idx.device)
    pos = (torch.cumsum(c, 0) - c)[:, None] + slot
    return torch.where(slot < c[:, None], order[pos.clamp(max=n - 1)], n)


def _segments(idx: torch.Tensor, num: int, w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(num, width) int64: row s lists, in ascending order, the positions
    of idx that hold s (and, given w, weigh more than 0), padded with
    len(idx) (the zero row ``_seg_sum`` appends) to a power-of-four width
    at least the largest segment. One read-back (the width)."""
    counts = _counts(idx, num, w)
    width = _pow4(int(_peak(counts)))
    tick("ba_readback")
    return _rows(idx, counts, width, w)


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 1 (a power of four long) four neighbours at a time
    (elements 4i .. 4i + 3 of a level make element i of the next) until one
    is left. A sum of four adds in an order fixed by its length alone, so
    the result depends on nothing but the width, and trailing zeros (a wider
    row) do not change it: they add exact zeros until the widths meet. A
    run of neighbours adds as it would in any row that holds it from the
    same aligned position, so a rank's share of a segment sums much as it
    does inside the whole row (the sharded path's partial sums)."""
    while x.shape[1] > 1:
        x = x.unflatten(1, (x.shape[1] // 4, 4)).sum(2)
    return x[:, 0]


def _seg_sum(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Segment sums of x (n, ...) over ``rows`` from :func:`_segments`: a
    gather to (num, width, ...), then :func:`_tree_sum` over the width."""
    pad = F.pad(x, (0, 0) * (x.dim() - 1) + (0, 1))
    return _tree_sum(pad[rows])


def _problem_sum(x: torch.Tensor, B: int) -> torch.Tensor:
    """(B,) sums of x (B * n, ...) over each problem's own entries, by
    :func:`_tree_sum` over its values zero-padded to a power of four."""
    v = x.reshape(B, -1)
    return _tree_sum(F.pad(v, (0, _pow4(v.shape[1]) - v.shape[1])))


def _spd_inv3(V: torch.Tensor, damp: torch.Tensor) -> torch.Tensor:
    """Batched inverse of damped 3x3 SPD blocks (adjugate closed form)."""
    A = V + damp[..., None, None] * torch.eye(3, dtype=V.dtype, device=V.device)
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    det = a * co00 + b * co01 + c * co02
    det = torch.where(det.abs() < 1e-12, 1e-12, det)
    inv = torch.stack([torch.stack([co00, co01, co02], -1),
                       torch.stack([co01, co11, co12], -1),
                       torch.stack([co02, co12, co22], -1)], -2)
    return inv / det[..., None, None]


def bundle_adjust(
    cams0: torch.Tensor,
    points0: torch.Tensor,
    cam_idx: torch.Tensor,
    pt_idx: torch.Tensor,
    uv: torch.Tensor,
    w: torch.Tensor,
    cam_fixed: torch.Tensor,
    pt_fixed: Optional[torch.Tensor] = None,
    max_iters: int = 20,
    cg_iters: int = 32,
    lam0: float = 1e-3,
    robust_delta: Optional[float] = None,
    cg_tol: float = 1e-3,
    stall_tol: float = 1e-5,
    pt_sorted: bool = False,
    reuse_blocks: bool = True,
    seg_matmul: Optional[bool] = None,
    flat_layout: Optional[bool] = None,
    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> BAState:
    """Joint pose + structure refinement of cams0 (C, 6) and points0
    (P, 3) over the observations (cam_idx, pt_idx, uv, w), with cam_fixed
    (C,) and pt_fixed (P,) 1 where frozen. robust_delta turns on Huber IRLS
    (in focal-normalized units). Stops after max_iters LM iterations or 3
    in a row without a relative cost drop beyond stall_tol; CG stops at
    cg_iters or at a preconditioned residual below cg_tol of the start.
    ``pt_sorted`` and ``reuse_blocks`` are accepted for tpu3d's signature:
    a gather hint there, and whether a rejected step rebuilds the normal
    equations' blocks, which are a function of the state and so the same
    either way (here a rejected step keeps its own).

    ``reduce`` shards the observations: each call sees only this rank's
    observations, and reduce (an all-reduce over the ranks that hold the
    others, dist/sharding.py) turns every segment sum and cost sum over
    them into the whole problem's; camera and point states stay
    replicated, and so does every stop decision. None: one process holds
    them all."""
    if seg_matmul or flat_layout:
        raise NotImplementedError(
            "bundle_adjust: seg_matmul and flat_layout are tpu3d's measured-and-rejected "
            "TPU variants (tpu3d/ba/lm.py:177-199); the port has only the default path")
    del pt_sorted, reuse_blocks
    st, steps = _solve(cams0[None], points0[None], cam_idx[None].long(), pt_idx[None].long(),
                       uv[None], w[None], cam_fixed[None],
                       None if pt_fixed is None else pt_fixed[None], max_iters, cg_iters,
                       lam0, robust_delta, cg_tol, stall_tol, reduce)
    # One problem runs while it is active: its iterations are the loop's.
    return BAState(st.cams[0], st.points[0], st.cost[0], st.lam[0], steps)


def bundle_adjust_batch(
    cams0: torch.Tensor,
    points0: torch.Tensor,
    cam_idx: torch.Tensor,
    pt_idx: torch.Tensor,
    uv: torch.Tensor,
    w: torch.Tensor,
    cam_fixed: torch.Tensor,
    pt_fixed: torch.Tensor,
    max_iters: int = 20,
    cg_iters: int = 32,
    lam0: float = 1e-3,
    robust_delta: Optional[float] = None,
    cg_tol: float = 1e-3,
    stall_tol: float = 1e-5,
) -> BAState:
    """B independent problems in one solve (tpu3d's ``_local_ba_batch``):
    cams0 (B, C, 6), points0 (B, P, 3), cam_idx / pt_idx / w (B, O), uv
    (B, O, 2), cam_fixed (B, C), pt_fixed (B, P). Problems of different
    sizes are padded to the largest: observations of weight 0 (any index
    in range), cameras and points frozen. Each problem gets the result
    ``bundle_adjust`` gives it alone. Returns the batched state, with
    n_iters (B,) per problem."""
    st, _ = _solve(cams0, points0, cam_idx.long(), pt_idx.long(), uv, w, cam_fixed, pt_fixed,
                   max_iters, cg_iters, lam0, robust_delta, cg_tol, stall_tol, None)
    return st


class _SchurCG:
    """Preconditioned CG on S dc = b for one solve, on (B, C, 6) vectors
    with (B, 1, 1) per-problem scalars, over buffers that last the solve:
    each LM step copies its operands in (``load``), and an iteration reads
    and updates only these buffers. A problem's update stops (alpha 0, p and
    rz kept) once ||r||_M <= cg_tol ||b||_M, or when its LM loop has
    stopped: the iterations after that leave its iterates as they were, as
    tpu3d's while loop does. With ``graphs`` (on the card, no cross-rank
    sums) the iteration's first run is followed by its capture as a CUDA
    graph, which every later iteration of the solve replays: one launch
    for the host to enqueue instead of some sixty kernels."""

    def __init__(self, B, C, cam_idx, pt_idx, cam_free, seg_cam, seg_pt, cg_tol, graphs):
        self.B, self.C = B, C
        self.cam_idx, self.pt_idx = cam_idx, pt_idx
        self.free = cam_free.view(B, C, 1)
        self.seg_cam, self.seg_pt = seg_cam, seg_pt
        self.tol2 = cg_tol * cg_tol
        self.graphs = graphs
        self.graph = None
        self.ops = self.x = None

    def dot(self, a, b):
        """(B, 1, 1) dot products of camera vectors (B, C, 6): each camera's
        six products summed, then the problem's cameras by the tree."""
        return _problem_sum((a * b).sum(-1), self.B).view(self.B, 1, 1)

    def matvec(self, x):
        Ucc, damp_c, Vinv, Wcp, _ = self.ops
        xf = x.view(self.B * self.C, 6)
        cp = _mv(Vinv, self.seg_pt(_mv(Wcp.transpose(-1, -2), xf[self.cam_idx])))
        return (_mv(Ucc, xf) + damp_c * xf
                - self.seg_cam(_mv(Wcp, cp[self.pt_idx]))).view(self.B, self.C, 6)

    def precond(self, v):
        """Block-Jacobi (U + damp)⁻¹; frozen cameras stay at 0."""
        return _mv(self.ops[4], v.view(self.B * self.C, 6)).view(self.B, self.C, 6) * self.free

    def load(self, Ucc, damp_c, Vinv, Wcp, Uinv, b, active) -> None:
        """A step's operands, and the start x = 0, r = b, p = M⁻¹ b."""
        ops = (Ucc, damp_c, Vinv, Wcp, Uinv)
        if self.ops is None:
            self.ops = [t.clone() for t in ops]
            self.act = active.view(self.B, 1, 1).clone()
        else:
            for dst, src in zip(self.ops, ops):
                dst.copy_(src)
            self.act.copy_(active.view(self.B, 1, 1))
        b = b.view(self.B, self.C, 6)
        p = self.precond(b)
        rz = self.dot(b, p)
        if self.x is None:
            self.x, self.rr, self.p = torch.zeros_like(b), b.clone(), p
            self.rz, self.stop = rz, self.tol2 * rz
            self.used = torch.zeros((self.B, 1, 1), dtype=torch.int64, device=b.device)
            return
        self.x.zero_()
        self.rr.copy_(b)
        self.p.copy_(p)
        self.rz.copy_(rz)
        self.stop.copy_(self.tol2 * rz)
        self.used.zero_()

    def running(self) -> torch.Tensor:
        return (self.act & (self.rz > self.stop)).any()

    def _iteration(self) -> None:
        on = self.act & (self.rz > self.stop)
        Ap = self.matvec(self.p)
        pAp = self.dot(self.p, Ap)
        alpha = torch.where(on, self.rz / torch.where(pAp.abs() < 1e-20, 1e-20, pAp), 0.0)
        self.x.add_(alpha * self.p)
        self.rr.sub_(alpha * Ap)
        z = self.precond(self.rr)
        rz_new = self.dot(self.rr, z)
        beta = rz_new / torch.where(self.rz.abs() < 1e-20, 1e-20, self.rz)
        self.p.copy_(torch.where(on, z + beta * self.p, self.p))
        self.rz.copy_(torch.where(on, rz_new, self.rz))
        self.used.add_(on)

    def iterate(self, n: int) -> None:
        for _ in range(n):
            if self.graph is not None:
                self.graph.replay()
                continue
            self._iteration()
            if self.graphs:
                self.graph = capture(self._iteration)


@contextlib.contextmanager
def _one_host_thread(dev: torch.device):
    """On the CPU, one intra-op thread while a solve runs: its operations
    are small, and on a host shared with other processes the thread pool's
    barriers cost many times the work (a refine_focal test took minutes
    instead of seconds beside five busy processes). The sums' orders do not
    depend on the thread count."""
    if dev.type != "cpu":
        yield
        return
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _solve(cams0, points0, *args) -> Tuple[BAState, int]:
    """The batched solve (full f32); returns the state and the LM steps it
    completed."""
    with f32_scope(), _one_host_thread(points0.device):
        return _solve_body(cams0, points0, *args)


def _solve_body(cams0, points0, cam_idx, pt_idx, uv, w, cam_fixed, pt_fixed, max_iters,
                cg_iters, lam0, robust_delta, cg_tol, stall_tol, reduce):
    B, C = cams0.shape[:2]
    P, O = points0.shape[1], cam_idx.shape[1]
    dtype, dev = points0.dtype, points0.device
    # CUDA graphs for CG on the card; a cross-rank sum cannot be captured
    graphs = dev.type == "cuda" and reduce is None
    reduce = reduce or (lambda x: x)
    batch = torch.arange(B, device=dev)[:, None]
    cam_idx = (cam_idx + batch * C).reshape(B * O)
    pt_idx = (pt_idx + batch * P).reshape(B * O)
    uv = uv.reshape(B * O, 2)
    w = w.reshape(B * O)
    if pt_fixed is None:
        pt_fixed = torch.zeros((B, P), dtype=dtype, device=dev)
    cam_free = (1.0 - cam_fixed.to(dtype)).reshape(B * C, 1)
    cc, pc = _counts(cam_idx, B * C, w), _counts(pt_idx, B * P, w)
    wc, wp = (_pow4(m) for m in torch.stack([_peak(cc), _peak(pc)]).tolist())
    tick("ba_readback")
    cam_rows, pt_rows = _rows(cam_idx, cc, wc, w), _rows(pt_idx, pc, wp, w)
    # A point with no valid observation must not move (its V block is
    # singular): freeze it too.
    pt_free = ((1.0 - pt_fixed.to(dtype)).reshape(B * P, 1)
               * (reduce(_seg_sum(w, pt_rows)) > 0).to(dtype)[:, None])
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    def scale(v, x):
        """x (B * n, ...) with each problem's rows times its value of v (B,)."""
        return (v.reshape(B, *([1] * x.dim())) * x.reshape(B, -1, *x.shape[1:])).reshape(
            x.shape)

    def select(m, a, b):
        """Per problem (m (B,) bool), a's rows where m holds, else b's."""
        return torch.where(m.reshape(B, *([1] * a.dim())), a.reshape(B, -1, *a.shape[1:]),
                           b.reshape(B, -1, *b.shape[1:])).reshape(a.shape)

    def seg_cam(x):
        return reduce(_seg_sum(x, cam_rows))

    def seg_pt(x):
        return reduce(_seg_sum(x, pt_rows))

    def evaluate(cams, points):
        """(B,) objectives at a state (the robustified one when IRLS is on:
        a step down the Huber cost may raise the raw SSE) and the normal
        equations' blocks there."""
        r, Jc, Jp = observation_jacobians(cams, points, cam_idx, pt_idx, uv, w)
        if robust_delta is None:
            cost = reduce(_problem_sum(r * r, B))
        else:
            rn = torch.sqrt(r[:, 0] * r[:, 0] + r[:, 1] * r[:, 1])
            cost = reduce(_problem_sum(torch.where(rn <= robust_delta, rn * rn,
                                                   2 * robust_delta * rn - robust_delta ** 2), B))
            w_rob = torch.sqrt(torch.clamp(robust_delta / torch.clamp(rn, min=1e-12), max=1.0))
            r = r * w_rob[:, None]
            Jc = Jc * w_rob[:, None, None]
            Jp = Jp * w_rob[:, None, None]
        Jc = Jc * cam_free[cam_idx][:, None, :]
        Jp = Jp * pt_free[pt_idx][:, None, :]
        # products over the residual's two rows (a sum of two is exact in
        # any order)
        return cost, (seg_cam((Jc[:, :, :, None] * Jc[:, :, None, :]).sum(1)),
                      seg_pt((Jp[:, :, :, None] * Jp[:, :, None, :]).sum(1)),
                      (Jc[:, :, :, None] * Jp[:, :, None, :]).sum(1),
                      seg_cam((Jc * r[:, :, None]).sum(1)),
                      seg_pt((Jp * r[:, :, None]).sum(1)))

    cams, points = cams0.reshape(B * C, 6), points0.reshape(B * P, 3)
    lam = torch.full((B,), lam0, dtype=dtype, device=dev)
    cost, blocks = evaluate(cams, points)
    keep = float(np.float32(1.0) - np.float32(stall_tol))   # tpu3d's, in f32
    active = torch.ones(B, dtype=torch.bool, device=dev)
    it = torch.zeros(B, dtype=torch.int64, device=dev)
    stall = torch.zeros(B, dtype=torch.int64, device=dev)
    need = torch.zeros(B, dtype=torch.int64, device=dev)   # CG iterations of the last step
    first = min(cg_iters, 8)        # CG iterations before the step's read-back
    cg = _SchurCG(B, C, cam_idx, pt_idx, cam_free, seg_cam, seg_pt, cg_tol, graphs)
    steps = 0
    while steps < max_iters:
        Ucc, Vpp, Wcp, gc, gp = blocks
        damp_c = scale(lam, torch.diagonal(Ucc, dim1=-2, dim2=-1) + 1e-8)
        vd = torch.diagonal(Vpp, dim1=-2, dim2=-1)
        Vinv = _spd_inv3(Vpp, scale(lam, ((vd[:, 0] + vd[:, 1]) + vd[:, 2]) / 3.0 + 1e-8))
        b = gc - seg_cam(_mv(Wcp, _mv(Vinv, gp)[pt_idx]))
        # Block-Jacobi preconditioner (U + damp)⁻¹, frozen cameras identity.
        Ud = Ucc + damp_c[..., None] * eye6
        Ud = Ud * cam_free[:, :, None] + eye6 * (1.0 - cam_free[:, :, None])
        cg.load(Ucc, damp_c, Vinv, Wcp, torch.linalg.inv_ex(Ud).inverse, b, active)
        cg.iterate(first)
        # The step's one read-back: is any problem still active (if not, the
        # loop ends and this step's work is dropped; it changed nothing), is
        # any CG still running, and the last step's CG iterations.
        more, running, last = torch.stack([active.any(), cg.running(), need.max()]).tolist()
        tick("ba_readback")
        if not more:
            break
        if running:
            cg.iterate(cg_iters - first)
        # The next step reads back after as many CG iterations as this one's
        # predecessor took (a step that took longer finishes on the rest).
        first = min(cg_iters, max(int(last) + 1, 2)) if not running else cg_iters
        need = cg.used.view(B).clone()
        dc = cg.x.view(B * C, 6) * cam_free
        # Back-substitute the points: dp = V⁻¹ (gp - Wᵀ dc).
        dp = _mv(Vinv, gp - seg_pt(_mv(Wcp.transpose(-1, -2), dc[cam_idx]))) * pt_free
        new_cams, new_points = cams - dc, points - dp
        new_cost, new_blocks = evaluate(new_cams, new_points)
        accept = active & (new_cost < cost)
        cams = select(accept, new_cams, cams)
        points = select(accept, new_points, points)
        # The blocks are a function of the state: an accepted step takes the
        # new state's, a rejected one keeps its own.
        blocks = tuple(select(accept, n, o) for n, o in zip(new_blocks, blocks))
        lam = torch.where(accept, torch.clamp(lam / 3.0, min=1e-9),
                          torch.where(active, torch.clamp(lam * 4.0, max=1e6), lam))
        prev = cost
        cost = torch.where(accept, new_cost, cost)
        stall = torch.where(active, torch.where(cost < prev * keep, 0, stall + 1), stall)
        it = it + active
        active = active & (it < max_iters) & (stall < 3)
        steps += 1
    return BAState(cams.reshape(B, C, 6), points.reshape(B, P, 3), cost, lam, it), steps
