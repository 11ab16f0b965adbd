"""The grid gradient of trilinear sampling, and the differentiable sampler
built from it.

Counterpart of tpu3d/kernels/trilinear_grad.py: ``scatter_grad`` (the
backward) and ``sample_packed_diff`` (its custom_vjp pairing with the
forward). On a CUDA tensor ``trilinear_scatter_grad`` launches
``trilinear_grad_kernel`` (csrc/trilinear_grad.cu); on a CPU tensor it runs
the plain version. The gradient is that of

    sum(g * trilinear_sample(grid, min_bound, max_bound, pts)[0])

with respect to the grid: an 8-corner scatter-add of the cotangents, each
weighted by the product of the forward's lerp factors, from the corners and
fractions of the same ``_corner_setup`` as kernels/trilinear.py. Samples
outside the box contribute nothing; the position cotangent is zero, as in
tpu3d (training samples depths that carry no grid dependence).

Every element of the gradient is the sum of its contributions in one fixed
order, that of the plain version on the CPU: corner k = 4a + 2b + c, then
sample n, from +0.0, each product and each sum rounded on its own. The
kernel follows it (a stable sort bins the samples by base cell, and each
output row is summed by one warp, csrc/trilinear_grad.cu), so on the card
it equals the plain version run on a CPU copy of its inputs bit for bit,
and two launches give the same bits. (The plain version's ``index_add_`` on
a CUDA tensor sums in no fixed order: compare on the CPU.)
"""
from __future__ import annotations

from typing import Tuple

import torch

from tpu3d_torch.kernels import LAUNCHES
from tpu3d_torch.kernels._build import check, function, stream
from tpu3d_torch.kernels.trilinear import (_INT32_MAX, MAX_CHANNELS, _corner_setup,
                                          trilinear_sample)


def trilinear_scatter_grad_plain(g: torch.Tensor, min_bound: torch.Tensor,
                                 max_bound: torch.Tensor, res: Tuple[int, int, int],
                                 pts: torch.Tensor) -> torch.Tensor:
    """Plain version. g: (N, C) cotangents of the sampled values; pts:
    (N, 3) world points; res: (X, Y, Z). Returns the (X, Y, Z, C) gradient,
    accumulated with one ``index_add_`` on the (X*Y*Z, C) view, which on the
    CPU adds its rows in index order: corner k, then sample n."""
    X, Y, Z = res
    C = g.shape[1]
    i0, frac, in_bounds = _corner_setup((X, Y, Z), min_bound, max_bound, pts)
    gv = g * in_bounds[:, None]
    base = (i0[:, 0] * Y + i0[:, 1]) * Z + i0[:, 2]
    w = ((1 - frac[:, 0:1], frac[:, 0:1]), (1 - frac[:, 1:2], frac[:, 1:2]),
         (1 - frac[:, 2:3], frac[:, 2:3]))
    rows, vals = [], []
    for a in (0, 1):
        for b in (0, 1):
            for c in (0, 1):
                rows.append(base + (a * Y * Z + b * Z + c))
                vals.append(w[0][a] * w[1][b] * w[2][c] * gv)
    out = torch.zeros((X * Y * Z, C), dtype=g.dtype, device=g.device)
    out.index_add_(0, torch.cat(rows), torch.cat(vals))
    return out.reshape(X, Y, Z, C)


def trilinear_scatter_grad(g: torch.Tensor, min_bound: torch.Tensor,
                           max_bound: torch.Tensor, res: Tuple[int, int, int],
                           pts: torch.Tensor) -> torch.Tensor:
    """The (X, Y, Z, C) grid gradient; see
    :func:`trilinear_scatter_grad_plain` for the arguments. A CPU tensor
    takes the plain version; a CUDA tensor runs the keys pass
    (:func:`launch_keys`), the binning (:func:`bins`) and
    ``trilinear_grad_kernel``, which writes every element of a fresh
    buffer. No host read: capturable in a CUDA graph."""
    if g.device.type == "cpu":
        return trilinear_scatter_grad_plain(g, min_bound, max_bound, res, pts)
    if g.device.type != "cuda":
        raise ValueError(f"trilinear_scatter_grad: unsupported device {g.device}")
    X, Y, Z = (int(r) for r in res)
    if (g.dim() != 2 or g.dtype != torch.float32 or not g.is_contiguous()
            or not 1 <= g.shape[1] <= MAX_CHANNELS or min(X, Y, Z) < 2
            or X * Y * Z >= _INT32_MAX or g.shape[0] >= _INT32_MAX):
        raise ValueError("trilinear_scatter_grad: g must be a contiguous f32 "
                         f"(N < 2^31 - 1, C<={MAX_CHANNELS}) tensor and res >= 2 per axis "
                         f"with X*Y*Z < 2^31 - 1, got {tuple(g.shape)} {g.dtype}, "
                         f"res {tuple(res)}")
    N, C = g.shape
    for name, t, shape in (("min_bound", min_bound, (3,)), ("max_bound", max_bound, (3,)),
                           ("pts", pts, (N, 3))):
        if (t.device != g.device or t.dtype != torch.float32 or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"trilinear_scatter_grad: {name} must be a contiguous f32 "
                             f"{shape} tensor on {g.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    keys, weights = launch_keys(min_bound, max_bound, (X, Y, Z), pts)
    out = torch.empty((X, Y, Z, C), dtype=torch.float32, device=g.device)
    launch_scatter(g, weights, *bins(keys, (X, Y, Z)), out)
    LAUNCHES["trilinear_grad_kernel"] += 1
    return out


def bins(keys: torch.Tensor, res: Tuple[int, int, int]
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The samples binned by base cell, as tpu3d's scatter_grad bins them
    (a sort by key, then searchsorted offsets, trilinear_grad.py:125-130):
    (sorted keys (N,) int32, perm (N,) int64, col_start (X*Y + 1,) int32).
    The sort is stable, so the samples of one cell keep their order, and
    col_start[c] is the first sorted position of column c = x * Y + y,
    whose keys are c * Z .. c * Z + Z - 1. ``keys`` (N,) int32: each
    sample's flat base cell, X*Y*Z for a sample outside the box."""
    X, Y, Z = res
    sorted_keys, perm = torch.sort(keys, stable=True)
    cols = torch.arange(X * Y + 1, dtype=torch.int32, device=keys.device) * Z
    return sorted_keys, perm, torch.searchsorted(sorted_keys, cols, out_int32=True)


def launch_keys(min_bound: torch.Tensor, max_bound: torch.Tensor,
                res: Tuple[int, int, int], pts: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's first pass on the card: (keys (N,) int32, each
    sample's flat base cell or X*Y*Z outside the box; weights (N, 8), its
    corner weights in corner order)."""
    X, Y, Z = res
    N = pts.shape[0]
    keys = torch.empty((N,), dtype=torch.int32, device=pts.device)
    weights = torch.empty((N, 8), dtype=torch.float32, device=pts.device)
    err = function("tpu3d_trilinear_grad_keys")(
        min_bound.data_ptr(), max_bound.data_ptr(), pts.data_ptr(), keys.data_ptr(),
        weights.data_ptr(), X, Y, Z, N, stream(pts.get_device()))
    check(err, "trilinear_grad_keys")
    return keys, weights


def launch_scatter(g: torch.Tensor, weights: torch.Tensor, sorted_keys: torch.Tensor,
                   perm: torch.Tensor, col_start: torch.Tensor, out: torch.Tensor) -> None:
    """Launch ``trilinear_grad_kernel``, writing every element of ``out``
    (X, Y, Z, C) from :func:`launch_keys`' weights and :func:`bins`."""
    X, Y, Z, C = out.shape
    vec = C % 4 == 0 and g.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    err = function("tpu3d_trilinear_grad")(
        g.data_ptr(), weights.data_ptr(), sorted_keys.data_ptr(), perm.data_ptr(),
        col_start.data_ptr(), out.data_ptr(), X, Y, Z, C, int(vec), stream(g.get_device()))
    check(err, "trilinear_grad_kernel")


class TrilinearSample(torch.autograd.Function):
    """Trilinear sampling, differentiable with respect to the grid: the
    forward is kernels/trilinear.py::trilinear_sample, the backward
    :func:`trilinear_scatter_grad`. Only the points and the bounds are saved
    for the backward, never the (N, C) output. The bounds and the points get
    no gradient (tpu3d returns zeros for them, trilinear_grad.py:241-242)."""

    @staticmethod
    def forward(ctx, grid, min_bound, max_bound, pts):
        vals, in_bounds = trilinear_sample(grid, min_bound, max_bound, pts)
        ctx.save_for_backward(min_bound, max_bound, pts)
        ctx.res = tuple(grid.shape[:3])
        ctx.mark_non_differentiable(in_bounds)
        return vals, in_bounds

    @staticmethod
    def backward(ctx, g_vals, _g_in_bounds):
        min_bound, max_bound, pts = ctx.saved_tensors
        grad = trilinear_scatter_grad(g_vals.contiguous(), min_bound, max_bound,
                                      ctx.res, pts)
        return grad, None, None, None


def trilinear_sample_diff(grid: torch.Tensor, min_bound: torch.Tensor,
                          max_bound: torch.Tensor, pts: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values (N, C), in_bounds (N,)) as trilinear_sample, with the grid
    gradient of :class:`TrilinearSample` (tpu3d's sample_packed_diff)."""
    return TrilinearSample.apply(grid, min_bound, max_bound, pts)
