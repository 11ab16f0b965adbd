"""The SDF grid and the ray samplers of the dense stage (tpu3d/dense/sdf.py):
the ray-box slab test, stratified depths (jittered for training),
inverse-CDF importance sampling, and the SDF model's grid (1 SDF channel +
27 SH channels) with its queries: the SDF value, its spatial gradient by
autograd through the plain trilinear interpolant, the gradient-softmax
proposal weights, and (density, colour) as relu(SDF) and SH.

The jitter is drawn from a ``torch.Generator`` or given as uniforms ``u``,
as tpu3d's own ``u`` parameter allows; tests pass tpu3d's draws there,
which torch cannot reproduce."""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from tpu3d_torch.dense.grid import VoxelGrid, eval_sh
from tpu3d_torch.dense.grid import trilinear_sample as trilinear_plain
from tpu3d_torch.kernels.trilinear import trilinear_sample
from tpu3d_torch.kernels.trilinear_grad import trilinear_sample_diff


class SDFGrid(NamedTuple):
    grid: torch.Tensor        # (X, Y, Z, 28): 1 SDF + 27 SH
    min_bound: torch.Tensor
    max_bound: torch.Tensor

    def as_voxel_grid(self) -> VoxelGrid:
        return VoxelGrid(self.grid, self.min_bound, self.max_bound)


def grid_bounds_from_cloud(points, max_resolution: int = 250, margin: float = 1.5):
    """Grid bounds = margin x the cloud's box, cut into equal cubes (ref
    sdf.py:94-108). Returns (min_bound, max_bound, resolution xyz)."""
    mn = np.min(points, axis=0) * margin
    mx = np.max(points, axis=0) * margin
    size = mx - mn
    box = np.max(size) / max_resolution
    res = np.maximum(np.ceil(size / box).astype(int), 2)
    mx = mn + res * box
    return mn.astype(np.float32), mx.astype(np.float32), tuple(int(r) for r in res)


def ray_aabb(rays_o: torch.Tensor, rays_d: torch.Tensor, min_bound, max_bound
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slab test (ref sdf.py:154-165). Returns (t_near, t_far, valid)."""
    inv_d = 1.0 / torch.where(rays_d.abs() < 1e-9, torch.full_like(rays_d, 1e-9), rays_d)
    t0 = (min_bound - rays_o) * inv_d
    t1 = (max_bound - rays_o) * inv_d
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    t_near = torch.clamp(t_near, min=0.0)
    return t_near, t_far, t_far > t_near


def linspace01(n: int, device=None) -> torch.Tensor:
    """(n,) f32 from 0 to 1 as XLA evaluates ``jnp.linspace(0, 1, n)``:
    i times the f32 reciprocal of n - 1, the last exactly 1."""
    if n == 1:
        return torch.zeros(1, device=device)
    t = torch.arange(n, dtype=torch.float32, device=device) * float(
        torch.tensor(1.0) / (n - 1))
    t[-1] = 1.0
    return t


def _uniform(shape, like: torch.Tensor, generator: Optional[torch.Generator],
             u: Optional[torch.Tensor]) -> torch.Tensor:
    if u is not None:
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"injected uniforms of shape {tuple(u.shape)}, expected {shape}")
        return u
    return torch.rand(shape, generator=generator, dtype=like.dtype, device=like.device)


def sample_stratified(t_near: torch.Tensor, t_far: torch.Tensor, n: int,
                      perturb: bool = False, generator: Optional[torch.Generator] = None,
                      u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depths (N, n) over [t_near, t_far]: uniform, or with ``perturb``
    one draw inside each stratum (ref sdf.py:167-180). u: (N, n) uniforms
    in [0, 1) to use instead of drawing from ``generator``."""
    t = linspace01(n, t_near.device)
    z = t_near[:, None] * (1 - t)[None, :] + t_far[:, None] * t[None, :]
    if perturb:
        mids = 0.5 * (z[:, 1:] + z[:, :-1])
        upper = torch.cat([mids, z[:, -1:]], dim=-1)
        lower = torch.cat([z[:, :1], mids], dim=-1)
        z = lower + (upper - lower) * _uniform(z.shape, z, generator, u)
    return z


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               det: bool = False, generator: Optional[torch.Generator] = None,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF importance sampling (NeRF hierarchical sampling; ref
    sdf.py:188-218): (N, n_samples) depths distributed as ``weights`` over
    the (N, B) ``bins``. det takes evenly spaced quantiles; u: (N,
    n_samples) uniforms to use instead of drawing from ``generator``."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)      # (N, B+1)
    bins_pad = torch.cat([bins[..., :1], bins], dim=-1)                 # (N, B+1)
    shape = (*cdf.shape[:-1], n_samples)
    if det:
        u = linspace01(n_samples, cdf.device).expand(shape)
    else:
        u = _uniform(shape, cdf, generator, u)
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(idx - 1, min=0)
    above = torch.clamp(idx, max=cdf.shape[-1] - 1)
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    bin_b = torch.gather(bins_pad, -1, below)
    bin_a = torch.gather(bins_pad, -1, above)
    denom = torch.where(cdf_a - cdf_b < 1e-5, torch.ones_like(cdf_a), cdf_a - cdf_b)
    t = (u - cdf_b) / denom
    return bin_b + t * (bin_a - bin_b)


def get_sdf(sg: SDFGrid, pts: torch.Tensor) -> torch.Tensor:
    """(N,) SDF values at (N, 3) points (the plain interpolant, so that it
    is differentiable in the points)."""
    vals, _ = trilinear_plain(sg.grid[..., :1], sg.min_bound, sg.max_bound, pts)
    return vals[:, 0]


def get_sdf_gradient(sg: SDFGrid, pts: torch.Tensor) -> torch.Tensor:
    """(N, 3) spatial gradient of the interpolated SDF (ref sdf.py:344-348):
    autograd through the plain trilinear interpolant, as tpu3d's jax.grad
    (the CUDA kernel's backward gives the grid gradient only)."""
    with torch.enable_grad():
        p = pts.detach().clone().requires_grad_()
        (g,) = torch.autograd.grad(get_sdf(sg, p).sum(), p)
    return g


def gradient_softmax_weights(sg: SDFGrid, pts: torch.Tensor) -> torch.Tensor:
    """Proposal weights = softmax over |grad sdf| along each ray (ref
    sdf.py:237-242). pts: (N, S, 3) -> (N, S)."""
    gm = torch.linalg.norm(get_sdf_gradient(sg, pts.reshape(-1, 3)), dim=-1)
    return torch.softmax(gm.reshape(pts.shape[:-1]), dim=-1)


def query_sdf_sh(sg: SDFGrid, pts: torch.Tensor, dirs: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sigma, rgb) of the SDF grid: density = relu(SDF channel) (ref
    sdf.py:376-377), colour = SH of channels 1:28 (ref sdf.py:398); both
    zero outside the box. Samples through the kernel wrapper, and through
    the scatter kernel's autograd Function when the grid requires grad."""
    fn = trilinear_sample_diff if sg.grid.requires_grad else trilinear_sample
    vals, in_bounds = fn(sg.grid, sg.min_bound, sg.max_bound, pts)
    sigma = torch.relu(vals[:, 0]) * in_bounds
    k = vals[:, 1:].reshape(*vals.shape[:-1], 3, 9)
    rgb = eval_sh(k, dirs) * in_bounds[:, None]
    return sigma, rgb
