"""Ray samplers of the dense stage (tpu3d/dense/sdf.py:46-101): the ray-box
slab test, stratified depths (jittered for training) and inverse-CDF
importance sampling. The SDF grid comes with the SDF model.

The jitter is drawn from a ``torch.Generator`` or given as uniforms ``u``,
as tpu3d's own ``u`` parameter allows; tests pass tpu3d's draws there,
which torch cannot reproduce."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


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
