"""Ray samplers of the dense stage (tpu3d/dense/sdf.py:46,58): the ray-box
slab test and stratified depths. Importance sampling and the SDF grid come
with dense training."""
from __future__ import annotations

from typing import Tuple

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


def sample_stratified(t_near: torch.Tensor, t_far: torch.Tensor, n: int) -> torch.Tensor:
    """Uniform depths (N, n) over [t_near, t_far]: tpu3d's sample_stratified
    with perturb=False, the eval path's sampling (the jittered training
    draw comes with dense training)."""
    t = linspace01(n, t_near.device)
    return t_near[:, None] * (1 - t)[None, :] + t_far[:, None] * t[None, :]
