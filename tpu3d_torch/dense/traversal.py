"""Batched Amanatides-Woo voxel traversal (tpu3d/dense/traversal.py; the
reference's voxel_travesal.py walks one ray at a time over ragged step
counts). Every ray advances in lockstep for a fixed budget of steps, on
whole tensors, with a per-ray done mask; finished rays emit (-1, -1, -1)."""
from __future__ import annotations

from typing import Tuple

import torch


def voxel_traversal(rays_o: torch.Tensor, rays_d: torch.Tensor, t_near: torch.Tensor,
                    t_far: torch.Tensor, min_bound, voxel_size,
                    grid_resolution: Tuple[int, int, int], max_steps: int = 256
                    ) -> torch.Tensor:
    """Visited voxel indices (N, max_steps, 3), int32; -1 marks unused
    slots. rays_o / rays_d: (N, 3); [t_near, t_far] is the traversal
    interval (for instance from dense.sdf.ray_aabb). The first voxel is the
    one just past the entry point; each step moves along the axis whose
    next boundary is nearest (the lowest axis on a tie) and a ray stops
    when it leaves the grid or passes t_far (voxel_travesal.py:10-68)."""
    dev, dt = rays_o.device, rays_o.dtype
    res = torch.as_tensor(grid_resolution, dtype=torch.int32, device=dev)
    mn = torch.as_tensor(min_bound, dtype=dt, device=dev)
    vs = torch.as_tensor(voxel_size, dtype=dt, device=dev).expand(3)
    p_in = rays_o + (t_near[:, None] + 1e-6) * rays_d
    voxel = torch.floor((p_in - mn) / vs).to(torch.int32)
    voxel = torch.minimum(torch.clamp(voxel, min=0), res - 1)
    step = torch.where(rays_d > 0, 1, -1).to(torch.int32)
    flat = rays_d.abs() < 1e-12
    safe_d = torch.where(flat, torch.full_like(rays_d, 1e-12), rays_d)
    t_delta = (vs / safe_d).abs()
    next_boundary = mn + (voxel + (step > 0).to(torch.int32)) * vs
    t_max = torch.where(flat, torch.full_like(rays_d, float("inf")),
                        (next_boundary - rays_o) / safe_d)
    done = t_far <= t_near
    out = torch.empty((rays_o.shape[0], max_steps, 3), dtype=torch.int32, device=dev)
    for s in range(max_steps):
        out[:, s] = torch.where(done[:, None], -1, voxel)
        axis = torch.argmin(t_max, dim=-1)
        onehot = torch.nn.functional.one_hot(axis, 3).to(torch.int32)
        voxel = voxel + onehot * step
        t_exit = t_max.amin(dim=-1)
        t_max = t_max + onehot.to(dt) * t_delta
        oob = ((voxel < 0) | (voxel >= res)).any(dim=-1)
        done = done | oob | (t_exit > t_far)
    return out
