"""Occupancy-guided ray sampling (tpu3d/dense/occupancy.py).

A coarse boolean occupancy grid, one cell per factor^3 voxels, says where
the density is; training draws its sample depths by inverse CDF over each
ray's occupied probes (``sample_occupied``), and rendering can shrink each
ray's band to its occupied part (``tighten_bands``). tpu3d computes all of
this outside its Pallas kernels, so here it is plain PyTorch on the grid's
device. tpu3d's ``occupancy_from_packed`` reads its packed TPU layout,
which the port does not keep; ``occupancy_from_grid`` is its counterpart.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tpu3d_torch.dense.sdf import sample_pdf


def occupancy_from_grid(grid: torch.Tensor, factor: int = 4, threshold: float = 0.5,
                        dilate: bool = True) -> torch.Tensor:
    """(ceil(X/f), ceil(Y/f), ceil(Z/f)) bool occupancy of an (X, Y, Z, C)
    grid: a cell is occupied iff relu(density) of any voxel of its block
    exceeds ``threshold``; ``dilate`` adds the 6 neighbours of every
    occupied cell (wrapping around the grid's faces, as tpu3d's roll)."""
    return _occupancy_from_density(grid[..., 0], factor, threshold, dilate)


def _occupancy_from_density(dens: torch.Tensor, factor: int, threshold: float,
                            dilate: bool) -> torch.Tensor:
    X, Y, Z = dens.shape
    f = factor
    px, py, pz = (-X) % f, (-Y) % f, (-Z) % f
    dens = F.pad(torch.relu(dens), (0, pz, 0, py, 0, px))
    blocks = dens.reshape((X + px) // f, f, (Y + py) // f, f, (Z + pz) // f, f)
    occ = blocks.amax(dim=(1, 3, 5)) > threshold
    if dilate:
        o = occ
        occ = o.clone()
        for axis in range(3):
            occ |= torch.roll(o, 1, axis) | torch.roll(o, -1, axis)
    return occ


def probe_occupancy(occ: torch.Tensor, min_bound: torch.Tensor, max_bound: torch.Tensor,
                    rays_o: torch.Tensor, rays_d: torch.Tensor, t_near: torch.Tensor,
                    t_far: torch.Tensor, n_probes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-cell occupancy at ``n_probes`` evenly spaced depths over
    each ray's [t_near, t_far]: (depths (N, P), occupied (N, P) bool);
    probes outside the box are unoccupied."""
    n = rays_o.shape[0]
    res = torch.tensor(occ.shape, dtype=torch.float32, device=rays_o.device)
    step = (t_far - t_near) / (n_probes - 1)
    ts = t_near[:, None] + step[:, None] * torch.arange(n_probes, dtype=torch.float32,
                                                        device=rays_o.device)[None, :]
    pts = rays_o[:, None, :] + ts[..., None] * rays_d[:, None, :]
    u = (pts - min_bound) / (max_bound - min_bound)
    # tpu3d casts u * res to int32 (toward zero), then clips to the grid;
    # clamping in float first gives the same cell without overflow
    idx = torch.minimum((u * res).clamp(min=0.0), res - 1.0).long()
    inb = ((u >= 0.0) & (u < 1.0)).all(dim=-1)
    Yc, Zc = occ.shape[1], occ.shape[2]
    flat = (idx[..., 0] * Yc + idx[..., 1]) * Zc + idx[..., 2]
    return ts, occ.reshape(-1)[flat.reshape(-1)].reshape(n, n_probes) & inb


def sample_occupied(occ: torch.Tensor, min_bound: torch.Tensor, max_bound: torch.Tensor,
                    rays_o: torch.Tensor, rays_d: torch.Tensor, t_near: torch.Tensor,
                    t_far: torch.Tensor, n_probes: int, n_samples: int, perturb: bool = True,
                    empty_weight: float = 1e-2, generator: Optional[torch.Generator] = None,
                    u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sorted (N, n_samples) depths drawn by inverse CDF over the probes'
    occupancy (weight 1 + ``empty_weight`` occupied, ``empty_weight``
    empty, so that training can still reach cells classified empty);
    evenly spaced quantiles unless ``perturb``, else the uniforms ``u`` or
    draws from ``generator``. A ray with no occupied probe samples its band
    uniformly."""
    ts, o = probe_occupancy(occ, min_bound, max_bound, rays_o, rays_d, t_near, t_far, n_probes)
    w = o.float() + empty_weight
    z = sample_pdf(ts, w, n_samples, det=not perturb, generator=generator, u=u)
    return torch.sort(z, dim=-1).values


def tighten_bands(occ: torch.Tensor, min_bound: torch.Tensor, max_bound: torch.Tensor,
                  rays_o: torch.Tensor, rays_d: torch.Tensor, t_near: torch.Tensor,
                  t_far: torch.Tensor, n_probes: int = 128
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each ray's band shrunk to [first occupied probe - 1 step, last + 1
    step] within [t_near, t_far]: (t_near', t_far', hit). A ray with no
    occupied probe gets the degenerate band [t_near, t_near + 1e-4] and
    hit False."""
    n = rays_o.shape[0]
    step = (t_far - t_near) / (n_probes - 1)
    ts, o = probe_occupancy(occ, min_bound, max_bound, rays_o, rays_d, t_near, t_far, n_probes)
    hit = o.any(dim=-1)
    oi = o.to(torch.uint8)
    first = torch.argmax(oi, dim=-1)
    last = n_probes - 1 - torch.argmax(torch.flip(oi, dims=[1]), dim=-1)
    rows = torch.arange(n, device=rays_o.device)
    t0 = torch.maximum(ts[rows, first] - step, t_near)
    t1 = torch.minimum(ts[rows, last] + step, t_far)
    return torch.where(hit, t0, t_near), torch.where(hit, t1, t_near + 1e-4), hit
