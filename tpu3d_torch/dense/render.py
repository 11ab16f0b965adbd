"""Volume rendering of a voxel grid (tpu3d/dense/render.py).

alpha = 1 - exp(-sigma * delta); transmittance = shifted cumprod(1 - alpha);
pixel = sum(w * c) + (1 - sum(w)) * background. tpu3d's forward routes
(``render_rays`` through the XLA gather, ``render_rays_packed`` through the
Pallas sampler) and its training routes (``render_rays`` under autodiff,
``render_rays_packed_diff``) are one function here, ``render_rays``: it
samples through ``kernels/trilinear.py`` (the CUDA kernel on the card) and,
when the grid requires grad, through ``kernels/trilinear_grad.py``'s
autograd Function, whose backward is the CUDA scatter kernel.
``render_rays_aabb`` renders the SDF grid with per-ray box bands.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpu3d_torch.dense.contract import contract as contract_pts
from tpu3d_torch.dense.grid import VoxelGrid, eval_sh
from tpu3d_torch.dense.occupancy import occupancy_from_grid, sample_occupied
from tpu3d_torch.dense.sdf import (SDFGrid, linspace01, query_sdf_sh, ray_aabb, sample_pdf,
                                   sample_stratified)
from tpu3d_torch.kernels.trilinear import trilinear_sample
from tpu3d_torch.kernels.trilinear_grad import trilinear_sample_diff

# Euclidean reach of the background disparity tail under contraction
# (normalized units, scene core ~1).
_CONTRACT_BG_FAR = 50.0


def composite_weights(sigma: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Per-sample compositing weights w = T * alpha. (N, S) -> (N, S)."""
    delta = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], dim=-1)
    alpha = 1.0 - torch.exp(-sigma * delta)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
    return trans * alpha


def composite(sigma: torch.Tensor, rgb: torch.Tensor, z: torch.Tensor,
              white_bg: bool = True, bg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sigma: (N, S), rgb: (N, S, 3), z: (N, S) sorted depths -> (N, 3).
    bg: optional per-ray background colour (N, 3) that replaces white."""
    w = composite_weights(sigma, z)[..., None]
    c = (w * rgb).sum(dim=1)
    if bg is not None:
        c = c + (1.0 - w.sum(dim=(1, 2)))[..., None] * bg
    elif white_bg:
        c = c + 1.0 - w.sum(dim=(1, 2))[..., None]
    return c


def _sample_z(rays_o, rays_d, t_near, t_far, n_samples, bg_far=None, perturb=False,
              generator=None, u=None, occ=None, bounds=None, n_probes=128):
    """Depths along each ray (tpu3d/dense/render.py:59-86): stratified
    (jittered with ``perturb``, from ``generator`` or the uniforms ``u``),
    or, given an occupancy grid ``occ`` over the box ``bounds``, drawn by
    inverse CDF over its ``n_probes`` probes (dense/occupancy.py). With
    ``bg_far`` (contraction, which takes precedence over ``occ``) a quarter
    of the budget is a tail uniform in disparity from t_far out to
    max(bg_far, 1.05 t_far), and ``u`` covers the stratified part only."""
    if bg_far is None:
        if occ is None:
            return sample_stratified(t_near, t_far, n_samples, perturb, generator, u)
        return sample_occupied(occ, bounds[0], bounds[1], rays_o, rays_d, t_near, t_far,
                               n_probes, n_samples, perturb, generator=generator, u=u)
    n_bg = n_samples // 4
    z_fg = sample_stratified(t_near, t_far, n_samples - n_bg, perturb, generator, u)
    s = linspace01(n_bg + 1, t_near.device)[1:]
    bg_end = torch.clamp(t_far * 1.05, min=bg_far)
    inv = (1.0 / torch.clamp(t_far, min=1e-6))[:, None] * (1.0 - s)[None, :] \
        + (1.0 / bg_end)[:, None] * s[None, :]
    return torch.cat([z_fg, 1.0 / inv], dim=-1)


def jitter_width(n_samples: int, contract: bool) -> int:
    """How many uniforms a ray's jittered depths take: all ``n_samples``,
    or under contraction the stratified three quarters."""
    return n_samples - n_samples // 4 if contract else n_samples


def _band(rays_o, rays_d, near, far, min_bound, max_bound, clip_aabb):
    """Per-ray (t_near, t_far): [near, far], intersected with the box when
    clip_aabb."""
    n = rays_o.shape[0]
    t_near = torch.full((n,), near, dtype=rays_o.dtype, device=rays_o.device)
    t_far = torch.full((n,), far, dtype=rays_o.dtype, device=rays_o.device)
    if clip_aabb:
        t0, t1, valid = ray_aabb(rays_o, rays_d, min_bound, max_bound)
        t_near = torch.where(valid, torch.maximum(t_near, t0), t_near)
        t_far = torch.where(valid, torch.minimum(torch.maximum(t1, t_near + 1e-4), t_far),
                            t_near + 1e-4)
    return t_near, t_far


def _points(rays_o, rays_d, z, contract):
    pts = rays_o[:, None, :] + z[..., None] * rays_d[:, None, :]
    if contract:
        pts = contract_pts(pts)
    dirs = rays_d[:, None, :].expand(pts.shape).reshape(-1, 3)
    return pts.reshape(-1, 3), dirs


def ray_samples(rays_o: torch.Tensor, rays_d: torch.Tensor, near: float, far: float,
                n_samples: int, min_bound: torch.Tensor, max_bound: torch.Tensor,
                clip_aabb: bool = False, contract: bool = False, perturb: bool = False,
                generator: Optional[torch.Generator] = None,
                u: Optional[torch.Tensor] = None, occ: Optional[torch.Tensor] = None,
                occ_probes: int = 128) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sample positions along rays: (pts (N*S, 3), dirs (N*S, 3), z (N, S)).
    clip_aabb intersects each ray's [near, far] band with the box;
    contract warps the positions (not the depths); perturb jitters the
    depths and occ guides them (see :func:`_sample_z`)."""
    t_near, t_far = _band(rays_o, rays_d, near, far, min_bound, max_bound, clip_aabb)
    z = _sample_z(rays_o, rays_d, t_near, t_far, n_samples,
                  _CONTRACT_BG_FAR if contract else None, perturb, generator, u, occ,
                  (min_bound, max_bound), occ_probes)
    pts, dirs = _points(rays_o, rays_d, z, contract)
    return pts, dirs, z


def _shade(vals, in_b, dirs):
    """(sigma, rgb) from the raw channels: relu density, degree-2 SH
    colour, both zero outside the box."""
    sigma = torch.relu(vals[:, 0]) * in_b
    rgb = eval_sh(vals[:, 1:28].reshape(-1, 3, 9), dirs) * in_b[:, None]
    return sigma, rgb


def _sample(vg: VoxelGrid, pts: torch.Tensor, base_vg: Optional[VoxelGrid] = None):
    """Raw channel values at ``pts`` and their in-box flags:
    differentiable when the grid requires grad (the training step), else
    forward-only. With a cascade base, the base's raw channels (sampled
    forward-only, no gradient) are added to the grid's, which counts only
    inside its own box; every sample then counts."""
    fn = trilinear_sample_diff if vg.grid.requires_grad else trilinear_sample
    vals, in_b = fn(vg.grid, vg.min_bound, vg.max_bound, pts)
    if base_vg is not None:
        bvals, bin_b = trilinear_sample(base_vg.grid.detach(), base_vg.min_bound,
                                        base_vg.max_bound, pts)
        vals = bvals * bin_b[:, None] + vals * in_b[:, None]
        in_b = torch.ones_like(in_b)
    return vals, in_b


def render_rays(vg: VoxelGrid, rays_o: torch.Tensor, rays_d: torch.Tensor,
                near: float, far: float, n_samples: int = 192, white_bg: bool = True,
                clip_aabb: bool = False, bg: Optional[torch.Tensor] = None,
                contract: bool = False, base_vg: Optional[VoxelGrid] = None,
                perturb: bool = False, generator: Optional[torch.Generator] = None,
                u: Optional[torch.Tensor] = None, occ: Optional[torch.Tensor] = None,
                occ_probes: int = 128) -> torch.Tensor:
    """(N, 3) colours of rays through the grid at stratified depths,
    jittered with ``perturb`` (training) from ``generator`` or the
    uniforms ``u`` (N, :func:`jitter_width`), or at depths guided by the
    occupancy grid ``occ`` with ``occ_probes`` probes per ray.

    base_vg: optional frozen cascade base grid; ``vg`` is then the detail
    layer: depths and clipping follow the base's box, the base's raw
    channels are added before the activations, and the detail grid counts
    only inside its own box. The base is sampled forward-only and gets no
    gradient."""
    n = rays_o.shape[0]
    rb = base_vg if base_vg is not None else vg
    pts, dirs, z = ray_samples(rays_o, rays_d, near, far, n_samples, rb.min_bound,
                               rb.max_bound, clip_aabb, contract, perturb, generator, u,
                               occ, occ_probes)
    sigma, rgb = _shade(*_sample(vg, pts, base_vg), dirs)
    return composite(sigma.reshape(n, n_samples), rgb.reshape(n, n_samples, 3), z,
                     white_bg, bg)


def render_rays_aabb(sg: SDFGrid, rays_o: torch.Tensor, rays_d: torch.Tensor,
                     n_samples: int = 160, white_bg: bool = True, perturb: bool = False,
                     generator: Optional[torch.Generator] = None,
                     u: Optional[torch.Tensor] = None, bg: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SDF-grid rendering with per-ray box bounds (tpu3d/dense/render.py:150-172,
    ref sdf.py:391-406): each ray's band is its stretch inside the box
    (t_far = t_near + 1 on a ray that misses it), depths stratified
    (jittered with ``perturb`` from ``generator`` or the (N, n_samples)
    uniforms ``u``). Rays that miss are masked, not dropped: returns (rgb
    (N, 3), valid (N,))."""
    n = rays_o.shape[0]
    t_near, t_far, valid = ray_aabb(rays_o, rays_d, sg.min_bound, sg.max_bound)
    t_far = torch.where(valid, t_far, t_near + 1.0)
    z = sample_stratified(t_near, t_far, n_samples, perturb, generator, u)
    pts, dirs = _points(rays_o, rays_d, z, False)
    sigma, rgb = query_sdf_sh(sg, pts, dirs)
    out = composite(sigma.reshape(n, n_samples), rgb.reshape(n, n_samples, 3), z, white_bg, bg)
    return out, valid


def render_rays_hierarchical(vg: VoxelGrid, rays_o: torch.Tensor, rays_d: torch.Tensor,
                             near: float, far: float, n_coarse: int = 64, n_fine: int = 64,
                             white_bg: bool = True, clip_aabb: bool = False,
                             bg: Optional[torch.Tensor] = None, perturb: bool = True,
                             generator: Optional[torch.Generator] = None,
                             u_coarse: Optional[torch.Tensor] = None,
                             u_fine: Optional[torch.Tensor] = None,
                             occ: Optional[torch.Tensor] = None, occ_probes: int = 128,
                             contract: bool = False,
                             base_vg: Optional[VoxelGrid] = None) -> torch.Tensor:
    """Two-pass (coarse -> fine) rendering, as tpu3d's
    render_rays_hierarchical_packed (render.py:390-463). The coarse pass
    samples the grid forward-only at ``n_coarse`` depths from
    :func:`_sample_z` (uniforms ``u_coarse``, the occupancy grid ``occ``,
    the contraction's disparity tail) and keeps the density; its
    compositing weights, without gradient, place ``n_fine`` importance
    samples (uniforms ``u_fine``); the fine pass reads the grid at the
    merged, sorted depths, with the grid gradient when the grid requires
    grad. A cascade base (``base_vg``) is composed in both passes, and the
    band and the occupancy probes follow its box."""
    n = rays_o.shape[0]
    rb = base_vg if base_vg is not None else vg
    t_near, t_far = _band(rays_o, rays_d, near, far, rb.min_bound, rb.max_bound, clip_aabb)
    z_c = _sample_z(rays_o, rays_d, t_near, t_far, n_coarse,
                    _CONTRACT_BG_FAR if contract else None, perturb, generator, u_coarse, occ,
                    (rb.min_bound, rb.max_bound), occ_probes)
    with torch.no_grad():
        pts_c, _ = _points(rays_o, rays_d, z_c, contract)
        vals_c, in_c = _sample(VoxelGrid(vg.grid.detach(), vg.min_bound, vg.max_bound), pts_c,
                               base_vg)
        sigma_c = (torch.relu(vals_c[:, 0]) * in_c).reshape(n, n_coarse)
        w = composite_weights(sigma_c, z_c)
    z_f = sample_pdf(z_c, w, n_fine, generator=generator, u=u_fine)
    z = torch.sort(torch.cat([z_c, z_f], dim=-1), dim=-1).values
    pts, dirs = _points(rays_o, rays_d, z, contract)
    sigma, rgb = _shade(*_sample(vg, pts, base_vg), dirs)
    S = n_coarse + n_fine
    return composite(sigma.reshape(n, S), rgb.reshape(n, S, 3), z, white_bg, bg)


def render_image(vg: VoxelGrid, rays_o: torch.Tensor, rays_d: torch.Tensor,
                 near: float, far: float, n_samples: int = 192, chunk: int = 4096,
                 clip_aabb: bool = False, occ_prune: bool = False, occ_factor: int = 4,
                 occ_threshold: float = 0.5, bg_sh: Optional[torch.Tensor] = None,
                 contract: bool = False, base_grid: Optional[VoxelGrid] = None) -> torch.Tensor:
    """Full-image render in chunks of ``chunk`` rays (no padding: eager
    PyTorch has no compiled shape to keep). occ_prune draws every ray's
    depths by its occupancy, computed once from ``vg`` (factor
    ``occ_factor``, threshold ``occ_threshold``). bg_sh: learned (3, 9)
    background SH coefficients, composited under the residual
    transmittance in place of white."""
    occ = occupancy_from_grid(vg.grid, occ_factor, occ_threshold) if occ_prune else None
    outs = []
    for s in range(0, rays_o.shape[0], chunk):
        rd = rays_d[s:s + chunk]
        bg = None if bg_sh is None else eval_sh(bg_sh.expand(rd.shape[0], 3, 9), rd)
        outs.append(render_rays(vg, rays_o[s:s + chunk], rd, near, far, n_samples,
                                clip_aabb=clip_aabb, bg=bg, contract=contract,
                                base_vg=base_grid, occ=occ))
    return torch.cat(outs)
