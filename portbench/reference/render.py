"""Plain PyTorch volume rendering of a plenoxel grid: the reference that the
benchmark holds the program's renders and training steps against.

Written from the model's equations, not from the program: a channels-last
(X, Y, Z, 1 + 27) grid sampled by trilinear interpolation (align-corners,
zero outside the box), density relu(channel 0), colour from degree-2 real
spherical harmonics, alpha = 1 - exp(-sigma * delta), transmittance the
shifted product of (1 - alpha + 1e-10), pixel = sum(w * c) + (1 - sum w) *
background. Depths are stratified over each ray's band (its stretch inside
the grid's box when clipped), jittered by given uniforms; under contraction
a quarter of them run uniform in disparity out to 50 and sample positions are
warped into the radius-2 ball; hierarchical sampling adds inverse-CDF
samples from a detached coarse pass. Every function works in the dtype of
its inputs, so the same code computes the reference (float32) and its
lower-precision control (bfloat16).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

C0, C1 = 0.282095, 0.488603
C2 = (1.092548, 1.092548, 0.315392, 1.092548, 0.546274)
BG_FAR = 50.0       # the disparity tail's reach under contraction


def eval_sh(k: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Degree-2 real SH colours: k (..., 3, 9) coefficients, d (..., 3)
    unit directions -> (..., 3)."""
    x, y, z = d[..., 0:1], d[..., 1:2], d[..., 2:3]
    return (C0 * k[..., 0] - C1 * y * k[..., 1] + C1 * z * k[..., 2] - C1 * x * k[..., 3]
            + C2[0] * x * y * k[..., 4] - C2[1] * y * z * k[..., 5]
            + C2[2] * (2.0 * z * z - x * x - y * y) * k[..., 6] - C2[3] * x * z * k[..., 7]
            + C2[4] * (x * x - y * y) * k[..., 8])


def trilinear(grid: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, pts: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values (N, C), inside (N,) bool) of an (X, Y, Z, C) grid spanning
    [lo, hi] at (N, 3) points: the 8 corners of each point's cell blended
    along z, then y, then x; zero outside the box."""
    X, Y, Z, C = grid.shape
    res = torch.tensor([X, Y, Z], dtype=pts.dtype, device=pts.device)
    u = (pts - lo) / (hi - lo)
    inside = ((u >= 0) & (u <= 1)).all(dim=-1)
    v = u * (res - 1)
    i0 = torch.minimum(torch.floor(v).clamp(min=0), res - 2)
    f = v - i0
    i0 = i0.long()
    flat = grid.reshape(-1, C)
    base = (i0[:, 0] * Y + i0[:, 1]) * Z + i0[:, 2]

    def corner(a, b, c):
        return flat[base + (a * Y * Z + b * Z + c)]

    fx, fy, fz = f[:, 0:1], f[:, 1:2], f[:, 2:3]

    def along_z(a, b):
        return corner(a, b, 0) * (1 - fz) + corner(a, b, 1) * fz

    c0 = along_z(0, 0) * (1 - fy) + along_z(0, 1) * fy
    c1 = along_z(1, 0) * (1 - fy) + along_z(1, 1) * fy
    out = c0 * (1 - fx) + c1 * fx
    return out * inside[:, None].to(out.dtype), inside


def ray_box(o: torch.Tensor, d: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """Slab test: (t_enter >= 0, t_exit, hit)."""
    inv = 1.0 / torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
    t0, t1 = (lo - o) * inv, (hi - o) * inv
    t_in = torch.minimum(t0, t1).amax(dim=-1).clamp(min=0.0)
    t_out = torch.maximum(t0, t1).amin(dim=-1)
    return t_in, t_out, t_out > t_in


def band(o, d, near: float, far: float, lo, hi, clip: bool):
    """Each ray's (t_near, t_far): [near, far], cut to the box when
    ``clip`` (a ray that misses it gets the empty band [near, near + 1e-4])."""
    t_near = torch.full(o.shape[:1], near, dtype=o.dtype, device=o.device)
    t_far = torch.full(o.shape[:1], far, dtype=o.dtype, device=o.device)
    if clip:
        t_in, t_out, hit = ray_box(o, d, lo, hi)
        t_near = torch.where(hit, torch.maximum(t_near, t_in), t_near)
        t_far = torch.where(hit, torch.minimum(torch.maximum(t_out, t_near + 1e-4), t_far),
                            t_near + 1e-4)
    return t_near, t_far


def unit_steps(n: int, dtype, device) -> torch.Tensor:
    """n evenly spaced numbers from 0 to 1: i times the reciprocal of n - 1
    (in float32), the last exactly 1."""
    t = torch.arange(n, dtype=torch.float32, device=device) * float(
        np.float32(1.0) / np.float32(n - 1))
    t[-1] = 1.0
    return t.to(dtype)


def stratified(t_near, t_far, n: int, u: Optional[torch.Tensor]) -> torch.Tensor:
    """(N, n) depths: n evenly spaced over each band, or with uniforms
    ``u`` one draw inside each stratum between the midpoints."""
    t = unit_steps(n, t_near.dtype, t_near.device)
    z = t_near[:, None] * (1 - t)[None, :] + t_far[:, None] * t[None, :]
    if u is None:
        return z
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    upper = torch.cat([mids, z[:, -1:]], dim=-1)
    lower = torch.cat([z[:, :1], mids], dim=-1)
    return lower + (upper - lower) * u


def depths(t_near, t_far, n: int, contracted: bool, u: Optional[torch.Tensor]) -> torch.Tensor:
    """(N, n) sorted depths; under contraction n - n // 4 stratified over
    the band and n // 4 uniform in disparity from t_far out to
    max(BG_FAR, 1.05 t_far)."""
    if not contracted:
        return stratified(t_near, t_far, n, u)
    n_bg = n // 4
    z_fg = stratified(t_near, t_far, n - n_bg, u)
    s = unit_steps(n_bg + 1, t_near.dtype, t_near.device)[1:]
    end = torch.clamp(t_far * 1.05, min=BG_FAR)
    inv = (1.0 / torch.clamp(t_far, min=1e-6))[:, None] * (1 - s)[None, :] \
        + (1.0 / end)[:, None] * s[None, :]
    return torch.cat([z_fg, 1.0 / inv], dim=-1)


def contract(p: torch.Tensor) -> torch.Tensor:
    """Points beyond the unit ball pulled into the ball of radius 2."""
    n = torch.linalg.norm(p, dim=-1, keepdim=True).clamp(min=1e-9)
    return torch.where(n <= 1.0, p, (2.0 - 1.0 / n) * (p / n))


def weights(sigma: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Compositing weights T * alpha, (N, S)."""
    delta = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], dim=-1)
    alpha = 1.0 - torch.exp(-sigma * delta)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
    return trans * alpha


def composite(sigma, rgb, z, bg: Optional[torch.Tensor]) -> torch.Tensor:
    """(N, 3) colours; the residual transmittance shows ``bg`` (N, 3), or
    white when it is None."""
    w = weights(sigma, z)[..., None]
    c = (w * rgb).sum(dim=1)
    rest = 1.0 - w.sum(dim=(1, 2))
    return c + rest[:, None] * (bg if bg is not None else 1.0)


def inverse_cdf(bins: torch.Tensor, w: torch.Tensor, n: int, u: torch.Tensor) -> torch.Tensor:
    """(N, n) depths drawn by the uniforms ``u`` from the piecewise-linear
    CDF of weights ``w`` + 1e-5 over the (N, B) depths ``bins``."""
    w = w + 1e-5
    cdf = torch.cumsum(w / w.sum(dim=-1, keepdim=True), dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
    edges = torch.cat([bins[:, :1], bins], dim=-1)
    idx = torch.searchsorted(cdf.float().contiguous(), u.float().contiguous(), right=True)
    below = (idx - 1).clamp(min=0)
    above = idx.clamp(max=cdf.shape[-1] - 1)
    c_b, c_a = torch.gather(cdf, 1, below), torch.gather(cdf, 1, above)
    b_b, b_a = torch.gather(edges, 1, below), torch.gather(edges, 1, above)
    span = torch.where(c_a - c_b < 1e-5, torch.ones_like(c_a), c_a - c_b)
    return b_b + (u - c_b) / span * (b_a - b_b)


class Grids:
    """What a render samples: the trained grid over [lo, hi] and, for a
    cascade, a frozen base grid over [base_lo, base_hi] whose raw channels
    are added (the trained grid counting only inside its own box)."""

    def __init__(self, grid, lo, hi, base=None, base_lo=None, base_hi=None):
        self.grid, self.lo, self.hi = grid, lo, hi
        self.base, self.base_lo, self.base_hi = base, base_lo, base_hi

    def box(self):
        return (self.base_lo, self.base_hi) if self.base is not None else (self.lo, self.hi)

    def sample(self, pts: torch.Tensor, grid: Optional[torch.Tensor] = None):
        """(raw channels (N, C), counts (N,)) at ``pts``; ``grid`` stands
        for the trained grid (a detached copy for a pass without gradient)."""
        vals, inside = trilinear(self.grid if grid is None else grid, self.lo, self.hi, pts)
        if self.base is None:
            return vals, inside.to(vals.dtype)
        bvals, binside = trilinear(self.base, self.base_lo, self.base_hi, pts)
        vals = bvals * binside[:, None].to(vals.dtype) + vals * inside[:, None].to(vals.dtype)
        return vals, torch.ones_like(inside, dtype=vals.dtype)


def shade(vals, count, dirs):
    """(sigma, rgb) from raw channels: relu density and SH colour, both
    zero where the sample does not count."""
    sigma = torch.relu(vals[:, 0]) * count
    rgb = eval_sh(vals[:, 1:28].reshape(-1, 3, 9), dirs) * count[:, None]
    return sigma, rgb


def points(o, d, z, contracted: bool):
    p = o[:, None, :] + z[..., None] * d[:, None, :]
    if contracted:
        p = contract(p)
    return p.reshape(-1, 3), d[:, None, :].expand(p.shape).reshape(-1, 3)


def render_rays(g: Grids, o, d, near: float, far: float, n: int, clip: bool,
                contracted: bool = False, u: Optional[torch.Tensor] = None,
                bg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, 3) colours of rays at n (jittered by ``u``) depths."""
    lo, hi = g.box()
    t_near, t_far = band(o, d, near, far, lo, hi, clip)
    z = depths(t_near, t_far, n, contracted, u)
    p, dirs = points(o, d, z, contracted)
    sigma, rgb = shade(*g.sample(p), dirs)
    return composite(sigma.reshape(-1, n), rgb.reshape(-1, n, 3), z, bg)


def render_rays_hierarchical(g: Grids, o, d, near: float, far: float, n_coarse: int,
                             n_fine: int, clip: bool, contracted: bool, u: torch.Tensor,
                             u_fine: torch.Tensor, bg: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """(N, 3) colours: a coarse pass of density alone at n_coarse depths,
    without gradient, whose weights place n_fine more by inverse CDF; the
    colour from all n_coarse + n_fine depths, sorted."""
    lo, hi = g.box()
    t_near, t_far = band(o, d, near, far, lo, hi, clip)
    z_c = depths(t_near, t_far, n_coarse, contracted, u)
    with torch.no_grad():
        p, _ = points(o, d, z_c, contracted)
        vals, count = g.sample(p, g.grid.detach())
        w = weights((torch.relu(vals[:, 0]) * count).reshape(-1, n_coarse), z_c)
    z_f = inverse_cdf(z_c, w, n_fine, u_fine)
    z = torch.sort(torch.cat([z_c, z_f], dim=-1), dim=-1).values
    p, dirs = points(o, d, z, contracted)
    sigma, rgb = shade(*g.sample(p), dirs)
    S = n_coarse + n_fine
    return composite(sigma.reshape(-1, S), rgb.reshape(-1, S, 3), z, bg)


def view_rays(cam: np.ndarray, height: int, width: int, focal: float, center, scale,
              stride: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """A camera's rays at every ``stride``-th row and column, row-major:
    (origins, unit directions), (h*w, 3) float32 each, in the frame (x -
    center) / scale. cam: [rvec | t] world->camera; the pixel (x, y) looks
    along (x - W/2, -(y - H/2), focal) in the camera's frame."""
    w = np.asarray(cam[:3], np.float64)
    theta = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    R = (np.eye(3) + np.sin(theta) / theta * K + (1 - np.cos(theta)) / theta ** 2 * K @ K
         if theta >= 1e-8 else np.eye(3) + K + 0.5 * K @ K).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(0, height, stride), np.arange(0, width, stride),
                         indexing="ij")
    x = xs.reshape(-1).astype(np.float32) - width / 2.0
    y = -(ys.reshape(-1).astype(np.float32) - height / 2.0)
    d = np.stack([x / focal, y / focal, np.ones_like(x)], axis=-1) @ R
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o = (-R.T @ np.asarray(cam[3:6]) - center) / scale
    return np.broadcast_to(o.astype(np.float32), d.shape).copy(), d


def render_view(grid: torch.Tensor, lo, hi, cam: np.ndarray, height: int, width: int,
                focal: float, center, scale, near: float, far: float, n: int,
                bg_sh: torch.Tensor, dtype=torch.float32, chunk: int = 4096,
                stride: int = 1) -> np.ndarray:
    """One whole view of ``grid`` at every ``stride``-th row and column,
    with box clipping and the SH background ``bg_sh`` (3, 9), computed in
    ``dtype`` in chunks of rays: (h, w, 3) float32 on the host."""
    o_np, d_np = view_rays(cam, height, width, focal, center, scale, stride)
    dev = grid.device
    g = Grids(grid.to(dtype), lo.to(dtype), hi.to(dtype))
    bgk = bg_sh.to(dtype)
    out = []
    with torch.no_grad():
        for s in range(0, len(o_np), chunk):
            o = torch.from_numpy(o_np[s:s + chunk]).to(dev).to(dtype)
            d = torch.from_numpy(d_np[s:s + chunk]).to(dev).to(dtype)
            bg = eval_sh(bgk.expand(d.shape[0], 3, 9), d)
            out.append(render_rays(g, o, d, near, far, n, True, bg=bg).float().cpu())
    return torch.cat(out).numpy().reshape(len(range(0, height, stride)),
                                          len(range(0, width, stride)), 3)
