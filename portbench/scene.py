"""The benchmark's seeded synthetic scene, made on the device.

Three textured planes form a corner (x = 0, y = 0, z = 0, each for in-plane
coordinates in [0, S]); cameras on a 60-degree arc look at the corner. The
geometry is fixed: cameras, the sparse cloud (a regular lattice of points on
the planes) and everything derived from it (normalization, sampling band,
cascade box) are the same for every seed, so every seed gives the same
amount of work. The seed draws the three textures, and with them the
photographs and the voxel grids made from them.

This is a frozen copy, rewritten in torch, of the scene that ``chip_smoke.py``
builds in numpy (``make_scene``, ``_texture``, ``make_dense_artifacts``), and of
the arithmetic that ``densify`` applies to a sparse cloud (the coremax and
contracted normalizations, the automatic near / far band, the cascade's detail
box, the interpolated flythrough). It imports nothing of the program, so a
later change to the program cannot move the benchmark's inputs.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SH_C0 = 0.282095
# (axis of the normal, (in-plane axes a, b)); a plane point (pa, pb) shows
# texture[pb * texels, pa * texels].
PLANES = ((0, (2, 1)), (2, (0, 1)), (1, (0, 2)))
TEXTURE_GAINS = (0.9, 1.0, 0.8)
TARGET = np.array([1.5, 1.0, 1.5])
CAMERA_DISTANCE = 5.6          # sets the texture's size: about one texel per pixel
BACKGROUND = 0.5


# --------------------------------------------------------------------------
# Fixed geometry, on the host (a few dozen numbers).


def so3_exp(w) -> np.ndarray:
    """Rodrigues: axis-angle (3,) -> rotation (3, 3), float64."""
    w = np.asarray(w, np.float64)
    theta = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if theta < 1e-8:
        return np.eye(3) + K + 0.5 * K @ K
    return np.eye(3) + np.sin(theta) / theta * K + (1 - np.cos(theta)) / theta ** 2 * K @ K


def so3_log(R) -> np.ndarray:
    """Rotation (3, 3) -> axis-angle (3,), float64 (quaternion route)."""
    R = np.asarray(R, np.float64)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                      (R[1, 0] - R[0, 1]) / s])
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12)) * 2
        v = np.empty(3)
        v[i] = 0.25 * s
        v[j] = (R[j, i] + R[i, j]) / s
        v[k] = (R[k, i] + R[i, k]) / s
        q = np.array([(R[k, j] - R[j, k]) / s, *v])
    if q[0] < 0:
        q = -q
    vn = np.linalg.norm(q[1:])
    if vn < 1e-12:
        return 2.0 * q[1:]
    return 2.0 * np.arctan2(vn, q[0]) * q[1:] / vn


def look_at(center, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """World->camera rotation whose z axis looks from ``center`` at
    ``target`` and whose y axis points up."""
    z = np.asarray(target, np.float64) - center
    z /= np.linalg.norm(z)
    y = np.asarray(up, np.float64) - z * np.dot(up, z)
    y /= np.linalg.norm(y)
    return np.stack([np.cross(y, z), y, z])


def cameras(n_views: int, width: int) -> Dict[str, np.ndarray]:
    """The arc of cameras: {"cams": (n, 6) [rvec | t] world->camera,
    "focal": float}."""
    Rs, Cs = [], []
    for phi in np.linspace(np.radians(15.0), np.radians(75.0), n_views):
        C = TARGET + np.array([5.0 * np.cos(phi), 2.5, 5.0 * np.sin(phi)])
        Rs.append(look_at(C, TARGET))
        Cs.append(C)
    R, C = np.stack(Rs), np.stack(Cs)
    cams = np.stack([np.concatenate([so3_log(r), -r @ c]) for r, c in zip(R, C)])
    return {"cams": cams, "focal": 0.9 * width}


def lattice_points(plane_size: float, per_side: int) -> np.ndarray:
    """The sparse cloud: a per_side x per_side lattice of cell centres on
    each plane, (3 * per_side^2, 3) float64."""
    s = (np.arange(per_side) + 0.5) / per_side * plane_size
    pa, pb = np.meshgrid(s, s, indexing="ij")
    out = []
    for axis, (a, b) in PLANES:
        p = np.zeros((per_side * per_side, 3))
        p[:, a], p[:, b] = pa.reshape(-1), pb.reshape(-1)
        out.append(p)
    return np.concatenate(out)


def held_out_views(n_views: int, holdout_every: int) -> List[int]:
    """The held-out views of images named img_000 ... : the last number in
    the name is holdout_every // 2 modulo holdout_every."""
    return [i for i in range(n_views) if i % holdout_every == holdout_every // 2]


def core_points(points: np.ndarray, q: float, k: float) -> np.ndarray:
    center = np.median(points, axis=0)
    dist = np.linalg.norm(points - center, axis=1)
    return points[dist <= k * np.percentile(dist, q)]


def norm_coremax(points: np.ndarray, q: float) -> Tuple[np.ndarray, float]:
    """(centre float32 (3,), scale): the points within p``q`` of the median
    radius, their mean and max-abs extent."""
    keep = core_points(points, q, 1.0)
    p = keep if len(keep) else points
    center = p.mean(axis=0)
    return center.astype(np.float32), float(np.abs(p - center).max() + 1e-9)


def norm_contracted(points: np.ndarray, core_q: float, core_radius: float
                    ) -> Tuple[np.ndarray, float]:
    """(centre, scale) under which the p``core_q`` radius of the
    median-centred cloud lands at ``core_radius``."""
    center = np.median(points, axis=0)
    dist = np.linalg.norm(points - center, axis=1)
    return center.astype(np.float32), float(np.percentile(dist, core_q)) / core_radius + 1e-9


def auto_near_far(cams: np.ndarray, points: np.ndarray, center, scale) -> Tuple[float, float]:
    """The sampling band from the cloud: percentiles of the points' depth
    along each camera's optical axis, in the normalized frame."""
    pts = core_points(points, 90.0, 4.0)
    pts = ((pts if len(pts) else points) - center) / scale
    depths = []
    for m in range(0, len(cams), max(len(cams) // 32, 1)):
        R = so3_exp(cams[m, :3]).astype(np.float32)
        C = (-R.T @ cams[m, 3:6] - center) / scale
        d = (pts - C) @ R[2]
        depths.append([np.percentile(d, 2), np.percentile(d, 98)])
    depths = np.asarray(depths)
    near = max(float(np.percentile(depths[:, 0], 10)) * 0.8, 1e-2)
    far = float(np.percentile(depths[:, 1], 90)) * 1.3
    return near, max(far, near + 1e-2)


def contract_np(p: np.ndarray) -> np.ndarray:
    n = np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-9)
    return np.where(n <= 1.0, p, (2.0 - 1.0 / n) * (p / n))


def detail_box(points: np.ndarray, center, scale, coremax_q: float, base_lo, base_hi,
               budget: int) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int, int]]:
    """The cascade's detail grid: the kept cloud's box in the contracted
    frame, inside the base's box, at the budget^3 voxel count. Returns
    (lo, hi, resolution), each axis a multiple of 8 in [32, 2 * budget]."""
    kept = core_points(points, coremax_q, 1.0)
    pn = contract_np(((kept if len(kept) else points) - center) / scale).astype(np.float32)
    lo = np.percentile(pn, 0.5, axis=0).astype(np.float32)
    hi = np.percentile(pn, 99.5, axis=0).astype(np.float32)
    pad = 0.05 * (hi - lo) + 1e-3
    lo, hi = np.maximum(lo - pad, base_lo), np.minimum(hi + pad, base_hi)
    ext = np.maximum(hi - lo, 1e-3)
    s = float((budget ** 3 / np.prod(ext)) ** (1.0 / 3.0))
    res = tuple(int(np.clip(round(e * s / 8) * 8, 32, 2 * budget)) for e in ext)
    return lo.astype(np.float32), hi.astype(np.float32), res


def interpolate_poses(cams: np.ndarray, n_frames: int) -> np.ndarray:
    """A flythrough along the cameras: piecewise slerp of the rotations and
    lerp of the centres at uniform arc length. (M, 6) -> (n_frames, 6)."""
    M = len(cams)
    Rs = np.stack([so3_exp(c[:3]) for c in cams])
    Cs = np.stack([-R.T @ c[3:6] for R, c in zip(Rs, cams)])
    cum = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(Cs, axis=0), axis=1))])
    out, k = [], 0
    for s in np.linspace(0.0, cum[-1], n_frames):
        while k < M - 2 and cum[k + 1] < s:
            k += 1
        a = float(np.clip((s - cum[k]) / max(cum[k + 1] - cum[k], 1e-12), 0.0, 1.0))
        R = so3_exp(a * so3_log(Rs[k + 1] @ Rs[k].T)) @ Rs[k]
        c = (1.0 - a) * Cs[k] + a * Cs[k + 1]
        out.append(np.concatenate([so3_log(R), -R @ c]))
    return np.stack(out)


# --------------------------------------------------------------------------
# Seeded data, on the device.


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable gaussian blur of an (n, n) tensor, edges replicated, the
    kernel cut at 4 sigma."""
    r = max(int(4.0 * sigma + 0.5), 1)
    x = torch.arange(-r, r + 1, dtype=img.dtype, device=img.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()
    out = F.pad(img[None, None], (r, r, r, r), mode="replicate")
    out = F.conv2d(out, k.view(1, 1, 1, -1))
    return F.conv2d(out, k.view(1, 1, -1, 1))[0, 0]


def textures(generator: torch.Generator, n: int, device) -> List[torch.Tensor]:
    """The three plane textures, (n, n) float64 each: multi-scale gaussian
    noise stretched to [0.08, 0.92] x the plane's gain."""
    out = []
    for gain in TEXTURE_GAINS:
        noise = torch.randn((n, n), generator=generator, dtype=torch.float64, device=device)
        tex = sum(gaussian_blur(noise, s) * s ** 0.8 for s in (1.0, 2.0, 4.0, 8.0, 16.0))
        lo, hi = torch.quantile(tex.reshape(-1), torch.tensor([0.01, 0.99], dtype=tex.dtype,
                                                              device=device))
        out.append(gain * (0.08 + 0.84 * torch.clamp((tex - lo) / (hi - lo), 0.0, 1.0)))
    return out


def bilinear(tex: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of ``tex`` at fractional (rows, cols), coordinates
    clamped to the texture."""
    n0, n1 = tex.shape
    r = rows.clamp(0, n0 - 1)
    c = cols.clamp(0, n1 - 1)
    r0 = r.floor().clamp(max=n0 - 2).long()
    c0 = c.floor().clamp(max=n1 - 2).long()
    fr, fc = r - r0, c - c0
    flat = tex.reshape(-1)
    i = r0 * n1 + c0
    return ((flat[i] * (1 - fc) + flat[i + 1] * fc) * (1 - fr)
            + (flat[i + n1] * (1 - fc) + flat[i + n1 + 1] * fc) * fr)


class Scene:
    """The scene of one seed: fixed cameras and cloud, seeded textures.
    ``cfg`` is a configuration's ``scene`` group."""

    def __init__(self, cfg: dict, seed: int, device):
        self.device = torch.device(device)
        self.width, self.height = int(cfg["width"]), int(cfg["height"])
        self.plane_size = float(cfg["plane_size"])
        cam = cameras(int(cfg["n_views"]), self.width)
        self.cams, self.focal = cam["cams"], cam["focal"]
        self.points = lattice_points(self.plane_size, int(cfg["points_per_side"]))
        self.n_tex = int(self.plane_size * self.focal / CAMERA_DISTANCE)
        self.texels = self.n_tex / self.plane_size
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.textures = textures(gen, self.n_tex, self.device)
        test = held_out_views(int(cfg["n_views"]), int(cfg["holdout_every"]))
        self.train = [i for i in range(int(cfg["n_views"])) if i not in test]

    def camera_dirs(self, view: int, dtype=torch.float32) -> torch.Tensor:
        """Unit world directions of a view's pixels, row-major, (H*W, 3):
        the pixel (x, y) looks along (x - W/2, -(y - H/2), focal) in the
        camera's frame."""
        dev = self.device
        ys, xs = torch.meshgrid(torch.arange(self.height, device=dev, dtype=dtype),
                                torch.arange(self.width, device=dev, dtype=dtype), indexing="ij")
        d_cam = torch.stack([(xs.reshape(-1) - self.width / 2.0) / self.focal,
                             -(ys.reshape(-1) - self.height / 2.0) / self.focal,
                             torch.ones(xs.numel(), device=dev, dtype=dtype)], dim=-1)
        R = torch.as_tensor(so3_exp(self.cams[view, :3]), dtype=dtype, device=dev)
        d = d_cam @ R
        return d / torch.linalg.norm(d, dim=-1, keepdim=True)

    def centre(self, view: int) -> np.ndarray:
        R = so3_exp(self.cams[view, :3]).astype(np.float32)
        return -R.T @ self.cams[view, 3:6]

    def photograph(self, view: int) -> torch.Tensor:
        """A view's 8-bit grey photograph as float32 in [0, 1], (H*W,),
        by ray-plane intersection (float64)."""
        d = self.camera_dirs(view, torch.float64)
        C = torch.as_tensor(self.centre(view), dtype=torch.float64, device=self.device)
        depth = torch.full((d.shape[0],), float("inf"), dtype=torch.float64, device=self.device)
        img = torch.full_like(depth, BACKGROUND)
        S = self.plane_size
        for (axis, (a, b)), tex in zip(PLANES, self.textures):
            lam = -C[axis] / d[:, axis]
            pa, pb = C[a] + lam * d[:, a], C[b] + lam * d[:, b]
            hit = (lam > 0) & (lam < depth) & (pa >= 0) & (pa <= S) & (pb >= 0) & (pb <= S)
            val = bilinear(tex, pb * self.texels, pa * self.texels)
            img = torch.where(hit, val, img)
            depth = torch.where(hit, lam, depth)
        return (torch.floor(img.clamp(0.0, 1.0) * 255.0 + 0.5) / 255.0).float()

    def train_rays(self, center, scale, stride: int = 1
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(origins, directions, colours), each (N, 3) float32 on the
        device: every ``stride``-th pixel of each training view, view by
        view and row by row, in the frame (x - center) / scale. The three
        are allocated once and filled view by view, so that the set-up's
        peak is the rays themselves."""
        keep = self._stride_mask(stride)
        per_view = int(keep.sum())
        n = per_view * len(self.train)
        o, d, c = (torch.empty((n, 3), dtype=torch.float32, device=self.device)
                   for _ in range(3))
        for i, v in enumerate(self.train):
            rows = slice(i * per_view, (i + 1) * per_view)
            o[rows] = torch.as_tensor(((self.centre(v) - center) / scale).astype(np.float32),
                                      device=self.device)
            d[rows] = self.camera_dirs(v)[keep]
            c[rows] = self.photograph(v)[keep][:, None]
        return o, d, c

    def _stride_mask(self, stride: int) -> torch.Tensor:
        ys = torch.arange(self.height, device=self.device) % stride == 0
        xs = torch.arange(self.width, device=self.device) % stride == 0
        return (ys[:, None] & xs[None, :]).reshape(-1)

    def voxelize(self, res: Sequence[int], lo, hi, center, scale, contracted: bool,
                 sigma: float) -> torch.Tensor:
        """An analytic (X, Y, Z, 28) float32 grid of the planes over the box
        [lo, hi] of the normalized frame (contracted: each node taken back
        through the inverse contraction). Density ``sigma`` within one
        node spacing of a plane, SH DC = texture / C0 within 2.5 (the
        texture blurred to the spacing), zero elsewhere."""
        dev, S = self.device, self.plane_size
        res = tuple(int(r) for r in res)
        lo_t = torch.as_tensor(np.asarray(lo, np.float64), device=dev)
        hi_t = torch.as_tensor(np.asarray(hi, np.float64), device=dev)
        step = (hi_t - lo_t) / torch.tensor([r - 1 for r in res], dtype=torch.float64, device=dev)
        sp0 = float(step.max()) * scale
        blurred = [gaussian_blur(t, 0.5 * sp0 * self.texels) for t in self.textures]
        grid = torch.zeros((*res, 28), dtype=torch.float32, device=dev)
        ys = [lo_t[a] + step[a] * torch.arange(res[a], dtype=torch.float64, device=dev)
              for a in range(3)]
        c = torch.as_tensor(np.asarray(center, np.float64), device=dev)
        slab = max(1, (1 << 22) // (res[1] * res[2]))
        for x0 in range(0, res[0], slab):
            xs = ys[0][x0:x0 + slab]
            y = torch.stack(torch.meshgrid(xs, ys[1], ys[2], indexing="ij"), dim=-1)
            sp = torch.full(y.shape[:3], sp0, dtype=torch.float64, device=dev)
            if contracted:
                n = torch.linalg.norm(y, dim=-1, keepdim=True).clamp(1e-9, 2.0 - 1e-4)
                y = torch.where(n <= 1.0, y, y / (n * (2.0 - n)))
                sp = sp * torch.where(n[..., 0] <= 1.0, torch.ones_like(sp),
                                      1.0 / (2.0 - n[..., 0]) ** 2)
            w = y * scale + c
            out = grid[x0:x0 + slab]
            for (axis, (a, b)), tex in zip(PLANES, blurred):
                dist = w[..., axis].abs()
                inside = (w[..., a] >= 0) & (w[..., a] <= S) & (w[..., b] >= 0) & (w[..., b] <= S)
                dens = inside & (dist <= sp)
                colour = inside & (dist <= 2.5 * sp)
                dc = (bilinear(tex, w[..., b] * self.texels, w[..., a] * self.texels)
                      / SH_C0).float()
                out[..., 0] = torch.where(dens, torch.full_like(out[..., 0], sigma), out[..., 0])
                for ch in (1, 10, 19):
                    out[..., ch] = torch.where(colour, dc, out[..., ch])
        return grid
