"""A render chunk's colours from its trilinear values, in one pass.

dense/render.py's forward-only render: relu density and degree-2 SH colour
from each sample's 28 raw channels (a cascade base's channels added first),
alpha = 1 - exp(-sigma delta) with the last segment 1e10, the exclusive
transmittance product of 1 - alpha + 1e-10, w = T alpha, and the pixel
sum(w rgb) with the background under 1 - sum(w): a per-ray colour, white,
or nothing. On a CUDA tensor ``shade_composite`` launches
``shade_composite_kernel`` (csrc/shade_composite.cu), one warp a ray; on a
CPU tensor it runs the plain version, which repeats the kernel's order: the
eager path's operations (``_shade``, ``composite``) sample by sample, the
SH basis once a ray, the transmittance scanned over rounds of 32 samples
(Hillis-Steele within a round, a carried product across rounds, each
partial product with its rounding error beside it) and the sums taken per
lane over the rounds, then over the lanes by an xor butterfly. Everything
is f32. Against the eager path only the transmittance's carried error and
the sums' association differ: a pixel agrees to rounding (the transmittance
is the exact product rounded once, as the CPU's double-accumulated cumprod
gives it), and the kernel repeats bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch

from tpu3d_torch.kernels import LAUNCHES
from tpu3d_torch.kernels._build import check, function, stream
from tpu3d_torch.utils.trace import launch_span

CHANNELS = 28        # 1 density + 3 colours x 9 SH coefficients
LANES = 32           # samples a round: one a lane of the ray's warp
_F32 = torch.float32
# Real SH degree-2 constants (dense/grid.py's).
_C0, _C1 = 0.282095, 0.488603
_C2 = (1.092548, 1.092548, 0.315392, 1.092548, 0.546274)


def sh_basis(d: torch.Tensor) -> torch.Tensor:
    """(N, 8) direction factors of eval_sh's terms 1-8, rounded as eval_sh
    forms them from the (N, 3) unit directions ``d``."""
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    return torch.cat([_C1 * y, _C1 * z, _C1 * x, _C2[0] * x * y, _C2[1] * y * z,
                      _C2[2] * (2.0 * z * z - x * x - y * y), _C2[3] * x * z,
                      _C2[4] * (x * x - y * y)], dim=-1)


def _sh(k: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """eval_sh's sum over the (..., 9) coefficients ``k`` with the basis
    ``b`` (..., 8), term by term in its order and signs."""
    s = _C0 * k[..., 0]
    for j in range(8):
        t = b[..., j] * k[..., j + 1]
        s = s - t if j % 2 == 0 else s + t
    return s


def _pmul(h1, l1, h2, l2):
    """The kernel's carried product (h1 + l1)(h2 + l2): h = h1 h2 rounded,
    l = its exact rounding error (fma(h1, h2, -h), exact in double) plus
    the rounded cross terms."""
    h = h1 * h2
    err = (h1.double() * h2.double() - h.double()).float()
    return h, err + (h1 * l2 + l1 * h2)


def _rounds(x: torch.Tensor, fill: float) -> torch.Tensor:
    """(N, S, ...) -> (N, R, 32, ...), the samples past S as ``fill``."""
    N, S = x.shape[:2]
    pad = -S % LANES
    if pad:
        x = torch.cat([x, x.new_full((N, pad, *x.shape[2:]), fill)], dim=1)
    return x.reshape(N, -1, LANES, *x.shape[2:])


def _lane_sum(x: torch.Tensor) -> torch.Tensor:
    """(N, R, 32, ...) -> (N, ...): each lane's rounds in order, then the
    lanes by an xor butterfly (lane 0's order)."""
    acc = x[:, 0]
    for r in range(1, x.shape[1]):
        acc = acc + x[:, r]
    off = LANES // 2
    while off:
        acc = acc[:, :off] + acc[:, off:2 * off]
        off //= 2
    return acc[:, 0]


def shade_composite_plain(vals: torch.Tensor, in_b: torch.Tensor, z: torch.Tensor,
                          rays_d: torch.Tensor, white_bg: bool = True,
                          bg: Optional[torch.Tensor] = None,
                          bvals: Optional[torch.Tensor] = None,
                          bin_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version; see :func:`shade_composite` for the arguments."""
    N, S = z.shape
    if bvals is not None:
        vals = bvals * bin_b[:, None] + vals * in_b[:, None]
        in_b = torch.ones_like(in_b)
    sigma = (torch.relu(vals[:, 0]) * in_b).reshape(N, S)
    k = vals[:, 1:CHANNELS].reshape(N, S, 3, 9)
    rgb = _sh(k, sh_basis(rays_d)[:, None, None, :]) * in_b.reshape(N, S, 1)
    delta = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], dim=-1)
    alpha = 1.0 - torch.exp(-sigma * delta)
    h = _rounds(1.0 - alpha + 1e-10, 1.0)
    lo = torch.zeros_like(h)
    off = 1
    while off < LANES:
        ph, pl = _pmul(h[..., :-off], lo[..., :-off], h[..., off:], lo[..., off:])
        h, lo = torch.cat([h[..., :off], ph], dim=-1), torch.cat([lo[..., :off], pl], dim=-1)
        off *= 2
    ex_h = torch.cat([torch.ones_like(h[..., :1]), h[..., :-1]], dim=-1)
    ex_l = torch.cat([torch.zeros_like(lo[..., :1]), lo[..., :-1]], dim=-1)
    ch, cl, trans = torch.ones_like(h[:, 0, :1]), torch.zeros_like(h[:, 0, :1]), []
    for r in range(h.shape[1]):
        th, tl = _pmul(ch, cl, ex_h[:, r], ex_l[:, r])
        trans.append(th + tl)
        ch, cl = _pmul(ch, cl, h[:, r, LANES - 1:], lo[:, r, LANES - 1:])
    w = torch.stack(trans, dim=1) * _rounds(alpha, 0.0)
    c = _lane_sum(w[..., None] * _rounds(rgb, 0.0))
    w_sum = _lane_sum(w)[:, None]
    if bg is not None:
        return c + (1.0 - w_sum) * bg
    if white_bg:
        return c + 1.0 - w_sum
    return c


def shade_composite(vals: torch.Tensor, in_b: torch.Tensor, z: torch.Tensor,
                    rays_d: torch.Tensor, white_bg: bool = True,
                    bg: Optional[torch.Tensor] = None, bvals: Optional[torch.Tensor] = None,
                    bin_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, 3) colours of N rays of S samples each. vals: (N*S, 28) f32 raw
    channels in ray-major order, in_b: (N*S,) bool in-box flags; bvals /
    bin_b: a cascade base's, both or neither (the base is added where it is
    in its box, the grid where it is in its own, and every sample counts);
    z: (N, S) sorted depths; rays_d: (N, 3) unit directions; bg: (N, 3)
    per-ray background replacing white. A CPU tensor takes
    :func:`shade_composite_plain`; a CUDA tensor launches
    ``shade_composite_kernel`` on the current stream and raises on what the
    kernel does not take."""
    N, S = z.shape if z.dim() == 2 else (-1, -1)
    expect = [("vals", vals, (N * S, CHANNELS), _F32), ("in_b", in_b, (N * S,), torch.bool),
              ("z", z, (N, S), _F32), ("rays_d", rays_d, (N, 3), _F32)]
    if (bvals is None) != (bin_b is None):
        raise ValueError("shade_composite: bvals and bin_b come together")
    if bvals is not None:
        expect += [("bvals", bvals, (N * S, CHANNELS), _F32), ("bin_b", bin_b, (N * S,),
                                                                torch.bool)]
    if bg is not None:
        expect.append(("bg", bg, (N, 3), _F32))
    for name, t, shape, dtype in expect:
        if (S < 1 or t.shape != shape or t.dtype != dtype or t.device != z.device
                or not t.is_contiguous()):
            raise ValueError(f"shade_composite: {name} must be a contiguous {dtype} {shape} "
                             f"tensor on {z.device} (z (N, S>=1)), got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    if N == 0:
        return z.new_empty((0, 3))
    if z.device.type == "cpu":
        return shade_composite_plain(vals, in_b, z, rays_d, white_bg, bg, bvals, bin_b)
    if z.device.type != "cuda":
        raise ValueError(f"shade_composite: unsupported device {z.device}")
    if any(t.data_ptr() % 16 for t in (vals, bvals) if t is not None):
        raise ValueError("shade_composite: vals and bvals must start on a 16-byte boundary")
    out = z.new_empty((N, 3))

    def ptr(t):
        return None if t is None else t.data_ptr()

    with launch_span("kernels.shade_composite"):
        err = function("tpu3d_shade_composite")(
            vals.data_ptr(), in_b.data_ptr(), ptr(bvals), ptr(bin_b), z.data_ptr(),
            rays_d.data_ptr(), ptr(bg), out.data_ptr(), N, S, int(white_bg),
            stream(z.get_device()))
    check(err, "shade_composite_kernel")
    LAUNCHES["shade_composite_kernel"] += 1
    return out
