"""tpu3d_torch's fused shading and compositing on the CPU: the plain version
(kernels/shade_composite.py::shade_composite_plain, which repeats the
kernel's order) against the eager path it replaces (dense/render.py's
``_shade`` and ``composite``) over random values, the wrapper's checks, a
module that imports and runs without nvcc or a card, and render_rays' eager
chunks counted while tracing. The kernel itself is held to the eager path
on the card (tests/test_torch_gpu.py)."""
import importlib

import pytest
import torch

from tpu3d_torch.dense.grid import VoxelGrid
from tpu3d_torch.dense.render import _dirs, _shade, composite, render_rays
from tpu3d_torch.kernels import LAUNCHES, _build
from tpu3d_torch.kernels import shade_composite as sc
from tpu3d_torch.utils import trace

N_RAYS = 509              # not a multiple of the kernel's 8 rays a block
DENSITY_SCALES = (0.01, 0.3, 3.0, 30.0)


@pytest.fixture(autouse=True)
def one_thread():
    """torch's CPU operations on one thread here: with several, a process's
    first exp over a chunk's (N, S) values came out ~1e-4 off its later ones
    in 3 to 5 of 60 fresh processes (the eager path's own, torch 2.13 on the
    CPU), against none of 60 on one thread; the comparisons hold 1e-6."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _chunk(S, cascade, seed, n=N_RAYS):
    """A chunk's random inputs: (N*S, 28) raw channels with densities of
    every scale in DENSITY_SCALES (a quarter of the rays each) and N(0, 1)
    SH coefficients, in-box flags with the first 7 rays wholly out of the
    box (in the cascade, out of both boxes), sorted depths, unit
    directions; with ``cascade`` the base's channels and flags too."""
    g = torch.Generator().manual_seed(seed)

    def values():
        v = torch.randn((n, S, 28), generator=g)
        scale = torch.tensor(DENSITY_SCALES)[torch.arange(n) % len(DENSITY_SCALES)]
        v[..., 0] = torch.randn((n, S), generator=g).abs() * scale[:, None]
        return v.reshape(n * S, 28)

    def flags():
        f = torch.rand((n, S), generator=g) > 0.25
        f[:7] = False
        return f.reshape(-1)

    z = torch.sort(torch.rand((n, S), generator=g) * 4.0 + 0.5, dim=-1).values
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=-1)
    bg = torch.rand((n, 3), generator=g)
    base = (values(), flags()) if cascade else (None, None)
    return values(), flags(), z, d, bg, base


def _eager(vals, in_b, z, d, white_bg, bg, bvals, bin_b):
    """The eager path: dense/render.py's _sample composition of a cascade
    base (its two lines), _shade, composite."""
    n, S = z.shape
    if bvals is not None:
        vals = bvals * bin_b[:, None] + vals * in_b[:, None]
        in_b = torch.ones_like(in_b)
    sigma, rgb = _shade(vals, in_b, _dirs(d, S))
    return composite(sigma.reshape(n, S), rgb.reshape(n, S, 3), z, white_bg, bg)


@pytest.mark.parametrize("S", [128, 192])
@pytest.mark.parametrize("background", ["white", "per_ray", "black"])
@pytest.mark.parametrize("cascade", [False, True], ids=["grid", "cascade"])
def test_plain_version_matches_the_eager_path(S, background, cascade):
    """The wrapper on CPU tensors (the plain version) against _shade +
    composite: every pixel within 1e-6 (the association of the sums and the
    transmittance's carried rounding error differ; the CPU's cumprod
    accumulates in double); rays with every sample out of the box are the
    background exactly, and nothing is launched."""
    vals, in_b, z, d, bg, (bvals, bin_b) = _chunk(S, cascade, seed=S + 7 * cascade)
    white, bg = background == "white", bg if background == "per_ray" else None
    before = LAUNCHES["shade_composite_kernel"]
    got = sc.shade_composite(vals, in_b, z, d, white, bg, bvals, bin_b)
    ref = _eager(vals, in_b, z, d, white, bg, bvals, bin_b)
    assert got.shape == (N_RAYS, 3) and got.dtype == torch.float32
    assert (got - ref).abs().max().item() <= 1e-6
    want = bg[:7] if bg is not None else torch.full((7, 3), 1.0 if white else 0.0)
    assert torch.equal(got[:7], want)
    assert LAUNCHES["shade_composite_kernel"] == before == 0


def test_transmittance_is_the_exact_product_rounded_once():
    """The plain version's per-sample weights, read back through a one-hot
    colour, against the double-precision exclusive cumprod of the same f32
    factors rounded once: within one f32 rounding of w, where an f32 scan
    drifts by many."""
    S, n = 192, 64
    vals, in_b, z, d, _, _ = _chunk(S, False, seed=3, n=n)
    in_b[:] = True
    sigma = torch.relu(vals[:, 0]).reshape(n, S)
    delta = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], dim=-1)
    alpha = 1.0 - torch.exp(-sigma * delta)
    trans = torch.cumprod((1.0 - alpha + 1e-10).double(), dim=-1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1).float()
    w_ref = trans * alpha
    for s in (0, 31, 32, 100, S - 1):
        # colour: channel 1 (red's DC term) makes r = C0 at sample s alone
        v = vals.clone().reshape(n, S, 28)
        v[..., 1:] = 0.0
        v[:, s, 1] = 1.0
        got = sc.shade_composite(v.reshape(-1, 28), in_b, z, d, False)[:, 0]
        want = (sc._C0 * torch.ones(())).float() * w_ref[:, s]
        tol = 2 * torch.finfo(torch.float32).eps * want.abs() + 1e-30
        assert ((got - want).abs() <= tol).all(), s


@pytest.mark.parametrize("bad", ["vals_shape", "vals_dtype", "in_b_dtype", "z_dim", "rays_d",
                                 "bg_shape", "base_alone", "noncontiguous", "device"])
def test_shade_composite_rejects_what_it_does_not_take(bad):
    """Wrong shapes, dtypes, a base without its flags, a non-contiguous
    input and a device that is neither the CPU nor a card raise."""
    vals, in_b, z, d, bg, _ = _chunk(64, False, seed=1, n=9)
    kw = {}
    if bad == "vals_shape":
        vals = vals[:, :27].contiguous()
    elif bad == "vals_dtype":
        vals = vals.double()
    elif bad == "in_b_dtype":
        in_b = in_b.float()
    elif bad == "z_dim":
        z = z.reshape(-1)
    elif bad == "rays_d":
        d = d[:8]
    elif bad == "bg_shape":
        kw["bg"] = bg[:, :2].contiguous()
    elif bad == "base_alone":
        kw["bvals"] = vals
    elif bad == "noncontiguous":
        z = z.t().contiguous().t()
    else:
        vals, in_b, z, d = (t.to("meta") for t in (vals, in_b, z, d))
    with pytest.raises(ValueError, match="shade_composite"):
        sc.shade_composite(vals, in_b, z, d, **kw)


def test_no_rays_give_no_colours():
    """A chunk of no rays returns a (0, 3) tensor."""
    out = sc.shade_composite(torch.zeros((0, 28)), torch.zeros((0,), dtype=torch.bool),
                             torch.zeros((0, 16)), torch.zeros((0, 3)))
    assert out.shape == (0, 3)


def test_shade_composite_module_imports_and_runs_without_nvcc(monkeypatch):
    """The module imports without building anything, and CPU tensors never
    reach the kernel library: with the build and the loader made to fail, a
    reload and a call still work, and equal the eager path's pixels to
    1e-6."""
    def no_library(*args, **kwargs):
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(_build, "build", no_library)
    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(_build, "_functions", {})
    module = importlib.reload(sc)
    vals, in_b, z, d, bg, _ = _chunk(40, False, seed=2, n=11)
    got = module.shade_composite(vals, in_b, z, d, True, bg)
    assert (got - _eager(vals, in_b, z, d, True, bg, None, None)).abs().max().item() <= 1e-6


@pytest.fixture
def tracer(monkeypatch):
    """A fresh global tracer, tracing off."""
    monkeypatch.setattr(trace, "_GLOBAL", None)
    monkeypatch.setattr(trace, "_ENABLED", False)
    return trace.get_tracer()


def test_render_rays_counts_its_eager_chunks_on_the_cpu(tracer):
    """On the CPU render_rays shades eagerly, grad or not, and launches
    nothing: while tracing, one ``render.composite_eager`` a call and no
    ``render.composite_fused``; off, no counter at all."""
    g = torch.Generator().manual_seed(4)
    vg = VoxelGrid(torch.rand((8, 8, 8, 28), generator=g) - 0.3, torch.full((3,), -1.0),
                   torch.full((3,), 1.0))
    o = torch.full((12, 3), -2.5) + 0.1 * torch.randn((12, 3), generator=g)
    d = torch.nn.functional.normalize(-o, dim=-1)
    before = LAUNCHES["shade_composite_kernel"]
    render_rays(vg, o, d, 0.5, 5.0, 16)
    assert tracer.summary()["counters"] == {}
    trace.enable(True)
    with torch.no_grad():
        render_rays(vg, o, d, 0.5, 5.0, 16)
    grad_vg = VoxelGrid(vg.grid.clone().requires_grad_(), vg.min_bound, vg.max_bound)
    render_rays(grad_vg, o, d, 0.5, 5.0, 16).sum().backward()
    assert tracer.summary()["counters"] == {"render.composite_eager": 2.0}
    assert LAUNCHES["shade_composite_kernel"] == before == 0


@pytest.mark.parametrize("case", ["plain", "clip_aabb_bg", "cascade_contract"])
def test_render_rays_fused_branch_matches_eager(monkeypatch, tracer, case):
    """render_rays' fused branch, taken on the CPU by forcing the card's
    condition (the wrapper then runs the plain version): the grid's and the
    base's trilinear values, depths, directions and background handed over
    as the eager branch uses them, so every pixel within 1e-6 of the eager
    branch; one ``render.composite_fused`` a call while tracing."""
    from tpu3d_torch.dense import render

    g = torch.Generator().manual_seed(6)
    grid = torch.randn((12, 12, 12, 28), generator=g) * 0.5
    grid[..., 0] = grid[..., 0].abs() * 8
    vg = VoxelGrid(grid, torch.full((3,), -1.0), torch.full((3,), 1.0))
    o = torch.nn.functional.normalize(torch.randn((70, 3), generator=g), dim=-1) * 2.5
    d = torch.nn.functional.normalize(-o + 0.4 * torch.randn((70, 3), generator=g), dim=-1)
    kw = dict(near=0.5, far=4.5, n_samples=48)
    if case == "clip_aabb_bg":
        kw.update(clip_aabb=True, bg=torch.rand((70, 3), generator=g))
    elif case == "cascade_contract":
        base = torch.randn((10, 10, 10, 28), generator=g) * 0.5
        base[..., 0] = base[..., 0].abs() * 4
        kw.update(contract=True, base_vg=VoxelGrid(base, torch.full((3,), -2.0),
                                                   torch.full((3,), 2.0)))
        vg = VoxelGrid(grid, torch.full((3,), -0.5), torch.full((3,), 0.7))
    ref = render_rays(vg, o, d, **kw)
    trace.enable(True)
    monkeypatch.setattr(render, "_fused", lambda *args: True)
    got = render_rays(vg, o, d, **kw)
    assert (got - ref).abs().max().item() <= 1e-6
    assert tracer.summary()["counters"] == {"render.composite_fused": 1.0}
