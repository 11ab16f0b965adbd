"""The batched bundle adjustment (tpu3d's vmapped ``_local_ba_batch``,
tpu3d/sfm/engine.py:153) on the CPU: three problems of different sizes and
stop points against each solved alone by the port, and against tpu3d's
batched solve on the same stacked, padded inputs; the stop rules evaluated
on the device, with one read-back per LM step. Tolerances are stated where
they are asserted."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_reconstruct import _ba_problem
from tpu3d_torch.ba.lm import bundle_adjust, bundle_adjust_batch
from tpu3d_torch.sfm.engine import stack_ba_problems
from tpu3d_torch.utils import dispatch

# tpu3d's batched local BA arguments (engine.py:153-166), with max_iters
# chosen so that the three problems stop three ways
KW = dict(max_iters=8, cg_iters=8, stall_tol=1e-4)


def _problem(seed, n_cams, n_pts, perturb_cam, perturb_pt, noise_px=0.3):
    rng = np.random.default_rng(seed)
    p = _ba_problem(rng, n_cams=n_cams, n_pts=n_pts, perturb_cam=perturb_cam,
                    perturb_pt=perturb_pt, noise_px=noise_px)
    # cameras 0 and 1 frozen at their poses, as a local BA freezes its
    # references: the scale gauge is fixed
    p["cams0"][1] = p["cams"][1]
    p["cam_fixed"][1] = 1.0
    return (p["cams0"], p["X0"], p["cam_idx"].astype(np.int64), p["pt_idx"].astype(np.int64),
            p["uv"], p["w"], p["cam_fixed"], np.zeros(n_pts, np.float32))


@pytest.fixture(scope="module")
def problems():
    """4 cameras x 300 points far from the optimum (still improving at
    max_iters: 10 steps to its stall exit), 4 x 250 near it (a stall exit
    after 7), and 4 x 100 exact and noise-free (three steps without a
    relative drop beyond the stall tolerance: the earliest stop)."""
    return [_problem(4, 4, 300, 0.3, 0.8), _problem(4, 4, 250, 0.02, 0.05),
            _problem(3, 4, 100, 0.0, 0.0, noise_px=0.0)]


def _torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_batch_matches_solo(problems):
    """Each problem of the batch against the port's solve of it alone: the
    same iteration count, cameras and points within 1e-5, cost within 1e-5
    relative (on the CPU they measured bit-equal: every sum adds each
    problem's own entries in one fixed order). The stop points are the
    three kinds: max_iters, the stall rule, at once."""
    st = bundle_adjust_batch(*_torch(stack_ba_problems(problems)), **KW)
    solo = [bundle_adjust(*_torch(p), **KW) for p in problems]
    assert [s.n_iters for s in solo] == st.n_iters.tolist()
    assert solo[0].n_iters == KW["max_iters"]
    assert 3 < solo[1].n_iters < KW["max_iters"]
    assert solo[2].n_iters == 3
    for b, (p, s) in enumerate(zip(problems, solo)):
        C, P = len(p[0]), len(p[1])
        assert (st.cams[b, :C] - s.cams).abs().max().item() <= 1e-5
        assert (st.points[b, :P] - s.points).abs().max().item() <= 1e-5
        assert abs(st.cost[b].item() - s.cost.item()) <= 1e-5 * s.cost.item() + 1e-30
        assert st.lam[b].item() == s.lam.item()
        # padded cameras and points stay where they were
        assert torch.equal(st.cams[b, C:], torch.zeros_like(st.cams[b, C:]))
        assert torch.equal(st.points[b, P:], torch.zeros_like(st.points[b, P:]))
    again = bundle_adjust_batch(*_torch(stack_ba_problems(problems)), **KW)
    for name in ("cams", "points", "cost", "lam", "n_iters"):
        assert torch.equal(getattr(st, name), getattr(again, name)), name


def test_batch_matches_tpu3d(problems):
    """The same stacked, padded inputs through tpu3d's _local_ba_batch (B =
    3, C = 4, P = 300, O = 1,200): _compare_ba's tolerances for a fixed
    gauge, cameras and points within 1e-4 (f32 sums in two orders). A
    problem at its stall exit sits at the noise floor, where rounding moves
    points along their poorly determined depths: on a 3-camera problem
    (seed 4, 3 x 200, perturbed 0.002 / 0.01) tpu3d's own batched solve
    measured 3.4e-4 from its single solve, and the port's single solve
    3.5e-4 from it; the 4-camera problem here measured 3.3e-6 between the
    two packages' batched solves."""
    from tpu3d.sfm.engine import _local_ba_batch

    arrays = stack_ba_problems(problems)
    st = bundle_adjust_batch(*_torch(arrays), **KW)
    jargs = [jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a) for a in arrays]
    cams, pts = _local_ba_batch(*jargs, max_iters=KW["max_iters"], cg_iters=KW["cg_iters"])
    cams, pts = np.asarray(cams), np.asarray(pts)
    np.testing.assert_allclose(st.cams.numpy(), cams, rtol=0, atol=1e-4)
    np.testing.assert_allclose(st.points.numpy(), pts, rtol=0, atol=1e-4)


def _count_host_reads(monkeypatch):
    """Count the reads of a tensor's value to the host (the read-backs a
    card would wait for)."""
    reads = []
    for name in ("tolist", "item", "__bool__", "__int__", "__float__", "__index__", "numpy"):
        orig = getattr(torch.Tensor, name)

        def wrapper(self, *a, _orig=orig, _name=name, **k):
            reads.append(_name)
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, wrapper)
    return reads


@pytest.mark.parametrize("reduce", [False, True])
def test_one_read_back_per_lm_step(problems, monkeypatch, reduce):
    """A solve reads a tensor back to the host once for the segment widths
    and once per LM step it begins: at most LM steps + 2 (the step begun
    after the last finds no problem active and ends the loop); no CG
    iteration reads back (32 a step here). The same with ``reduce`` (the
    sharded path's hook, here the identity): the stop decisions come from
    the reduced, replicated cost."""
    kw = dict(max_iters=20, cg_iters=32)
    if reduce:
        kw["reduce"] = lambda x: x.clone()
    args = _torch(problems[0])
    dispatch.reset()
    reads = _count_host_reads(monkeypatch)
    st = bundle_adjust(*args, **kw)
    monkeypatch.undo()
    assert 3 < st.n_iters < kw["max_iters"]
    assert len(reads) <= st.n_iters + 2, reads
    assert dispatch.snapshot()["ba_readback"] == len(reads)
    ref = bundle_adjust(*args, max_iters=20, cg_iters=32)
    assert torch.equal(st.cams, ref.cams) and st.n_iters == ref.n_iters
