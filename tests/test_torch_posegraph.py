"""The port's numpy pose graph (tpu3d_torch/sfm/posegraph.py) against
tpu3d's, function by function, on tests/test_posegraph.py's graphs: a
camera ring with chordal extra edges and noisy relative poses, at three
noise levels and with 15% gross outlier edges. Both sides are numpy f64
(f32 only where tpu3d's so3_exp_np / so3_log_np round), so they agree to
1e-9."""
import numpy as np
import pytest

from tests.test_posegraph import make_graph
from tpu3d.core import lie as jlie
from tpu3d.sfm import posegraph as J
from tpu3d_torch.sfm import posegraph as T

CASES = {"exact": dict(rot_noise=0.0, t_noise=0.0), "noisy": dict(rot_noise=0.01, t_noise=0.01),
         "noisier": dict(rot_noise=0.03, t_noise=0.03), "outliers": None}


def _graph(case):
    rng = np.random.default_rng(42)
    if CASES[case] is not None:
        return 12, make_graph(rng, **CASES[case])
    # tests/test_posegraph.py::test_averaging_survives_outlier_edges' graph
    Rs, Cs, edges, rel_R, rel_t = make_graph(rng, n=16, extra_edges=24, rot_noise=0.005,
                                             t_noise=0.005)
    for k in rng.choice(len(edges), max(len(edges) * 15 // 100, 1), replace=False):
        rel_R[k] = jlie.so3_exp_np(rng.normal(0, 2.0, 3).astype(np.float32))
        d = rng.normal(0, 1, 3)
        rel_t[k] = d / np.linalg.norm(d)
    return 16, (Rs, Cs, edges, rel_R, rel_t)


def test_largest_component_matches_tpu3d():
    for edges in ([(0, 1), (1, 2), (4, 5)], [(3, 4), (0, 1), (5, 6), (6, 7), (4, 5)], []):
        np.testing.assert_array_equal(T.largest_component(8, edges),
                                      J.largest_component(8, edges))


@pytest.mark.parametrize("case", list(CASES))
def test_posegraph_matches_tpu3d(case):
    """average_rotations, refine_rotations, average_translations (with and
    without seed weights, on a masked component) and pose_graph_init."""
    n, (Rs, Cs, edges, rel_R, rel_t) = _graph(case)
    mask = np.ones(n, bool)
    mask[-1] = False
    for m in (None, mask):
        R = T.average_rotations(n, edges, rel_R, m)
        np.testing.assert_allclose(R, J.average_rotations(n, edges, rel_R, m), atol=1e-9)
        Rr = T.refine_rotations(n, edges, rel_R, R, m)
        np.testing.assert_allclose(Rr, J.refine_rotations(n, edges, rel_R, R, m), atol=1e-9)
        w0 = np.linspace(0.5, 1.0, len(edges))
        for init in (None, w0):
            C = T.average_translations(n, edges, rel_t, np.stack(Rs), m, init_weights=init)
            np.testing.assert_allclose(
                C, J.average_translations(n, edges, rel_t, np.stack(Rs), m, init_weights=init),
                atol=1e-9)
    cams, has_cam, comp = T.pose_graph_init(n, edges, rel_R, rel_t)
    jcams, jhas, jcomp = J.pose_graph_init(n, edges, rel_R, rel_t)
    np.testing.assert_array_equal(has_cam, jhas)
    np.testing.assert_array_equal(comp, jcomp)
    # cams are f32 (so3_log_np rounds to f32): the same bits
    np.testing.assert_array_equal(cams, jcams)
