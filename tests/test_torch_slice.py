"""The port's extract -> retrieve -> match slice against tpu3d's, on the
synthetic scene of chip_smoke.py (6 views of 320x240, 512 keypoints), on
the CPU.

The port draws its random numbers from torch.Generators; tpu3d from
jax.random. Where the slice is compared decision for decision, tpu3d's
draws are fed through the port's two seams (``_retrieval_draws`` and
``_gate_noise`` in tpu3d_torch/sfm/pipeline.py).

Run as a script, it runs tpu3d's slice on chip_smoke.py's full-size scene
(24 views of 968x648, 2048 keypoints) on the CPU and prints what
chip_smoke.TPU3D_CPU_ACCEPTED records:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_slice.py
"""
import dataclasses
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import tpu3d.sfm.pipeline as JP
import tpu3d_torch.sfm.pipeline as TP
from chip_smoke import make_scene, rotation_errors_deg
from tpu3d.config import CameraConfig, FrontendConfig
from tpu3d.config import PipelineConfig as JaxPipelineConfig
from tpu3d_torch.config import PipelineConfig

N_VIEWS, W, H, K = 6, 320, 240, 512


def _scene_on_disk(d, seed, n_views, width, height, max_keypoints):
    """make_scene's views as PNG files in d (tpu3d reads a directory), with
    tpu3d's config and the port's copy of it."""
    sc = make_scene(seed=seed, n_views=n_views, width=width, height=height)
    for i, rgb in enumerate(sc["rgb"]):
        Image.fromarray(rgb).save(os.path.join(d, f"{i:03d}.png"))
    sc["dir"] = str(d)
    jcfg = dataclasses.replace(JaxPipelineConfig(),
                               camera=CameraConfig(focal_length=sc["focal"]),
                               frontend=FrontendConfig(max_keypoints=max_keypoints))
    sc["jcfg"] = jcfg
    sc["cfg"] = PipelineConfig.from_dict(dataclasses.asdict(jcfg))
    return sc


def _tpu3d_slice(sc):
    """tpu3d's extract -> retrieve -> match on the scene's files."""
    cfg = sc["jcfg"]
    feats = JP.run_extraction(sc["dir"], cfg, verbose=False)
    adj = JP.run_retrieval(feats, cfg, seed=0)
    regs, ts = JP.run_matching(feats, adj, cfg, seed=1, verbose=False)
    return feats, adj, regs, ts


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return _scene_on_disk(tmp_path_factory.mktemp("views"), 0, N_VIEWS, W, H, K)


@pytest.fixture(scope="module")
def reference(scene):
    """tpu3d's slice, and its draws for the port's seams."""
    feats, adj, regs, _ = _tpu3d_slice(scene)
    # run_matching's per-edge keys: split(split(PRNGKey(seed))[1], n_edges)
    # over the sorted candidate edges; each key splits into the five-point
    # key and the 8-point key, which splits into the two RANSAC rounds.
    edges = sorted({(min(i, j), max(i, j)) for i in adj for j in adj[i] if i != j})
    _, ckey = jax.random.split(jax.random.PRNGKey(1))
    keys = dict(zip(edges, np.asarray(jax.random.split(ckey, len(edges)))))
    return dict(feats=feats, adj=adj, regs=regs, keys=keys)


@pytest.fixture
def tpu3d_draws(monkeypatch, reference):
    """Feed tpu3d's codebook and gate draws to the port."""
    def retrieval_draws(seed, valid, k):
        key = jax.random.PRNGKey(seed)
        v = jnp.asarray(valid.reshape(-1).cpu().numpy())
        n = v.shape[0]
        fill = jax.random.choice(key, n, (n,), p=v / jnp.sum(v))
        init = jax.random.choice(jax.random.fold_in(key, 1), n, (k,), replace=False)
        return torch.from_numpy(np.array(fill)), torch.from_numpy(np.array(init))

    own_gate_noise = TP._gate_noise

    def gate_noise(seed, edges, shapes, device):
        if not all(e in reference["keys"] for e in edges):
            return own_gate_noise(seed, edges, shapes, device)
        out = [[] for _ in shapes]
        for e in edges:
            k5, k8 = jax.random.split(jnp.asarray(reference["keys"][e]))
            k0, k1 = jax.random.split(k8)
            for lst, key, shp in zip(out, (k5, k0, k1), shapes):
                lst.append(torch.from_numpy(np.array(jax.random.gumbel(key, shp))))
        return [torch.stack(lst).to(device) for lst in out]

    monkeypatch.setattr(TP, "_retrieval_draws", retrieval_draws)
    monkeypatch.setattr(TP, "_gate_noise", gate_noise)


def _edges(regs):
    return {(e.ref_img, r.img): e for r in regs for e in r.edges}


def _angle_deg(Ra, Rb):
    c = (np.trace(np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def _compare(regs, ref_regs, scene):
    """Same accepted set and bootstrap pair, >= 90% of the (ref, new) edges
    shared, inlier counts within 5%. Returns the rotation differences of
    the shared edges in degrees."""
    assert sorted(r.img for r in regs) == sorted(r.img for r in ref_regs)
    assert (regs[0].edges[0].ref_img, regs[0].img) == \
        (ref_regs[0].edges[0].ref_img, ref_regs[0].img)
    got, ref = _edges(regs), _edges(ref_regs)
    shared = set(got) & set(ref)
    assert len(shared) >= 0.9 * max(len(got), len(ref))
    for e in shared:
        n_got, n_ref = len(got[e].idx_new), len(ref[e].idx_new)
        assert abs(n_got - n_ref) <= 0.05 * n_ref, (e, n_got, n_ref)
    assert np.median(rotation_errors_deg(regs, scene["R"])) < 0.5
    return np.array([_angle_deg(got[e].rel_R, ref[e].rel_R) for e in sorted(shared)])


def test_slice_matches_tpu3d(scene, reference, tpu3d_draws):
    """The whole slice from the image files. Features differ by f32
    rounding (test_torch_frontend.py), which can move a refit's consensus by
    a point and switch it between the minimal and the least-squares model:
    the relative rotations agree within 0.1 degree at the median, and
    within 1 degree on every edge."""
    cfg = scene["cfg"]
    feats = TP.run_extraction(scene["dir"], cfg, verbose=False, device="cpu")
    assert feats.descriptors_dev.device.type == "cpu"
    adj = TP.run_retrieval(feats, cfg, seed=0, device="cpu")
    regs, ts = TP.run_matching(feats, adj, cfg, seed=1, verbose=False, device="cpu")
    dang = _compare(regs, reference["regs"], scene)
    assert np.median(dang) < 0.1 and dang.max() < 1.0
    assert ts.next_track > 0


@pytest.mark.parametrize("canonical", [True, False])
def test_match_stage_on_tpu3d_features(scene, reference, tpu3d_draws, canonical):
    """tpu3d's own features through the port's retrieval and match, with
    canonical reference selection and with the legacy BFS consume: the
    same view graph, and every edge's rotation within 0.1 degree."""
    jf = reference["feats"]
    feats = TP.ExtractedFeatures.from_numpy(
        jf.names, jf.keypoints, jf.keypoints_px, jf.valid, jf.colors_bgr,
        jf.image_size, jf.descriptors, device="cpu")
    adj = TP.run_retrieval(feats, scene["cfg"], seed=0, device="cpu")
    assert adj == reference["adj"]
    ref_regs = reference["regs"]
    jcfg = scene["jcfg"]
    if not canonical:
        jcfg = dataclasses.replace(jcfg, matching=dataclasses.replace(
            jcfg.matching, canonical_select=False))
        ref_regs, _ = JP.run_matching(jf, reference["adj"], jcfg, seed=1, verbose=False)
    cfg = PipelineConfig.from_dict(dataclasses.asdict(jcfg))
    regs, _ = TP.run_matching(feats, adj, cfg, seed=1, verbose=False, device="cpu")
    dang = _compare(regs, ref_regs, scene)
    assert dang.max() < 0.1


def test_match_without_pair_cache(scene, reference):
    """pair_batch=1: no gate blocks, each pair gated when the legacy BFS
    consume reaches it. Its start image is the root, not a registration
    (as in tpu3d); every other view is accepted."""
    jf = reference["feats"]
    feats = TP.ExtractedFeatures.from_numpy(
        jf.names, jf.keypoints, jf.keypoints_px, jf.valid, jf.colors_bgr,
        jf.image_size, jf.descriptors, device="cpu")
    cfg = scene["cfg"]
    cfg = dataclasses.replace(cfg, matching=dataclasses.replace(cfg.matching, pair_batch=1))
    timers = {}
    regs, _ = TP.run_matching(feats, reference["adj"], cfg, verbose=False, device="cpu",
                              timers=timers)
    assert timers["n_edges"] == 0 and timers["unmatched"] == []
    start = max(reference["adj"], key=lambda i: len(reference["adj"][i]))
    assert sorted(r.img for r in regs) == [v for v in range(N_VIEWS) if v != start]
    assert np.median(rotation_errors_deg(regs, scene["R"])) < 0.5


def test_slice_with_its_own_draws(scene, reference):
    """The port's generators alone (the path the card runs): decoded arrays
    in place of files give the same features, and every view is accepted
    with relative rotations close to the scene's."""
    cfg = scene["cfg"]
    feats = TP.run_extraction((scene["gray"], scene["rgb"]), cfg, verbose=False, device="cpu")
    from_files = TP.run_extraction(scene["dir"], cfg, verbose=False, device="cpu")
    np.testing.assert_array_equal(feats.keypoints, from_files.keypoints)
    np.testing.assert_array_equal(feats.colors_bgr, from_files.colors_bgr)
    adj = TP.run_retrieval(feats, cfg, device="cpu")
    timers = {}
    regs, _ = TP.run_matching(feats, adj, cfg, verbose=False, device="cpu", timers=timers)
    assert sorted(r.img for r in regs) == list(range(N_VIEWS))
    assert timers["n_edges"] > 0 and timers["unmatched"] == []
    errs = rotation_errors_deg(regs, scene["R"])
    assert np.median(errs) < 0.5 and errs.max() < 5.0


if __name__ == "__main__":
    import tempfile

    import chip_smoke

    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as d:
        sc = _scene_on_disk(d, chip_smoke.SCENE_SEED, chip_smoke.N_VIEWS, chip_smoke.WIDTH,
                            chip_smoke.HEIGHT, 2048)
        t0 = time.time()
        feats, adj, regs, ts = _tpu3d_slice(sc)
        errs = rotation_errors_deg(regs, sc["R"])
        print(f"tpu3d on the CPU, {chip_smoke.N_VIEWS} views {chip_smoke.WIDTH}x"
              f"{chip_smoke.HEIGHT}: accepted {len(regs)}, edges "
              f"{sum(len(r.edges) for r in regs)}, gated edges "
              f"{JP.LAST_MATCH_TIMERS['n_edges']}, tracks {ts.next_track}, rotation error "
              f"median {np.median(errs):.4f} max {errs.max():.4f} deg, "
              f"{time.time() - t0:.1f} s")
        sys.exit(0 if len(regs) >= chip_smoke.TPU3D_CPU_ACCEPTED else 1)
