"""The port's learned frontends and matcher (tpu3d_torch/features/{disk,
superpoint,learned}.py, matching/lightglue.py, the learned branches of
sfm/pipeline.py and cli ingest) against tpu3d's Flax forwards, on the CPU.

The released checkpoints are not in the repository, so both packages
compute from one seeded random init: tpu3d's Flax init (``jax.random.
PRNGKey``) as numpy, carried into the port's modules by the weight functions
(``*_params_from_tpu3d``), or a random torch state_dict in the released
checkpoints' naming through both packages' converters.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tpu3d.config import FrontendConfig as JFrontendConfig
from tpu3d.config import MatchingConfig as JMatchingConfig
from tpu3d.config import PipelineConfig as JPipelineConfig
from tpu3d.features import disk as JD
from tpu3d.features import learned as JL
from tpu3d.features import superpoint as JS
from tpu3d.matching import lightglue as JLG
from tpu3d_torch.config import PipelineConfig
from tpu3d_torch.features import disk as PD
from tpu3d_torch.features import learned as PL
from tpu3d_torch.features import superpoint as PS
from tpu3d_torch.matching import lightglue as PLG


def t(a):
    return torch.from_numpy(np.array(a))


def n(x):
    return x.detach().cpu().numpy()


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        np.testing.assert_array_equal(np.asarray(la[k]), np.asarray(lb[k]), err_msg=str(k))


@pytest.fixture(scope="module")
def disk_params():
    return host(JD.DiskUNet().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))


@pytest.fixture(scope="module")
def superpoint_params():
    return host(JS.SuperPointNet().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1))))


def _lg_params(n_layers, input_dim=128, seed=0):
    k = jnp.zeros((1, 8, 2))
    d = jnp.zeros((1, 8, input_dim))
    s = jnp.ones((1, 2))
    return host(JLG.LightGlue(input_dim=input_dim, n_layers=n_layers).init(
        jax.random.PRNGKey(seed), k, d, s, k, d, s))


def test_disk_unet_matches_tpu3d(disk_params):
    """DiskUNet from tpu3d's init: the 129-channel map within rtol 1e-4 /
    atol 1e-5 (the instance norm's variance sums in another order)."""
    x = np.random.RandomState(0).uniform(0, 1, (2, 32, 48, 3)).astype(np.float32)
    ref = np.asarray(JD.DiskUNet().apply(disk_params, jnp.asarray(x)))
    net = PD.DiskUNet()
    net.load_state_dict(PD.disk_params_from_tpu3d(disk_params))
    with torch.no_grad():
        got = n(net(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
    assert got.shape == ref.shape == (2, 32, 48, 129)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["ties", "few_maxima"])
def test_detect_from_heatmap_matches_tpu3d(case):
    """Window NMS + top K on a heatmap quantized to four levels (many
    equal maxima, which tpu3d's top_k orders by index) and on one with fewer
    window maxima than K (the rest -inf, invalid): keypoints, scores and
    validity exact, descriptors within 1e-6, on valid slots."""
    rng = np.random.RandomState(1)
    B, H, W, K = 2, 24, 32, 40
    if case == "ties":
        heat = rng.randint(0, 4, (B, H, W)).astype(np.float32) / 4.0
    else:
        heat = np.zeros((B, H, W), np.float32)
        heat[:, ::8, ::8] = rng.uniform(0.1, 1.0, (B, 3, 4))
        heat[0, 0, 0] = heat[0, 0, 8]
        K = 64
    desc = rng.randn(B, H, W, 128).astype(np.float32)
    ref = JD.detect_from_heatmap(jnp.asarray(heat), jnp.asarray(desc), K)
    got = PD.detect_from_heatmap(t(heat), t(desc).permute(0, 3, 1, 2), K)
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(n(got.valid), v)
    assert 0 < v.sum() < v.size if case == "few_maxima" else v.all()
    np.testing.assert_array_equal(n(got.keypoints)[v], np.asarray(ref.keypoints)[v])
    np.testing.assert_array_equal(n(got.scores), np.asarray(ref.scores))
    np.testing.assert_allclose(n(got.descriptors), np.asarray(ref.descriptors), atol=1e-6)


def test_superpoint_matches_tpu3d(superpoint_params):
    """SuperPointNet from tpu3d's init: scores and descriptor map within
    rtol 1e-4 / atol 1e-5; extract_superpoint (NMS, borders, top K,
    tpu3d's bilinear descriptor formula): validity and keypoints exact,
    scores and descriptors within 1e-5."""
    x = np.random.RandomState(2).uniform(0, 1, (2, 48, 64)).astype(np.float32)
    js, jd = JS.SuperPointNet().apply(superpoint_params, jnp.asarray(x)[..., None])
    net = PS.SuperPointNet()
    net.load_state_dict(PS.superpoint_params_from_tpu3d(superpoint_params))
    with torch.no_grad():
        s, d = net(t(x)[:, None])
        np.testing.assert_allclose(n(s), np.asarray(js), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(n(d.permute(0, 2, 3, 1)), np.asarray(jd), rtol=1e-4,
                                   atol=1e-5)
        got = PS.extract_superpoint(net, t(x), max_keypoints=96)
    ref = JS.extract_superpoint(superpoint_params, jnp.asarray(x), max_keypoints=96)
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(n(got.valid), v)
    assert v.any()
    np.testing.assert_array_equal(n(got.keypoints)[v], np.asarray(ref.keypoints)[v])
    np.testing.assert_allclose(n(got.scores), np.asarray(ref.scores), atol=1e-5)
    np.testing.assert_allclose(n(got.descriptors), np.asarray(ref.descriptors), atol=1e-5)


def _lg_inputs(seed, M, N, pad0=0, pad1=0):
    rng = np.random.RandomState(seed)
    kp0 = np.stack([rng.uniform(0, 640, (1, M)), rng.uniform(0, 480, (1, M))], -1)
    kp1 = np.stack([rng.uniform(0, 640, (1, N)), rng.uniform(0, 480, (1, N))], -1)
    d0 = rng.normal(0, 1, (1, M, 128))
    d1 = rng.normal(0, 1, (1, N, 128))
    size = np.array([[640.0, 480.0]])
    v0 = (np.arange(M) < M - pad0)[None].astype(np.float32)
    v1 = (np.arange(N) < N - pad1)[None].astype(np.float32)
    return [a.astype(np.float32) for a in (kp0, d0, size, kp1, d1, size, v0, v1)]


@pytest.mark.parametrize("n_layers", [2, 9])
def test_lightglue_matches_tpu3d(n_layers):
    """LightGlue at M=64, N=80 with padding masks (10 and 16 padded slots),
    from tpu3d's init: log-assignment scores within atol 1e-4 plus rtol
    2e-5 (at 9 layers the residual stream and the scores grow to ~100,
    where f32 products summed in another order differ by up to 1.8e-5 of
    the value), match probabilities within 1e-4 and filter_matches'
    matches equal."""
    params = _lg_params(n_layers)
    args = _lg_inputs(3, 64, 80, 10, 16)
    ref = np.asarray(JLG.LightGlue(input_dim=128, n_layers=n_layers).apply(
        params, *map(jnp.asarray, args)))
    net = PLG.lightglue_from_tpu3d(params, "cpu")
    assert net.n_layers == n_layers
    with torch.no_grad():
        got = n(net(*map(t, args)))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-4)
    m0, _, ms0, _ = PLG.filter_matches(t(got))
    jm0, _, jms0, _ = JLG.filter_matches(jnp.asarray(ref))
    np.testing.assert_array_equal(n(m0), np.asarray(jm0))
    np.testing.assert_allclose(n(ms0), np.asarray(jms0), atol=1e-4)


def test_lightglue_padding_mask_invariance():
    """tpu3d's test_learned_e2e.py:149 case on the port: the masked forward
    on padded arrays gives the unpadded forward's matches and scores on the
    real slots, and padded slots never match."""
    params = _lg_params(2, seed=1)
    net = PLG.lightglue_from_tpu3d(params, "cpu")
    M, N, PAD = 40, 48, 24
    kp0, d0, size, kp1, d1, _, _, _ = _lg_inputs(4, M, N)
    size = np.array([[128.0, 96.0]], np.float32)

    def pad(a):
        out = np.zeros((1, a.shape[1] + PAD, *a.shape[2:]), a.dtype)
        out[:, :a.shape[1]] = a
        return t(out)

    v0 = t((np.arange(M + PAD) < M)[None].astype(np.float32))
    v1 = t((np.arange(N + PAD) < N)[None].astype(np.float32))
    with torch.no_grad():
        m0_ref, _, ms0_ref, _ = PLG.filter_matches(net(t(kp0), t(d0), t(size), t(kp1), t(d1),
                                                       t(size)))
        m0, _, ms0, _ = PLG.filter_matches(net(pad(kp0), pad(d0), t(size), pad(kp1), pad(d1),
                                               t(size), v0, v1))
    np.testing.assert_array_equal(n(m0_ref)[0], n(m0)[0][:M])
    np.testing.assert_allclose(n(ms0_ref)[0], n(ms0)[0][:M], atol=1e-4)
    assert (n(m0)[0][M:] == -1).all()


def test_filter_matches_matches_tpu3d():
    """Mutual argmax + threshold on log assignments with ties (values on a
    grid of 0.25): all four outputs exactly tpu3d's."""
    rng = np.random.RandomState(5)
    scores = np.log(rng.randint(1, 5, (2, 31, 41)) / 4.0).astype(np.float32)
    for got, ref in zip(PLG.filter_matches(t(scores), 0.3),
                        JLG.filter_matches(jnp.asarray(scores), 0.3)):
        np.testing.assert_array_equal(n(got), np.asarray(ref))


def _kornia_disk_sd(params):
    """tpu3d's DiskUNet params in kornia >= 0.7's thin-unet checkpoint
    naming (tests/test_ingest.py's inverse of convert_kornia_state_dict)."""
    p, sd = params["params"], {}

    def put(prefix, blk, gated=True):
        k = blk["conv"]["kernel"] if gated else blk["kernel"]
        b = blk["conv"]["bias"] if gated else blk["bias"]
        pre = prefix + ".conv" if gated else prefix
        sd[pre + ".weight"] = torch.tensor(np.transpose(k, (3, 2, 0, 1)))
        sd[pre + ".bias"] = torch.tensor(b)
        if gated:
            sd[prefix + ".gate.weight"] = torch.tensor(blk["prelu_alpha"])

    for i in range(5):
        put(f"unet.path_down.{i}.1", p[f"down_{i}"])
    for i in range(3):
        put(f"unet.path_up.{i}.1", p[f"up_{i}"])
    put("unet.path_up.3.1.conv", p["up_3_conv"], gated=False)
    return sd


def _lightglue_sd(n_layers, input_dim=128, dim=256, seed=0):
    """A random state_dict in the torch LightGlue reference's naming."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g)

    sd = {"input_proj.weight": r(dim, input_dim), "input_proj.bias": r(dim),
          "posenc.Wr.weight": r(dim // 8, 2)}
    for i in range(n_layers):
        sa, ca = f"self_attn.{i}", f"cross_attn.{i}"
        sd.update({f"{sa}.Wqkv.weight": r(3 * dim, dim), f"{sa}.Wqkv.bias": r(3 * dim),
                   f"{sa}.out_proj.weight": r(dim, dim), f"{sa}.out_proj.bias": r(dim)})
        for name in ("to_qk", "to_v", "to_out"):
            sd.update({f"{ca}.{name}.weight": r(dim, dim), f"{ca}.{name}.bias": r(dim)})
        for pre in (sa, ca):
            sd.update({f"{pre}.ffn.0.weight": r(2 * dim, 2 * dim), f"{pre}.ffn.0.bias": r(2 * dim),
                       f"{pre}.ffn.1.weight": r(2 * dim), f"{pre}.ffn.1.bias": r(2 * dim),
                       f"{pre}.ffn.3.weight": r(dim, 2 * dim), f"{pre}.ffn.3.bias": r(dim)})
        la = f"log_assignment.{i}"
        sd.update({f"{la}.final_proj.weight": r(dim, dim), f"{la}.final_proj.bias": r(dim),
                   f"{la}.matchability.weight": r(1, dim), f"{la}.matchability.bias": r(1)})
    return sd


def _superpoint_sd(seed=0):
    g = torch.Generator().manual_seed(seed)
    net = PS.SuperPointNet()
    return {k: torch.randn(v.shape, generator=g) for k, v in net.state_dict().items()}


def test_converters_match_tpu3d(disk_params):
    """Each converter on a torch state_dict in its checkpoint's naming
    (kornia's DISK, the LightGlue reference's, MagicLeap's SuperPoint):
    tpu3d's tree, array for array; and the port's module then loads it."""
    _assert_trees_equal(PD.convert_kornia_state_dict(_kornia_disk_sd(disk_params)),
                        JD.convert_kornia_state_dict(_kornia_disk_sd(disk_params)))
    _assert_trees_equal(PD.convert_kornia_state_dict(_kornia_disk_sd(disk_params)), disk_params)
    lg = _lightglue_sd(3)
    _assert_trees_equal(PLG.convert_torch_state_dict(lg, 3), JLG.convert_torch_state_dict(lg, 3))
    assert PLG.lightglue_from_tpu3d(PLG.convert_torch_state_dict(lg, 3), "cpu").n_layers == 3
    sp = _superpoint_sd()
    tree = PS.convert_torch_state_dict(sp)
    _assert_trees_equal(tree, JS.convert_torch_state_dict(sp))
    back = PL.frontend_module("superpoint", tree, "cpu").state_dict()
    for k, v in sp.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)


def test_param_npz_round_trips_both_ways(tmp_path, disk_params):
    """The port's .npz loads in tpu3d and tpu3d's in the port: equal trees
    under the same '/'-joined keys."""
    lg = _lg_params(2)
    for params in (disk_params, lg):
        PL.save_params_npz(str(tmp_path / "p.npz"), params)
        JL.save_params_npz(str(tmp_path / "j.npz"), params)
        _assert_trees_equal(JL.load_params_npz(str(tmp_path / "p.npz")), params)
        _assert_trees_equal(PL.load_params_npz(str(tmp_path / "j.npz")), params)
        assert sorted(np.load(str(tmp_path / "p.npz")).files) == \
            sorted(np.load(str(tmp_path / "j.npz")).files)
    assert PL.count_arrays(lg) == len(jax.tree_util.tree_leaves(lg))


# --------------------------------------------------------------------------
# The pipeline's learned branches on tpu3d's six 96x128 images.


@pytest.fixture(scope="module")
def learned_scene(tmp_path_factory, disk_params, superpoint_params):
    """tpu3d's test_learned_e2e.py:27-41 images and weights: six 96x128
    crops of a box-filtered noise texture under small shifts, and DISK,
    SuperPoint and 2-layer LightGlue weights from tpu3d's inits as .npz."""
    rng = np.random.default_rng(3)
    base = (rng.uniform(0, 255, (160, 200, 3))).astype(np.uint8)
    base = (base.astype(np.float32) + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3.0
    d = tmp_path_factory.mktemp("learned")
    images = d / "imgs"
    images.mkdir()
    for i in range(6):
        crop = base[i * 4: i * 4 + 96, i * 6: i * 6 + 128].astype(np.uint8)
        Image.fromarray(crop).save(images / f"im{i:02d}.png")
    w = {}
    for name, params in (("disk", disk_params), ("superpoint", superpoint_params),
                         ("lightglue", _lg_params(2))):
        w[name] = str(d / f"{name}.npz")
        JL.save_params_npz(w[name], params)
    return dict(images=str(images), weights=w, root=d)


def _configs(frontend, weights, matcher="mnn", m_weights=""):
    jcfg = JPipelineConfig(
        frontend=JFrontendConfig(model=frontend, weights=weights, max_keypoints=128,
                                 batch_size=2),
        matching=JMatchingConfig(matcher=matcher, weights=m_weights, min_raw_matches=4,
                                 pair_batch=4))
    return jcfg, PipelineConfig.from_dict(dataclasses.asdict(jcfg))


@pytest.mark.parametrize("model", ["disk", "superpoint"])
def test_run_extraction_learned_matches_tpu3d(learned_scene, model):
    """run_extraction with a learned frontend (DISK reads RGB, SuperPoint
    grey; padded to multiples of 16, the pad's detections invalid): the
    validity and keypoints exact on valid slots, descriptors within 1e-5,
    colours and sizes equal."""
    from tpu3d.sfm.pipeline import run_extraction as jax_run_extraction
    from tpu3d_torch.sfm.pipeline import run_extraction

    jcfg, cfg = _configs(model, learned_scene["weights"][model])
    ref = jax_run_extraction(learned_scene["images"], jcfg, verbose=False)
    got = run_extraction(learned_scene["images"], cfg, verbose=False, device="cpu")
    v = ref.valid
    assert got.names == ref.names and v.any()
    np.testing.assert_array_equal(got.valid, v)
    np.testing.assert_array_equal(got.keypoints_px[v], ref.keypoints_px[v])
    np.testing.assert_array_equal(got.keypoints[v], ref.keypoints[v])
    np.testing.assert_allclose(got.descriptors, ref.descriptors, atol=1e-5)
    assert got.descriptors.shape[-1] == (128 if model == "disk" else 256)
    np.testing.assert_array_equal(got.image_size, ref.image_size)
    np.testing.assert_array_equal(got.colors_bgr[v], ref.colors_bgr[v])


def test_lightglue_match_stage_matches_tpu3d(learned_scene):
    """The match stage with LightGlue (pair blocks of 4, the forward under
    the validity masks, filter_matches at 0.1) on tpu3d's DISK features:
    for every pair the matched index set equals tpu3d's."""
    from tpu3d.sfm.pipeline import _batch_match_pairs as jax_batch_match_pairs
    from tpu3d.sfm.pipeline import run_extraction as jax_run_extraction
    from tpu3d_torch.sfm.pipeline import ExtractedFeatures, _batch_match_pairs

    w = learned_scene["weights"]
    jcfg, cfg = _configs("disk", w["disk"], "lightglue", w["lightglue"])
    jf = jax_run_extraction(learned_scene["images"], jcfg, verbose=False)
    pairs = [(0, 1), (1, 2), (2, 3), (0, 2), (3, 5)]
    jmemo, memo = {}, {}
    jax_batch_match_pairs(jf, pairs, jcfg, jax.random.PRNGKey(0), jmemo)
    feats = ExtractedFeatures.from_numpy(jf.names, jf.keypoints, jf.keypoints_px, jf.valid,
                                         jf.colors_bgr, jf.image_size, jf.descriptors,
                                         device="cpu")
    _batch_match_pairs(feats, pairs, cfg, 0, memo)
    K = jf.keypoints.shape[1]
    assert memo.keys() == jmemo.keys()
    n_matched = 0
    for e in jmemo:
        a, b = memo[e][:K * 3].reshape(K, 3), jmemo[e][:K * 3].reshape(K, 3)
        np.testing.assert_array_equal(a[:, 1], b[:, 1], err_msg=str(e))
        m = b[:, 1] > 0
        np.testing.assert_array_equal(a[m, 0], b[m, 0], err_msg=str(e))
        n_matched += int(m.sum())
    assert n_matched > 0


@pytest.mark.parametrize("kind", ["disk", "superpoint", "lightglue"])
def test_ingest_matches_tpu3d(tmp_path, capsys, disk_params, kind):
    """cli ingest of a .pth in each checkpoint's naming: the .npz holds
    tpu3d's ingest output array for array, and the JSON line is tpu3d's."""
    from tpu3d.cli import main as jax_main
    from tpu3d_torch.cli import main

    sd = {"disk": lambda: _kornia_disk_sd(disk_params), "superpoint": _superpoint_sd,
          "lightglue": lambda: _lightglue_sd(9)}[kind]()
    ckpt = str(tmp_path / f"{kind}.pth")
    torch.save(sd, ckpt)
    flags = (["--matcher-weights", ckpt] if kind == "lightglue"
             else ["--frontend", kind, "--frontend-weights", ckpt])
    outs = []
    for fn, name in ((main, "port"), (jax_main, "tpu3d")):
        fn(["ingest", *flags, "--out", str(tmp_path / f"{name}.npz")])
        outs.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert {k: v for k, v in outs[0].items() if k != "out"} == \
        {k: v for k, v in outs[1].items() if k != "out"}
    _assert_trees_equal(PL.load_params_npz(outs[0]["out"]), JL.load_params_npz(outs[1]["out"]))
    with pytest.raises(SystemExit):
        main(["ingest"])
    assert os.path.exists(outs[0]["out"])


def test_learned_entry_points_default_to_the_card(disk_params):
    """Without a card, the learned entry points refuse their default device
    by name instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    from tpu3d_torch.config import FrontendConfig

    gray = np.zeros((1, 32, 32), np.uint8)
    for call in (lambda: PL.frontend_module("disk", disk_params),
                 lambda: PL.extract_learned(disk_params, "disk", gray,
                                            np.zeros((1, 32, 32, 3), np.uint8), FrontendConfig()),
                 lambda: PLG.lightglue_from_tpu3d(_lg_params(2))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
