"""The learned frontends (DISK, SuperPoint) behind the classical frontend's
FeatureSet, and the param store of every learned model
(tpu3d/features/learned.py).

Weights live as tpu3d's param trees: nested dicts of numpy arrays in
Flax's layout (``{"params": {...}}``, convolution kernels HWIO, dense
kernels (in, out)), stored flat in an ``.npz`` under tpu3d's ``/``-joined
keys, so tpu3d's files load here and the port's load in tpu3d. A torch
checkpoint (``.pth``) goes through the per-model converter into the same
tree. :func:`state_dict_from_tree` turns a tree into a module's
``state_dict`` (kernels to OIHW and (out, in), LayerNorm scales to
weights). The released checkpoints are not in the repository: tests and
the card's smoke run use seeded random weights.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from tpu3d_torch import f32_scope, resolve_device
from tpu3d_torch.config import FrontendConfig
from tpu3d_torch.core.camera import pixel_to_centered
from tpu3d_torch.features.frontend import FeatureSet

Tree = Dict[str, Any]


# ---------------------------------------------------------------------------
# The param store: tpu3d's trees <-> flat .npz, and trees -> state_dicts.


def _flatten(tree: Tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Tree:
    tree: Tree = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_params_npz(path: str, params: Tree) -> None:
    """A param tree as a flat .npz under tpu3d's keys."""
    np.savez_compressed(path, **_flatten(params))


def load_params_npz(path: str) -> Tree:
    z = np.load(path)
    return _unflatten({k: z[k] for k in z.files})


def count_arrays(params: Tree) -> int:
    """The number of arrays in a param tree (its leaves)."""
    return len(_flatten(params))


def state_dict_from_tree(params: Tree) -> Dict[str, torch.Tensor]:
    """A tpu3d param tree as the ``state_dict`` of the port's module of the
    same structure: ``a/b/kernel`` -> ``a.b.weight`` (HWIO -> OIHW for a
    convolution, (in, out) -> (out, in) for a dense layer), a LayerNorm's
    ``scale`` -> ``weight``, every other leaf under its own name."""
    sd = {}
    for key, v in _flatten(params.get("params", params)).items():
        *path, leaf = key.split("/")
        v = np.array(v, np.float32)
        if leaf == "kernel":
            leaf = "weight"
            v = np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v.T
        elif leaf == "scale":
            leaf = "weight"
        sd[".".join(path + [leaf])] = torch.from_numpy(np.ascontiguousarray(v))
    return sd


def tree_from_state_dict(sd: Dict[str, torch.Tensor]) -> Tree:
    """The inverse of :func:`state_dict_from_tree`: a port module's
    ``state_dict`` as a tpu3d param tree (numpy), so that weights made in
    torch save as tpu3d's .npz."""
    flat = {}
    for key, v in sd.items():
        *path, leaf = key.split(".")
        v = v.detach().cpu().numpy()
        if leaf == "weight" and v.ndim in (2, 4):
            leaf = "kernel"
            v = np.transpose(v, (2, 3, 1, 0)) if v.ndim == 4 else v.T
        elif leaf == "weight":
            leaf = "scale"
        flat["/".join(["params", *path, leaf])] = np.ascontiguousarray(v)
    return _unflatten(flat)


def _torch_state_dict(path: str) -> Dict[str, Any]:
    sd = torch.load(path, map_location="cpu")
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def load_frontend_params(model: str, weights_path: str) -> Tree:
    """Front-end weights for ``model`` in {disk, superpoint}: a converted
    .npz, or a torch checkpoint through the model's converter."""
    if weights_path.endswith(".npz"):
        return load_params_npz(weights_path)
    sd = _torch_state_dict(weights_path)
    if model == "disk":
        from tpu3d_torch.features.disk import convert_kornia_state_dict

        return convert_kornia_state_dict(sd)
    if model == "superpoint":
        from tpu3d_torch.features.superpoint import convert_torch_state_dict

        return convert_torch_state_dict(sd)
    raise ValueError(f"unknown learned frontend {model!r}")


def load_matcher_params(weights_path: str, n_layers: int = 9) -> Tree:
    """LightGlue weights: a converted .npz, or a torch checkpoint."""
    if weights_path.endswith(".npz"):
        return load_params_npz(weights_path)
    from tpu3d_torch.matching.lightglue import convert_torch_state_dict

    return convert_torch_state_dict(_torch_state_dict(weights_path), n_layers)


def frontend_module(model: str, params: Tree, device="cuda") -> torch.nn.Module:
    """The port's DiskUNet or SuperPointNet holding ``params``, on
    ``device``, in eval mode."""
    if model == "disk":
        from tpu3d_torch.features.disk import DiskUNet as Net
    elif model == "superpoint":
        from tpu3d_torch.features.superpoint import SuperPointNet as Net
    else:
        raise ValueError(f"unknown learned frontend {model!r}")
    net = Net()
    net.load_state_dict(state_dict_from_tree(params))
    return net.to(resolve_device(device)).eval()


# ---------------------------------------------------------------------------
# Batched extraction behind the FeatureSet interface.


def _pad16(hw: int) -> int:
    return (hw + 15) // 16 * 16


def _to_featureset(kp_px, scores, desc, valid, orig_w: float, orig_h: float) -> FeatureSet:
    """Pixel keypoints on the padded canvas -> FeatureSet in the original
    image's frame: detections in the pad invalid, centred y-up coordinates
    against the original (W, H), scales all 1 (single-scale models)."""
    B, K, _ = kp_px.shape
    valid = valid & (kp_px[..., 0] < orig_w) & (kp_px[..., 1] < orig_h)
    scores = torch.where(valid, scores, torch.zeros_like(scores))
    desc = desc * valid[..., None].to(desc.dtype)
    size = torch.tensor([orig_w, orig_h], dtype=torch.float32,
                        device=kp_px.device).expand(B, 2)
    return FeatureSet(keypoints=pixel_to_centered(kp_px, size[:, None, :]), keypoints_px=kp_px,
                      descriptors=desc, scores=scores,
                      scales=torch.ones((B, K), dtype=torch.float32, device=kp_px.device),
                      valid=valid, image_size=size.contiguous())


def extract_learned(params: Union[Tree, torch.nn.Module], model: str, gray_u8: np.ndarray,
                    rgb_u8: np.ndarray, cfg: FrontendConfig, device="cuda") -> FeatureSet:
    """The learned extractor on one uint8 batch, on ``device``: DISK reads
    RGB, SuperPoint grey, each zero-padded to multiples of 16, in full f32
    (``f32_scope``: no TF32 in the convolutions). ``params`` is a tpu3d
    param tree or the module :func:`frontend_module` made from one.
    gray_u8: (B, H, W); rgb_u8: (B, H, W, 3)."""
    dev = resolve_device(device)
    net = params if isinstance(params, torch.nn.Module) else frontend_module(model, params, dev)
    B, H, W = np.asarray(gray_u8).shape
    Hp, Wp = _pad16(H), _pad16(W)
    with f32_scope(), torch.no_grad():
        if model == "disk":
            from tpu3d_torch.features.disk import extract_disk

            img = torch.zeros((B, Hp, Wp, 3), dtype=torch.float32, device=dev)
            img[:, :H, :W] = torch.from_numpy(np.asarray(rgb_u8)).to(dev).float() / 255.0
            f = extract_disk(net, img, max_keypoints=cfg.max_keypoints)
        elif model == "superpoint":
            from tpu3d_torch.features.superpoint import extract_superpoint

            img = torch.zeros((B, Hp, Wp), dtype=torch.float32, device=dev)
            img[:, :H, :W] = torch.from_numpy(np.asarray(gray_u8)).to(dev).float() / 255.0
            f = extract_superpoint(net, img, max_keypoints=cfg.max_keypoints)
        else:
            raise ValueError(f"unknown learned frontend {model!r}")
        return _to_featureset(f.keypoints, f.scores, f.descriptors, f.valid, float(W), float(H))
