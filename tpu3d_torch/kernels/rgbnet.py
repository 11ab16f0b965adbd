"""DVGO's colour MLP over the samples that its equations colour.

dense/dvgo.py's ``march``: c = sigmoid(W3 relu(W2 relu(W1 x + b1) + b2) +
b3) with x = [k0, the ray's 27-value view encoding], the MLP
Linear(39, 128)-ReLU-Linear(128, 128)-ReLU-Linear(128, 3), run only on the
rows of the (R, 12) k0 where ``coloured`` (w > tau) holds; every other row's
colour is 0, and so is its k0 cotangent. On a CUDA tensor
``rgbnet_forward`` / ``rgbnet_backward`` launch the kernels of
csrc/rgbnet.cu: the compaction (``rgbnet_count_kernel``,
``rgbnet_compact_kernel``: the coloured rows' indices in ascending order and
their count, in device memory), ``rgbnet_forward_kernel``, and
``rgbnet_backward_kernel`` with ``rgbnet_reduce_kernel``, which read the
count on the card: no host read, so a step captures and replays as one CUDA
graph. On a CPU tensor they run the plain versions, the same compacted MLP
by boolean indexing and ``addmm``.

Everything is f32. The kernels sum in their own fixed orders (each weight
gradient by one thread over its block's rows, then the blocks in order), so
they agree with the plain version to f32 rounding and repeat bit for bit.
"""
from __future__ import annotations

import struct
from typing import Sequence, Tuple

import torch

from tpu3d_torch.kernels import LAUNCHES
from tpu3d_torch.kernels._build import check, function, stream
from tpu3d_torch.utils.trace import launch_span

K0_DIM, EMB_DIM, WIDTH, OUT = 12, 27, 128, 3
IN_DIM = K0_DIM + EMB_DIM
SHAPES = ((WIDTH, IN_DIM), (WIDTH,), (WIDTH, WIDTH), (WIDTH,), (OUT, WIDTH), (OUT,))
N_PARAMS = sum(torch.Size(s).numel() for s in SHAPES)     # 22,019
_COMPACT_TILE = 4096
_FWD = struct.Struct("14Q4i")
_BWD = struct.Struct("15Q4i")
_F32 = torch.float32
_sms: dict = {}


def _check(name: str, t: torch.Tensor, shape, dtype=_F32, device=None, contiguous=True) -> None:
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or (device is not None and t.device != device)
            or (contiguous and not t.is_contiguous())):
        raise ValueError(f"rgbnet: {name} must be a{' contiguous' if contiguous else ''} {dtype} "
                         f"{tuple(shape)} tensor on {device}, got {tuple(t.shape)} {t.dtype} "
                         f"on {t.device}")


def _inputs(k0: torch.Tensor, emb: torch.Tensor, coloured: torch.Tensor,
            params: Sequence[torch.Tensor]) -> Tuple[int, int]:
    """(R, S) after checking the shapes: k0 (R, 12) with unit column
    stride, emb (N, 27), coloured (N, S) or (R,) bool, the six leaves."""
    R, N = k0.shape[0], emb.shape[0]
    if N == 0 or R % N:
        raise ValueError(f"rgbnet: {R} rows are not a whole number of samples for {N} rays")
    dev = k0.device
    _check("k0", k0, (R, K0_DIM), device=dev, contiguous=False)
    if k0.stride(1) != 1:
        raise ValueError("rgbnet: k0's columns must be adjacent")
    _check("emb", emb, (N, EMB_DIM), device=dev)
    if coloured.dtype != torch.bool or coloured.numel() != R or coloured.device != dev:
        raise ValueError(f"rgbnet: coloured must be a bool tensor of {R} elements on {dev}")
    if len(params) != len(SHAPES):
        raise ValueError(f"rgbnet: {len(params)} leaves, expected {len(SHAPES)}")
    for i, (p, s) in enumerate(zip(params, SHAPES)):
        _check(f"leaf {i}", p, s, device=dev)
    return R, R // N


def rgbnet_forward_plain(k0: torch.Tensor, emb: torch.Tensor, coloured: torch.Tensor,
                         params: Sequence[torch.Tensor], save: bool = True):
    """Plain version of :func:`rgbnet_forward`: the coloured rows by boolean
    indexing, three ``addmm``; ``saved`` is (mask, x, h1, h2, the rows'
    colours)."""
    R, S = k0.shape[0], k0.shape[0] // emb.shape[0]
    w1, b1, w2, b2, w3, b3 = params
    mask = coloured.reshape(-1)
    x = torch.cat([k0[mask], emb[:, None, :].expand(-1, S, -1).reshape(R, -1)[mask]], -1)
    h1 = torch.addmm(b1, x, w1.t()).relu_()
    h2 = torch.addmm(b2, h1, w2.t()).relu_()
    cr = torch.sigmoid(torch.addmm(b3, h2, w3.t()))
    c = k0.new_zeros((R, OUT))
    c[mask] = cr
    count = mask.sum(dtype=torch.int32).reshape(1)
    return c, count, ((mask, x, h1, h2, cr) if save else None)


def rgbnet_backward_plain(g: torch.Tensor, saved, params: Sequence[torch.Tensor]):
    """Plain version of :func:`rgbnet_backward`, from
    :func:`rgbnet_forward_plain`'s ``saved``."""
    mask, x, h1, h2, cr = saved
    w1, _, w2, _, w3, _ = params
    gl = g[mask] * (1 - cr) * cr
    gw3, gb3 = gl.t().mm(h2), gl.sum(0)
    gh = torch.ops.aten.threshold_backward(gl.mm(w3), h2, 0.0)     # ReLU's backward
    gw2, gb2 = gh.t().mm(h1), gh.sum(0)
    gh = torch.ops.aten.threshold_backward(gh.mm(w2), h1, 0.0)
    gw1, gb1 = gh.t().mm(x), gh.sum(0)
    gk0 = g.new_zeros((g.shape[0], K0_DIM))
    gk0[mask] = gh.mm(w1[:, :K0_DIM])
    return gk0, (gw1, gb1, gw2, gb2, gw3, gb3)


def _grid(dev: torch.device) -> int:
    """The persistent kernels' blocks: one an SM."""
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    if i not in _sms:
        _sms[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _sms[i]


def compact(coloured: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx (R,) int32, count (1,) int32): the indices of ``coloured``'s
    true elements in ascending order, the first ``count`` of ``idx`` valid,
    by ``rgbnet_count_kernel`` and ``rgbnet_compact_kernel`` on the card. A
    CPU tensor takes ``nonzero``."""
    flat = coloured.reshape(-1)
    R = flat.numel()
    if flat.device.type == "cpu":
        rows = flat.nonzero().reshape(-1).to(torch.int32)
        idx = torch.zeros(R, dtype=torch.int32)
        idx[:rows.numel()] = rows
        return idx, torch.tensor([rows.numel()], dtype=torch.int32)
    if flat.dtype != torch.bool or not flat.is_contiguous() or R >= 2 ** 31:
        raise ValueError("rgbnet: compact takes a contiguous bool tensor of fewer than 2^31 "
                         f"elements, got {tuple(coloured.shape)} {coloured.dtype}")
    idx = torch.empty(R, dtype=torch.int32, device=flat.device)
    count = torch.empty(1, dtype=torch.int32, device=flat.device)
    counts = torch.empty(max(1, -(-R // _COMPACT_TILE)), dtype=torch.int32, device=flat.device)
    with launch_span("kernels.rgbnet_compact"):
        err = function("tpu3d_rgbnet_compact")(flat.data_ptr(), R, counts.data_ptr(),
                                               idx.data_ptr(), count.data_ptr(),
                                               stream(flat.get_device()))
    check(err, "rgbnet_compact_kernel")
    LAUNCHES["rgbnet_count_kernel"] += 1
    LAUNCHES["rgbnet_compact_kernel"] += 1
    return idx, count


def rgbnet_forward(k0: torch.Tensor, emb: torch.Tensor, coloured: torch.Tensor,
                   params: Sequence[torch.Tensor], save: bool = True):
    """(c (R, 3), count (1,) int32, saved): the colours of the R rows of k0
    (R, 12) (unit column stride, any row stride: ``vals[:, 1:]``) whose
    ``coloured`` (N, S) holds, each beside its ray's view encoding ``emb``
    (N, 27) (row r is ray r // S), 0 at every other row; the number of
    coloured rows; what :func:`rgbnet_backward` needs when ``save``, else
    None. ``params``: W1 (128, 39), b1, W2 (128, 128), b2, W3 (3, 128), b3.
    A CPU tensor takes :func:`rgbnet_forward_plain`; a CUDA tensor runs the
    compaction and ``rgbnet_forward_kernel`` on the current stream."""
    R, S = _inputs(k0, emb, coloured, params)
    if k0.device.type == "cpu":
        return rgbnet_forward_plain(k0, emb, coloured, params, save)
    if k0.device.type != "cuda":
        raise ValueError(f"rgbnet: unsupported device {k0.device}")
    if R * max(k0.stride(0), K0_DIM) >= 2 ** 31:
        raise ValueError(f"rgbnet: {R} rows exceed the kernels' int32 row index")
    idx, count = compact(coloured)
    c = torch.zeros((R, OUT), dtype=_F32, device=k0.device)
    h1 = h2 = None
    if save:
        h1 = torch.empty((R, WIDTH), dtype=_F32, device=k0.device)
        h2 = torch.empty((R, WIDTH), dtype=_F32, device=k0.device)
    with launch_span("kernels.rgbnet_forward"):
        err = function("tpu3d_rgbnet_forward")(_FWD.pack(
            k0.data_ptr(), emb.data_ptr(), idx.data_ptr(), count.data_ptr(),
            *(p.data_ptr() for p in params), c.data_ptr(), 0 if h1 is None else h1.data_ptr(),
            0 if h2 is None else h2.data_ptr(), stream(k0.get_device()), k0.stride(0), S,
            _grid(k0.device), 0))
    check(err, "rgbnet_forward_kernel")
    LAUNCHES["rgbnet_forward_kernel"] += 1
    return c, count, ((k0, emb, c, idx, count, h1, h2) if save else None)


def rgbnet_backward(g: torch.Tensor, saved, params: Sequence[torch.Tensor]):
    """(gk0 (R, 12), the six leaves' gradients) from the colours'
    cotangent ``g`` (R, 3) and :func:`rgbnet_forward`'s ``saved``: gk0 is
    +0 at every uncoloured row. A CPU tensor takes
    :func:`rgbnet_backward_plain`; a CUDA tensor runs
    ``rgbnet_backward_kernel`` and ``rgbnet_reduce_kernel`` on the current
    stream."""
    if g.device.type == "cpu":
        return rgbnet_backward_plain(g, saved, params)
    k0, emb, c, idx, count, h1, h2 = saved
    R = k0.shape[0]
    g = g.contiguous()
    _check("g", g, (R, OUT), device=k0.device)
    blocks = _grid(k0.device)
    gk0 = torch.zeros((R, K0_DIM), dtype=_F32, device=g.device)
    part = torch.empty((blocks, N_PARAMS), dtype=_F32, device=g.device)
    flat = torch.empty(N_PARAMS, dtype=_F32, device=g.device)
    w1, _, w2, _, w3, _ = params
    with launch_span("kernels.rgbnet_backward"):
        err = function("tpu3d_rgbnet_backward")(_BWD.pack(
            g.data_ptr(), c.data_ptr(), k0.data_ptr(), emb.data_ptr(), idx.data_ptr(),
            count.data_ptr(), h1.data_ptr(), h2.data_ptr(), w1.data_ptr(), w2.data_ptr(),
            w3.data_ptr(), gk0.data_ptr(), part.data_ptr(), flat.data_ptr(),
            stream(g.get_device()), k0.stride(0), R // emb.shape[0], blocks, 0))
    check(err, "rgbnet_backward_kernel")
    LAUNCHES["rgbnet_backward_kernel"] += 1
    LAUNCHES["rgbnet_reduce_kernel"] += 1
    grads, off = [], 0
    for s in SHAPES:
        n = torch.Size(s).numel()
        grads.append(flat[off:off + n].view(s))
        off += n
    return gk0, tuple(grads)
