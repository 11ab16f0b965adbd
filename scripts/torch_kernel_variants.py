#!/usr/bin/env python3
"""Time source variants of the port's top2 and orient_desc kernels on one
NVIDIA GPU, each against the plain PyTorch version, in one process.

    python3 scripts/torch_kernel_variants.py [--top2 A.cu B.cu ...]
                                             [--orient-desc C.cu ...]

Each source must export the C entry point and packed argument block of
tpu3d_torch/csrc/top2.cu (``tpu3d_top2(const Top2Args*)``, which also
fills the column keys) or
csrc/orient_desc.cu (``tpu3d_orient_desc(const OrientDescArgs*)``); by
default the two files of the checkout are timed. Every source is built by
nvcc for sm_90a into its own library under build/kernel_variants/ (one nvcc
per source, all at once; ptxas' register and spill lines are printed). Then,
in turns (the list, then the list reversed):

  top2         B = 32 pairs of 2048 x 2048 unit descriptors, D = 128, 90%
               valid (chip_smoke.py's inputs, seed 2): rows and columns
               against mutual_top2_plain wherever the top-2 gap exceeds
               1e-5, then ms per launch (CUDA events, median of 5 batches
               of 20), with the column keys and without them (rows only).
  orient_desc  the arguments of the first extract batch of chip_smoke.py's
               scene (K = 8,192): theta and samples against
               orient_desc_samples_plain (max |err| over keypoints whose
               theta agrees within 1e-5 rad), then ms per launch (median of
               5 batches of 50).

With --sass, each library's kernels are also disassembled (cuobjdump
-sass) and their instruction mix printed: the count of each opcode, most
frequent first.

Prints one line per variant and turn, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tpu3d_torch.kernels import _build  # noqa: E402
from tpu3d_torch.kernels import distance as dist  # noqa: E402
from tpu3d_torch.kernels import orient_desc as od  # noqa: E402

OUT = ROOT / "build" / "kernel_variants"


def build(sources):
    """{source: ctypes library}, built in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = []
    for i, src in enumerate(sources):
        lib = OUT / f"v{i}_{Path(src).stem}.so"
        cmd = [nvcc, *_build.ARCH, *_build.FLAGS, "-shared", str(src), "-o", str(lib)]
        procs.append((src, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for src, lib, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed on {src}:\n{out}")
        regs = [ln.strip() for ln in out.splitlines() if "registers" in ln or "spill" in ln]
        print(f"build {src}: " + " | ".join(regs), flush=True)
        libs[src] = ctypes.CDLL(str(lib))
        libs[src]._path = lib
    return libs


def sass_mix(lib_path: Path) -> str:
    """Opcode counts of every kernel in a library, most frequent first."""
    import collections
    import os
    import re
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(_build._nvcc()),
                                                      "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                         timeout=300).stdout
    ops = collections.Counter(m.group(1) for m in
                              re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9.]+)",
                                          out))
    total = sum(ops.values())
    return f"{total} instructions: " + ", ".join(f"{k} {v}" for k, v in ops.most_common(14))


def events_ms(fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


def top2_case(dev):
    B, K, D = 32, 2048, 128
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    q = torch.nn.functional.normalize(torch.randn((B, K, D), generator=g, device=dev), dim=-1)
    k = torch.nn.functional.normalize(torch.randn((B, K, D), generator=g, device=dev), dim=-1)
    vq = (torch.rand((B, K), generator=g, device=dev) < 0.9).float()
    vk = (torch.rand((B, K), generator=g, device=dev) < 0.9).float()
    pb, ps, pa, pc = dist.mutual_top2_plain(q, k, vq, vk)
    cb, cs, _ = dist.descriptor_top2_plain(k, q, vk, vq)
    clear = ((pb - ps) > 1e-5) | (vq == 0)
    cclear = ((cb - cs) > 1e-5) | (vk == 0)
    return (q, k, vq, vk), (pb, ps, pa, pc, clear, cclear)


def run_top2(lib, args, ref):
    q, k, vq, vk = args
    B, K0, D = q.shape
    K1 = k.shape[1]
    fn = lib.tpu3d_top2
    fn.argtypes = [ctypes.c_char_p]
    fn.restype = ctypes.c_int
    best, second = torch.empty_like(vq), torch.empty_like(vq)
    arg = torch.empty((B, K0), dtype=torch.int32, device=q.device)
    keys = torch.empty((B, K1), dtype=torch.int64, device=q.device)
    packed = dist._ARGS.pack(q.data_ptr(), k.data_ptr(), vq.data_ptr(), vk.data_ptr(),
                             best.data_ptr(), second.data_ptr(), arg.data_ptr(),
                             keys.data_ptr(), torch.cuda.current_stream().cuda_stream,
                             B, K0, K1, D)

    rows_only = dist._ARGS.pack(*dist._ARGS.unpack(packed)[:7], 0,
                                *dist._ARGS.unpack(packed)[8:])

    def launch(args=packed):
        _build.check(fn(args), "top2 variant")

    launch()
    torch.cuda.synchronize()
    pb, ps, pa, pc, clear, cclear = ref
    col = keys.view(torch.int32).view(B, K1, 2)[..., 0]
    err = max(float((best - pb).abs().max()), float((second - ps).abs().max()))
    bad = int(((arg != pa) & clear).sum()) + int(((col != pc) & cclear).sum())
    ms = events_ms(launch, 20)
    rows_ms = events_ms(lambda: launch(rows_only), 20)
    flops = 2.0 * B * K0 * K1 * D
    return (f"max_abs_err={err:.3g} argmax mismatches {bad}; {ms:.4f} ms per launch, "
            f"{flops / ms / 1e9:.1f} TFLOP/s; rows only (no column keys) {rows_ms:.4f} ms"), \
        err <= 1e-5 and bad == 0


def orient_case(dev):
    import chip_smoke

    scene = chip_smoke.make_scene()
    cfg = chip_smoke._full_config(scene)
    args = chip_smoke._orient_desc_inputs(torch, dev, scene, cfg)
    return args, od.orient_desc_samples_plain(*args)


def run_orient(lib, args, ref):
    gx, gy, ky, kx, lvl, sigma, ymax, xmax = args
    L, H, W = gx.shape
    K = ky.shape[0]
    fn = lib.tpu3d_orient_desc
    fn.argtypes = [ctypes.c_char_p]
    fn.restype = ctypes.c_int
    gxs = gx.new_empty((K, od.DESC_N))
    gys = gx.new_empty((K, od.DESC_N))
    th = gx.new_empty((K,))
    packed = od._ARGS.pack(*(t.data_ptr() for t in args), od._table(gx.device).data_ptr(),
                           gxs.data_ptr(), gys.data_ptr(), th.data_ptr(),
                           torch.cuda.current_stream().cuda_stream, L, H, W, K)

    def launch():
        _build.check(fn(packed), "orient_desc variant")

    launch()
    torch.cuda.synchronize()
    rgx, rgy, rth = ref
    dth = (torch.remainder(th - rth + np.pi, 2 * np.pi) - np.pi).abs()
    agree = dth <= 1e-5
    err = float(torch.maximum((gxs - rgx).abs(), (gys - rgy).abs())[agree].max())
    ms = events_ms(launch, 50)
    return (f"max_abs_err={err:.3g} theta beyond 1e-5 rad on {int((~agree).sum())} "
            f"keypoints; {ms:.4f} ms per launch"), err == 0.0


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--top2", nargs="*", default=[str(ROOT / "tpu3d_torch/csrc/top2.cu")])
    ap.add_argument("--orient-desc", nargs="*",
                    default=[str(ROOT / "tpu3d_torch/csrc/orient_desc.cu")])
    ap.add_argument("--sass", action="store_true", help="print each library's opcode mix")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_kernel_variants: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    libs = build(opts.top2 + opts.orient_desc)
    if opts.sass:
        for src, lib in libs.items():
            print(f"sass {src}: {sass_mix(lib._path)}", flush=True)
    ok = True
    torch.backends.cuda.matmul.allow_tf32 = False
    for kind, sources, case, run in (("top2", opts.top2, top2_case, run_top2),
                                     ("orient_desc", opts.orient_desc, orient_case, run_orient)):
        if not sources:
            continue
        args, ref = case(dev)
        for turn, order in enumerate((sources, sources[::-1])):
            for src in order:
                line, good = run(libs[src], args, ref)
                ok &= good
                print(f"{kind} turn {turn} {src}: {line}", flush=True)
        del args, ref
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
