"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). The build happens at first use, into
``build/tpu3d_torch/`` at the repository root, and again whenever a source
is newer than the library. The sources compile in parallel, one ``nvcc``
each, and are linked once.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpu3d_torch"
LIB_NAME = "libtpu3d_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
# What the last build printed (ptxas register / shared memory / spill
# lines) and how long it took; empty when the library was up to date.
BUILD_LOG: dict = {"seconds": 0.0, "ptxas": ""}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # one packed block of arguments (PatchSampleArgs), built by the wrapper
    "tpu3d_patch_sample": [ctypes.c_char_p],
    # one packed block of arguments (Top2Args), built by the wrapper
    "tpu3d_top2": [ctypes.c_char_p],
    # one packed block of arguments (TrilinearArgs), built by the wrapper
    "tpu3d_trilinear": [ctypes.c_char_p],
    # g, min_bound, max_bound, pts, out, X, Y, Z, C, N, vec, stream
    "tpu3d_trilinear_grad": [_P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_int64, _I, _P],
    # one packed block of arguments (OrientDescArgs), built by the wrapper
    "tpu3d_orient_desc": [ctypes.c_char_p],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("tpu3d_torch: nvcc not found; the CUDA kernels "
                           "are built with the CUDA toolkit's nvcc")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _stale(lib: Path) -> bool:
    if not lib.exists():
        return True
    t = lib.stat().st_mtime
    deps = _sources() + sorted(CSRC.glob("*.cuh"))
    return any(p.stat().st_mtime > t for p in deps)


def build(force: bool = False) -> Path:
    """Compile the sources if the library is missing or stale; returns its
    path. Raises with the compiler's output when a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / LIB_NAME
    if not force and not _stale(lib):
        return lib
    nvcc = _nvcc()
    t0 = time.time()
    procs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *ARCH, *FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, objs, failed = [], [], []
    for src, obj, p in procs:
        out, _ = p.communicate()
        logs.append(out)
        objs.append(obj)
        if p.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
    if failed:
        raise RuntimeError("tpu3d_torch: nvcc failed\n" + "\n".join(failed))
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    link = subprocess.run([nvcc, *ARCH, "-shared", *map(str, objs), "-o", str(tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError("tpu3d_torch: nvcc link failed\n" + link.stdout)
    os.replace(tmp, lib)   # atomic: a concurrent loader sees old or new
    BUILD_LOG["seconds"] = time.time() - t0
    BUILD_LOG["ptxas"] = "".join(logs)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


_functions: dict = {}
_raw_stream = None


def function(name: str):
    """The library's C function ``name``, looked up once: a launch does
    not go through :func:`library`'s lock after the first."""
    fn = _functions.get(name)
    if fn is None:
        fn = _functions[name] = getattr(library(), name)
    return fn


def stream(device_index: int) -> int:
    """The raw handle of PyTorch's current stream on a CUDA device, without
    building a ``torch.cuda.Stream`` where the build of PyTorch exposes it."""
    global _raw_stream
    if _raw_stream is None:
        import torch

        _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
            lambda i: torch.cuda.current_stream(i).cuda_stream)
    return _raw_stream(device_index)


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"tpu3d_torch: {name} launch failed with CUDA "
                           f"error {err}")
