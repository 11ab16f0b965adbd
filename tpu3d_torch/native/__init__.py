"""The native (C++) track-store loops, loaded through ctypes
(tpu3d/native): union-find canonicalization, the per-pair union and the
engine's first-wins observation insert, sequential host work that neither
batches onto the card nor vectorizes in numpy. The library builds at first
use (``build.py``); where it cannot (no compiler) ``available()`` is False
and the callers take their Python versions, which the tests hold equal.

``CALLS`` counts the calls into the library per entry point, so a run can
show that it took the native path.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

CALLS = {"resolve": 0, "union_pair": 0, "record_obs": 0}

_lib = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    from tpu3d_torch.native.build import ensure_built

    path = ensure_built()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    i64 = ctypes.c_int64
    p64 = ctypes.POINTER(ctypes.c_int64)
    pu8 = ctypes.POINTER(ctypes.c_uint8)
    pf32 = ctypes.POINTER(ctypes.c_float)
    lib.ts_resolve.argtypes = [p64, p64, i64]
    lib.ts_resolve.restype = None
    lib.ts_union_pair.argtypes = [p64, i64, p64, i64, i64, i64, p64, p64, i64, i64, p64]
    lib.ts_union_pair.restype = i64
    lib.ts_record_obs.argtypes = [pu8, p64, pf32, i64, i64, p64, p64, pf32, i64]
    lib.ts_record_obs.restype = i64
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def library_path() -> Optional[str]:
    """Where the loaded library lives, or None."""
    return None if _load() is None else _lib._name


def reset_calls() -> None:
    for k in CALLS:
        CALLS[k] = 0


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


def _p64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def resolve(parent: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Canonical track ids of a copy of ``ids`` (-1 passes through);
    compresses paths in ``parent``."""
    lib = _lib_or_raise()
    out = np.ascontiguousarray(ids, np.int64).copy()
    flat = out.reshape(-1)
    lib.ts_resolve(_p64(parent), _p64(flat), len(flat))
    CALLS["resolve"] += 1
    return out.reshape(np.shape(ids))


def union_pair(parent: np.ndarray, kp_track: np.ndarray, img0: int, img1: int,
               idx0: np.ndarray, idx1: np.ndarray, next_track: int) -> tuple:
    """TrackStore.union_pair on the store's arrays. Returns (track ids
    (M,), the new next_track). Raises when the capacity is exceeded."""
    lib = _lib_or_raise()
    idx0 = np.ascontiguousarray(idx0, np.int64)
    idx1 = np.ascontiguousarray(idx1, np.int64)
    out = np.empty(len(idx0), np.int64)
    nt = lib.ts_union_pair(_p64(parent), len(parent), _p64(kp_track), kp_track.shape[1],
                           img0, img1, _p64(idx0), _p64(idx1), len(idx0), next_track,
                           _p64(out))
    CALLS["union_pair"] += 1
    if nt < 0:
        raise RuntimeError("TrackStore capacity exceeded")
    return out, int(nt)


def record_obs(valid: np.ndarray, track: np.ndarray, uv: np.ndarray, kpts_per_image: int,
               img: int, idx: np.ndarray, tr: np.ndarray, uv_in: np.ndarray) -> int:
    """First-wins insert into the dense observation table (slot = img * K
    + kpt); valid (N*K,) uint8, track (N*K,) int64, uv (N*K, 2) float32,
    all contiguous. Returns how many observations were inserted."""
    lib = _lib_or_raise()
    idx = np.ascontiguousarray(idx, np.int64)
    tr = np.ascontiguousarray(tr, np.int64)
    uv_in = np.ascontiguousarray(uv_in, np.float32)
    n = int(lib.ts_record_obs(valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                              _p64(track), uv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                              kpts_per_image, img, _p64(idx), _p64(tr),
                              uv_in.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(idx)))
    CALLS["record_obs"] += 1
    return n
