"""The port's native track store (tpu3d_torch/native) against its Python
path and tpu3d's TrackStore, after tpu3d's tests/test_native.py: union_pair,
resolve, the first-wins observation insert and the capacity check. Integer
bookkeeping, so every comparison is exact. Skipped only where no g++
exists to build the library."""
import shutil
from pathlib import Path

import numpy as np
import pytest

from tpu3d.matching import TrackStore as JaxTrackStore
from tpu3d_torch import native
from tpu3d_torch.matching.tracks import TrackStore
from tpu3d_torch.sfm.engine import IncrementalSfM

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ to build the "
                                "native library")


def _random_pairs(rng, n_img=12, K=64, n_pairs=40):
    pairs = []
    for _ in range(n_pairs):
        i, j = rng.choice(n_img, 2, replace=False)
        m = rng.integers(4, K // 2)
        idx0 = rng.choice(K, m, replace=False)
        idx1 = rng.choice(K, m, replace=False)
        pairs.append((int(i), int(j), idx0.astype(np.int64), idx1.astype(np.int64)))
    return pairs


def _stores(n_img, K, capacity):
    return (TrackStore(n_img, K, capacity=capacity, use_native=False),
            TrackStore(n_img, K, capacity=capacity, use_native=True),
            JaxTrackStore(n_img, K, capacity=capacity, use_native=False))


def test_library_builds_outside_the_source_tree():
    assert native.available()
    path = Path(native.library_path()).resolve()
    root = Path(native.__file__).resolve().parents[2]
    assert path == root / "build" / "tpu3d_torch" / "_trackstore.so"
    assert not list(Path(native.__file__).parent.glob("*.so"))


def test_union_pair_equivalence():
    rng = np.random.default_rng(7)
    py, c, ref = _stores(12, 64, 10_000)
    assert c._native and not py._native
    before = native.CALLS["union_pair"]
    for i, j, idx0, idx1 in _random_pairs(rng):
        outs = [s.union_pair(i, j, idx0, idx1) for s in (py, c, ref)]
        # canonical ids agree after resolve (path compression may leave the
        # parents in other transient states; the roots agree)
        canon = [s.resolve(o) for s, o in zip((py, c, ref), outs)]
        np.testing.assert_array_equal(canon[0], canon[1])
        np.testing.assert_array_equal(canon[0], canon[2])
    assert native.CALLS["union_pair"] - before == 40
    assert py.next_track == c.next_track == ref.next_track
    np.testing.assert_array_equal(py.resolve(py.kp_track), c.resolve(c.kp_track))
    np.testing.assert_array_equal(py.resolve(py.kp_track), ref.resolve(ref.kp_track))


def test_resolve_equivalence():
    rng = np.random.default_rng(3)
    stores = _stores(6, 32, 1000)
    for i, j, idx0, idx1 in _random_pairs(rng, 6, 32, 15):
        for s in stores:
            s.union_pair(i, j, idx0, idx1)
    ids = rng.integers(-1, stores[0].next_track, (20, 25)).astype(np.int64)
    got = [s.resolve(ids) for s in stores]
    assert got[1].shape == ids.shape
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_array_equal(got[0], got[2])


def test_record_obs_first_wins():
    """The native insert against the engine's numpy path on the same
    batches: a duplicate keypoint keeps its first observation, occupied
    slots are kept, and the tables end equal."""
    K = 16
    valid = np.zeros(4 * K, np.uint8)
    track = np.zeros(4 * K, np.int64)
    uv = np.zeros((4 * K, 2), np.float32)
    idx = np.array([3, 5, 3], np.int64)           # duplicate kpt 3
    tr = np.array([10, 11, 99], np.int64)
    uvs = np.array([[1, 2], [3, 4], [7, 7]], np.float32)
    assert native.record_obs(valid, track, uv, K, 2, idx, tr, uvs) == 2
    assert valid[2 * K + 3] and track[2 * K + 3] == 10   # first wins
    assert tuple(uv[2 * K + 5]) == (3.0, 4.0)
    assert native.record_obs(valid, track, uv, K, 2, idx, tr, uvs) == 0

    rng = np.random.default_rng(5)
    engines = []
    for use_native in (True, False):
        eng = IncrementalSfM(4, device="cpu")
        if not use_native:
            eng._native = False
        engines.append(eng)
    assert engines[0]._native
    K = engines[0]._K
    for _ in range(30):
        img = int(rng.integers(0, 4))
        idx = rng.integers(0, K, 50)
        tr = rng.integers(0, 1000, 50)
        uv = rng.normal(0, 100, (50, 2)).astype(np.float32)
        for eng in engines:
            eng._record_obs(img, idx, tr, uv)
    for name in ("obs_valid", "obs_track", "obs_uv"):
        np.testing.assert_array_equal(getattr(engines[0], name), getattr(engines[1], name))


def test_capacity_exceeded():
    for s in _stores(2, 8, 4):
        with pytest.raises(RuntimeError, match="capacity"):
            s.union_pair(0, 1, np.arange(8), np.arange(8))
