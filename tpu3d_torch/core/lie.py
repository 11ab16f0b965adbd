"""SO(3) helpers in numpy for host-side bookkeeping (tpu3d/core/lie.py:97,112).

The port's own copy of tpu3d's numpy twins; the torch half of tpu3d's module
comes with the reconstruct stage."""
from __future__ import annotations

import numpy as np


def so3_exp_np(w) -> np.ndarray:
    """Rodrigues: axis-angle (3,) -> rotation (3, 3) float32."""
    w = np.asarray(w, np.float64)
    theta = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if theta < 1e-8:
        return (np.eye(3) + K + 0.5 * K @ K).astype(np.float32)
    a = np.sin(theta) / theta
    b = (1 - np.cos(theta)) / theta**2
    return (np.eye(3) + a * K + b * K @ K).astype(np.float32)


def so3_log_np(R) -> np.ndarray:
    """Rotation (3, 3) -> axis-angle (3,) float32, by the quaternion route."""
    R = np.asarray(R, np.float64)
    tr = np.trace(R)
    q = np.empty(4)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q[:] = [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s]
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12)) * 2
        qv = np.empty(3)
        qv[i] = 0.25 * s
        qv[j] = (R[j, i] + R[i, j]) / s
        qv[k] = (R[k, i] + R[i, k]) / s
        q[:] = [(R[k, j] - R[j, k]) / s, *qv]
    if q[0] < 0:
        q = -q
    nv = np.linalg.norm(q[1:])
    if nv < 1e-12:
        return np.zeros(3, np.float32)
    theta = 2.0 * np.arctan2(nv, q[0])
    return (q[1:] / nv * theta).astype(np.float32)
