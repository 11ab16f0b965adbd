"""Surface extraction from the trained density grid by marching tetrahedra
(tpu3d/dense/mesh.py; the port's own copy of that numpy module).

Marching tetrahedra over the 6-tetrahedron cube split has a small case
table with no ambiguous saddle configurations. It runs once per scene on
the host, over the saved ``mesh_grid``, and selects its cells by the data,
so it stays numpy.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# Cube corner offsets (x, y, z) and the standard 6-tetrahedron split of a
# cube around the 0-6 diagonal.
_CORNERS = np.array(
    [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
     (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)], np.int64)
_TETS = np.array(
    [(0, 5, 1, 6), (0, 1, 2, 6), (0, 2, 3, 6),
     (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6)], np.int64)


def _tet_case_table():
    """triangles-per-inside-mask for one tetrahedron: each triangle is 3
    edges, each edge a (corner, corner) pair of the tet (0..3)."""
    table = []
    for mask in range(16):
        inside = [i for i in range(4) if mask >> i & 1]
        outside = [i for i in range(4) if not mask >> i & 1]
        if len(inside) in (0, 4):
            table.append([])
        elif len(inside) == 1:
            a = inside[0]
            table.append([[(a, outside[0]), (a, outside[1]), (a, outside[2])]])
        elif len(inside) == 3:
            a = outside[0]
            table.append([[(a, inside[0]), (a, inside[2]), (a, inside[1])]])
        else:
            a, b = inside
            c, d = outside
            table.append([[(a, c), (a, d), (b, d)],
                          [(a, c), (b, d), (b, c)]])
    return table


_CASES = _tet_case_table()


def marching_tetrahedra(
    sigma: np.ndarray,
    iso: float,
    min_bound,
    max_bound,
    colors: Optional[np.ndarray] = None,
    chunk_cells: int = 2_000_000,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Extract the iso-surface sigma == iso.

    sigma: (X, Y, Z); colors: optional (X, Y, Z, 3) sampled per vertex by
    edge interpolation. Returns (verts (V, 3) world coords, faces (F, 3)
    int32 into verts, vert_colors (V, 3) or None). Grid nodes sit at
    min_bound + i/(res-1) * extent per axis (align-corners convention,
    matching the renderer)."""
    X, Y, Z = sigma.shape
    mn = np.asarray(min_bound, np.float64)
    mx = np.asarray(max_bound, np.float64)
    step = (mx - mn) / (np.array([X, Y, Z]) - 1.0)

    # Straddling cells: some corner above AND some below the iso level.
    above = sigma > iso
    cell_any = np.zeros((X - 1, Y - 1, Z - 1), bool)
    cell_all = np.ones((X - 1, Y - 1, Z - 1), bool)
    for dx, dy, dz in _CORNERS:
        c = above[dx : X - 1 + dx, dy : Y - 1 + dy, dz : Z - 1 + dz]
        cell_any |= c
        cell_all &= c
    sel = np.argwhere(cell_any & ~cell_all)  # (N, 3) cell base indices
    tris = []
    cols = []
    for s0 in range(0, len(sel), chunk_cells):
        base = sel[s0 : s0 + chunk_cells]               # (n, 3)
        idx = base[:, None, :] + _CORNERS[None]         # (n, 8, 3)
        v = sigma[idx[..., 0], idx[..., 1], idx[..., 2]]  # (n, 8)
        p = mn + idx * step                             # (n, 8, 3)
        col = (colors[idx[..., 0], idx[..., 1], idx[..., 2]]
               if colors is not None else None)
        for tet in _TETS:
            tv = v[:, tet]                              # (n, 4)
            mask = ((tv > iso) << np.arange(4)).sum(-1)  # (n,)
            for case in range(1, 15):
                rows = np.nonzero(mask == case)[0]
                if len(rows) == 0:
                    continue
                for tri in _CASES[case]:
                    vert3 = []
                    col3 = []
                    for (a, b) in tri:
                        ca, cb = tet[a], tet[b]
                        va = v[rows, ca]
                        vb = v[rows, cb]
                        t = (iso - va) / np.where(
                            np.abs(vb - va) < 1e-12, 1e-12, vb - va)
                        t = np.clip(t, 0.0, 1.0)[:, None]
                        vert3.append(p[rows, ca] * (1 - t) + p[rows, cb] * t)
                        if col is not None:
                            col3.append(col[rows, ca] * (1 - t) + col[rows, cb] * t)
                    tris.append(np.stack(vert3, 1))     # (r, 3, 3)
                    if col is not None:
                        cols.append(np.stack(col3, 1))
    if not tris:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32),
                np.zeros((0, 3), np.float32) if colors is not None else None)
    verts = np.concatenate(tris).reshape(-1, 3).astype(np.float32)
    faces = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
    vcols = (np.concatenate(cols).reshape(-1, 3).astype(np.float32)
             if cols else None)
    return verts, faces, vcols


def dedup_mesh(verts: np.ndarray, faces: np.ndarray,
               vcols: Optional[np.ndarray] = None, decimals: int = 6):
    """Merge duplicate vertices (triangle-soup output shares every interior
    edge vertex ~4-6x); keeps viewers and file sizes sane."""
    key = np.round(verts, decimals)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    # first occurrence index per unique vertex for color/exact-coord pick
    first = np.full(len(uniq), -1, np.int64)
    order = np.arange(len(verts))[::-1]
    first[inv[::-1]] = order
    new_verts = verts[first]
    new_faces = inv[faces].astype(np.int32)
    # drop degenerate faces
    good = ((new_faces[:, 0] != new_faces[:, 1])
            & (new_faces[:, 1] != new_faces[:, 2])
            & (new_faces[:, 0] != new_faces[:, 2]))
    new_cols = vcols[first] if vcols is not None else None
    return new_verts, new_faces[good], new_cols
