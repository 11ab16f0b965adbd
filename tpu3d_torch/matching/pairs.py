"""View-graph construction and BFS pair ordering (numpy copy of
tpu3d/matching/pairs.py).

Host-side graph logic (tiny: N ≈ hundreds of images) mirroring the
reference's retrieval graph + BFS traversal (matching.py:61-105):
edges where tf-idf cosine similarity exceeds a threshold, start node =
max degree, BFS emitting (reference_image, new_image) pairs, where the
reference image is preferentially an already-visited neighbor of the new
image (matching.py:98-105). The similarity math itself runs on-device
(tpu3d_torch/matching/bow.py); only the queue bookkeeping lives here.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Tuple

import numpy as np


def build_view_graph(
    topk_idx: np.ndarray,
    topk_sim: np.ndarray,
    threshold: float = 0.5,
    min_neighbors: int = 2,
) -> Dict[int, List[int]]:
    """Undirected adjacency from per-image top-k retrieval results.

    Mirrors matching.py:61-73 (including symmetrization), with one
    robustness addition: each image always keeps its `min_neighbors` most
    similar neighbors even below the threshold, so a sequence whose BoW
    similarities run low (descriptor-dependent) still yields a connected
    graph — the downstream E-matrix gate rejects any false edge anyway."""
    n = topk_idx.shape[0]
    adj: Dict[int, List[int]] = {i: [] for i in range(n)}
    for i in range(n):
        for rank, (j, sim) in enumerate(zip(topk_idx[i], topk_sim[i])):
            j = int(j)
            if j == i:
                continue
            if sim > threshold or rank < min_neighbors:
                if j not in adj[i]:
                    adj[i].append(j)
                if i not in adj[j]:
                    adj[j].append(i)
    return adj


def bfs_pair_order(adj: Dict[int, List[int]], start: int | None = None) -> List[Tuple[int, int]]:
    """BFS spanning-tree pair order [(ref_img, new_img), ...].

    Start node = max degree (matching.py:77-82). For each newly reached
    image, the reference image is the first already-visited neighbor if one
    precedes the expanding node in its adjacency list (matching.py:98-105)."""
    if not adj:
        return []
    if start is None:
        start = max(adj, key=lambda i: len(adj[i]))
    visited = {start}
    queue = deque([start])
    pairs: List[Tuple[int, int]] = []
    while queue:
        u = queue.popleft()
        for v in adj[u]:
            if v in visited:
                continue
            ref = u
            for w in adj[v]:
                if w == u:
                    break
                if w in visited:
                    ref = w
                    break
            pairs.append((ref, v))
            visited.add(v)
            queue.append(v)
    return pairs


def connected_order_fallback(n: int) -> List[Tuple[int, int]]:
    """Sequential chain pairing for when retrieval yields no edges (e.g.
    video-like datasets): (0,1), (1,2), ..."""
    return [(i, i + 1) for i in range(n - 1)]
