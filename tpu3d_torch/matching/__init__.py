"""Retrieval, matching (mutual-NN, and LightGlue in matching/lightglue.py)
and track bookkeeping."""
from tpu3d_torch.matching.bow import (build_codebook, kmeans, tfidf_vectors,
                                      topk_similar, vector_quantize)
from tpu3d_torch.matching.mnn import MatchResult, match_descriptors
from tpu3d_torch.matching.pairs import bfs_pair_order, build_view_graph
from tpu3d_torch.matching.tracks import TrackStore

__all__ = [
    "match_descriptors", "MatchResult", "kmeans", "vector_quantize",
    "tfidf_vectors", "build_codebook", "topk_similar", "build_view_graph",
    "bfs_pair_order", "TrackStore",
]
