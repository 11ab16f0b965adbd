"""Feature front-ends: the classical DoG/SIFT-style one, and the learned
DISK and SuperPoint (features/learned.py)."""
from tpu3d_torch.features.frontend import FeatureSet, extract_features

__all__ = ["FeatureSet", "extract_features"]
