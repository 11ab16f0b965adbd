"""Classical DoG/SIFT-style feature front-end."""
from tpu3d_torch.features.frontend import FeatureSet, extract_features

__all__ = ["FeatureSet", "extract_features"]
