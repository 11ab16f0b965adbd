"""Pipeline stages, the incremental engine and the reconstruction (tpu3d/sfm)."""
from tpu3d_torch.sfm.engine import (EdgeObservations, ImageRegistration, IncrementalSfM,
                                    PairObservations)
from tpu3d_torch.sfm.scene import Reconstruction

__all__ = ["EdgeObservations", "ImageRegistration", "IncrementalSfM", "PairObservations",
           "Reconstruction"]
