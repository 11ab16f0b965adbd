"""Bundle adjustment: reprojection residuals, closed-form Jacobian blocks and
the Schur-reduced Levenberg-Marquardt solver (tpu3d/ba)."""
from tpu3d_torch.ba.lm import BAState, ba_cost, bundle_adjust
from tpu3d_torch.ba.residuals import observation_jacobians, reprojection_residuals

__all__ = ["BAState", "ba_cost", "bundle_adjust", "observation_jacobians",
           "reprojection_residuals"]
