"""Dense stage: voxel radiance and SDF grids, rendering, training,
held-out evaluation, voxel traversal and meshing."""
from tpu3d_torch.dense.grid import VoxelGrid, eval_sh, trilinear_sample
from tpu3d_torch.dense.render import composite, render_rays
from tpu3d_torch.dense.sdf import SDFGrid, ray_aabb, sample_pdf, sample_stratified
from tpu3d_torch.dense.traversal import voxel_traversal

__all__ = [
    "VoxelGrid",
    "trilinear_sample",
    "eval_sh",
    "render_rays",
    "composite",
    "SDFGrid",
    "ray_aabb",
    "sample_stratified",
    "sample_pdf",
    "voxel_traversal",
]
