"""Host-side I/O: images, PLY, the artifact store (tpu3d/io)."""
from tpu3d_torch.io.artifacts import ArtifactStore
from tpu3d_torch.io.images import list_images, load_image_batch, load_images
from tpu3d_torch.io.ply import filter_point_cloud, write_ply

__all__ = ["list_images", "load_images", "load_image_batch", "write_ply",
           "filter_point_cloud", "ArtifactStore"]
