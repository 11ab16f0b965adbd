"""Dense stage: voxel radiance grid, rendering and held-out evaluation."""
