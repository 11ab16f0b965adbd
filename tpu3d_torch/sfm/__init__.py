"""Pipeline stages, the incremental engine and the reconstruction."""
