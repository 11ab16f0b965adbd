"""The plain reference: plain PyTorch and numpy, importing nothing of the
program, the JAX package or JAX."""
