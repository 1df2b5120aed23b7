"""SPIN serving in PyTorch on CUDA: the port of the JAX package ``repro``."""
