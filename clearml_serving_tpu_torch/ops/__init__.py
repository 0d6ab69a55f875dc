"""Operators of the port: hand-written CUDA kernels beside their plain
PyTorch versions (the JAX package's ``ops/`` counterparts)."""
