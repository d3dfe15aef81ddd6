"""Functional numerics of the port: attention cores, spectral convolution,
initializers, and the CUDA kernels under ``ops.cuda``."""
