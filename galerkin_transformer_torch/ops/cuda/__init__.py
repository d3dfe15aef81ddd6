"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version.  Sources live in ``galerkin_transformer_torch/csrc``;
``_build`` compiles them with nvcc on first use."""
