"""Functional numerics of the port: attention cores, spectral convolution,
interpolation, initializers, sparse edges, and the CUDA kernels under
``ops.cuda`` (built on first use, never at import)."""
from .attention import (causal_linear_attention, cosine_attention, fourier_attention,
                        galerkin_attention, galerkin_attention_pos_blocked,
                        per_head_instance_norm, per_head_layer_norm, softmax_attention)
from .init import diagonal_dominant_init, scaled_xavier_normal, scaled_xavier_uniform
from .interp import bilinear_resize, interp_matrix, resolve_interp_size
from .sparse import densify_edges, edges_to_bcoo
from .spectral import (complex_einsum, spectral_conv_1d, spectral_conv_1d_dft,
                       spectral_conv_2d, spectral_conv_2d_dft)

__all__ = [
    "galerkin_attention", "fourier_attention", "softmax_attention",
    "cosine_attention", "causal_linear_attention",
    "per_head_layer_norm", "per_head_instance_norm",
    "bilinear_resize", "interp_matrix", "resolve_interp_size",
    "spectral_conv_1d", "spectral_conv_2d", "complex_einsum",
    "spectral_conv_1d_dft", "spectral_conv_2d_dft",
    "diagonal_dominant_init", "scaled_xavier_uniform", "scaled_xavier_normal",
    "galerkin_attention_pos_blocked", "densify_edges", "edges_to_bcoo",
]
