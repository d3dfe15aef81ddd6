"""PyTorch/CUDA port of the JAX package (the TPU build) for NVIDIA Hopper.

Mirrors the JAX package's module layout.  Plain tensor code is PyTorch;
every Pallas TPU kernel on a ported path is a hand-written CUDA C++
kernel under ``csrc/``, built with ``nvcc`` on first use and bound with
``ctypes`` (``ops/cuda``).  Importing this package imports neither jax
nor anything of the JAX package, and builds nothing.

Entry points (``SimpleTransformer``, ``FourierTransformer2D``,
``Predictor``) run on ``cuda``
unless the caller passes ``device="cpu"``; without a GPU they raise.
"""
from .models import FourierTransformer2D, SimpleTransformer
from .serve import Predictor
from .utils import load_config

__all__ = ["SimpleTransformer", "FourierTransformer2D", "Predictor",
           "load_config"]
