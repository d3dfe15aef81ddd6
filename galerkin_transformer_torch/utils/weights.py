"""Weights of the JAX package's models as state_dicts of the port.

`params_from_jax` takes the JAX parameter tree as nested dicts of numpy
arrays and returns the port's state_dict, whose keys are the original
torch repo's.  A Dense ``kernel`` (in, out) becomes a ``Linear.weight``
(out, in); per-head norm parameters (H, d_k) are split into one
``norm_X.{h}`` per head; ``fourier_weight`` (in, out, modes, 2) keeps its
layout, and the 2D pair ``fourier_weight_pos`` / ``_neg`` becomes
``fourier_weight.0`` / ``.1``.  A convolution kernel (kh, kw, in, out)
becomes a ``Conv2d.weight`` (out, in, kh, kw), a transposed-convolution
kernel a ``ConvTranspose2d.weight`` (in, out, kh, kw).  The JAX package's
``utils/torch_compat.py::convert_state_dict`` is the inverse map for the
module families it knows.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


_MODULE_RULES = [   # (JAX module path, port module name); \d groups carried
    (r"feat_extract/id", "feat_extract.id"),
    (r"downscaler/id", "downscaler.id"),
    (r"downscaler/interp/(conv\d)/res/shortcut", "downscaler.downsample.{0}.res.shortcut"),
    (r"upscaler/interp/conv/res/shortcut", "upscaler.upsample.conv.0.res.shortcut"),
    (r"downscaler/conv([01])/(conv\d)/res/shortcut", "downscaler.downsample.{0}.{1}.res.shortcut"),
    (r"upscaler/deconv([01])/deconv([01])", "upscaler.upsample.{0}.deconv{1}"),
    (r"encoder_layer(\d+)/attn/q_proj", "encoder_layers.{0}.attn.linears.0"),
    (r"encoder_layer(\d+)/attn/k_proj", "encoder_layers.{0}.attn.linears.1"),
    (r"encoder_layer(\d+)/attn/v_proj", "encoder_layers.{0}.attn.linears.2"),
    (r"encoder_layer(\d+)/attn/fc", "encoder_layers.{0}.attn.fc"),
    (r"encoder_layer(\d+)/ff/lr([12])", "encoder_layers.{0}.ff.lr{1}"),
    (r"encoder_layer(\d+)/layer_norm([12])", "encoder_layers.{0}.layer_norm{1}"),
    (r"regressor/fc", "regressor.fc"),
    (r"regressor/spectral_conv(\d+)/linear", "regressor.spectral_conv.{0}.linear"),
    (r"regressor/regressor_fc1", "regressor.regressor.0"),
    (r"regressor/regressor_fc2", "regressor.regressor.2"),
    (r"regressor/ff(\d+)", "regressor.ff.{0}.0"),
    (r"regressor/out", "regressor.out"),
]
_CONV_RULES = [   # the convolution `conv` or `conv1` of a Conv2dResBlock
    (r"downscaler/interp/(conv\d)/(conv1?)", "downscaler.downsample.{0}.{1}.0"),
    (r"downscaler/conv([01])/(conv\d)/(conv1?)", "downscaler.downsample.{0}.{1}.{2}.0"),
    (r"upscaler/interp/conv/(conv1?)", "upscaler.upsample.conv.0.{0}.0"),
]
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX SimpleTransformer or FourierTransformer2D params (nested dicts
    of arrays) -> state_dict.

    Raises KeyError on a parameter this port has no place for."""
    sd: Dict[str, torch.Tensor] = {}
    for path, val in _flatten(tree).items():
        key = "/".join(path)
        m = re.fullmatch(r"encoder_layer(\d+)/attn/norm_([KQV])_(scale|bias)", key)
        if m:
            leaf = _LEAF[m.group(3)]
            for h, row in enumerate(val):
                sd[f"encoder_layers.{m.group(1)}.attn.norm_{m.group(2)}.{h}.{leaf}"] = \
                    torch.from_numpy(np.array(row, dtype=np.float32))
            continue
        m = re.fullmatch(r"regressor/spectral_conv(\d+)/fourier_weight(_pos|_neg)?", key)
        if m:
            corner = {None: "", "_pos": ".0", "_neg": ".1"}[m.group(2)]
            sd[f"regressor.spectral_conv.{m.group(1)}.fourier_weight{corner}"] = \
                torch.from_numpy(np.array(val, dtype=np.float32))
            continue
        module, leaf = "/".join(path[:-1]), path[-1]
        conv = next((name.format(*m.groups()) for pattern, name in _CONV_RULES
                     for m in [re.fullmatch(pattern, module)] if m), None)
        if conv is not None and leaf == "kernel":   # (kh, kw, in, out) -> (out, in, kh, kw)
            sd[f"{conv}.weight"] = torch.from_numpy(
                np.array(val.transpose(3, 2, 0, 1), dtype=np.float32))
            continue
        for pattern, name in _MODULE_RULES:
            m = re.fullmatch(pattern, module)
            if m and leaf in _LEAF:
                if leaf == "kernel" and val.ndim == 4:   # transposed conv: (in, out, kh, kw)
                    arr = val.transpose(2, 3, 0, 1)
                else:
                    arr = val.T if leaf == "kernel" else val
                sd[f"{name.format(*m.groups())}.{_LEAF[leaf]}"] = \
                    torch.from_numpy(np.array(arr, dtype=np.float32))
                break
        else:
            raise KeyError(f"no port parameter for JAX parameter {key!r}")
    return sd
