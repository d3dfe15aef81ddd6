"""Weights of the JAX package's models as state_dicts of the port.

`params_from_jax` takes the JAX parameter tree as nested dicts of numpy
arrays and returns the port's state_dict, whose keys are the original
torch repo's.  A Dense ``kernel`` (in, out) becomes a ``Linear.weight``
(out, in); per-head norm parameters (H, d_k) are split into one
``norm_X.{h}`` per head; ``fourier_weight`` (in, out, modes, 2) keeps its
layout, and the 2D pair ``fourier_weight_pos`` / ``_neg`` becomes
``fourier_weight.0`` / ``.1``.  A convolution kernel (kh, kw, in, out)
becomes a ``Conv2d.weight`` (out, in, kh, kw), a transposed-convolution
kernel a ``ConvTranspose2d.weight`` (in, out, kh, kw).  A vmapped Dense
stack (T, in, out) of the `BulkRegressor` becomes a `BatchedLinear` weight
(T, out, in); the `DenseGeneral` kernels of flax's multi-head attention,
(in, H, d_h) for query, key and value and (H, d_h, out) for out, become
Linear weights (H·d_h, in) and (out, H·d_h); the 2D ``official`` branch's
vanilla blocks map as the 1D ones do, and ``official_proj`` keeps its
name.  The graph extractors' ``gcn_layer{i}`` / ``gat_layer{i}`` become
``gcn_layer0`` and ``gcn_layers.{i-1}`` (``gat_...`` alike), their
``weight``, ``bias``, ``W`` and ``a`` (in, out) unchanged, and the edge
encoder's ``lap_conv1`` / ``lap_conv2`` map as the other convolutions.
A bare ``GalerkinTransformerDecoderLayer``'s ``self_attn`` and
``cross_attn`` map as an encoder layer's ``attn``; its ``norm1``-``norm3``
and ``ff`` keep their names.
The JAX package's
``utils/torch_compat.py::convert_state_dict`` is the inverse map for the
module families it knows.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

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
    (r"encoder_layer(\d+)/attn/(query|key|value|out)_projection",
     "encoder_layers.{0}.attn.{1}_projection"),
    (r"encoder_layer(\d+)/ff/lr([12])", "encoder_layers.{0}.ff.lr{1}"),
    (r"encoder_layer(\d+)/layer_norm([12])", "encoder_layers.{0}.layer_norm{1}"),
    (r"encoder_layer(\d+)/(linear[12]|norm[12])", "encoder_layers.{0}.{1}"),
    # a bare GalerkinTransformerDecoderLayer
    (r"(self_attn|cross_attn)/q_proj", "{0}.linears.0"),
    (r"(self_attn|cross_attn)/k_proj", "{0}.linears.1"),
    (r"(self_attn|cross_attn)/v_proj", "{0}.linears.2"),
    (r"(self_attn|cross_attn)/fc", "{0}.fc"),
    (r"ff/lr([12])", "ff.lr{0}"),
    (r"(norm[123])", "{0}"),
    (r"(freq_fc[12])", "{0}"),
    (r"official_proj", "official_proj"),
    (r"freq_regressor/linear", "freq_regressor.linear"),
    (r"regressor/fc", "regressor.fc"),
    (r"regressor/spectral_conv(\d+)/linear", "regressor.spectral_conv.{0}.linear"),
    (r"regressor/regressor_fc1", "regressor.regressor.0"),
    (r"regressor/regressor_fc2", "regressor.regressor.2"),
    (r"regressor/ff(\d+)", "regressor.ff.{0}.0"),
    (r"regressor/out", "regressor.out"),
]
_CONV_RULES = [   # the convolution `conv` or `conv1` of a Conv2dResBlock
    (r"feat_extract/edge_learner/(lap_conv[12])/(conv1?)", "feat_extract.edge_learner.{0}.{1}.0"),
    (r"downscaler/interp/(conv\d)/(conv1?)", "downscaler.downsample.{0}.{1}.0"),
    (r"downscaler/conv([01])/(conv\d)/(conv1?)", "downscaler.downsample.{0}.{1}.{2}.0"),
    (r"upscaler/interp/conv/(conv1?)", "upscaler.upsample.conv.0.{0}.0"),
]
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def params_from_jax(tree: Mapping, random_features: Optional[Mapping] = None
                    ) -> Dict[str, torch.Tensor]:
    """JAX SimpleTransformer, FourierTransformer2D,
    FourierTransformer2DLite, RandomFourierTransformer or
    GalerkinTransformerDecoderLayer params (nested
    dicts of arrays) -> state_dict.  `random_features`, the JAX
    ``random_features`` collection of a random-feature model, adds each
    layer's ω (``encoder_layers.{i}.attn.omega``).

    Raises KeyError on a parameter this port has no place for."""
    sd: Dict[str, torch.Tensor] = {}
    for path, val in _flatten(random_features or {}).items():
        m = re.fullmatch(r"encoder_layer(\d+)/attn/omega", "/".join(path))
        if m is None:
            raise KeyError(f"no port buffer for JAX random feature {'/'.join(path)!r}")
        sd[f"encoder_layers.{m.group(1)}.attn.omega"] = torch.from_numpy(
            np.array(val, dtype=np.float32))
    for path, val in _flatten(tree).items():
        key = "/".join(path)
        m = re.fullmatch(r"feat_extract/(gcn|gat)_layer(\d+)/(weight|bias|W|a)", key)
        if m:   # the graph layers' own parameters, (in, out) in both packages
            i = int(m.group(2))
            name = f"{m.group(1)}_layer0" if i == 0 else f"{m.group(1)}_layers.{i - 1}"
            sd[f"feat_extract.{name}.{m.group(3)}"] = torch.from_numpy(
                np.array(val, dtype=np.float32))
            continue
        m = re.fullmatch(r"(encoder_layer\d+/attn|self_attn|cross_attn)/"
                         r"norm_([KQV])_(scale|bias)", key)
        if m:
            leaf = _LEAF[m.group(3)]
            attn = re.sub(r"encoder_layer(\d+)/attn", r"encoder_layers.\1.attn", m.group(1))
            for h, row in enumerate(val):
                sd[f"{attn}.norm_{m.group(2)}.{h}.{leaf}"] = \
                    torch.from_numpy(np.array(row, dtype=np.float32))
            continue
        m = re.fullmatch(r"regressor/spectral_conv(\d+)/fourier_weight(_pos|_neg)?", key)
        if m:
            corner = {None: "", "_pos": ".0", "_neg": ".1"}[m.group(2)]
            sd[f"regressor.spectral_conv.{m.group(1)}.fourier_weight{corner}"] = \
                torch.from_numpy(np.array(val, dtype=np.float32))
            continue
        module, leaf = "/".join(path[:-1]), path[-1]
        m = re.fullmatch(r"freq_regressor/(freq_fc[12])", module)
        if m:   # a vmapped Dense stack: kernel (T, in, out), bias (T, out)
            arr = val.transpose(0, 2, 1) if leaf == "kernel" else val
            sd[f"freq_regressor.{m.group(1)}.{_LEAF[leaf]}"] = \
                torch.from_numpy(np.array(arr, dtype=np.float32))
            continue
        m = re.fullmatch(r"encoder_layer(\d+)/self_attn/(query|key|value|out)", module)
        if m:   # DenseGeneral: (in, H, d_h) or (H, d_h, out) kernels
            if leaf == "kernel" and m.group(2) == "out":
                arr = val.reshape(-1, val.shape[-1]).T
            elif leaf == "kernel":
                arr = val.reshape(val.shape[0], -1).T
            else:
                arr = val.reshape(-1)
            sd[f"encoder_layers.{m.group(1)}.self_attn.{m.group(2)}.{_LEAF[leaf]}"] = \
                torch.from_numpy(np.array(arr, dtype=np.float32))
            continue
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


_GROUP = re.compile(r"\(([^()]*)\)")


def _reversed(rules):
    """(port regex, JAX path template) for each (JAX regex, port template):
    the k-th group of the JAX pattern is the port name's ``{k}``."""
    out = []
    for pattern, name in rules:
        groups = _GROUP.findall(pattern)
        regex = re.escape(name)
        for k, group in enumerate(groups):
            regex = regex.replace(re.escape("{%d}" % k), f"({group})")
        counter = iter(range(len(groups)))
        out.append((regex, _GROUP.sub(lambda m: "{%d}" % next(counter), pattern)))
    return out


_MODULE_RULES_BACK = _reversed(_MODULE_RULES)
_CONV_RULES_BACK = _reversed(_CONV_RULES)


def params_to_jax(state_dict: Mapping[str, torch.Tensor], n_head=None) -> dict:
    """The inverse of `params_from_jax`: a state_dict of the port's models
    -> the JAX parameter tree (nested dicts of float32 numpy arrays).  A
    1-D ``weight`` is a LayerNorm ``scale``; `n_head` splits the flax
    multi-head attention kernels of the vanilla blocks (H, d_h) and is
    needed only where they are.  Raises KeyError on a key that has no JAX
    parameter."""
    tree: dict = {}

    def put(path: str, value):
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(value, dtype=np.float32)

    heads: Dict[tuple, dict] = {}
    for key, tensor in state_dict.items():
        val = tensor.detach().float().cpu().numpy()
        m = re.fullmatch(r"feat_extract\.(gcn|gat)_layer(?:0|s\.(\d+))\.(weight|bias|W|a)", key)
        if m:
            i = 0 if m.group(2) is None else int(m.group(2)) + 1
            put(f"feat_extract/{m.group(1)}_layer{i}/{m.group(3)}", val)
            continue
        m = re.fullmatch(r"(encoder_layers\.\d+\.attn|self_attn|cross_attn)\."
                         r"norm_([KQV])\.(\d+)\.(weight|bias)", key)
        if m:
            attn = re.sub(r"encoder_layers\.(\d+)\.attn", r"encoder_layer\1/attn", m.group(1))
            heads.setdefault((attn, m.group(2), m.group(4)), {})[int(m.group(3))] = val
            continue
        m = re.fullmatch(r"regressor\.spectral_conv\.(\d+)\.fourier_weight(\.[01])?", key)
        if m:
            corner = {None: "", ".0": "_pos", ".1": "_neg"}[m.group(2)]
            put(f"regressor/spectral_conv{m.group(1)}/fourier_weight{corner}", val)
            continue
        module, leaf = key.rsplit(".", 1)
        m = re.fullmatch(r"freq_regressor\.(freq_fc[12])", module)
        if m:
            put(f"freq_regressor/{m.group(1)}/{'kernel' if leaf == 'weight' else 'bias'}",
                val.transpose(0, 2, 1) if leaf == "weight" else val)
            continue
        m = re.fullmatch(r"encoder_layers\.(\d+)\.self_attn\.(query|key|value|out)", module)
        if m:
            if n_head is None:
                raise ValueError(f"{key}: n_head is needed to split the multi-head kernels")
            path = f"encoder_layer{m.group(1)}/self_attn/{m.group(2)}"
            if m.group(2) == "out":
                put(f"{path}/{'kernel' if leaf == 'weight' else 'bias'}",
                    val.T.reshape(n_head, -1, val.shape[0]) if leaf == "weight" else val)
            else:
                put(f"{path}/{'kernel' if leaf == 'weight' else 'bias'}",
                    val.T.reshape(val.shape[1], n_head, -1) if leaf == "weight"
                    else val.reshape(n_head, -1))
            continue
        conv = next((path.format(*m.groups()) for regex, path in _CONV_RULES_BACK
                     for m in [re.fullmatch(regex, module)] if m), None)
        if conv is not None and leaf == "weight":   # (out, in, kh, kw) -> (kh, kw, in, out)
            put(f"{conv}/kernel", val.transpose(2, 3, 1, 0))
            continue
        for regex, path in _MODULE_RULES_BACK:
            m = re.fullmatch(regex, module)
            if m and leaf in ("weight", "bias"):
                if leaf == "bias":
                    name, arr = "bias", val
                elif val.ndim == 1:
                    name, arr = "scale", val
                elif val.ndim == 4:   # transposed conv: (in, out, kh, kw) -> (kh, kw, in, out)
                    name, arr = "kernel", val.transpose(2, 3, 0, 1)
                else:
                    name, arr = "kernel", val.T
                put(f"{path.format(*m.groups())}/{name}", arr)
                break
        else:
            raise KeyError(f"no JAX parameter for port parameter {key!r}")
    for (attn, which, leaf), rows in heads.items():
        put(f"{attn}/norm_{which}_{'scale' if leaf == 'weight' else 'bias'}",
            np.stack([rows[h] for h in range(len(rows))]))
    return tree
