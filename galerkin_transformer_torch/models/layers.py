"""Core layers (counterpart of ``models/layers.py``): feed-forward, Galerkin
and Fourier attention, 1D and 2D spectral convolutions.

Modules are built on the CPU from an explicit ``torch.Generator`` and
moved by the entry point that owns them.  Parameter names follow the
original torch repo, so ``utils/torch_compat.py::convert_state_dict`` of
the JAX package maps a state_dict of this port onto its parameter tree.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from ..ops import attention as A
from ..ops import spectral as S
from ..ops.cuda.fourier import MAX_D as FOURIER_MAX_D
from ..ops.cuda.fourier import fourier_attention_tiled
from ..ops.cuda.galerkin import MAX_D as GALERKIN_MAX_D
from ..ops.cuda.galerkin import galerkin_attention_fused
from ..ops.init import diagonal_dominant_init
from ..utils.misc import default

ACTIVATIONS: Dict[str, Callable] = {
    "silu": F.silu,
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu's default
    "elu": F.elu,
    "leaky_relu": F.leaky_relu,
    "identity": lambda x: x,
}

FOURIER_TYPES = ("fourier", "integral", "local")


def get_activation(name: Optional[str], fallback: str = "relu") -> Callable:
    return ACTIVATIONS[default(name, fallback)]


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


@torch.no_grad()
def torch_linear_init(linear: nn.Linear, g: torch.Generator) -> nn.Linear:
    """torch's nn.Linear default, U(±1/√fan_in) for weight and bias, drawn
    from `g`."""
    bound = float(linear.in_features) ** -0.5
    linear.weight.uniform_(-bound, bound, generator=g)
    if linear.bias is not None:
        linear.bias.uniform_(-bound, bound, generator=g)
    return linear


def linear(in_features: int, out_features: int,
           g: torch.Generator) -> nn.Linear:
    """An nn.Linear with torch's default init drawn from `g` (the global RNG
    is never touched)."""
    return torch_linear_init(skip_init(nn.Linear, in_features, out_features), g)


def dense(lin: nn.Linear, x: torch.Tensor,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """`lin(x)`, or with a compute `dtype` what flax's ``Dense(dtype=...)``
    does: input, weight and bias are cast to `dtype`, the product is
    rounded to it, and the bias is added in it.  The parameters stay
    float32."""
    if dtype is None:
        return lin(x)
    y = F.linear(x.to(dtype), lin.weight.to(dtype))
    return y if lin.bias is None else y + lin.bias.to(dtype)


class Activation(nn.Module):
    """An entry of ACTIVATIONS as a module, for ``nn.Sequential``."""

    def __init__(self, name: Optional[str], fallback: str = "relu"):
        super().__init__()
        self.name = default(name, fallback)
        self.fn = ACTIVATIONS[self.name]

    def forward(self, x):
        return self.fn(x)

    def extra_repr(self) -> str:
        return self.name


class Identity(nn.Module):
    """The linear lift of the reference's Identity (layers.py:71-81)."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.id = linear(in_features, out_features, _generator(generator))

    def forward(self, x):
        return self.id(x)


class FeedForward(nn.Module):
    """Linear -> activation -> dropout -> Linear (layers.py:954-987)."""

    def __init__(self, in_dim: int = 256, dim_feedforward: int = 1024,
                 out_dim: Optional[int] = None,
                 activation: Optional[str] = "relu", dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = _generator(generator)
        # activation None resolves to relu (layers.py:47-48)
        self.act = get_activation(activation, "relu")
        self.dtype = dtype   # compute dtype (parameters stay float32)
        self.lr1 = linear(in_dim, dim_feedforward, g)
        self.dropout = nn.Dropout(dropout)
        self.lr2 = linear(dim_feedforward, default(out_dim, in_dim), g)

    def forward(self, x):
        x = self.dropout(self.act(dense(self.lr1, x, self.dtype)))
        return dense(self.lr2, x, self.dtype)


class SimpleAttention(nn.Module):
    """Multi-head softmax-free attention with per-head pre-matmul norm
    (layers.py:125-377; reference libs/layers.py:764-951).

    * Q, K, V: three d_model→d_model Linear layers (``linears.{0,1,2}``)
      with diagonal-dominant init and zero bias.
    * galerkin: per-head norm on K and V (``norm_K``, ``norm_V``); fourier:
      on K and Q (``norm_K``, ``norm_Q``).  Layer norm or, with
      ``norm_type='instance'``, instance norm over the sequence.
    * pos is repeated per head and concatenated in front of q, k, v after
      the norm; ``fc`` projects (d_model + n_head·pos_dim) back to d_model.
    * score dropout acts on the reduced score matrix.

    Kernels: galerkin with layer norm runs ``galerkin_scores``; fourier runs
    ``fourier_chain``, each where the head fits the kernel (d_k + pos_dim
    <= 128 columns; a wider head takes the JAX package's XLA route: per-head
    LN and the block form, or the dense fourier scores).  On CUDA tensors
    those launch the hand-written
    kernels (the float32 ones, or with ``dtype=torch.bfloat16`` the
    bfloat16 tensor-core ones), on CPU tensors their plain versions.  With
    a compute `dtype` the projections and ``fc`` run as `dense` does; the
    parameters stay float32.  The other attention
    types, masks, the mass-weight hook and fourier score dropout in
    training (the n×n scores are never formed) are not ported and raise.
    """

    def __init__(self, n_head: int, d_model: int, pos_dim: int = 1,
                 attention_type: str = "fourier", dropout: float = 0.1,
                 score_dropout: Optional[float] = None,
                 xavier_init: float = 1e-4, diagonal_weight: float = 1e-2,
                 symmetric_init: bool = False, norm: bool = False,
                 norm_type: str = "layer", eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if d_model % n_head:
            raise ValueError(f"d_model={d_model} is not a multiple of "
                             f"n_head={n_head}")
        if attention_type != "galerkin" and attention_type not in FOURIER_TYPES:
            raise NotImplementedError(
                f"attention_type={attention_type!r} is not ported "
                f"(ported: galerkin, {', '.join(FOURIER_TYPES)})")
        if xavier_init <= 0:
            raise NotImplementedError("xavier_init <= 0 (lecun_normal init) "
                                      "is not ported")
        if norm_type not in ("layer", "instance"):
            raise ValueError(f"norm_type must be 'layer' or 'instance', "
                             f"got {norm_type!r}")
        g = _generator(generator)
        self.n_head, self.d_model, self.pos_dim = n_head, d_model, pos_dim
        self.d_k = d_model // n_head
        self.attention_type = attention_type
        self.is_galerkin = attention_type == "galerkin"
        self.score_rate = default(score_dropout, dropout)
        self.norm, self.norm_type, self.eps = norm, norm_type, eps
        self.dtype = dtype

        self.linears = nn.ModuleList()
        for _ in range(3):
            lin = skip_init(nn.Linear, d_model, d_model)
            diagonal_dominant_init(lin.weight.data, g, xavier_init,
                                   diagonal_weight, symmetric_init)
            lin.bias.data.zero_()
            self.linears.append(lin)

        if norm:
            norm_cls = (nn.LayerNorm if norm_type == "layer"
                        else lambda d: nn.InstanceNorm1d(d, affine=True))
            second = "norm_V" if self.is_galerkin else "norm_Q"
            self.norm_K = nn.ModuleList(norm_cls(self.d_k) for _ in range(n_head))
            setattr(self, second,
                    nn.ModuleList(norm_cls(self.d_k) for _ in range(n_head)))
        self.fc = (linear(d_model + n_head * pos_dim, d_model, g)
                   if pos_dim > 0 else None)

    def _affine(self, name: str):
        mods = getattr(self, f"norm_{name}")
        return (torch.stack([m.weight for m in mods]),
                torch.stack([m.bias for m in mods]))

    def _head_norm(self, x, name: str):
        fn = (A.per_head_layer_norm if self.norm_type == "layer"
              else A.per_head_instance_norm)
        scale, bias = self._affine(name)
        return fn(x, scale.to(x.dtype), bias.to(x.dtype), eps=self.eps)

    def _score_dropout(self, scores):
        return F.dropout(scores, self.score_rate, self.training)

    def forward(self, query, key, value, pos=None, mask=None, weight=None):
        if mask is not None:
            raise NotImplementedError("attention masks are not ported")
        if weight is not None:
            raise NotImplementedError("the mass-weight hook is not ported")
        bsz, n = query.shape[0], query.shape[1]
        h, d_k = self.n_head, self.d_k

        def split_heads(x):   # (B, n, d_model) -> (B, H, n, d_k)
            return x.reshape(bsz, -1, h, d_k).transpose(1, 2)

        q, k, v = (split_heads(dense(lin, x, self.dtype)) for lin, x
                   in zip(self.linears, (query, key, value)))
        pos_in = None
        if pos is not None and self.pos_dim > 0:
            if pos.shape[-1] != self.pos_dim:
                raise ValueError(f"pos has {pos.shape[-1]} columns, the layer "
                                 f"was built for pos_dim={self.pos_dim}")
            pos_in = pos.contiguous()

        # the kernels take d_k + p <= 128 columns; a wider head takes the JAX
        # package's own route for it (XLA there): per-head LN and the block
        # form for galerkin, the dense scores for fourier.  Decided from the
        # shapes, before any launch.
        p = 0 if pos_in is None else self.pos_dim
        if self.is_galerkin and self.norm and self.norm_type == "layer" \
                and d_k + p <= GALERKIN_MAX_D:
            sk, bk = self._affine("K")
            sv, bv = self._affine("V")
            x, p_attn = galerkin_attention_fused(
                q, k.contiguous(), v.contiguous(), pos_in, sk, bk, sv, bv,
                eps=self.eps, score_dropout=self._score_dropout)
        elif self.is_galerkin:
            if self.norm:
                k, v = self._head_norm(k, "K"), self._head_norm(v, "V")
            if pos_in is not None:
                x, p_attn = A.galerkin_attention_pos_blocked(
                    q, k, v, pos_in, score_dropout=self._score_dropout)
            else:
                p_attn = self._score_dropout(A.galerkin_attention(q, k, v)[1])
                x = torch.matmul(q.float(), p_attn.float()).to(q.dtype)
        else:
            if self.norm:
                k, q = self._head_norm(k, "K"), self._head_norm(q, "Q")
            if pos_in is not None:
                ph = pos_in[:, None].expand(bsz, h, n, self.pos_dim).to(q.dtype)
                q, k, v = (torch.cat([ph, t], dim=-1) for t in (q, k, v))
            if self.training and self.score_rate > 0.0:
                raise NotImplementedError("fourier score dropout in training "
                                          "is not ported")
            if d_k + p <= FOURIER_MAX_D:
                x = fourier_attention_tiled(q.contiguous(), k.contiguous(),
                                            v.contiguous())
                p_attn = None
            else:
                x, p_attn = A.fourier_attention(q, k, v)

        out = x.transpose(1, 2).reshape(bsz, n, -1)
        if pos_in is not None:
            out = dense(self.fc, out, self.dtype)
        return out, p_attn


class SpectralConv1d(nn.Module):
    """FNO1d layer: linear residual + mode-truncated spectral conv
    (layers.py:380-424; reference libs/layers.py:1040-1106).

    ``fourier_weight`` is stored as real pairs (in, out, modes, 2), the
    reference's layout, with torch ``xavier_normal_(gain=1/(in·out))``
    statistics on that tensor.  The transform is the DFT-as-products form
    (norm='ortho'); ``ops.spectral.spectral_conv_1d`` is its FFT cross-check.
    """

    def __init__(self, in_dim: int, out_dim: int, modes: int,
                 dropout: float = 0.1, activation: Optional[str] = "silu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = _generator(generator)
        self.act = get_activation(activation, "silu")
        self.linear = linear(in_dim, out_dim, g)
        self.dropout = nn.Dropout(dropout)
        gain = 1.0 / (in_dim * out_dim)
        std = gain * math.sqrt(2.0 / ((in_dim + out_dim) * modes * 2))
        w = torch.empty(in_dim, out_dim, modes, 2).normal_(0.0, std, generator=g)
        self.fourier_weight = nn.Parameter(w)

    def forward(self, x):
        res = self.linear(x)
        x = self.dropout(x)
        w = torch.complex(self.fourier_weight[..., 0], self.fourier_weight[..., 1])
        out = S.spectral_conv_1d_dft(x.float(), w)
        return self.act(out.to(res.dtype) + res)


class SpectralConv2d(nn.Module):
    """FNO2d layer with two-corner mode truncation (layers.py:427-476;
    reference libs/layers.py:1109-1196).

    Accepts (B, n², C) or (B, n, n, C).  ``fourier_weight`` holds the two
    corners' weights (positive, then negative frequencies of the first
    axis) as real pairs (in, out, modes, modes, 2), with torch
    ``xavier_normal_(gain=1/(in·out)·√(in+out))`` statistics.  The
    transform is the DFT-as-products form; ``ops.spectral.spectral_conv_2d``
    is its FFT cross-check.
    """

    def __init__(self, in_dim: int, out_dim: int, modes: int,
                 dropout: float = 0.1, activation: Optional[str] = "silu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = _generator(generator)
        self.in_dim, self.out_dim = in_dim, out_dim
        self.act = get_activation(activation, "silu")
        self.linear = linear(in_dim, out_dim, g)
        self.dropout = nn.Dropout(dropout)
        gain = 1.0 / (in_dim * out_dim) * math.sqrt(in_dim + out_dim)
        std = gain * math.sqrt(2.0 / ((in_dim + out_dim) * modes * modes * 2))
        self.fourier_weight = nn.ParameterList(
            nn.Parameter(torch.empty(in_dim, out_dim, modes, modes, 2)
                         .normal_(0.0, std, generator=g)) for _ in range(2))

    def forward(self, x):
        flat = x.dim() == 3
        if flat:
            bsz = x.shape[0]
            n = int(round(x.shape[1] ** 0.5))
            x = x.reshape(bsz, n, n, self.in_dim)
        res = self.linear(x)
        x = self.dropout(x)
        w_pos, w_neg = (torch.complex(w[..., 0], w[..., 1])
                        for w in self.fourier_weight)
        out = S.spectral_conv_2d_dft(x.float(), w_pos, w_neg)
        out = self.act(out.to(res.dtype) + res)
        return out.reshape(bsz, n * n, self.out_dim) if flat else out
