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
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from ..ops import attention as A
from ..ops import spectral as S
from ..ops.cuda.fourier import MAX_D as FOURIER_MAX_D
from ..ops.cuda.fourier import fourier_attention_tiled
from ..ops.cuda.galerkin import MAX_D as GALERKIN_MAX_D
from ..ops.cuda.galerkin import galerkin_attention_fused
from ..ops.init import diagonal_dominant_init, lecun_normal
from ..parallel.galerkin import seq_sharded_galerkin_attention
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
GALERKIN_TYPES = ("galerkin", "linear", "global")
# the attention types SimpleAttention knows; a model routes any other name to
# its vanilla softmax encoder (transformer.py:137)
ATTENTION_TYPES = FOURIER_TYPES + GALERKIN_TYPES + ("softmax", "cosine", "causal")


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


class PositionalEncoding(nn.Module):
    """Sin/cos positional encoding added to the features, then dropout
    (layers.py:84-103; reference libs/layers.py:61-85).  The table is
    float32 and cast to the input's type."""

    def __init__(self, d_model: int, dropout: float = 0.1, max_len: int = 2 ** 13):
        super().__init__()
        pos = torch.arange(max_len, dtype=torch.float32)[:, None]
        div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32)
                        * (-math.log(2 ** 13) / d_model))
        pe = torch.zeros(max_len, d_model)
        pe[:, 0::2] = torch.sin(pos * div)
        pe[:, 1::2] = torch.cos(pos * div)
        self.register_buffer("pe", pe, persistent=False)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, start: int = 0):
        """`start`: the position of x's first row (a rank's rows of a
        sequence sharded over a seq mesh start past 0)."""
        return self.dropout(x + self.pe[None, start: start + x.shape[1]].to(x.dtype))


class SimpleAttention(nn.Module):
    """Multi-head attention with per-head pre-matmul norm (layers.py:125-377;
    reference libs/layers.py:764-951).

    * Q, K, V: three d_model→d_model Linear layers (``linears.{0,1,2}``)
      with diagonal-dominant init, or with ``xavier_init <= 0`` flax's
      lecun-normal, and zero bias.
    * galerkin, linear, global: per-head norm on K and V (``norm_K``,
      ``norm_V``); every other type: on K and Q (``norm_K``, ``norm_Q``).
      Layer norm or, with ``norm_type='instance'``, instance norm over the
      sequence.
    * pos is repeated per head and concatenated in front of q, k, v after
      the norm; ``fc`` projects (d_model + n_head·pos_dim) back to d_model.
    * `weight` (a mass matrix) multiplies the raw query and key first.
    * score dropout acts on the reduced score matrix (galerkin, linear,
      global, fourier) or the softmax weights (softmax); causal and cosine
      have none, as in JAX.
    * a `mask` zeroes fourier scores and sets softmax scores to -1e9 where
      it is 0 (it is broadcast against (B, H, n, n) as ``mask[:, None]``);
      causal needs one, the (B, n) key mask; galerkin, linear, global and
      cosine ignore it, as in JAX.  Any type outside the nine named here
      computes fourier attention, as JAX's layer does.

    Kernels: galerkin with layer norm runs ``galerkin_scores``; fourier
    without a mask runs ``fourier_chain``, each where the head fits the
    kernel (d_k + pos_dim <= 128 columns; a wider head takes the JAX
    package's XLA route: per-head LN and the block form, or the dense
    fourier scores).  Fourier forms its dense n×n scores instead, as JAX
    does, with a mask and in training with a non-zero score dropout.  The
    weights that ``need_weights`` returns: galerkin's kernel gives its
    d×d scores as they are; fourier keeps its chain kernel for the output
    and forms the dense n×n weights ``Q Kᵀ / (√d · n)`` beside it (what
    JAX's dense route returns), so a request for weights launches the
    kernels of one without.  On CUDA tensors the
    kernels are the hand-written ones (the float32 ones, or with
    ``dtype=torch.bfloat16`` the bfloat16 tensor-core ones), on CPU
    tensors their plain versions.  linear, global, softmax, cosine and
    causal run plain PyTorch, as JAX runs them in XLA.  With a compute
    `dtype` the projections and ``fc`` run as `dense` does; the parameters
    stay float32.

    With a `seq_mesh` (a ``parallel.Mesh``) galerkin attention runs
    sequence-parallel over its `seq_axis`
    (``parallel.seq_sharded_galerkin_attention``: the ``galerkin_scores``
    kernels on each rank's rows, one all-reduce of the d×d scores), with
    the parameters of the unsharded layer.  Only galerkin attention with
    per-head layer norm and no mask shards; any other configuration with a
    `seq_mesh` raises ``ValueError`` at its forward, as JAX's layer does.
    forward's `seq_tokens` says that the inputs are this rank's rows of a
    sequence of that many tokens (a model's sharded encoder); without it
    the inputs are whole, and so is the output.  In training with a score
    dropout the keep-mask of the seq group's first rank is used by all.
    """

    def __init__(self, n_head: int, d_model: int, pos_dim: int = 1,
                 attention_type: str = "fourier", dropout: float = 0.1,
                 score_dropout: Optional[float] = None,
                 xavier_init: float = 1e-4, diagonal_weight: float = 1e-2,
                 symmetric_init: bool = False, norm: bool = False,
                 norm_type: str = "layer", eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None, seq_mesh=None,
                 seq_axis: str = "seq",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if d_model % n_head:
            raise ValueError(f"d_model={d_model} is not a multiple of "
                             f"n_head={n_head}")
        self.seq_mesh, self.seq_axis = seq_mesh, seq_axis
        if norm_type not in ("layer", "instance"):
            raise ValueError(f"norm_type must be 'layer' or 'instance', "
                             f"got {norm_type!r}")
        g = _generator(generator)
        self.n_head, self.d_model, self.pos_dim = n_head, d_model, pos_dim
        self.d_k = d_model // n_head
        self.attention_type = attention_type
        self.is_galerkin = attention_type in GALERKIN_TYPES
        self.score_rate = default(score_dropout, dropout)
        self.norm, self.norm_type, self.eps = norm, norm_type, eps
        self.dtype = dtype

        self.linears = nn.ModuleList()
        for _ in range(3):
            lin = skip_init(nn.Linear, d_model, d_model)
            if xavier_init > 0:
                diagonal_dominant_init(lin.weight.data, g, xavier_init,
                                       diagonal_weight, symmetric_init)
            else:
                lecun_normal(lin.weight.data, g)
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

    def _check_seq_mesh(self, mask):
        atype = self.attention_type
        if atype == "galerkin" and self.norm and self.norm_type == "layer" and mask is None:
            return
        # a silent fall-through to the unsharded compute on a real mesh is a
        # correctness surprise, not a fallback
        raise ValueError(
            f"seq_mesh is set but the attention config is outside the "
            f"sequence-sharded path's support "
            f"(attention_type={atype!r}, norm={self.norm}, "
            f"norm_type={self.norm_type!r}, mask={'set' if mask is not None else None}); "
            f"supported: galerkin attention + per-head layer norm + no "
            f"mask.  Unset seq_mesh to run the unsharded compute.")

    def _seq_sharded(self, q, k, v, pos_in, seq_tokens):
        mesh, axis = self.seq_mesh, self.seq_axis
        sk, bk = self._affine("K")
        sv, bv = self._affine("V")
        score_mask = None
        if self.training and self.score_rate > 0.0:
            d_eff = self.d_k + (0 if pos_in is None else self.pos_dim)
            score_mask = F.dropout(q.new_ones(q.shape[0], self.n_head, d_eff, d_eff),
                                   self.score_rate)
            dist.broadcast(score_mask, mesh.first_rank(axis), group=mesh.groups[axis])
        return seq_sharded_galerkin_attention(
            q, k, v, mesh, sk, bk, sv, bv, pos=pos_in, eps=self.eps, seq_axis=axis,
            score_mask=score_mask, n_global=seq_tokens)

    def forward(self, query, key, value, pos=None, mask=None, weight=None,
                need_weights: bool = False, seq_tokens: Optional[int] = None):
        """Returns (out (B, n, d_model), p_attn).  `need_weights`: fourier
        forms and returns its n×n weights beside the chain kernel's output.
        `seq_tokens` (with a `seq_mesh`): the inputs are this rank's rows of
        a sequence of that many tokens."""
        if self.seq_mesh is not None:
            self._check_seq_mesh(mask)
        if weight is not None:
            query, key = weight * query, weight * key
        bsz, n = query.shape[0], query.shape[1]
        h, d_k = self.n_head, self.d_k
        atype = self.attention_type

        def split_heads(x):   # (B, n, d_model) -> (B, H, n, d_k)
            return x.reshape(bsz, x.shape[1], h, d_k).transpose(1, 2)

        q, k, v = (split_heads(dense(lin, x, self.dtype)) for lin, x
                   in zip(self.linears, (query, key, value)))
        pos_in = None
        if pos is not None and self.pos_dim > 0:
            if pos.shape[-1] != self.pos_dim:
                raise ValueError(f"pos has {pos.shape[-1]} columns, the layer "
                                 f"was built for pos_dim={self.pos_dim}")
            pos_in = pos.contiguous()
        score_mask = None if mask is None else mask[:, None]

        # the kernels take d_k + p <= 128 columns; a wider head takes the JAX
        # package's own route for it (XLA there): per-head LN and the block
        # form for galerkin, the dense scores for fourier.  Decided from the
        # shapes, before any launch.
        p = 0 if pos_in is None else self.pos_dim
        if self.seq_mesh is not None:
            x, p_attn = self._seq_sharded(q, k, v, pos_in, seq_tokens)
        elif atype == "galerkin" and self.norm and self.norm_type == "layer" \
                and d_k + p <= GALERKIN_MAX_D:
            sk, bk = self._affine("K")
            sv, bv = self._affine("V")
            x, p_attn = galerkin_attention_fused(
                q, k.contiguous(), v.contiguous(), pos_in, sk, bk, sv, bv,
                eps=self.eps, score_dropout=self._score_dropout)
        elif atype == "galerkin" and pos_in is not None:
            if self.norm:
                k, v = self._head_norm(k, "K"), self._head_norm(v, "V")
            x, p_attn = A.galerkin_attention_pos_blocked(
                q, k, v, pos_in, score_dropout=self._score_dropout)
        else:
            if self.norm:
                if self.is_galerkin:
                    k, v = self._head_norm(k, "K"), self._head_norm(v, "V")
                else:
                    k, q = self._head_norm(k, "K"), self._head_norm(q, "Q")
            if pos_in is not None:
                ph = pos_in[:, None].expand(bsz, h, n, self.pos_dim).to(q.dtype)
                q, k, v = (torch.cat([ph, t], dim=-1) for t in (q, k, v))
            if self.is_galerkin:
                x, p_attn = A.galerkin_attention(
                    q, k, v, softmax_qk=atype != "galerkin",
                    score_dropout=self._score_dropout)
            elif atype == "causal":
                if mask is None:
                    raise ValueError("causal attention requires a mask")
                x, p_attn = A.causal_linear_attention(q, k, v, kv_mask=mask)
            elif atype == "cosine":
                x, p_attn = A.cosine_attention(q, k, v)
            elif atype == "softmax":
                x, p_attn = A.softmax_attention(q, k, v, mask=score_mask,
                                                score_dropout=self._score_dropout)
            elif (mask is None and not (self.training and self.score_rate > 0.0)
                  and d_k + p <= FOURIER_MAX_D):
                x = fourier_attention_tiled(q.contiguous(), k.contiguous(),
                                            v.contiguous())
                p_attn = A.fourier_scores(q, k) if need_weights else None
            else:   # the dense n×n scores, as JAX forms them
                x, p_attn = A.fourier_attention(q, k, v, score_dropout=self._score_dropout,
                                                mask=score_mask)

        out = x.transpose(1, 2).reshape(bsz, n, h * x.shape[-1])   # n may be 0 on a rank
        if pos_in is not None:
            out = dense(self.fc, out, self.dtype)
        return out, p_attn


class SpectralConv1d(nn.Module):
    """FNO1d layer: linear residual + mode-truncated spectral conv
    (layers.py:380-424; reference libs/layers.py:1040-1106).

    ``fourier_weight`` is stored as real pairs (in, out, modes, 2), the
    reference's layout, with torch ``xavier_normal_(gain=1/(in·out))``
    statistics on that tensor.  ``impl="dft"`` (the default) is the
    DFT-as-products form (norm='ortho'); ``impl="fft"`` goes through
    ``ops.spectral.spectral_conv_1d`` with `norm`.  With `return_freq`
    forward returns (out, the truncated spectrum times the weight,
    (B, modes, out)), recomputed from the rfft with `norm` as JAX does.
    """

    def __init__(self, in_dim: int, out_dim: int, modes: int,
                 dropout: float = 0.1, activation: Optional[str] = "silu",
                 return_freq: bool = False, norm: str = "ortho", impl: str = "dft",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = _generator(generator)
        self.modes, self.return_freq, self.norm, self.impl = modes, return_freq, norm, impl
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
        if self.impl == "dft":
            out = S.spectral_conv_1d_dft(x.float(), w)
        else:
            out = S.spectral_conv_1d(x.float(), w, norm=self.norm)
        out = self.act(out.to(res.dtype) + res)
        if self.return_freq:
            x_ft = torch.fft.rfft(x.float(), dim=1, norm=self.norm)
            return out, S.complex_einsum("bxi,iox->bxo", x_ft[:, : self.modes], w)
        return out


class SpectralConv2d(nn.Module):
    """FNO2d layer with two-corner mode truncation (layers.py:427-476;
    reference libs/layers.py:1109-1196).

    Accepts (B, n², C) or (B, n, n, C).  ``fourier_weight`` holds the two
    corners' weights (positive, then negative frequencies of the first
    axis) as real pairs (in, out, modes, modes, 2), with torch
    ``xavier_normal_(gain=1/(in·out)·√(in+out))`` statistics.
    ``impl="dft"`` (the default) is the DFT-as-products form; ``impl="fft"``
    goes through ``ops.spectral.spectral_conv_2d`` with `norm`.
    `return_freq` is declared and changes nothing, as in JAX (layers.py:440).
    """

    def __init__(self, in_dim: int, out_dim: int, modes: int,
                 dropout: float = 0.1, norm: str = "ortho",
                 activation: Optional[str] = "silu", return_freq: bool = False,
                 impl: str = "dft", generator: Optional[torch.Generator] = None):
        super().__init__()
        g = _generator(generator)
        self.in_dim, self.out_dim = in_dim, out_dim
        self.norm, self.impl = norm, impl
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
        if self.impl == "dft":
            out = S.spectral_conv_2d_dft(x.float(), w_pos, w_neg)
        else:
            out = S.spectral_conv_2d(x.float(), w_pos, w_neg, norm=self.norm)
        out = self.act(out.to(res.dtype) + res)
        return out.reshape(bsz, n * n, self.out_dim) if flat else out


class BatchedLinear(nn.Module):
    """T independent Linear layers applied along dim 1 of (B, T, in): one
    weight (T, out, in) and one bias (T, out), each layer with torch's
    default init (flax's ``nn.vmap`` of ``Dense`` over that axis)."""

    def __init__(self, n_stacks: int, in_features: int, out_features: int,
                 g: torch.Generator):
        super().__init__()
        bound = float(in_features) ** -0.5
        self.weight = nn.Parameter(torch.empty(n_stacks, out_features, in_features)
                                   .uniform_(-bound, bound, generator=g))
        self.bias = nn.Parameter(torch.empty(n_stacks, out_features)
                                 .uniform_(-bound, bound, generator=g))

    def forward(self, x):
        return torch.einsum("bti,toi->bto", x, self.weight) + self.bias


class BulkRegressor(nn.Module):
    """Sequence -> per-target pred_len regressor (layers.py:479-510;
    reference libs/layers.py:990-1037): ``linear`` maps the features of
    each of the seq_len points to n_targets, then each target's sequence
    goes through its own two-layer MLP (``freq_fc1``, leaky ReLU,
    ``freq_fc2``); (B, seq_len, n_feats) -> (B, pred_len, n_targets)."""

    def __init__(self, in_dim: int, n_feats: int, n_targets: int, pred_len: int,
                 n_hidden: Optional[int] = None, sort_output: bool = False,
                 dropout: float = 0.1, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = _generator(generator)
        n_hidden = default(n_hidden, pred_len * 4)
        self.sort_output = sort_output
        self.linear = linear(n_feats, n_targets, g)
        self.freq_fc1 = BatchedLinear(n_targets, in_dim, n_hidden, g)
        self.freq_fc2 = BatchedLinear(n_targets, n_hidden, pred_len, g)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        x = self.linear(x).transpose(-2, -1)   # (B, n_targets, seq_len)
        out = self.freq_fc2(F.leaky_relu(self.freq_fc1(x))).transpose(-2, -1)
        out = self.dropout(out)
        return torch.sort(out, dim=-1).values if self.sort_output else out
