"""Sequence-parallel Galerkin attention (counterpart of
``parallel/galerkin.py``).

The Galerkin form ``out = Q (LN(K)ᵀ LN(V) / n)`` shards over the sequence
with one collective: each rank of a ``seq`` group computes the d×d partial
``[pos, LN_K(K)]ᵀ [pos, LN_V(V)]`` of its rows, one all-reduce sums the
partials into the global scores, and each rank's output rows need only
its own rows of Q.  The partial is exactly what the ``galerkin_scores``
kernel computes, so on CUDA tensors it is that kernel (``galerkin_scores``
for float32, ``galerkin_scores_bf16`` for bfloat16 K and V), and its
backward the ``galerkin_scores_bwd`` kernels; on CPU tensors their plain
versions.

Rows are split as JAX pads them: n tokens are padded to a multiple of the
seq size s, and rank r owns rows ``[r·m, (r+1)·m)`` of the padded sequence,
``m = ceil(n / s)``.  A rank passes only its real rows (the last ranks may
have fewer than m, or none), which is what JAX's zeroing of padded K rows
after LN and the pos concatenation gives; the sum is divided by the global
n.

The models shard their whole encoder stack this way (`SeqRegion`): at its
entry each rank keeps its rows of the tokens and of pos, at its exit the
rows are all-gathered, so everything outside the encoder (the lifts, the
scalers, the spectral regressor, the loss) runs whole on every rank.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from ..ops.cuda.galerkin import (MAX_D, _concat_pos, galerkin_scores,
                                 galerkin_scores_reference)
from .mesh import Mesh, all_reduce_sum


def axis_rows(mesh: Mesh, n: int, axis: str = "seq") -> slice:
    """This rank's rows of `n` split over `axis`: ``[r·m, (r+1)·m)`` of the
    padded count, cut at n, with ``m = ceil(n / size)``."""
    m = math.ceil(n / mesh.shape[axis])
    r = mesh.index[axis]
    return slice(min(r * m, n), min((r + 1) * m, n))


class _Gather(torch.autograd.Function):
    """All-gather of each rank's rows (dim `dim`) of an `n`-row tensor over
    `axis`.  Every rank pads its rows to m before the gather (collectives
    take parts of one size).  The adjoint is a reduce-scatter with a sum:
    each rank gets the sum over the group of the gradients of its own rows
    (an all-reduce of the whole gradient, then its rows)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, n, dim):
        group, size = mesh.groups[axis], mesh.shape[axis]
        rows = axis_rows(mesh, n, axis)
        m = math.ceil(n / size)
        ctx.group, ctx.rows, ctx.dim = group, rows, dim
        if x.shape[dim] < m:
            pad = list(x.shape)
            pad[dim] = m - x.shape[dim]
            x = torch.cat([x, x.new_zeros(pad)], dim=dim)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim).narrow(dim, 0, n)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        rows = ctx.rows
        return grad.narrow(ctx.dim, rows.start, rows.stop - rows.start), None, None, None, None


def gather_rows(x: torch.Tensor, mesh: Mesh, n: int, dim: int = 1,
                axis: str = "seq") -> torch.Tensor:
    """The whole `n` rows (dim `dim`) from each rank's `axis_rows` of them;
    differentiable."""
    return _Gather.apply(x, mesh, axis, n, dim)


class SeqRegion:
    """The sharded region of a model: this rank's rows of a sequence of `n`
    tokens on the mesh's `axis` (dim 1 of (B, n, ...) tensors).  With
    `mesh` None every method passes its argument through."""

    def __init__(self, mesh: Optional[Mesh], n: int, axis: str = "seq"):
        self.mesh, self.n, self.axis = mesh, n, axis
        self.tokens = None if mesh is None else n   # what the layers are told
        self.rows = None if mesh is None else axis_rows(mesh, n, axis)

    def enter(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This rank's rows of `x` (None, or a tensor without the sequence
        as dim 1, passes as it is)."""
        if self.mesh is None or x is None or x.dim() < 2 or x.shape[1] != self.n:
            return x
        return x[:, self.rows]

    def exit(self, x: torch.Tensor) -> torch.Tensor:
        """The whole sequence, gathered from every rank's rows."""
        if self.mesh is None:
            return x
        return gather_rows(x, self.mesh, self.n, 1, self.axis)


def _local_scores(k, v, pos, params, eps):
    """The float32 d×d partial of this rank's rows: the ``galerkin_scores``
    kernel (its plain version on CPU tensors); without LN parameters, or
    for a head wider than the kernel takes (d_k + p > 128), or with no rows
    at all, the plain product."""
    d_eff = k.shape[-1] + (0 if pos is None else pos.shape[-1])
    if params is None:
        kc, vc = _concat_pos(k, pos), _concat_pos(v, pos)
        return torch.matmul(kc.float().transpose(-2, -1), vc.float())
    if d_eff > MAX_D or k.shape[-2] == 0:
        return galerkin_scores_reference(k, v, pos, *params, eps)
    return galerkin_scores(k.contiguous(), v.contiguous(),
                           None if pos is None else pos.contiguous(), *params, eps)


def seq_sharded_galerkin_attention(query: torch.Tensor, key: torch.Tensor,
                                   value: torch.Tensor, mesh: Mesh,
                                   scale_k=None, bias_k=None, scale_v=None, bias_v=None,
                                   pos: Optional[torch.Tensor] = None,
                                   eps: float = 1e-5, seq_axis: str = "seq",
                                   batch_axis: Optional[str] = "data",
                                   score_mask: Optional[torch.Tensor] = None,
                                   n_global: Optional[int] = None):
    """Galerkin attention with the sequence dim sharded over `seq_axis`.

    query, key, value: (B, H, n, d); optional per-head LN parameters (H, d)
    (float32) are applied to K and V on each rank; optional pos (B, n, p)
    is cast to the query's type and concatenated after LN.  `score_mask`
    (B, H, d_eff, d_eff), e.g. a dropout keep-mask, multiplies the summed
    scores; every rank of the seq group must pass the same one.

    Two forms:

    * `n_global` None: the inputs are whole, as JAX's global arrays, and
      the same on every rank; each rank takes its rows, and with
      `batch_axis` on the mesh and B divisible by its size, its slice of
      the batch; the output and the scores are gathered back.  Returns
      (out (B, H, n, d[+p]), p_attn (B, H, d_eff, d_eff)), both whole on
      every rank.
    * `n_global` set: the inputs are this rank's rows (`axis_rows`) of a
      sequence of `n_global` tokens and its batch; returns (out of those
      rows, p_attn), nothing gathered (the models' `SeqRegion`).

    The partial is float32 (the kernel's output, or JAX's
    ``preferred_element_type``), then all-reduced over the seq group,
    divided by `n_global`, cast to the query's type and masked; ``out =
    [pos, Q] @ S`` with float32 sums, cast to the query's type.  The
    backward of the all-reduce all-reduces dS; the local dK, dV and LN
    gradients come from the ``galerkin_scores_bwd`` kernels (CUDA) or their
    plain versions (CPU).  Each rank's gradients of its inputs and of the
    LN parameters are then its shares; with the whole form, every rank's
    gradient of its rows is the group's sum (the gather's adjoint), and the
    mean over the ranks is the true gradient (``train.steps`` averages).
    """
    whole = n_global is None
    batch = None
    if whole:
        n_global = key.shape[-2]
        rows = axis_rows(mesh, n_global, seq_axis)
        if batch_axis in mesh.shape and mesh.shape[batch_axis] > 1 \
                and key.shape[0] % mesh.shape[batch_axis] == 0:
            batch = axis_rows(mesh, key.shape[0], batch_axis)
        cut = slice(None) if batch is None else batch
        query, key, value = (t[cut, :, rows] for t in (query, key, value))
        if pos is not None:
            pos = pos[cut, rows]
        if score_mask is not None:
            score_mask = score_mask[cut]
    if pos is not None:
        pos = pos.to(query.dtype)
    params = None if scale_k is None else (scale_k, bias_k, scale_v, bias_v)
    partial = _local_scores(key, value, pos, params, eps)
    scores = (all_reduce_sum(partial, mesh.groups[seq_axis]) / n_global).to(query.dtype)
    if score_mask is not None:
        scores = scores * score_mask.to(query.dtype)
    out = torch.matmul(_concat_pos(query, pos).float(), scores.float()).to(query.dtype)
    if whole:
        out = gather_rows(out, mesh, n_global, 2, seq_axis)
        if batch is not None:
            n_batch = mesh.shape[batch_axis] * out.shape[0]
            out, scores = (gather_rows(t, mesh, n_batch, 0, batch_axis)
                           for t in (out, scores))
    return out, scores
