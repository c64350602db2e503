"""Megatron tensor parallelism with explicit collectives: a port-only
module.

The reference has no counterpart file. Its step is jitted over parameters
sharded by ``param_shardings`` (``strom/parallel/sharding.py``), and XLA's
partitioner places the collectives that tp needs. Only inside the
pipelined step does the reference write them by hand
(``strom/parallel/pipeline.py`` ``_block_tp``). The port runs one process
per card and places every collective itself, so this module holds what
XLA derives there, over the mesh's tp axis:

- the two Megatron operators, *copy to tp* (identity forward, all-reduce
  backward) at the entry of a column-parallel region and *reduce from tp*
  (all-reduce forward, identity backward) at the exit of a row-parallel
  one. Written as ``autograd.Function``s on purpose:
  ``torch.distributed.nn.functional.all_reduce`` all-reduces in its
  backward too, which on a loss replicated over tp multiplies the
  gradients by tp;
- :func:`block_tp`, the Megatron block: ``wq/wk/wv/w_gate/w_up``
  column-split (local heads ``n_heads/tp`` and ``n_kv_heads/tp``),
  ``wo/w_down`` row-split, two reductions closing each pair;
- the embedding's gather: ``embed`` is split on ``d_model``
  (``P(None, "tp")``), each rank looks up its columns and all-gathers the
  full residual stream; the backward takes this rank's columns of the
  gradient, which is the same on every tp rank, and reduces nothing;
- the vocab-parallel next-token loss for ``lm_head`` ``P(None, "tp")``:
  the row max and the sum of exponentials are reduced over tp, and the
  gold logit comes from the rank that owns the target id.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F

from strom_torch.models.llama import LlamaConfig, attention, rmsnorm, rope
from strom_torch.parallel.mesh import AxisGroup


def check_tp(cfg: LlamaConfig, tp: int) -> None:
    """Raise ValueError unless every dimension tp splits divides by *tp*."""
    if cfg.n_heads % tp or cfg.n_kv_heads % tp or cfg.d_ff % tp \
            or cfg.vocab % tp or cfg.d_model % tp:
        raise ValueError(
            f"n_heads {cfg.n_heads}, n_kv_heads {cfg.n_kv_heads}, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab} and d_model {cfg.d_model} must "
            f"divide by tp {tp} for manual tensor parallelism")


def _all_reduce(t: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """The sum over the axis of a contiguous copy of *t*."""
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=axis.group)
    return out


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    """[..., d/tp] on each rank → [..., d], the ranks' columns in axis
    order; the backward keeps this rank's columns."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        if list(axis.ranks) != sorted(axis.ranks):
            raise NotImplementedError(
                f"tp ranks {axis.ranks} out of ascending order: the "
                "all-gather orders the columns by rank")
        x = x.contiguous()
        out = x.new_empty((axis.size * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=axis.group)
        out = out.view(axis.size, *x.shape)      # the ranks' blocks, stacked
        return torch.movedim(out, 0, -2).reshape(*x.shape[:-1], -1)

    @staticmethod
    def backward(ctx, g):
        axis = ctx.axis
        width = g.shape[-1] // axis.size
        return g[..., axis.index * width:(axis.index + 1) * width] \
            .contiguous(), None


def copy_to_tp(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """Identity forward, all-reduce over *axis* backward."""
    return _CopyToTP.apply(x, axis) if axis.size > 1 else x


def reduce_from_tp(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """All-reduce over *axis* forward, identity backward."""
    return _ReduceFromTP.apply(x, axis) if axis.size > 1 else x


def gather_from_tp(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """All-gather of the last dimension over *axis*; the backward keeps
    this rank's slice."""
    return _GatherFromTP.apply(x, axis) if axis.size > 1 else x


def block_tp(x: torch.Tensor, lp: dict[str, torch.Tensor], cfg: LlamaConfig,
             positions: torch.Tensor, attn_fn: Callable | None = None, *,
             tp: AxisGroup) -> torch.Tensor:
    """The Megatron block (``strom/parallel/pipeline.py`` ``_block_tp``):
    *lp*'s matmul weights are this rank's tp blocks (wq/wk/wv/w_gate/w_up
    column-split, wo/w_down row-split), so activations stay full-width,
    local heads attend independently (the GQA ratio kept: both head counts
    divide by tp), and the only collectives are the two reductions closing
    each column → row pair (and their backward's two all-reduces)."""
    nh, nkv, hd = cfg.n_heads // tp.size, cfg.n_kv_heads // tp.size, \
        cfg.head_dim
    B, S, _ = x.shape
    h = copy_to_tp(rmsnorm(x, lp["attn_norm"], cfg.norm_eps), tp)
    q = rope((h @ lp["wq"]).reshape(B, S, nh, hd), positions, cfg.rope_theta)
    k = rope((h @ lp["wk"]).reshape(B, S, nkv, hd), positions, cfg.rope_theta)
    v = (h @ lp["wv"]).reshape(B, S, nkv, hd)
    attn = (attn_fn or attention)(q, k, v)
    x = x + reduce_from_tp(attn.reshape(B, S, nh * hd) @ lp["wo"], tp)
    h = copy_to_tp(rmsnorm(x, lp["mlp_norm"], cfg.norm_eps), tp)
    gated = F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])
    return x + reduce_from_tp(gated @ lp["w_down"], tp)


class _VocabParallelCE(torch.autograd.Function):
    """Per-row −log softmax(logits)[target] over logits split on the vocab:
    *logits* [N, V/tp] f32 are this rank's columns, the ones from
    ``axis.index · V/tp``. The backward is softmax − onehot, on the local
    columns."""

    @staticmethod
    def forward(ctx, logits, targets, axis):
        width = logits.shape[-1]
        start = axis.index * width
        m = logits.amax(-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=axis.group)
        e = torch.exp(logits - m[:, None])
        local = targets - start
        own = (local >= 0) & (local < width)
        local = torch.where(own, local, 0)
        gold = torch.gather(logits, -1, local[:, None])[:, 0] * own
        sums = torch.stack([e.sum(-1), gold])     # one all-reduce for both
        dist.all_reduce(sums, group=axis.group)
        s, gold = sums[0], sums[1]
        ctx.save_for_backward(e, s, local, own)
        return m + torch.log(s) - gold

    @staticmethod
    def backward(ctx, g):
        e, s, local, own = ctx.saved_tensors
        grad = e * (g / s)[:, None]
        grad.scatter_add_(-1, local[:, None], -(g * own)[:, None])
        return grad, None, None


def vocab_parallel_ce(logits: torch.Tensor, targets: torch.Tensor,
                      axis: AxisGroup) -> torch.Tensor:
    """logits [..., V/tp] (this rank's vocab columns), targets [...] global
    ids → −log p(target) per position [...], the same on every tp rank."""
    lead = logits.shape[:-1]
    per = _VocabParallelCE.apply(logits.reshape(-1, logits.shape[-1]),
                                 targets.reshape(-1), axis)
    return per.reshape(lead)
