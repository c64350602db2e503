"""Mixture-of-Experts Llama variant (the port's counterpart of
``strom/models/moe.py``): the expert-parallel (ep) consumer.

Same parameterisation as the reference: Llama's attention, plus per layer
an f32 router ``[L, d, E]`` and stacked SwiGLU experts ``w_gate``/``w_up``
``[L, E, d, f]`` and ``w_down`` ``[L, E, f, d]``, so
:func:`params_from_jax` is a plain copy. Switch-style top-1 routing with
capacity ``cfg.capacity(N)`` over the whole batch of N tokens: a token's
place in its expert's queue is its index among the tokens routed there, in
row-major order, and it is dropped at or past the capacity.

The reference dispatches with one-hot ``[N, E, C]`` einsums;
:func:`switch_route` keeps that form (its parity oracle). :func:`moe_ffn`
scatters each kept token into a fixed ``[E, C_buf, d]`` buffer at its
expert and slot instead (``C_buf = min(C, N)``), runs the experts as three
batched matmuls and gathers the outputs back scaled by the gate: the same
values, static shapes (one CUDA graph), and no ``N·E·C·d`` products.

On a mesh (``parallel/expert_parallel.py``) the batch is split over dp
(and sp), the experts over ep: routing counts come from the global batch
(one all-gather), each rank runs its ``E/ep`` experts, and the partial
outputs are summed over ep. The auxiliary losses are then this rank's
share of the global ones (:func:`switch_aux`), so that the mean of the
ranks' losses that the train step takes is the reference's loss.
"""

from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Any, Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from strom_torch.models import llama
from strom_torch.models.llama import (LlamaConfig, attention_residual,
                                      lm_loss, rmsnorm, shard_positions)
from strom_torch.parallel.expert_parallel import TokenLayout, queue_offsets

if TYPE_CHECKING:
    from strom_torch.parallel.mesh import AxisGroup, Mesh

# parameters stacked over layers, in block order
LAYER_PARAMS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "router",
                "w_gate", "w_up", "w_down")
EXPERT_PARAMS = ("w_gate", "w_up", "w_down")     # [L, E, ...]: split on ep


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    base: LlamaConfig = dataclasses.field(default_factory=LlamaConfig.tiny)
    n_experts: int = 8
    capacity_factor: float = 1.25
    aux_loss_weight: float = 1e-2
    router_z_weight: float = 1e-3

    @classmethod
    def tiny(cls, n_experts: int = 4) -> "MoEConfig":
        return cls(base=LlamaConfig.tiny(), n_experts=n_experts)

    def capacity(self, n_tokens: int) -> int:
        return max(1, math.ceil(n_tokens / self.n_experts
                                * self.capacity_factor))


def param_shapes(cfg: MoEConfig) -> dict[str, tuple[int, ...]]:
    b = cfg.base
    d, f, L, E = b.d_model, b.d_ff, b.n_layers, cfg.n_experts
    nh, nkv, hd = b.n_heads, b.n_kv_heads, b.head_dim
    return {
        "embed": (b.vocab, d),
        "attn_norm": (L, d), "wq": (L, d, nh * hd), "wk": (L, d, nkv * hd),
        "wv": (L, d, nkv * hd), "wo": (L, nh * hd, d), "mlp_norm": (L, d),
        "router": (L, d, E),
        "w_gate": (L, E, d, f), "w_up": (L, E, d, f), "w_down": (L, E, f, d),
        "final_norm": (d,),
        "lm_head": (d, b.vocab),
    }


@dataclasses.dataclass
class Routing:
    """Top-1 routing of N tokens: their router *logits* and *probs*
    ``[N, E]`` f32, *expert* ``[N]`` (the first maximum of probs) and its
    *onehot* ``[N, E]`` f32, *pos*
    (the token's place in its expert's global queue), *keep* (pos below
    the capacity), *gate* (the kept token's probability, else 0) and
    *totals* ``[E]`` (the global batch's tokens routed to each expert)."""
    logits: torch.Tensor
    probs: torch.Tensor
    expert: torch.Tensor
    onehot: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    gate: torch.Tensor
    totals: torch.Tensor


def _exclusive_cumsum(onehot: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cumsum(onehot, dim) - onehot


def route(hf: torch.Tensor, router: torch.Tensor, capacity: int, B: int,
          layout: TokenLayout | None = None) -> Routing:
    """Route *hf* ``[N, d]``, this rank's ``B`` rows of ``N/B`` tokens, by
    *router* ``[d, E]`` (in f32, as the reference: ``h.astype(f32) @
    router``), with queues over the global batch of *layout* (default:
    *hf* is the whole batch)."""
    N, E = hf.shape[0], router.shape[-1]
    logits = hf.float() @ router
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(probs, dim=-1)
    onehot = (expert[:, None] == torch.arange(E, device=hf.device)).float()
    rows = onehot.view(B, N // B, E)
    before, totals = queue_offsets(rows.sum(1).long(), layout or TokenLayout())
    pos = (before[:, None, :] + _exclusive_cumsum(rows, 1).long()).view(N, E)
    pos = torch.gather(pos, 1, expert[:, None])[:, 0]
    keep = pos < capacity
    gate = torch.gather(probs, 1, expert[:, None])[:, 0] * keep
    return Routing(logits, probs, expert, onehot, pos, keep, gate, totals)


def switch_aux(r: Routing, n_tokens: int) -> torch.Tensor:
    """[lb, z]: the Switch load-balance loss ``E · Σ_e frac_e ·
    mean_prob_e`` and the router z-loss ``mean(logsumexp(logits)²)``, each
    mean over *n_tokens*. With the whole batch here and *n_tokens* its N,
    the reference's. On a rank of a mesh, *n_tokens* is the dp block's
    token count: ``frac`` (the global share, no gradient, as the
    reference's one-hot of an argmax) times this rank's sum of probs, and
    its sum of logsumexp², over that count, so that the dp group's mean of
    the ranks' sums (over sp) is the global loss."""
    E = r.probs.shape[-1]
    frac = r.totals.float() / r.totals.sum()
    lb = E * torch.sum(frac * (r.probs.sum(0) / n_tokens))
    z = torch.sum(torch.logsumexp(r.logits, dim=-1) ** 2) / n_tokens
    return torch.stack([lb, z])


def switch_route(h: torch.Tensor, router: torch.Tensor, capacity: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's form: h ``[N, d]`` → (dispatch ``[N, E, C]``
    one-hot, combine ``[N, E, C]`` probability-weighted, aux ``[lb, z]``).
    :func:`moe_ffn` does not build these; they are the parity oracle of
    its routing."""
    N = h.shape[0]
    r = route(h, router, capacity, 1)
    slot = torch.clamp(r.pos, max=capacity - 1)
    pos_onehot = (slot[:, None] == torch.arange(capacity,
                                                device=h.device)).float()
    dispatch = (r.onehot * r.keep[:, None])[..., None] * pos_onehot[:, None, :]
    return dispatch, dispatch * r.gate[:, None, None], switch_aux(r, N)


def moe_ffn(h: torch.Tensor, lp: dict[str, torch.Tensor], cfg: MoEConfig, *,
            ep: AxisGroup | None = None, layout: TokenLayout | None = None,
            routes: list | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """h ``[B, S, d]`` → (out ``[B, S, d]``, aux ``[2]``). *lp*'s expert
    stacks are this rank's ``E/ep`` experts under *ep*; *layout* places
    *h* in the global batch (the capacity is the global token count's).
    *routes*: a list that gets this call's ``(expert, keep)``."""
    layout = layout or TokenLayout()
    B, S, D = h.shape
    N = B * S
    C = cfg.capacity(N * layout.size)
    hf = h.reshape(N, D)
    r = route(hf, lp["router"], C, B, layout)
    if routes is not None:
        routes.append((r.expert.detach(), r.keep.detach()))
    aux = switch_aux(r, N * layout.cols)
    w_gate, w_up, w_down = (lp[n] for n in EXPERT_PARAMS)
    n_local = w_gate.shape[0]
    first = ep.index * n_local if ep is not None else 0
    gate = r.gate
    if ep is not None:
        from strom_torch.parallel.tensor_parallel import copy_to_tp

        # this rank's experts' share of the gradient: summed over ep
        hf, gate = copy_to_tp(hf, ep), copy_to_tp(gate, ep)
    # each kept token of this rank's experts to (its expert, its slot: the
    # tokens of its expert before it here), the rest to one spare row
    c_buf = min(C, N)
    local = r.expert - first
    mine = r.keep & (local >= 0) & (local < n_local)
    slot = torch.gather(_exclusive_cumsum(r.onehot, 0), 1,
                        r.expert[:, None])[:, 0].long()
    index = torch.where(mine, local * c_buf + slot, n_local * c_buf)
    x = hf.new_zeros(n_local * c_buf + 1, D).index_put((index,), hf)
    x = x[:-1].view(n_local, c_buf, D)
    y = torch.bmm(F.silu(torch.bmm(x, w_gate)) * torch.bmm(x, w_up), w_down)
    y = torch.cat([y.reshape(-1, D), y.new_zeros(1, D)])
    # the gate rounded to the activations' dtype, as combine.astype(h.dtype)
    out = y[index] * gate.to(h.dtype)[:, None]
    if ep is not None:
        from strom_torch.parallel.tensor_parallel import reduce_from_tp

        out = reduce_from_tp(out, ep)
    return out.view(B, S, D), aux


def block(x: torch.Tensor, lp: dict[str, torch.Tensor], cfg: MoEConfig,
          positions: torch.Tensor, attn_fn: Callable | None = None, *,
          ep: AxisGroup | None = None, layout: TokenLayout | None = None,
          routes: list | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    b = cfg.base
    x = attention_residual(x, lp, b, positions, attn_fn)
    h = rmsnorm(x, lp["mlp_norm"], b.norm_eps)
    ffn, aux = moe_ffn(h, lp, cfg, ep=ep, layout=layout, routes=routes)
    return x + ffn, aux


def _is_norm(name: str) -> bool:
    return name.endswith("norm")


class MoE(nn.Module):
    """The model's parameters, named as the reference's pytree leaves (the
    ``layers`` sub-dict flattened), and its forward. ``ep``: the
    expert-parallel axis once :meth:`shard_` kept this rank's experts,
    else None; ``tp`` is always None (MoE under tp is not ported)."""

    def __init__(self, cfg: MoEConfig, *, device: Any = None,
                 generator: torch.Generator | None = None,
                 attn_fn: Callable | None = None):
        super().__init__()
        from strom_torch.delivery.core import resolve_device

        device = resolve_device(device)
        self.cfg = cfg
        self.attn_fn = attn_fn
        b = cfg.base
        for name, shape in param_shapes(cfg).items():
            if _is_norm(name):
                t = torch.ones(shape, dtype=torch.float32, device=device)
            else:
                # N(0, 1/fan_in) drawn in f32, then cast (as the reference);
                # the router stays f32
                fan_in = b.d_model if name == "embed" else shape[-2]
                t = torch.randn(shape, generator=generator, device=device,
                                dtype=torch.float32).mul_(1.0 / math.sqrt(
                                    fan_in))
                if name != "router":
                    t = t.to(b.torch_dtype)
            self.register_parameter(name, nn.Parameter(t))
        self.tp = None
        self.ep: AxisGroup | None = None

    @torch.no_grad()
    def shard_(self, mesh: Mesh) -> "MoE":
        """Keep only this rank's experts of each expert stack (dim 1 split
        over the mesh's ep axis, ``moe_param_shardings``) and run them
        expert-parallel from now on. Nothing changes where ep is 1."""
        from strom_torch.parallel.sharding import (moe_param_shardings,
                                                   shard_params)

        ep = mesh.axis("ep")
        if ep.size == 1:
            return self
        if self.cfg.n_experts % ep.size:
            raise ValueError(f"n_experts {self.cfg.n_experts} must divide "
                             f"by ep {ep.size}")
        full = {n: p.detach() for n, p in self.named_parameters()}
        for name, t in shard_params(full, mesh,
                                    shardings=moe_param_shardings).items():
            if name in EXPERT_PARAMS:
                # a copy: the full tensor goes with the old parameter
                setattr(self, name, nn.Parameter(t.clone(
                    memory_format=torch.contiguous_format)))
        self.ep = ep
        return self

    def forward(self, tokens: torch.Tensor,
                positions: torch.Tensor | None = None,
                attn_fn: Callable | None = None, remat: bool = False, *,
                layout: TokenLayout | None = None, routes: list | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """tokens [B, S] integer → (logits [B, S, vocab] float32, aux
        losses [2] summed over layers). *positions* [B, S]: the tokens'
        places in the whole sequence (default 0..S-1); *layout*: where the
        tokens lie in the global batch; *routes* (not under *remat*, whose
        recompute routes again): gets each layer's ``(expert, keep)``."""
        cfg, b = self.cfg, self.cfg.base
        attn_fn = attn_fn or self.attn_fn
        B, S = tokens.shape
        if positions is None:
            positions = torch.arange(S, device=tokens.device).expand(B, S)
        if remat and routes is not None:
            raise ValueError("routes= records one forward: not under remat")
        x = self.embed[tokens.long()].to(b.torch_dtype)
        aux = []
        for i in range(b.n_layers):
            lp = {n: getattr(self, n)[i] for n in LAYER_PARAMS}
            kw = {"ep": self.ep, "layout": layout, "routes": routes}
            if remat:
                # the block draws no random numbers: no RNG state to keep
                # for the recompute (whose get/set would break a capture);
                # every rank recomputes the same collectives in one order
                x, a = checkpoint(block, x, lp, cfg, positions, attn_fn,
                                  use_reentrant=False,
                                  preserve_rng_state=False, **kw)
            else:
                x, a = block(x, lp, cfg, positions, attn_fn, **kw)
            aux.append(a)
        x = rmsnorm(x, self.final_norm, b.norm_eps)
        return (x @ self.lm_head).float(), torch.stack(aux).sum(0)


def next_token_loss(model: MoE, tokens: torch.Tensor, attn_fn=None,
                    remat: bool = False, sp: AxisGroup | None = None,
                    layout: TokenLayout | None = None) -> torch.Tensor:
    """The Llama next-token loss (``models.llama.next_token_loss``, with
    its *sp* handling: global positions, the last column's target from the
    next shard) plus ``aux_loss_weight · lb + router_z_weight · z``, the
    aux losses summed over layers. *layout*: where *tokens* lie in the
    global batch (``parallel.expert_parallel.token_layout``)."""
    cfg = model.cfg
    logits, aux = model(tokens, positions=shard_positions(tokens, sp),
                        attn_fn=attn_fn, remat=remat, layout=layout)
    lm = lm_loss(logits, tokens, sp)
    return lm + cfg.aux_loss_weight * aux[0] + cfg.router_z_weight * aux[1]


def params_from_jax(np_params: dict) -> dict[str, torch.Tensor]:
    """``strom.models.moe.init_params``'s tree, taken to numpy, → a state
    dict for :class:`MoE`: ``models.llama.params_from_jax``'s copy (the
    ``layers`` subtree flattened, nothing transposed, the f32 router kept
    f32)."""
    return llama.params_from_jax(np_params)
