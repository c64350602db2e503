"""Llama-style decoder-only transformer (the port's counterpart of
``strom/models/llama.py``): the consumer of the packed-token pipeline.

Same parameterisation as the reference: weights stacked over layers with a
leading ``n_layers`` dimension and kept in the reference's orientation
(``h @ wq`` with ``wq`` shaped ``[L, d, out]``), so :func:`params_from_jax`
is a plain copy. bf16 (or the config's dtype) weights and activations, f32
rmsnorm, softmax and loss; GQA, RoPE, SwiGLU; the ``attn_fn`` hook where
flash attention substitutes for the dense op; and ``remat=True`` wraps each
block in ``torch.utils.checkpoint`` so the backward recomputes block
activations instead of keeping them.

On a mesh, :meth:`Llama.shard_` keeps this rank's tp block of each
parameter (``parallel/sharding.py`` rules; the state-dict keys stay) and
the model then runs the Megatron block and the vocab-parallel loss of
``parallel/tensor_parallel.py``. :func:`next_token_loss` takes a sequence
shard with its ``sp`` axis: global RoPE positions, and the target of the
shard's last column from the next shard's first token.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import TYPE_CHECKING, Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

if TYPE_CHECKING:
    from strom_torch.parallel.mesh import AxisGroup, Mesh

# parameters stacked over layers, in block order
LAYER_PARAMS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
                "w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab: int = 128_256
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14_336
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @classmethod
    def llama3_8b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        """~2M params; unit tests."""
        return cls(vocab=512, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
                   d_ff=256, rope_theta=10_000.0)

    @classmethod
    def small(cls) -> "LlamaConfig":
        """~100M params."""
        return cls(vocab=32_000, d_model=768, n_layers=12, n_heads=12,
                   n_kv_heads=4, d_ff=2048)

    def param_count(self) -> int:
        d, f, v, l = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        mlp = 3 * d * f
        return v * d + l * (attn + mlp + 2 * d) + d + d * v


def param_shapes(cfg: LlamaConfig) -> dict[str, tuple[int, ...]]:
    d, hd, L = cfg.d_model, cfg.head_dim, cfg.n_layers
    nh, nkv, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    return {
        "embed": (cfg.vocab, d),
        "attn_norm": (L, d), "wq": (L, d, nh * hd), "wk": (L, d, nkv * hd),
        "wv": (L, d, nkv * hd), "wo": (L, nh * hd, d), "mlp_norm": (L, d),
        "w_gate": (L, d, f), "w_up": (L, d, f), "w_down": (L, f, d),
        "final_norm": (d,),
        "lm_head": (d, cfg.vocab),
    }


def _is_norm(name: str) -> bool:
    return name.endswith("norm")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * scale * w).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: [B, S, H, Dh]; positions: [B, S] (absolute)."""
    hd = x.shape[-1]
    freqs = theta ** (-torch.arange(0, hd // 2, dtype=torch.float32,
                                    device=x.device) / (hd // 2))
    angles = positions[..., None].float() * freqs            # [B,S,hd/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """Dense GQA core. q: [B,S,H,Dh]; k,v: [B,S,KV,Dh]. f32 softmax."""
    B, Sq, H, Dh = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, Dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() / math.sqrt(Dh)
    if causal:
        pos = torch.arange(Sq, device=q.device)
        mask = pos[:, None] >= torch.arange(k.shape[1], device=q.device)[None, :]
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0).to(v.dtype)  # fully-masked rows
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, Dh)


def attention_residual(x: torch.Tensor, lp: dict[str, torch.Tensor],
                       cfg: LlamaConfig, positions: torch.Tensor,
                       attn_fn: Callable | None = None) -> torch.Tensor:
    """The block's first half: x + attention(rmsnorm(x)) @ wo (the MoE
    block's too)."""
    B, S, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    q = (h @ lp["wq"]).reshape(B, S, nh, hd)
    k = (h @ lp["wk"]).reshape(B, S, nkv, hd)
    v = (h @ lp["wv"]).reshape(B, S, nkv, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    # attn_fn hook: flash attention (or ring attention) substitutes here
    attn = (attn_fn or attention)(q, k, v)
    return x + attn.reshape(B, S, nh * hd) @ lp["wo"]


def block(x: torch.Tensor, lp: dict[str, torch.Tensor], cfg: LlamaConfig,
          positions: torch.Tensor, attn_fn: Callable | None = None) -> torch.Tensor:
    x = attention_residual(x, lp, cfg, positions, attn_fn)
    h = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    gated = F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])
    return x + gated @ lp["w_down"]


class Llama(nn.Module):
    """The model's parameters, named as the reference's pytree leaves (the
    ``layers`` sub-dict flattened), and its forward / loss. ``tp``: the
    tensor-parallel axis once :meth:`shard_` kept this rank's blocks, else
    None."""

    def __init__(self, cfg: LlamaConfig, *, device: Any = None,
                 generator: torch.Generator | None = None,
                 attn_fn: Callable | None = None):
        super().__init__()
        from strom_torch.delivery.core import resolve_device

        device = resolve_device(device)
        self.cfg = cfg
        self.attn_fn = attn_fn
        for name, shape in param_shapes(cfg).items():
            if _is_norm(name):
                t = torch.ones(shape, dtype=torch.float32, device=device)
            else:
                # N(0, 1/fan_in) drawn in f32, then cast (as the reference)
                fan_in = cfg.d_model if name == "embed" else shape[-2]
                t = torch.randn(shape, generator=generator, device=device,
                                dtype=torch.float32)
                t = t.mul_(1.0 / math.sqrt(fan_in)).to(cfg.torch_dtype)
            self.register_parameter(name, nn.Parameter(t))
        self.tp: AxisGroup | None = None

    @torch.no_grad()
    def shard_(self, mesh: Mesh) -> "Llama":
        """Keep only this rank's block of each parameter, by
        ``param_shardings`` over *mesh*, and run tensor-parallel over its
        ``tp`` axis from now on. Nothing changes where tp is 1."""
        from strom_torch.parallel.sharding import shard_params
        from strom_torch.parallel.tensor_parallel import check_tp

        tp = mesh.axis("tp")
        if tp.size == 1:
            return self
        check_tp(self.cfg, tp.size)
        full = {n: p.detach() for n, p in self.named_parameters()}
        for name, t in shard_params(full, mesh).items():
            # a copy: the full tensor goes with the old parameter
            setattr(self, name, nn.Parameter(t.clone(
                memory_format=torch.contiguous_format)))
        self.tp = tp
        return self

    def forward(self, tokens: torch.Tensor, positions: torch.Tensor | None = None,
                attn_fn: Callable | None = None, remat: bool = False
                ) -> torch.Tensor:
        """tokens [B, S] integer → logits [B, S, vocab] float32 (under tp,
        this rank's vocab columns [B, S, vocab/tp]). *positions* [B, S]:
        the tokens' places in the whole sequence (default 0..S-1)."""
        from strom_torch.parallel import tensor_parallel as tpl

        cfg = self.cfg
        attn_fn = attn_fn or self.attn_fn
        B, S = tokens.shape
        if positions is None:
            positions = torch.arange(S, device=tokens.device).expand(B, S)
        x = self.embed[tokens.long()]
        blk = block
        if self.tp is not None:
            x = tpl.gather_from_tp(x, self.tp)
            blk = partial(tpl.block_tp, tp=self.tp)
        x = x.to(cfg.torch_dtype)
        for i in range(cfg.n_layers):
            lp = {n: getattr(self, n)[i] for n in LAYER_PARAMS}
            if remat:
                # the block draws no random numbers: no RNG state to keep
                # for the recompute (whose get/set would break a capture)
                x = checkpoint(blk, x, lp, cfg, positions, attn_fn,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = blk(x, lp, cfg, positions, attn_fn)
        x = rmsnorm(x, self.final_norm, cfg.norm_eps)
        if self.tp is not None:
            x = tpl.copy_to_tp(x, self.tp)
        return (x @ self.lm_head).float()


def next_token_loss(model: Llama, tokens: torch.Tensor, attn_fn=None,
                    remat: bool = False, sp: AxisGroup | None = None
                    ) -> torch.Tensor:
    """Mean cross-entropy of predicting tokens[:, 1:] from tokens[:, :-1],
    computed as a full-length forward plus roll-and-mask (as the reference:
    every tensor keeps one sequence length).

    *sp*: *tokens* [B, L/n] is shard ``sp.index`` of n of each row, as
    ``strom/parallel/pipeline.py`` takes it: RoPE sees global positions,
    the last column's target is the next shard's first token (one
    neighbour permute), only the last shard masks its last column, and the
    sum divides by B·(L−1) of the whole rows, so the shards' losses sum to
    the rows' mean."""
    logits = model(tokens, positions=shard_positions(tokens, sp),
                   attn_fn=attn_fn, remat=remat)
    return lm_loss(logits, tokens, sp, model.tp)


def shard_positions(tokens: torch.Tensor, sp: AxisGroup | None
                    ) -> torch.Tensor:
    """[B, S] global positions of *tokens*, shard ``sp.index`` of each row
    (the whole rows without *sp*)."""
    B, S = tokens.shape
    idx = sp.index if sp is not None else 0
    return (idx * S + torch.arange(S, device=tokens.device)).expand(B, S)


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor,
            sp: AxisGroup | None = None, tp: AxisGroup | None = None
            ) -> torch.Tensor:
    """:func:`next_token_loss` from the *logits* of *tokens* (under *tp*
    this rank's vocab columns)."""
    B, S = tokens.shape
    n, idx = (sp.size, sp.index) if sp is not None else (1, 0)
    toks = tokens.long()
    if n > 1:
        from strom_torch.parallel.ring import ppermute

        nxt = ppermute(toks[:, :1], [(i, (i - 1) % n) for i in range(n)], sp)
        targets = torch.cat([toks[:, 1:], nxt], dim=1)
    else:
        targets = torch.roll(toks, -1, dims=1)
    if tp is not None:
        from strom_torch.parallel.tensor_parallel import vocab_parallel_ce

        per = vocab_parallel_ce(logits, targets, tp)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        per = logz - torch.gather(logits, -1, targets[..., None])[..., 0]
    # only the globally last column has no target
    cols = torch.arange(S, device=tokens.device)
    mask = (cols < S - 1 if idx == n - 1 else cols >= 0).float()
    return (per * mask).sum() / (B * (n * S - 1))


def params_from_jax(np_params: dict) -> dict[str, torch.Tensor]:
    """``strom.models.llama.init_params`` output, taken to numpy, → a state
    dict for :class:`Llama` (same orientation: nothing is transposed).
    bfloat16 leaves may arrive as ml_dtypes bfloat16 arrays: they are
    widened to f32 and cast back, which is exact. Every leaf is copied, so
    the tensors own writable memory."""
    flat = {k: v for k, v in np_params.items() if k != "layers"}
    flat.update(np_params.get("layers", {}))
    out = {}
    for name, arr in flat.items():
        a = np.asarray(arr)
        if a.dtype.name == "bfloat16":
            out[name] = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            out[name] = torch.from_numpy(np.array(a))
    return out
