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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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


def block(x: torch.Tensor, lp: dict[str, torch.Tensor], cfg: LlamaConfig,
          positions: torch.Tensor, attn_fn: Callable | None = None) -> torch.Tensor:
    B, S, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    q = (h @ lp["wq"]).reshape(B, S, nh, hd)
    k = (h @ lp["wk"]).reshape(B, S, nkv, hd)
    v = (h @ lp["wv"]).reshape(B, S, nkv, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    # attn_fn hook: flash attention (or, later, ring attention) substitutes here
    attn = (attn_fn or attention)(q, k, v)
    x = x + attn.reshape(B, S, nh * hd) @ lp["wo"]
    h = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    gated = F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])
    return x + gated @ lp["w_down"]


class Llama(nn.Module):
    """The model's parameters, named as the reference's pytree leaves (the
    ``layers`` sub-dict flattened), and its forward / loss."""

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

    def forward(self, tokens: torch.Tensor, positions: torch.Tensor | None = None,
                attn_fn: Callable | None = None, remat: bool = False
                ) -> torch.Tensor:
        """tokens [B, S] integer → logits [B, S, vocab] float32."""
        cfg = self.cfg
        attn_fn = attn_fn or self.attn_fn
        B, S = tokens.shape
        if positions is None:
            positions = torch.arange(S, device=tokens.device).expand(B, S)
        x = self.embed[tokens.long()].to(cfg.torch_dtype)
        for i in range(cfg.n_layers):
            lp = {n: getattr(self, n)[i] for n in LAYER_PARAMS}
            if remat:
                x = checkpoint(block, x, lp, cfg, positions, attn_fn,
                               use_reentrant=False)
            else:
                x = block(x, lp, cfg, positions, attn_fn)
        x = rmsnorm(x, self.final_norm, cfg.norm_eps)
        return (x @ self.lm_head).float()


def next_token_loss(model: Llama, tokens: torch.Tensor, attn_fn=None,
                    remat: bool = False) -> torch.Tensor:
    """Mean cross-entropy of predicting tokens[:, 1:] from tokens[:, :-1],
    computed as a full-length forward plus roll-and-mask (as the reference:
    every tensor keeps one sequence length)."""
    B, L = tokens.shape
    logits = model(tokens, attn_fn=attn_fn, remat=remat)
    targets = torch.roll(tokens.long(), -1, dims=1)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    mask = (torch.arange(L, device=tokens.device) < L - 1).float()
    return ((logz - gold) * mask).sum() / (B * (L - 1))


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
