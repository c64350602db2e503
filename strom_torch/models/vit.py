"""ViT-B/16, the consumer of the WebDataset loader of BASELINE config #3
("WebDataset .tar shards → ViT-B/16 training loader (4×NVMe RAID0)"); the
port's counterpart of ``strom/models/vit.py``.

The same network and numerics as the JAX package's:

- images arrive NHWC from the loader and stay NHWC; ``patchify`` is one
  reshape and permute into ``[B, N, P·P·3]`` row-major patches, and the
  embedding one matmul with ``patch_embed [P·P·3, D]`` (not a convolution),
  so the JAX weights load as they are;
- weights and activations in ``cfg.dtype`` (bf16), ``cls_token`` and
  ``pos_embed`` included; layer norm in f32 with the biased variance, eps
  1e-6, cast back to the input's dtype; the head in f32 on the cls token;
- attention is the reference's dense ``attention(causal=False)``, bf16
  scores before an f32 softmax as the JAX einsums give them, with the keys
  and values zero-padded to a multiple of 8 rows (:func:`attention`); GELU
  is the tanh approximation, ``jax.nn.gelu``'s default;
- the reference's ``lax.scan`` over parameters stacked ``[L, ...]`` is a
  loop over an ``nn.ModuleList`` of one :class:`Block` per layer;
  :func:`params_from_jax` splits the stacked arrays.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from strom_torch.delivery.core import resolve_device
from strom_torch.models.resnet import softmax_xent

SCORE_ROWS = 8   # keys padded to a multiple of this: 8 bf16 scores are 16 bytes


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch: int = 16
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_mlp: int = 3072
    num_classes: int = 1000
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch) ** 2

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @classmethod
    def vit_b16(cls) -> "ViTConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "ViTConfig":
        """~300k params; unit tests (input 32×32)."""
        return cls(image_size=32, patch=8, d_model=64, n_layers=2, n_heads=4,
                   d_mlp=128, num_classes=10)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """f32 statistics (biased variance), f32 scale and bias, cast back."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B,H,W,C] → [B, N, patch*patch*C] row-major patches."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, patch * patch * C)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """The reference's dense attention, not causal (``strom/models/vit.py``
    calls ``strom.models.llama.attention(causal=False)``): q, k, v [B,S,H,Dh]
    → [B,S,H,Dh], f32 softmax over the scaled scores.

    The keys and values are zero-padded to a multiple of ``SCORE_ROWS``
    (ViT-B/16's S 197 to 200) and the padded keys' scores set to -inf
    before the softmax, so their probabilities are exactly 0: the GEMMs'
    reduction over the keys gains only zero terms, and every row of scores
    and probabilities starts on a 16-byte boundary, which lets cuBLAS take
    its aligned kernels (a 197-element bf16 row is 394 bytes)."""
    B, S, H, Dh = q.shape
    pad = -S % SCORE_ROWS
    if pad:
        k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (k, v))
    scores = torch.einsum("bqhd,bshd->bhqs", q, k).float() / math.sqrt(Dh)
    if pad:
        scores[..., S:] = float("-inf")
    probs = torch.softmax(scores, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0).to(v.dtype)  # as the reference
    return torch.einsum("bhqs,bshd->bqhd", probs, v)


def _dense(shape: tuple[int, ...], dtype, device, gen) -> nn.Parameter:
    """N(0, 1/fan_in) drawn in f32, then cast (as the reference)."""
    t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return nn.Parameter(t.mul_(1.0 / math.sqrt(shape[-2])).to(dtype))


def _const(shape: tuple[int, ...], value: float, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, dtype=dtype, device=device))


class LayerNorm(nn.Module):
    """f32 ``scale`` and ``bias`` of one layer norm."""

    def __init__(self, d: int, device):
        super().__init__()
        self.scale = _const((d,), 1.0, torch.float32, device)
        self.bias = _const((d,), 0.0, torch.float32, device)

    def forward(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, eps)


class Block(nn.Module):
    """One pre-norm encoder layer: x + attn(ln1(x)), then x + mlp(ln2(x))."""

    def __init__(self, cfg: ViTConfig, device, gen):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_mlp, cfg.torch_dtype
        self.cfg = cfg
        self.ln1 = LayerNorm(d, device)
        self.wqkv = _dense((d, 3 * d), dt, device, gen)
        self.wo = _dense((d, d), dt, device, gen)
        self.ln2 = LayerNorm(d, device)
        self.w1 = _dense((d, f), dt, device, gen)
        self.b1 = _const((f,), 0.0, dt, device)
        self.w2 = _dense((f, d), dt, device, gen)
        self.b2 = _const((d,), 0.0, dt, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, S, D = x.shape
        h = self.ln1(x, cfg.norm_eps)
        q, k, v = (h @ self.wqkv).reshape(B, S, 3, cfg.n_heads,
                                          cfg.head_dim).unbind(2)
        x = x + attention(q, k, v).reshape(B, S, D) @ self.wo
        h = self.ln2(x, cfg.norm_eps)
        h = F.gelu(h @ self.w1 + self.b1, approximate="tanh") @ self.w2 + self.b2
        return x + h


class Head(nn.Module):
    def __init__(self, d: int, num_classes: int, device, gen):
        super().__init__()
        self.w = _dense((d, num_classes), torch.float32, device, gen)
        self.b = _const((num_classes,), 0.0, torch.float32, device)


class ViT(nn.Module):
    """The model's parameters, named as the reference's pytree leaves with
    the stacked layers split per layer (``layers.<i>.wqkv``), and its
    forward."""

    def __init__(self, cfg: ViTConfig, *, device: Any = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        d, dt = cfg.d_model, cfg.torch_dtype
        self.cfg = cfg
        self.patch_embed = _dense((cfg.patch * cfg.patch * 3, d), dt, device,
                                  generator)
        self.patch_bias = _const((d,), 0.0, dt, device)
        self.cls_token = _const((1, 1, d), 0.0, dt, device)
        pos = torch.randn((1, cfg.n_patches + 1, d), generator=generator,
                          device=device, dtype=torch.float32)
        self.pos_embed = nn.Parameter(pos.mul_(0.02).to(dt))
        self.layers = nn.ModuleList(Block(cfg, device, generator)
                                    for _ in range(cfg.n_layers))
        self.final_ln = LayerNorm(d, device)
        self.head = Head(d, cfg.num_classes, device, generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B,H,W,3] (normalised float) → logits [B, classes] f32."""
        cfg = self.cfg
        B = images.shape[0]
        x = patchify(images.to(cfg.torch_dtype), cfg.patch)
        x = x @ self.patch_embed + self.patch_bias
        cls = self.cls_token.expand(B, 1, cfg.d_model)
        x = torch.cat([cls, x], dim=1) + self.pos_embed
        for block in self.layers:
            x = block(x)
        x = self.final_ln(x, cfg.norm_eps)
        return x[:, 0].float() @ self.head.w + self.head.b


def loss_fn(model: ViT, images: torch.Tensor, labels: torch.Tensor
            ) -> torch.Tensor:
    return softmax_xent(model(images), labels)


def params_from_jax(np_params: dict) -> dict[str, torch.Tensor]:
    """``strom.models.vit.init_params`` output, taken to numpy, → a
    ``ViT.state_dict()``: the stacked ``[L, ...]`` layer arrays split per
    layer, nothing transposed. bf16 leaves (ml_dtypes arrays) go through
    f32, which is exact."""

    def t(a) -> torch.Tensor:
        arr = np.asarray(a)
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(arr.astype(np.float32)).bfloat16()
        return torch.from_numpy(arr.copy())

    out = {name: t(np_params[name]) for name in
           ("patch_embed", "patch_bias", "cls_token", "pos_embed")}
    for ln in ("scale", "bias"):
        out[f"final_ln.{ln}"] = t(np_params["final_ln"][ln])
    out["head.w"], out["head.b"] = (t(np_params["head"][k]) for k in "wb")
    for name, arr in np_params["layers"].items():
        if isinstance(arr, dict):   # a layer norm's stacked scale and bias
            for ln, a in arr.items():
                for i, x in enumerate(t(a)):
                    out[f"layers.{i}.{name}.{ln}"] = x.clone()
        else:
            for i, x in enumerate(t(arr)):
                out[f"layers.{i}.{name}"] = x.clone()
    return out
