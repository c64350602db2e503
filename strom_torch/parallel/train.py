"""Training step for the flagship model, single device (the port's
counterpart of ``strom/parallel/train.py``).

The optimizer reproduces the reference's optax chain: clip-by-global-norm
1.0, then AdamW (b1 0.9, b2 0.999, eps 1e-8, weight decay on every
parameter) on a warmup-cosine schedule from 0 to ``lr`` over ``warmup``
steps, decaying to 0.1·lr at step 10 000. As in optax, the first update
uses schedule step 0 (lr = 0), and the AdamW moments stay in the parameter
dtype. Updates are in place: the parameters and moments are overwritten,
where the reference's jitted step donated its state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from strom_torch.delivery.core import resolve_device
from strom_torch.models.llama import Llama, LlamaConfig, next_token_loss

DECAY_STEPS = 10_000


def warmup_cosine(step: int, *, warmup: int, decay_steps: int = DECAY_STEPS,
                  end_frac: float = 0.1) -> float:
    """optax.warmup_cosine_decay_schedule(0, 1, warmup, decay_steps,
    end_frac) at *step*: the factor LambdaLR multiplies the peak lr by."""
    if warmup > 0 and step < warmup:
        return step / warmup
    span = max(decay_steps - warmup, 1)
    t = min(step - warmup, span)
    cosine = 0.5 * (1.0 + math.cos(math.pi * t / span))
    return (1.0 - end_frac) * cosine + end_frac


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    lr: float = 3e-4
    weight_decay: float = 0.1
    warmup: int = 100
    max_grad_norm: float = 1.0

    def build(self, params) -> tuple[torch.optim.Optimizer,
                                     torch.optim.lr_scheduler.LambdaLR]:
        opt = torch.optim.AdamW(params, lr=self.lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=self.weight_decay)
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda s: warmup_cosine(s, warmup=self.warmup))
        return opt, sched


def make_optimizer(lr: float = 3e-4, weight_decay: float = 0.1,
                   warmup: int = 100) -> OptimizerSpec:
    return OptimizerSpec(lr=lr, weight_decay=weight_decay, warmup=warmup)


@dataclasses.dataclass
class TrainState:
    model: Llama
    optimizer: torch.optim.Optimizer
    scheduler: Any
    step: int = 0


def init_train_state(cfg: LlamaConfig, optimizer: OptimizerSpec | None = None,
                     *, device: Any = None, seed: int = 0,
                     params: dict[str, torch.Tensor] | None = None) -> TrainState:
    """Model (random from *seed*, or *params*, e.g. from
    ``models.llama.params_from_jax``) and optimizer state on *device*."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = Llama(cfg, device=device, generator=gen)
    if params is not None:
        model.load_state_dict(params)
    opt, sched = (optimizer or make_optimizer()).build(model.parameters())
    return TrainState(model, opt, sched)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors]))


def make_train_step(cfg: LlamaConfig, optimizer: OptimizerSpec | None = None,
                    *, attn: str = "dense", device: Any = None
                    ) -> Callable[[TrainState, torch.Tensor],
                                  tuple[TrainState, dict]]:
    """A ``(state, tokens) -> (state, metrics)`` step; metrics are
    ``{"loss", "grad_norm"}`` as 0-dim tensors (reading them waits for the
    step). attn="flash": the CUDA flash-attention kernels (blockwise forward
    and backward) replace the dense op in every layer."""
    if attn not in ("dense", "flash"):
        raise ValueError(f"attn must be 'dense' or 'flash', got {attn!r}")
    device = resolve_device(device)
    spec = optimizer or make_optimizer()
    attn_fn = None
    if attn == "flash":
        from strom_torch.ops.flash_attention import make_flash_attention

        attn_fn = make_flash_attention()

    def step(state: TrainState, tokens: torch.Tensor):
        params = [p for p in state.model.parameters()]
        tokens = tokens.to(device, non_blocking=True)
        state.optimizer.zero_grad(set_to_none=True)
        loss = next_token_loss(state.model, tokens, attn_fn=attn_fn, remat=True)
        loss.backward()
        grads = [p.grad for p in params]
        norm = global_norm(grads)
        # optax.clip_by_global_norm: scale by max_norm / norm when above it
        clip = torch.clamp(spec.max_grad_norm / norm, max=1.0)
        torch._foreach_mul_(grads, clip)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": norm}

    return step
