"""Training steps, single device: the flagship Llama model (the port's
counterpart of ``strom/parallel/train.py``), and ResNet-50 and ViT-B/16
under plain SGD (``make_resnet_sgd_step`` and ``make_vit_sgd_step``, the
counterparts of the ``sgd_step`` that ``strom/cli.py``'s ResNet and ViT
benches build).

The optimizer reproduces the reference's optax chain: clip-by-global-norm
1.0, then AdamW (b1 0.9, b2 0.999, eps 1e-8, weight decay on every
parameter) on a warmup-cosine schedule from 0 to ``lr`` over ``warmup``
steps, decaying to 0.1·lr at step 10 000. As in optax, the first update
uses schedule step 0 (lr = 0), and the AdamW moments stay in the parameter
dtype; it runs as one fused pass (``torch.optim.AdamW(fused=True)``) whose
learning rate is a 0-dim device tensor that the schedule fills in place.

On a CUDA device each step runs as one captured CUDA graph, replayed on
every call (``strom_torch.parallel.capture``), where the reference jits the
step and donates its state; on the CPU the same body runs eagerly. Either
way the updates are in place: parameters, moments and batch-norm
statistics are overwritten, and the step body never waits for the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from strom_torch.delivery.core import resolve_device
from strom_torch.models.llama import Llama, LlamaConfig, next_token_loss
from strom_torch.models import vit
from strom_torch.models.resnet import (ResNet, ResNetConfig, imagenet_mean_std,
                                       loss_fn, normalize_images)
from strom_torch.parallel.capture import CapturedStep

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
        """Fused AdamW over *params*, its lr a 0-dim f32 tensor on their
        device (a graph reads it where it lies; ``LambdaLR`` fills it in
        place before each step), and the warmup-cosine schedule."""
        params = list(params)
        device = params[0].device
        lr = torch.tensor(self.lr, dtype=torch.float32, device=device)
        opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=self.weight_decay, fused=True,
                                capturable=device.type == "cuda")
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
    """sqrt of the sum of squares of every element, in f32: each tensor's
    norm accumulated in f32 without an f32 copy of it, then the norm of
    those."""
    return torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(list(tensors), 2, dtype=torch.float32)))


def make_train_step(cfg: LlamaConfig, optimizer: OptimizerSpec | None = None,
                    *, attn: str = "dense", device: Any = None) -> CapturedStep:
    """A ``(state, tokens) -> (state, metrics)`` step; metrics are
    ``{"loss", "grad_norm"}`` as 0-dim tensors (reading them waits for the
    step). On CUDA the step is captured as a graph (``CapturedStep``; its
    ``eager`` is the same step op by op). attn="flash": the CUDA
    flash-attention kernels (blockwise forward and backward) replace the
    dense op in every layer."""
    if attn not in ("dense", "flash"):
        raise ValueError(f"attn must be 'dense' or 'flash', got {attn!r}")
    device = resolve_device(device)
    spec = optimizer or make_optimizer()
    attn_fn = None
    if attn == "flash":
        from strom_torch.ops.flash_attention import make_flash_attention

        attn_fn = make_flash_attention()

    def body(state: TrainState, tokens: torch.Tensor) -> dict:
        params = list(state.model.parameters())
        state.optimizer.zero_grad(set_to_none=True)
        loss = next_token_loss(state.model, tokens, attn_fn=attn_fn, remat=True)
        loss.backward()
        grads = [p.grad for p in params]
        norm = global_norm(grads)
        # optax.clip_by_global_norm: scale by max_norm / norm when above it
        clip = torch.clamp(spec.max_grad_norm / norm, max=1.0)
        torch._foreach_mul_(grads, clip)
        state.optimizer.step()
        return {"loss": loss.detach(), "grad_norm": norm}

    def finish(state: TrainState, metrics: dict):
        # on the host, outside the graph: the next step's lr, filled into
        # the optimizer's lr tensor in place
        state.scheduler.step()
        state.step += 1
        return state, metrics

    return CapturedStep(body, device, finish=finish)


def make_resnet_sgd_step(cfg: ResNetConfig, *, lr: float = 1e-3,
                         device: Any = None) -> CapturedStep:
    """A ``(model, images, labels) -> metrics`` step: the counterpart of
    ``sgd_step`` in ``strom/cli.py``'s ResNet bench. uint8 NHWC images are
    normalised inside the step, labels taken ``% num_classes``; then plain
    SGD ``w - lr·g`` over every parameter (batch-norm scale and bias
    included), rounded as the JAX package rounds it (``lr·g`` in the
    parameter's dtype, then the difference), and the new batch-norm
    statistics stored. Updates are in place, where the reference's jitted
    step donated its parameters; on CUDA the step is captured as a graph.
    Metrics ``{"loss", "grad_norm"}`` are 0-dim tensors (reading them waits
    for the step)."""
    device = resolve_device(device)
    mean_std = imagenet_mean_std(device)

    def body(model: ResNet, images: torch.Tensor, labels: torch.Tensor
             ) -> dict:
        params = list(model.parameters())
        for p in params:
            p.grad = None
        loss, new_state = loss_fn(model, normalize_images(images, mean_std),
                                  labels.long() % cfg.num_classes)
        loss.backward()
        grads = [p.grad for p in params]
        norm = global_norm(grads)
        with torch.no_grad():
            torch._foreach_sub_(params, torch._foreach_mul(grads, lr))
            model.load_bn_state(new_state)
        return {"loss": loss.detach(), "grad_norm": norm}

    return CapturedStep(body, device)


def make_vit_sgd_step(cfg: vit.ViTConfig, *, lr: float = 1e-3,
                      device: Any = None) -> CapturedStep:
    """A ``(model, images, labels) -> metrics`` step: the counterpart of the
    ``sgd_step`` of ``strom/cli.py``'s ViT bench. The loss is taken on
    ``normalize_images(images)`` and ``labels % num_classes``; then
    ``w - lr·g`` in each parameter's own dtype (bf16 parameters stay bf16,
    with no f32 master copy), in place, where the reference's jitted step
    donated its parameters; on CUDA the step is captured as a graph.
    Metrics ``{"loss", "grad_norm"}`` are 0-dim tensors (reading them waits
    for the step)."""
    device = resolve_device(device)
    mean_std = imagenet_mean_std(device)

    def body(model: vit.ViT, images: torch.Tensor, labels: torch.Tensor
             ) -> dict:
        params = list(model.parameters())
        for p in params:
            p.grad = None
        loss = vit.loss_fn(model, normalize_images(images, mean_std),
                           labels.long() % cfg.num_classes)
        loss.backward()
        grads = [p.grad for p in params]
        norm = global_norm(grads)
        with torch.no_grad():
            torch._foreach_sub_(params, torch._foreach_mul(grads, lr))
        return {"loss": loss.detach(), "grad_norm": norm}

    return CapturedStep(body, device)
