"""Training steps: the flagship Llama model and its MoE variant (the
port's counterpart of ``strom/parallel/train.py``), and ResNet-50 and ViT-B/16
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

Given a mesh, the Llama step runs over its ``dp``, ``tp`` and ``sp``
axes, one process a card, where the reference lets XLA place every
collective. Each process runs its block of the global batch (the
``DTensor`` the sharded loader delivers, or its local block): its rows on
dp, and with ``sp=True`` its slice of each row on sp, attention then
running the ring (``parallel/ring.py``). Under tp the model holds this
rank's parameter blocks and runs the Megatron block
(``parallel/tensor_parallel.py``). After ``backward`` the gradients are
summed over the ranks that share this rank's tp coordinate (the dp×sp
group; NCCL on the card, gloo on the CPU) in one flat bucket a dtype and
divided by the dp size (and by the sp size where sp does not split the
rows), before the global norm and the clip, so the norm is the global
batch's as in the reference; the norm sums each tp shard's squares over
tp and counts a replicated parameter once. The loss it reports is the
group's mean, the same on every rank. The collectives, the ring's
send/recv pairs among them, are captured in the step's graph with the
rest. The MoE step (``make_moe_train_step``) runs the same way over
``dp``, ``sp`` and ``ep``: each rank holds its ``E/ep`` experts, routes
its tokens by the global batch's queues and sums its experts' outputs
over ep (``parallel/expert_parallel.py``); the global norm sums the
expert gradients' squares over ep. The vision steps are data-parallel
over ``dp``; the ResNet step also takes its batch-norm statistics over
the global batch, as the reference's jitted step does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist

from strom_torch.delivery.core import resolve_device
from strom_torch.models.llama import Llama, LlamaConfig, next_token_loss
from strom_torch.models import vit
from strom_torch.models.moe import MoE, MoEConfig
from strom_torch.models.resnet import (DpGroup, ResNet, ResNetConfig,
                                       imagenet_mean_std, loss_fn,
                                       normalize_images)
from strom_torch.parallel.capture import CapturedStep
from strom_torch.parallel.mesh import Mesh
from strom_torch.parallel.sharding import param_shardings

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
                     params: dict[str, torch.Tensor] | None = None,
                     mesh: Mesh | None = None) -> TrainState:
    """Model (random from *seed*, or *params*, e.g. from
    ``models.llama.params_from_jax``) and optimizer state on *device*.
    With a *mesh* the full parameters are made (or taken) first, then this
    rank keeps its tp blocks (``Llama.shard_``) and every replica starts
    from those of the first rank of its dp×sp group (broadcast); the fused
    AdamW holds this rank's blocks only."""
    return _init_state(Llama, cfg, optimizer, device, seed, params, mesh)


def init_moe_train_state(cfg: MoEConfig,
                         optimizer: OptimizerSpec | None = None, *,
                         device: Any = None, seed: int = 0,
                         params: dict[str, torch.Tensor] | None = None,
                         mesh: Mesh | None = None) -> TrainState:
    """:func:`init_train_state` for the MoE model (``models/moe.py``;
    *params* e.g. from its ``params_from_jax``): with a *mesh* this rank
    keeps its experts of each expert stack (``MoE.shard_``, dim 1 over
    ep) and every replica over dp and sp starts from the first rank of its
    group, each ep coordinate's with its own experts."""
    return _init_state(MoE, cfg, optimizer, device, seed, params, mesh)


def _init_state(model_cls, cfg, optimizer, device, seed, params, mesh
                ) -> TrainState:
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = model_cls(cfg, device=device, generator=gen)
    if params is not None:
        model.load_state_dict(params)
    if mesh is not None:
        model.shard_(mesh)
        replicate(model, mesh)
    opt, sched = (optimizer or make_optimizer()).build(model.parameters())
    return TrainState(model, opt, sched)


@torch.no_grad()
def replicate(model: torch.nn.Module, mesh: Mesh) -> None:
    """Make every replica of *model* over the mesh's dp and sp axes hold
    the parameters and buffers of the first rank of its group, the ranks
    that share its tp and ep coordinates (broadcast in place): under tp or
    ep each group broadcasts its own shards."""
    group = mesh.group("dp", "sp")
    if group is None:
        return
    src = mesh.group_ranks("dp", "sp")[0]
    for t in list(model.parameters()) + list(model.buffers()):
        dist.broadcast(t, src=src, group=group)


def _named_optimizer_state(state: TrainState) -> dict[str, dict]:
    """The optimizer's per-parameter state keyed by parameter name, each
    created as AdamW creates it at its first step (zero moments in the
    parameter's dtype, a zero ``step``) where the state has not stepped:
    AdamW then finds it and starts from it, so creating it early changes
    nothing."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    out = {}
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            st = state.optimizer.state[p]
            if not st:
                st["step"] = torch.zeros((), dtype=torch.float32,
                                         device=p.device) \
                    if group["fused"] or group["capturable"] \
                    else torch.tensor(0.0)
                st["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
            out[names[id(p)]] = st
    return out


def train_state_tree(state: TrainState) -> dict:
    """A Llama TrainState as a nested dict of its tensors, the tree a
    checkpoint saves: ``model`` (its ``state_dict``), ``optimizer`` (each
    parameter's AdamW state by name), ``lr`` (the optimizer's lr tensor),
    ``scheduler`` (``last_epoch``) and ``step``. The tensors are the
    state's own, not copies; the counterpart of handing the reference an
    abstract TrainState, and a restore's template. A tp- or ep-sharded
    state raises NotImplementedError: its checkpoint is not ported yet."""
    if state.model.tp is not None:
        raise NotImplementedError(
            "a checkpoint of a tp-sharded state (each rank holds its tp "
            "blocks) is not ported yet: ROADMAP.md, Queue A, item 1")
    if getattr(state.model, "ep", None) is not None:
        raise NotImplementedError(
            "a checkpoint of an ep-sharded state (each rank holds its "
            "experts) is not ported yet: ROADMAP.md, Queue A, item 3")
    lr = state.optimizer.param_groups[0]["lr"]
    return {"model": dict(state.model.state_dict()),
            "optimizer": {k: dict(v) for k, v in
                          _named_optimizer_state(state).items()},
            "lr": lr,
            "scheduler": {"last_epoch": int(state.scheduler.last_epoch)},
            "step": int(state.step)}


@torch.no_grad()
def load_train_state(state: TrainState, tree: dict) -> TrainState:
    """Copy a restored :func:`train_state_tree` into *state* in place:
    every tensor keeps its address, so a graph captured over the state
    stays valid and its next replay continues from the restored values.
    Creates the optimizer state where the state has not stepped yet."""
    sd = state.model.state_dict()
    if set(sd) != set(tree["model"]):
        raise ValueError("model keys differ: "
                         f"{sorted(set(sd) ^ set(tree['model']))}")
    for k, v in tree["model"].items():
        sd[k].copy_(v)
    opt = _named_optimizer_state(state)
    if set(opt) != set(tree["optimizer"]):
        raise ValueError("optimizer state names differ")
    for name, st in opt.items():
        for k, v in tree["optimizer"][name].items():
            st[k].copy_(v)
    group = state.optimizer.param_groups[0]
    if isinstance(group["lr"], torch.Tensor):
        group["lr"].copy_(tree["lr"])
    else:
        group["lr"] = float(tree["lr"])
    state.scheduler.last_epoch = int(tree["scheduler"]["last_epoch"])
    state.step = int(tree["step"])
    return state


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32: each tensor's
    norm accumulated in f32 without an f32 copy of it, then the norm of
    those."""
    return torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(list(tensors), 2, dtype=torch.float32)))


def _dp_group(mesh: Mesh):
    """(the dp axis's process group, its size) for the vision steps, which
    are data-parallel only."""
    if "dp" not in mesh.axis_names:
        raise ValueError(f"a data-parallel step needs a 'dp' axis, the mesh "
                         f"has {mesh.axis_names}")
    other = {a: n for a, n in mesh.shape.items() if a != "dp" and n > 1}
    if other:
        raise NotImplementedError(
            f"mesh axes {other}: the vision steps are data-parallel only")
    return mesh.device_mesh.get_group("dp"), mesh.shape["dp"]


def _check_axes(mesh: Mesh, sp: bool, axes: tuple[str, ...],
                why: str) -> None:
    """Raise for an axis above 1 outside *axes*, and for sp=True on a mesh
    without an sp axis."""
    other = {a: n for a, n in mesh.shape.items() if a not in axes and n > 1}
    if other:
        raise NotImplementedError(f"mesh axes {other}: {why}")
    if sp and "sp" not in mesh.axis_names:
        raise ValueError(f"sp=True shards the sequence over an 'sp' axis, "
                         f"the mesh has {mesh.axis_names}")


def _check_llama_mesh(cfg: LlamaConfig, mesh: Mesh, sp: bool) -> None:
    _check_axes(mesh, sp, ("dp", "tp", "sp"),
                "the Llama step runs over dp, tp and sp; pp comes with the "
                "pipeline slice (ROADMAP.md, Queue A, item 1), ep is the "
                "MoE step's (make_moe_train_step)")
    if mesh.axis_size("tp") > 1:
        from strom_torch.parallel.tensor_parallel import check_tp

        check_tp(cfg, mesh.axis_size("tp"))


def _check_moe_mesh(cfg: MoEConfig, mesh: Mesh, sp: bool) -> None:
    _check_axes(mesh, sp, ("dp", "sp", "ep"),
                "the MoE step runs over dp, sp and ep; MoE under tp or pp "
                "is not ported (ROADMAP.md, Queue A, item 3)")
    if cfg.n_experts % mesh.axis_size("ep"):
        raise ValueError(f"n_experts {cfg.n_experts} must divide by ep "
                         f"{mesh.axis_size('ep')}")


def _sharded_global_norm(grads: list[torch.Tensor], sharded: list[bool],
                         group) -> torch.Tensor:
    """The global norm of gradients of which those flagged *sharded* are
    this rank's blocks (tp or ep): their squares summed over the *group*
    of the axis that splits them, each replicated one counted once."""
    def sq(ts):
        norms = torch.stack(torch._foreach_norm(ts, 2, dtype=torch.float32))
        return (norms * norms).sum()

    shard_sq = sq([g for g, s in zip(grads, sharded) if s])
    dist.all_reduce(shard_sq, group=group)
    return torch.sqrt(shard_sq + sq([g for g, s in zip(grads, sharded)
                                     if not s]))


def _mean_over(tensors: list[torch.Tensor], group, size: int
               ) -> list[torch.Tensor]:
    """The group's mean of each tensor: one flat bucket a dtype, summed in
    one all-reduce and divided by the group's size. Returns views of the
    buckets shaped as the tensors."""
    out: list = [None] * len(tensors)
    by_dtype: dict[torch.dtype, list[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)   # gloo has no AVG: sum, divide
        flat.div_(size)
        for i, piece in zip(idx, flat.split([tensors[i].numel()
                                             for i in idx])):
            out[i] = piece.view_as(tensors[i])
    return out


def make_train_step(cfg: LlamaConfig, optimizer: OptimizerSpec | None = None,
                    *, attn: str = "dense", device: Any = None,
                    mesh: Mesh | None = None, sp: bool = False
                    ) -> CapturedStep:
    """A ``(state, tokens) -> (state, metrics)`` step; metrics are
    ``{"loss", "grad_norm"}`` as 0-dim tensors (reading them waits for the
    step). On CUDA the step is captured as a graph (``CapturedStep``; its
    ``eager`` is the same step op by op). attn="flash": the CUDA
    flash-attention kernels (blockwise forward and backward) replace the
    dense op in every layer.

    *mesh* of ``dp``, ``tp`` and ``sp`` axes (the module's docstring):
    *tokens* is the global batch's ``DTensor``, ``P("dp", "sp")`` with
    ``sp=True``, else ``P("dp", None)``, or this process's block of it;
    the state comes from ``init_train_state(mesh=)``. ``sp=True``:
    activations stay sequence-sharded and attention runs the ring over the
    sp axis, with attn "dense" (the plain ring), "flash" (the flash
    kernels in each ring step) or "zigzag" (the load-balanced causal flash
    ring)."""
    _check_attn(attn, mesh, sp)
    tp_group, sp_axis, sharded = None, None, set()
    if mesh is not None:
        _check_llama_mesh(cfg, mesh, sp)
        tp_group = mesh.group("tp")
        if sp:
            sp_axis = mesh.axis("sp")
        if tp_group is not None:
            from strom_torch.models.llama import param_shapes

            sharded = {n for n, sh in param_shardings(
                param_shapes(cfg), mesh).items() if "tp" in sh.spec}
    attn_fn = _attn_fn(attn, mesh, sp)

    def loss_fn(state: TrainState, tokens: torch.Tensor) -> torch.Tensor:
        if (tp_group is None) != (state.model.tp is None):
            raise ValueError("the state's tp blocks do not match the mesh: "
                             "make it with init_train_state(mesh=)")
        return next_token_loss(state.model, tokens, attn_fn=attn_fn,
                               remat=True, sp=sp_axis)

    return _adamw_step(loss_fn, optimizer, device, mesh, sp, tp_group,
                       sharded)


def make_moe_train_step(cfg: MoEConfig,
                        optimizer: OptimizerSpec | None = None, *,
                        attn: str = "dense", device: Any = None,
                        mesh: Mesh | None = None, sp: bool = False
                        ) -> CapturedStep:
    """:func:`make_train_step` for the MoE model (``models/moe.py``):
    the loss adds the routers' aux losses, remat per layer. *mesh* of
    ``dp``, ``sp`` and ``ep`` axes (``parallel/expert_parallel.py``): the
    tokens as the Llama step takes them (``P("dp", "sp")`` with
    ``sp=True``, else ``P("dp", None)``), replicated over ep; the state
    from ``init_moe_train_state(mesh=)``, each rank holding its ``E/ep``
    experts. Capacity queues and the aux losses are the global batch's;
    the gradients are averaged over dp×sp as the Llama step's, and the
    global norm sums the expert gradients' squares over ep. A ``tp`` or
    ``pp`` axis above 1 raises NotImplementedError."""
    from strom_torch.models import moe
    from strom_torch.parallel.expert_parallel import token_layout

    _check_attn(attn, mesh, sp)
    ep_group, sp_axis, sharded = None, None, set()
    if mesh is not None:
        _check_moe_mesh(cfg, mesh, sp)
        ep_group = mesh.group("ep")
        if sp:
            sp_axis = mesh.axis("sp")
        if ep_group is not None:
            sharded = set(moe.EXPERT_PARAMS)
    layout = token_layout(mesh, sp)
    attn_fn = _attn_fn(attn, mesh, sp)

    def loss_fn(state: TrainState, tokens: torch.Tensor) -> torch.Tensor:
        if (ep_group is None) != (state.model.ep is None):
            raise ValueError("the state's experts do not match the mesh: "
                             "make it with init_moe_train_state(mesh=)")
        return moe.next_token_loss(state.model, tokens, attn_fn=attn_fn,
                                   remat=True, sp=sp_axis, layout=layout)

    return _adamw_step(loss_fn, optimizer, device, mesh, sp, ep_group,
                       sharded)


def _check_attn(attn: str, mesh: Mesh | None, sp: bool) -> None:
    if attn not in ("dense", "flash", "zigzag"):
        raise ValueError(
            f"attn must be 'dense', 'flash' or 'zigzag', got {attn!r}")
    if attn == "zigzag" and not sp:
        raise ValueError("attn='zigzag' is the load-balanced causal RING; "
                         "it needs sp=True")
    if sp and mesh is None:
        raise ValueError("sp=True shards the sequence over a mesh's 'sp' "
                         "axis: pass mesh=")


def _attn_fn(attn: str, mesh: Mesh | None, sp: bool):
    """The steps' attention: the ring over sp (the flash kernels inside it
    for "flash" and "zigzag"), else the flash kernels or the dense op."""
    if sp:
        from strom_torch.parallel.ring import make_ring_attention

        return make_ring_attention(mesh, axis="sp", impl=attn)
    if attn == "flash":
        from strom_torch.ops.flash_attention import make_flash_attention

        return make_flash_attention()
    return None


def _adamw_step(loss_fn, optimizer: OptimizerSpec | None, device: Any,
                mesh: Mesh | None, sp: bool, shard_group,
                sharded: set[str]) -> CapturedStep:
    """The captured step around ``loss_fn(state, tokens)``: backward; on a
    mesh the gradients and the loss averaged over the dp×sp group (divided
    by the dp size, and by the sp size where sp does not split the rows);
    the global norm (the *sharded* parameters' squares summed over
    *shard_group*); the clip; the fused AdamW."""
    group, divisor = None, 1
    if mesh is not None:
        group = mesh.group("dp", "sp")
        # sp ranks that hold the same rows are replicas: averaged too
        divisor = mesh.axis_size("dp") * (1 if sp else mesh.axis_size("sp"))
    device = resolve_device(device)
    spec = optimizer or make_optimizer()

    def body(state: TrainState, tokens: torch.Tensor) -> dict:
        named = list(state.model.named_parameters())
        params = [p for _, p in named]
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state, tokens)
        loss.backward()
        grads = [p.grad for p in params]
        loss = loss.detach()
        if group is not None:
            grads = _mean_over(grads, group, divisor)
            for p, g in zip(params, grads):
                p.grad = g
            loss = _mean_over([loss], group, divisor)[0]
        if shard_group is None:
            norm = global_norm(grads)
        else:
            norm = _sharded_global_norm(
                grads, [n in sharded for n, _ in named], shard_group)
        # optax.clip_by_global_norm: scale by max_norm / norm when above it
        clip = torch.clamp(spec.max_grad_norm / norm, max=1.0)
        torch._foreach_mul_(grads, clip)
        state.optimizer.step()
        return {"loss": loss, "grad_norm": norm}

    def finish(state: TrainState, metrics: dict):
        # on the host, outside the graph: the next step's lr, filled into
        # the optimizer's lr tensor in place
        state.scheduler.step()
        state.step += 1
        return state, metrics

    return CapturedStep(body, device, finish=finish)


def _dp_sgd(params: list[torch.Tensor], loss: torch.Tensor,
            dp: DpGroup | None, lr: float) -> dict:
    """The SGD tail of the vision steps after ``backward``: with a dp group
    the gradients and the loss become the group's means (one flat bucket a
    dtype); then the gradients' global norm and ``w - lr·g`` in place."""
    grads = [p.grad for p in params]
    loss = loss.detach()
    if dp is not None:
        grads = _mean_over(grads, dp.group, dp.size)
        loss = _mean_over([loss], dp.group, dp.size)[0]
    norm = global_norm(grads)
    with torch.no_grad():
        torch._foreach_sub_(params, torch._foreach_mul(grads, lr))
    return {"loss": loss, "grad_norm": norm}


def _vision_dp(mesh: Mesh | None) -> DpGroup | None:
    """The dp group of a vision step's *mesh* (None without one)."""
    if mesh is None:
        return None
    group, size = _dp_group(mesh)
    return DpGroup(group, size, dist.get_rank(group))


def make_resnet_sgd_step(cfg: ResNetConfig, *, lr: float = 1e-3,
                         device: Any = None, mesh: Mesh | None = None
                         ) -> CapturedStep:
    """A ``(model, images, labels) -> metrics`` step: the counterpart of
    ``sgd_step`` in ``strom/cli.py``'s ResNet bench. uint8 NHWC images are
    normalised inside the step, labels taken ``% num_classes``; then plain
    SGD ``w - lr·g`` over every parameter (batch-norm scale and bias
    included), rounded as the JAX package rounds it (``lr·g`` in the
    parameter's dtype, then the difference), and the new batch-norm
    statistics stored. Updates are in place, where the reference's jitted
    step donated its parameters; on CUDA the step is captured as a graph.
    Metrics ``{"loss", "grad_norm"}`` are 0-dim tensors (reading them waits
    for the step).

    *mesh* with a ``dp`` axis: the step is data-parallel over it, as the
    reference's jitted step is over a ``P("dp", ...)`` batch. The images
    and labels are the global batch's ``DTensor``s (or this process's rows
    of them); batch norm normalises over the global batch
    (``models.resnet.GlobalBatchNorm``), so the running statistics are the
    same on every rank; the gradients and the loss are the group's means,
    all-reduced in one flat bucket a dtype inside the captured graph."""
    device = resolve_device(device)
    mean_std = imagenet_mean_std(device)
    dp = _vision_dp(mesh)

    def body(model: ResNet, images: torch.Tensor, labels: torch.Tensor
             ) -> dict:
        params = list(model.parameters())
        for p in params:
            p.grad = None
        loss, new_state = loss_fn(model, normalize_images(images, mean_std),
                                  labels.long() % cfg.num_classes, dp=dp)
        loss.backward()
        metrics = _dp_sgd(params, loss, dp, lr)
        model.load_bn_state(new_state)
        return metrics

    return CapturedStep(body, device)


def make_vit_sgd_step(cfg: vit.ViTConfig, *, lr: float = 1e-3,
                      device: Any = None, mesh: Mesh | None = None
                      ) -> CapturedStep:
    """A ``(model, images, labels) -> metrics`` step: the counterpart of the
    ``sgd_step`` of ``strom/cli.py``'s ViT bench. The loss is taken on
    ``normalize_images(images)`` and ``labels % num_classes``; then
    ``w - lr·g`` in each parameter's own dtype (bf16 parameters stay bf16,
    with no f32 master copy), in place, where the reference's jitted step
    donated its parameters; on CUDA the step is captured as a graph.
    Metrics ``{"loss", "grad_norm"}`` are 0-dim tensors (reading them waits
    for the step). *mesh* with a ``dp`` axis: data-parallel over it, the
    gradients and the loss the group's means (the ViT has no batch
    norm)."""
    device = resolve_device(device)
    mean_std = imagenet_mean_std(device)
    dp = _vision_dp(mesh)

    def body(model: vit.ViT, images: torch.Tensor, labels: torch.Tensor
             ) -> dict:
        params = list(model.parameters())
        for p in params:
            p.grad = None
        loss = vit.loss_fn(model, normalize_images(images, mean_std),
                           labels.long() % cfg.num_classes)
        loss.backward()
        return _dp_sgd(params, loss, dp, lr)

    return CapturedStep(body, device)
