"""ResNet-50, the consumer of the vision pipelines (the port's counterpart of
``strom/models/resnet.py``).

The same network and numerics as the JAX package's:

- images arrive NHWC; the convolutions run on the logical NCHW view of that
  memory, which is PyTorch's ``channels_last`` layout, with ``channels_last``
  weights (cuDNN's NHWC kernels on the card);
- convolution weights and activations in ``cfg.dtype`` (bf16), batch-norm
  statistics in f32, the head in f32 over an f32 global mean;
- padding is XLA's ``SAME``, which is asymmetric for a stride-2 window: a
  7×7/2 stem on 224 pads (2, 3), a 3×3/2 convolution or max pool on an even
  size pads (0, 1). An explicit ``F.pad`` does what ``padding=k//2`` would
  get wrong;
- batch norm in training normalises with the biased batch variance, in f32,
  and returns the new running statistics ``m·old + (1−m)·batch`` (m = 0.9,
  the biased variance) instead of updating them in place:
  ``F.batch_norm``'s own update uses the unbiased variance and the other
  momentum convention, so it is given no running statistics to update. The
  batch statistics are computed once, by the normalisation's own pass, and
  the running ones derived from them.

Given a data-parallel group (``forward(..., dp=DpGroup(...))``, from
``make_resnet_sgd_step(mesh=)``), training batch norm takes its statistics
over the group's global batch, as the reference's batch norm does under
``jit`` over a ``P("dp", ...)`` batch (:class:`GlobalBatchNorm`): each
rank's per-channel mean, inverse std and count are all-reduced in the
forward, and the two per-channel gradient sums in the backward, the
pattern of ``torch.nn.SyncBatchNorm`` over torch's own batch-norm ops on
the card (the same arithmetic in plain torch on the CPU, where those ops do
not exist).

``forward(images, train)`` returns ``(logits, new_bn_state)``; the train
step (``strom_torch.parallel.train.make_resnet_sgd_step``) stores the new
state with :meth:`ResNet.load_bn_state`. ``params_from_jax`` converts the
JAX package's parameter and state trees into a ``state_dict``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from strom_torch.delivery.core import resolve_device


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stages: tuple[int, ...] = (3, 4, 6, 3)   # bottleneck blocks per stage (50-layer)
    width: int = 64                          # stem channels
    num_classes: int = 1000
    dtype: str = "bfloat16"
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @classmethod
    def resnet50(cls) -> "ResNetConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "ResNetConfig":
        """~100k params; unit tests (input 32×32)."""
        return cls(stages=(1, 1), width=8, num_classes=10)


def _same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial dim: (before, after)."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """``lax.conv_general_dilated(..., padding="SAME")`` on an NCHW view;
    *w* is OIHW."""
    (h0, h1), (w0, w1) = (_same_pad(x.shape[2], w.shape[2], stride),
                          _same_pad(x.shape[3], w.shape[3], stride))
    if h0 == h1 and w0 == w1:
        return F.conv2d(x, w, stride=stride, padding=(h0, w0))
    return F.conv2d(F.pad(x, (w0, w1, h0, h1)), w, stride=stride)


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """The stem's ``reduce_window(max, 3×3, stride 2, "SAME")`` with −inf
    padding."""
    (h0, h1), (w0, w1) = _same_pad(x.shape[2], 3, 2), _same_pad(x.shape[3], 3, 2)
    if h0 == h1 and w0 == w1:   # max_pool2d pads with −inf itself
        return F.max_pool2d(x, 3, 2, padding=(h0, w0))
    return F.max_pool2d(F.pad(x, (w0, w1, h0, h1), value=-math.inf), 3, 2)


def _conv_param(kh: int, kw: int, cin: int, cout: int, dtype, device,
                gen) -> nn.Parameter:
    """He-normal OIHW weight, as the JAX package's ``_conv_init`` draws it
    (in f32, then cast)."""
    w = torch.randn(cout, cin, kh, kw, generator=gen, device=device,
                    dtype=torch.float32) * math.sqrt(2.0 / (kh * kw * cin))
    return nn.Parameter(w.to(dtype).contiguous(memory_format=torch.channels_last))


class DpGroup(NamedTuple):
    """A data-parallel group batch norm reduces over: the process group,
    its size and this process's rank in it."""

    group: Any
    size: int
    rank: int


_C = (1, -1, 1, 1)          # a per-channel vector against NCHW
_REDUCE = (0, 2, 3)         # every dimension but the channel


def _bn_stats(x: torch.Tensor, eps: float
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel f32 mean and 1/sqrt(biased var + eps) of *x*."""
    if x.is_cuda:
        return torch.batch_norm_stats(x, eps)
    xf = x.float()
    mean = xf.mean(_REDUCE)
    var = (xf - mean.view(_C)).square().mean(_REDUCE)
    return mean, (var + eps).rsqrt()


def _bn_gather(x: torch.Tensor, means: torch.Tensor, invstds: torch.Tensor,
               counts: torch.Tensor, eps: float
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The global mean and inverse std from each rank's (rows of *means*,
    *invstds*, *counts*): the biased variances merged with the spread of
    the means."""
    if x.is_cuda:
        # its first argument only sets the arithmetic's type: f32, as the
        # statistics and the counts are
        return torch.batch_norm_gather_stats_with_counts(
            means, means, invstds, None, None, 0.0, eps, counts)
    n = counts.sum()
    w = counts[:, None]
    mean = (w * means).sum(0) / n
    var = (w * (invstds.pow(-2) - eps + (means - mean).square())).sum(0) / n
    return mean, (var + eps).rsqrt()


def _bn_elemt(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              mean: torch.Tensor, invstd: torch.Tensor, eps: float
              ) -> torch.Tensor:
    """``(x - mean) · invstd · scale + bias`` in f32, in *x*'s dtype."""
    if x.is_cuda:
        return torch.batch_norm_elemt(x, scale, bias, mean, invstd, eps)
    y = (x.float() - mean.view(_C)) * (invstd * scale).view(_C) \
        + bias.view(_C)
    return y.to(x.dtype)


def _bn_backward_reduce(gy: torch.Tensor, x: torch.Tensor,
                        mean: torch.Tensor, invstd: torch.Tensor,
                        scale: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """(Σ dy, Σ dy·(x − mean), the scale's gradient, the bias's gradient)
    per channel, over this rank's rows, in f32."""
    if x.is_cuda:
        return torch.batch_norm_backward_reduce(gy, x, mean, invstd, scale,
                                                True, True, True)
    gf = gy.float()
    sum_dy = gf.sum(_REDUCE)
    sum_dy_xmu = (gf * (x.float() - mean.view(_C))).sum(_REDUCE)
    return sum_dy, sum_dy_xmu, sum_dy_xmu * invstd, sum_dy


def _bn_backward_elemt(gy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                       invstd: torch.Tensor, scale: torch.Tensor,
                       sum_dy: torch.Tensor, sum_dy_xmu: torch.Tensor,
                       counts: torch.Tensor) -> torch.Tensor:
    """The input's gradient from the global sums over the global count:
    ``scale · invstd · (dy − Σdy/N − (x − mean) · invstd² · Σdy(x−mean)/N)``,
    in *x*'s dtype."""
    if x.is_cuda:
        return torch.batch_norm_backward_elemt(
            gy, x, mean, invstd, scale, sum_dy, sum_dy_xmu,
            counts.to(torch.int32))
    n = counts.sum()
    xmu = x.float() - mean.view(_C)
    gx = (gy.float() - (sum_dy / n).view(_C)
          - xmu * (invstd.square() * sum_dy_xmu / n).view(_C)) \
        * (invstd * scale).view(_C)
    return gx.to(x.dtype)


class GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch norm over the global batch of a dp group: the
    forward all-reduces a [size, 2C+1] f32 table in which each rank has
    written its row (per-channel mean, inverse std, element count), so
    every rank merges the same statistics; the backward all-reduces the
    per-channel Σdy and Σdy·(x − mean). The scale and bias gradients stay
    this rank's: the step's gradient mean sums them over the group. One
    all-reduce each way a layer, captured in the step's graph with the
    rest. Returns ``(y, mean, invstd)``; the statistics carry no
    gradient."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float, dp: DpGroup):
        c = x.shape[1]
        mean, invstd = _bn_stats(x, eps)
        table = torch.zeros(dp.size, 2 * c + 1, dtype=torch.float32,
                            device=x.device)
        row = table[dp.rank]
        row[:c] = mean
        row[c: 2 * c] = invstd
        row[2 * c:].fill_(x.numel() // c)   # a fill: no host copy
        dist.all_reduce(table, group=dp.group)
        counts = table[:, 2 * c]
        mean, invstd = _bn_gather(x, table[:, :c], table[:, c: 2 * c],
                                  counts, eps)
        ctx.save_for_backward(x, scale, mean, invstd, counts)
        ctx.dp = dp
        ctx.mark_non_differentiable(mean, invstd)
        return _bn_elemt(x, scale, bias, mean, invstd, eps), mean, invstd

    @staticmethod
    def backward(ctx, gy, _gmean, _ginvstd):
        x, scale, mean, invstd, counts = ctx.saved_tensors
        gy = gy.contiguous(memory_format=torch.channels_last) \
            if x.is_contiguous(memory_format=torch.channels_last) \
            else gy.contiguous()
        sum_dy, sum_dy_xmu, gscale, gbias = _bn_backward_reduce(
            gy, x, mean, invstd, scale)
        sums = torch.cat([sum_dy, sum_dy_xmu])
        dist.all_reduce(sums, group=ctx.dp.group)
        sum_dy, sum_dy_xmu = sums.chunk(2)
        gx = _bn_backward_elemt(gy, x, mean, invstd, scale, sum_dy,
                                sum_dy_xmu, counts)
        return gx, gscale, gbias, None, None


class BatchNorm(nn.Module):
    """Functional batch norm: f32 scale and bias, f32 running mean and var
    as buffers, never updated in place."""

    def __init__(self, c: int, cfg: ResNetConfig, device):
        super().__init__()
        self.cfg = cfg
        self.scale = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("mean", torch.zeros(c, device=device))
        self.register_buffer("var", torch.ones(c, device=device))

    def forward(self, x: torch.Tensor, train: bool, new_state: dict,
                dp: DpGroup | None = None) -> torch.Tensor:
        cfg = self.cfg
        if not train:
            new_state[self] = (self.mean, self.var)
            return F.batch_norm(x, self.mean, self.var, self.scale, self.bias,
                                training=False, eps=cfg.bn_eps)
        # one statistics pass: the batch mean and 1/sqrt(biased var + eps),
        # in f32, normalise x (gradients through the batch statistics), and
        # the new running statistics come from the same two numbers; no
        # running statistics are given, so none are updated in place. With
        # a dp group, the batch is the group's global batch
        if dp is None:
            y, mean, invstd = torch.native_batch_norm(
                x, self.scale, self.bias, None, None, True, 0.0, cfg.bn_eps)
        else:
            y, mean, invstd = GlobalBatchNorm.apply(x, self.scale, self.bias,
                                                    cfg.bn_eps, dp)
        with torch.no_grad():
            var = invstd.float().pow(-2) - cfg.bn_eps
            m = cfg.bn_momentum
            new_state[self] = (m * self.mean + (1 - m) * mean.float(),
                               m * self.var + (1 - m) * var)
        return y


class Stem(nn.Module):
    def __init__(self, cfg: ResNetConfig, device, gen):
        super().__init__()
        self.conv = _conv_param(7, 7, 3, cfg.width, cfg.torch_dtype, device, gen)
        self.bn = BatchNorm(cfg.width, cfg, device)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, mid: int, cout: int, stride: int,
                 cfg: ResNetConfig, device, gen):
        super().__init__()
        dt = cfg.torch_dtype
        self.stride = stride
        self.conv1 = _conv_param(1, 1, cin, mid, dt, device, gen)
        self.bn1 = BatchNorm(mid, cfg, device)
        self.conv2 = _conv_param(3, 3, mid, mid, dt, device, gen)
        self.bn2 = BatchNorm(mid, cfg, device)
        self.conv3 = _conv_param(1, 1, mid, cout, dt, device, gen)
        self.bn3 = BatchNorm(cout, cfg, device)
        self.proj = self.proj_bn = None
        if cin != cout or stride != 1:
            self.proj = _conv_param(1, 1, cin, cout, dt, device, gen)
            self.proj_bn = BatchNorm(cout, cfg, device)

    def forward(self, x: torch.Tensor, train: bool, new_state: dict,
                dp: DpGroup | None = None) -> torch.Tensor:
        h = F.relu(self.bn1(conv_same(x, self.conv1), train, new_state, dp))
        h = F.relu(self.bn2(conv_same(h, self.conv2, self.stride), train,
                            new_state, dp))
        h = self.bn3(conv_same(h, self.conv3), train, new_state, dp)
        if self.proj is not None:
            x = self.proj_bn(conv_same(x, self.proj, self.stride), train,
                             new_state, dp)
        return F.relu(h + x)


class Head(nn.Module):
    def __init__(self, cin: int, num_classes: int, device, gen):
        super().__init__()
        self.w = nn.Parameter(torch.randn(cin, num_classes, generator=gen,
                                          device=device) / math.sqrt(cin))
        self.b = nn.Parameter(torch.zeros(num_classes, device=device))


class ResNet(nn.Module):
    """ResNet over :class:`ResNetConfig`; parameters named as the JAX
    package's tree (``stem.conv``, ``stage0.0.bn1.scale``, ``head.w``)."""

    def __init__(self, cfg: ResNetConfig, *, device: Any = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        gen = generator or torch.Generator(device=device).manual_seed(0)
        self.cfg = cfg
        self.stem = Stem(cfg, device, gen)
        cin = cfg.width
        for si, n_blocks in enumerate(cfg.stages):
            mid = cfg.width * (2 ** si)
            blocks = []
            for bi in range(n_blocks):
                stride = 2 if (si > 0 and bi == 0) else 1
                blocks.append(Bottleneck(cin, mid, mid * 4, stride, cfg,
                                         device, gen))
                cin = mid * 4
            setattr(self, f"stage{si}", nn.ModuleList(blocks))
        self.head = Head(cin, cfg.num_classes, device, gen)
        self._bn_names = {bn: name for name, bn in self.named_modules()
                          if isinstance(bn, BatchNorm)}

    def forward(self, images: torch.Tensor, train: bool = True,
                dp: DpGroup | None = None
                ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """images [B,H,W,3], any float dtype, already normalised →
        (logits [B, classes] f32, new batch-norm state keyed as the
        buffers: ``stem.bn.mean``, ``stem.bn.var``, ...). *dp*: the
        data-parallel group whose global batch training batch norm
        normalises over (None: these rows alone)."""
        cfg = self.cfg
        # NHWC memory seen as NCHW: the channels_last layout
        x = images.to(cfg.torch_dtype).permute(0, 3, 1, 2)
        new: dict = {}
        x = conv_same(x, self.stem.conv, 2)
        x = F.relu(self.stem.bn(x, train, new, dp))
        x = max_pool_same(x)
        for si in range(len(cfg.stages)):
            for block in getattr(self, f"stage{si}"):
                x = block(x, train, new, dp)
        x = x.float().mean(dim=(2, 3))   # global average pool, in f32
        logits = x @ self.head.w + self.head.b
        state = {}
        for bn, (mean, var) in new.items():
            state[f"{self._bn_names[bn]}.mean"] = mean
            state[f"{self._bn_names[bn]}.var"] = var
        return logits, state

    @torch.no_grad()
    def load_bn_state(self, state: dict[str, torch.Tensor]) -> None:
        """Store the running statistics a training forward returned."""
        buffers = dict(self.named_buffers())
        for name, t in state.items():
            buffers[name].copy_(t)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy; labels integer [B]."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[:, None])[:, 0]
    return (logz - gold).mean()


def loss_fn(model: ResNet, images: torch.Tensor, labels: torch.Tensor,
            dp: DpGroup | None = None
            ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    logits, new_state = model(images, train=True, dp=dp)
    return softmax_xent(logits, labels), new_state


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def imagenet_mean_std(device: Any) -> tuple[torch.Tensor, torch.Tensor]:
    """The normalisation's f32 mean and std on *device*: made once by a
    step, so that a captured step copies nothing from the host."""
    return (torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device),
            torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device))


def normalize_images(u8: torch.Tensor,
                     mean_std: tuple[torch.Tensor, torch.Tensor] | None = None
                     ) -> torch.Tensor:
    """uint8 [..., 3] → normalised f32, on the tensor's device (*mean_std*:
    ``imagenet_mean_std`` of that device, made here when not given)."""
    mean, std = mean_std or imagenet_mean_std(u8.device)
    return (u8.float() / 255.0 - mean) / std


def params_from_jax(params: dict, state: dict) -> dict[str, torch.Tensor]:
    """The JAX package's ``(params, bn_state)`` trees (``init_params``) as a
    ``ResNet.state_dict()``: HWIO convolution weights to OIHW, each
    batch-norm's scale and bias with its running mean and var, the f32
    head as it is."""
    out: dict[str, torch.Tensor] = {}

    def t(a) -> torch.Tensor:
        arr = np.asarray(a)
        if arr.dtype.name == "bfloat16":   # numpy has no bf16: via f32
            return torch.from_numpy(arr.astype(np.float32)).bfloat16()
        return torch.from_numpy(arr.copy())

    def conv(name: str, w) -> None:
        out[name] = t(w).permute(3, 2, 0, 1).contiguous()

    def bn(name: str, p: dict, s: dict) -> None:
        out[f"{name}.scale"], out[f"{name}.bias"] = t(p["scale"]), t(p["bias"])
        out[f"{name}.mean"], out[f"{name}.var"] = t(s["mean"]), t(s["var"])

    conv("stem.conv", params["stem"]["conv"])
    bn("stem.bn", params["stem"]["bn"], state["stem"])
    si = 0
    while f"stage{si}" in params:
        for bi, (b, s) in enumerate(zip(params[f"stage{si}"],
                                        state[f"stage{si}"])):
            pre = f"stage{si}.{bi}"
            for c in ("conv1", "conv2", "conv3", "proj"):
                if c in b:
                    conv(f"{pre}.{c}", b[c])
            for n in ("bn1", "bn2", "bn3", "proj_bn"):
                if n in b:
                    bn(f"{pre}.{n}", b[n], s[n])
        si += 1
    out["head.w"], out["head.b"] = t(params["head"]["w"]), t(params["head"]["b"])
    return out
