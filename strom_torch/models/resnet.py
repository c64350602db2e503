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

``forward(images, train)`` returns ``(logits, new_bn_state)``; the train
step (``strom_torch.parallel.train.make_resnet_sgd_step``) stores the new
state with :meth:`ResNet.load_bn_state`. ``params_from_jax`` converts the
JAX package's parameter and state trees into a ``state_dict``.
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

    def forward(self, x: torch.Tensor, train: bool,
                new_state: dict) -> torch.Tensor:
        cfg = self.cfg
        if not train:
            new_state[self] = (self.mean, self.var)
            return F.batch_norm(x, self.mean, self.var, self.scale, self.bias,
                                training=False, eps=cfg.bn_eps)
        # one statistics pass: the batch mean and 1/sqrt(biased var + eps),
        # in f32, normalise x (gradients through the batch statistics), and
        # the new running statistics come from the same two numbers; no
        # running statistics are given, so none are updated in place
        y, mean, invstd = torch.native_batch_norm(
            x, self.scale, self.bias, None, None, True, 0.0, cfg.bn_eps)
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

    def forward(self, x: torch.Tensor, train: bool,
                new_state: dict) -> torch.Tensor:
        h = F.relu(self.bn1(conv_same(x, self.conv1), train, new_state))
        h = F.relu(self.bn2(conv_same(h, self.conv2, self.stride), train,
                            new_state))
        h = self.bn3(conv_same(h, self.conv3), train, new_state)
        if self.proj is not None:
            x = self.proj_bn(conv_same(x, self.proj, self.stride), train,
                             new_state)
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

    def forward(self, images: torch.Tensor, train: bool = True
                ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """images [B,H,W,3], any float dtype, already normalised →
        (logits [B, classes] f32, new batch-norm state keyed as the
        buffers: ``stem.bn.mean``, ``stem.bn.var``, ...)."""
        cfg = self.cfg
        # NHWC memory seen as NCHW: the channels_last layout
        x = images.to(cfg.torch_dtype).permute(0, 3, 1, 2)
        new: dict = {}
        x = conv_same(x, self.stem.conv, 2)
        x = F.relu(self.stem.bn(x, train, new))
        x = max_pool_same(x)
        for si in range(len(cfg.stages)):
            for block in getattr(self, f"stage{si}"):
                x = block(x, train, new)
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


def loss_fn(model: ResNet, images: torch.Tensor, labels: torch.Tensor
            ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    logits, new_state = model(images, train=True)
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
