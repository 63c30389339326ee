"""ResNet on one device: the counterpart of `ray_tpu/models/resnet.py`
(flax.linen), with its blocks, widths, compute dtype (bf16 activations
over f32 parameters and batch statistics) and its variable tree: every
submodule carries flax's auto-name (``Conv_0``, ``BatchNorm_1``,
``ResNetBlock_3``, ``Dense_0``), so `params_from_numpy` and
`params_to_numpy` carry a flax ``{"params", "batch_stats"}`` tree across
and back. Conv kernels are flax's HWIO carried as torch's OIHW (the one
carry-across that transposes); the dense kernel keeps ``[in, out]``.

Two places where torch's library layers give other numbers, written out
to match flax:

- ``padding="SAME"``: flax pads ``(total // 2, total - total // 2)``
  with ``total = max((ceil(n / s) - 1) * s + k - n, 0)``, so a stride-2
  layer on an even input pads one more on the high side (3x3 on 56:
  (0, 1); the 7x7 stem on 224: (2, 3); the 3x3 max pool on 112: (0, 1),
  with -inf). Every strided layer pads explicitly.
- ``BatchNorm``: statistics in f32 over (N, H, W), the variance as
  E[x^2] - E[x]^2 clipped at 0 (biased), the running averages as
  ``0.9 * running + 0.1 * batch`` (`batch_norm`); `nn.BatchNorm2d` keeps
  the unbiased variance.

Convolutions and the dense product are library calls, as the reference
leaves them to XLA. Inputs are NHWC like the reference's; inside, the
activations are NCHW tensors, on the card in channels-last memory
(cuDNN's layout).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

_MOMENTUM = 0.9
_EPS = 1e-5


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """flax/XLA ``"SAME"`` padding (low, high) of one spatial axis."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, k: int, s: int, value: float = 0.0):
    ph = same_pads(x.shape[2], k, s)
    pw = same_pads(x.shape[3], k, s)
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


def batch_norm(x, scale, bias, mean_buf, var_buf, train: bool):
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5)`` on NCHW ``x``: in
    training the batch's f32 mean and biased variance normalise ``x`` and
    update the running buffers in place; in eval the buffers do. The
    result is in x's dtype."""
    if train:
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp(xf.square().mean(dim=(0, 2, 3)) - mean.square(),
                          min=0.0)
        with torch.no_grad():
            mean_buf.copy_(_MOMENTUM * mean_buf + (1 - _MOMENTUM) * mean)
            var_buf.copy_(_MOMENTUM * var_buf + (1 - _MOMENTUM) * var)
    else:
        mean, var = mean_buf, var_buf
    mul = torch.rsqrt(var + _EPS) * scale
    y = (x - mean[:, None, None]) * mul[:, None, None] + bias[:, None, None]
    return y.to(x.dtype)


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False, padding="SAME")`` with an f32 OIHW
    ``kernel``, computed in the activation dtype."""

    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 gen: torch.Generator, device):
        super().__init__()
        self.k, self.stride = k, stride
        w = torch.randn((cout, cin, k, k), generator=gen, device=device)
        self.kernel = nn.Parameter(w / np.sqrt(cin * k * k))

    def forward(self, x):
        if self.stride == 1 and self.k % 2:
            return F.conv2d(x, self.kernel.to(x.dtype), padding=self.k // 2)
        return F.conv2d(_pad_same(x, self.k, self.stride),
                        self.kernel.to(x.dtype), stride=self.stride)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm``: f32 ``scale``/``bias`` parameters and
    ``mean``/``var`` batch statistics (`batch_norm`)."""

    def __init__(self, c: int, device, zero_scale: bool = False):
        super().__init__()
        init = torch.zeros if zero_scale else torch.ones
        self.scale = nn.Parameter(init((c,), device=device))
        self.bias = nn.Parameter(torch.zeros((c,), device=device))
        self.register_buffer("mean", torch.zeros((c,), device=device))
        self.register_buffer("var", torch.ones((c,), device=device))

    def forward(self, x, train: bool):
        return batch_norm(x, self.scale, self.bias, self.mean, self.var,
                          train)


class ResNetBlock(nn.Module):
    """`ray_tpu.models.resnet.ResNetBlock`: two 3x3 convs, the projection
    (1x1 conv + norm) where the shape changes."""

    expansion = 1

    def __init__(self, cin: int, filters: int, strides: int,
                 gen: torch.Generator, device):
        super().__init__()
        self.Conv_0 = Conv(cin, filters, 3, strides, gen, device)
        self.BatchNorm_0 = BatchNorm(filters, device)
        self.Conv_1 = Conv(filters, filters, 3, 1, gen, device)
        self.BatchNorm_1 = BatchNorm(filters, device, zero_scale=True)
        self.proj = strides != 1 or cin != filters
        if self.proj:
            self.Conv_2 = Conv(cin, filters, 1, strides, gen, device)
            self.BatchNorm_2 = BatchNorm(filters, device)

    def forward(self, x, train: bool):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.BatchNorm_1(self.Conv_1(y), train)
        residual = x
        if self.proj:
            residual = self.BatchNorm_2(self.Conv_2(x), train)
        return F.relu(residual + y)


class BottleneckBlock(nn.Module):
    """`ray_tpu.models.resnet.BottleneckBlock`: 1x1, strided 3x3, 1x1 to
    4x the filters, the projection where the shape changes."""

    expansion = 4

    def __init__(self, cin: int, filters: int, strides: int,
                 gen: torch.Generator, device):
        super().__init__()
        out = filters * 4
        self.Conv_0 = Conv(cin, filters, 1, 1, gen, device)
        self.BatchNorm_0 = BatchNorm(filters, device)
        self.Conv_1 = Conv(filters, filters, 3, strides, gen, device)
        self.BatchNorm_1 = BatchNorm(filters, device)
        self.Conv_2 = Conv(filters, out, 1, 1, gen, device)
        self.BatchNorm_2 = BatchNorm(out, device, zero_scale=True)
        self.proj = strides != 1 or cin != out
        if self.proj:
            self.Conv_3 = Conv(cin, out, 1, strides, gen, device)
            self.BatchNorm_3 = BatchNorm(out, device)

    def forward(self, x, train: bool):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        residual = x
        if self.proj:
            residual = self.BatchNorm_3(self.Conv_3(x), train)
        return F.relu(residual + y)


class ResNet(nn.Module):
    """`ray_tpu.models.resnet.ResNet`: ``model(images, train)`` takes NHWC
    images and returns f32 logits; ``train=True`` normalises with the
    batch's statistics and updates the running ones in place. Parameters
    are f32, drawn from a `torch.Generator` seeded with ``seed`` on
    ``device`` (the card unless told otherwise; flax's initialisers
    differ, so carry flax variables across with `params_from_numpy` where
    they must match)."""

    def __init__(self, stage_sizes: Sequence[int], block_cls=ResNetBlock,
                 num_classes: int = 10, num_filters: int = 64,
                 dtype: str = "bfloat16", small_inputs: bool = True, *,
                 channels: int = 3, seed: int = 0, device=None):
        super().__init__()
        from ray_tpu_torch.models.gpt import resolve_device
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.dtype = getattr(torch, dtype)
        self.small_inputs = small_inputs
        self.Conv_0 = Conv(channels, num_filters, 3 if small_inputs else 7,
                           1 if small_inputs else 2, gen, device)
        self.BatchNorm_0 = BatchNorm(num_filters, device)
        cin, n = num_filters, 0
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                strides = 2 if i > 0 and j == 0 else 1
                filters = num_filters * 2 ** i
                self.add_module(f"{block_cls.__name__}_{n}", block_cls(
                    cin, filters, strides, gen, device))
                cin, n = filters * block_cls.expansion, n + 1
        self.Dense_0 = nn.Module()
        self.Dense_0.kernel = nn.Parameter(
            torch.randn((cin, num_classes), generator=gen, device=device)
            / np.sqrt(cin))
        self.Dense_0.bias = nn.Parameter(
            torch.zeros((num_classes,), device=device))

    @property
    def device(self) -> torch.device:
        return self.Conv_0.kernel.device

    def forward(self, images, train: bool = True):
        x = torch.as_tensor(images, device=self.device).to(self.dtype)
        x = x.permute(0, 3, 1, 2)      # NHWC storage: NCHW, channels last
        if not x.is_cuda:
            # the CPU build's channels-last backward of a strided 1x1 conv
            # corrupts the heap: plain NCHW there
            x = x.contiguous()
        x = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        if not self.small_inputs:
            x = F.max_pool2d(_pad_same(x, 3, 2, value=-float("inf")), 3, 2)
        for name, block in self.named_children():
            if name.startswith(("ResNetBlock_", "BottleneckBlock_")):
                x = block(x, train)
        pooled = x.float().mean(dim=(2, 3)).to(self.dtype).float()
        return pooled @ self.Dense_0.kernel + self.Dense_0.bias


def resnet18(num_classes: int = 10, **kw) -> ResNet:
    return ResNet(stage_sizes=[2, 2, 2, 2], block_cls=ResNetBlock,
                  num_classes=num_classes, **kw)


def resnet50(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet(stage_sizes=[3, 4, 6, 3], block_cls=BottleneckBlock,
                  num_classes=num_classes, small_inputs=False, **kw)


def _entries(model: ResNet):
    """(flax collection, name, tensor) for every variable of the model:
    parameters are flax's "params", buffers its "batch_stats", and a
    name's dotted path is its flax path."""
    for name, t in model.named_parameters():
        yield "params", name, t
    for name, t in model.named_buffers():
        yield "batch_stats", name, t


def params_from_numpy(variables: dict, model: ResNet) -> ResNet:
    """Carry a flax ``{"params", "batch_stats"}`` tree (numpy arrays or
    tensors) into ``model`` in place: conv kernels HWIO -> OIHW, every
    other leaf as it is. Every leaf of the model must be in the tree.
    Returns ``model``."""
    with torch.no_grad():
        for coll, name, t in _entries(model):
            x = variables[coll]
            for k in name.split("."):
                x = x[k]
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.array(x))
            if x.dim() == 4:
                x = x.permute(3, 2, 0, 1)
            if tuple(x.shape) != tuple(t.shape):
                raise ValueError(f"{coll}/{name.replace('.', '/')} has shape "
                                 f"{tuple(x.shape)}, the model wants "
                                 f"{tuple(t.shape)}")
            t.copy_(x)
    return model


def to_flax_layout(t: torch.Tensor) -> np.ndarray:
    """One variable (or its gradient) as flax holds it: float32 numpy,
    a conv kernel OIHW -> HWIO."""
    x = t.detach().float()
    if x.dim() == 4:
        x = x.permute(2, 3, 1, 0)
    return x.contiguous().cpu().numpy()


def params_to_numpy(model: ResNet) -> dict:
    """The way back: the model's variables as flax's ``{"params",
    "batch_stats"}`` tree of float32 numpy arrays (conv kernels HWIO)."""
    from ray_tpu_torch.models._stacked import nest
    out: dict = {"params": {}, "batch_stats": {}}
    for coll in out:
        out[coll] = nest((name, to_flax_layout(t))
                         for c, name, t in _entries(model) if c == coll)
    return out
