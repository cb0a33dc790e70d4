"""Basic building blocks (counterpart of pytracking_tpu/models/layers/blocks.py:
`ConvBlock`, `LinearBlock`, `instance_l2_norm`; plus the BatchNorm the JAX
package gets from flax, and flax's truncated-normal initialiser)."""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def trunc_normal_fan_in(weight: torch.Tensor, scale: float,
                        generator: torch.Generator) -> None:
    """flax variance_scaling(scale, 'fan_in', 'truncated_normal') in place:
    scale 1 is lecun-normal, scale 2 he-normal. The fan-in of an (out, in,
    ...) weight is the size of one output's slice."""
    std = math.sqrt(scale / weight[0].numel()) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def instance_l2_norm(x: torch.Tensor, scale: float = 1.0, eps: float = 1e-5) -> torch.Tensor:
    """Instance L2 normalisation over the last three dims, (C, H, W) for NCHW,
    size-averaged: the result's mean square is scale**2."""
    n = x.shape[-1] * x.shape[-2] * x.shape[-3]
    ss = torch.sum(x * x, dim=(-1, -2, -3), keepdim=True)
    return x * (scale * torch.sqrt(n / (ss + eps)))


class BatchNorm(nn.Module):
    """flax's BatchNorm(momentum=0.9, epsilon=1e-5).

    In eval mode it normalises with the running statistics along `dim` (1
    for NCHW maps, -1 for token vectors). In train mode (`self.training`)
    it normalises with the batch's statistics over every other axis, in
    float32, and moves the running ones towards them: flax's biased
    variance E[x²] - E[x]² clipped at 0, and running = momentum * running +
    (1 - momentum) * batch for the mean and that variance alike
    (`nn.BatchNorm2d` would feed its running variance the unbiased one).
    In eval mode the
    arithmetic is float32 and the result takes the input's dtype, as flax's
    BatchNorm with a compute dtype gives. With `param_dtype` bfloat16 (the
    statistics and affine parameters stored as bf16 values, as the JAX
    package's bf16 mode stores them) the step order is flax's,
    (x - mean) * (rsqrt(var + eps) * scale) + bias, with the multiplier in
    bf16 arithmetic: a bf16 input is normalised in bf16 throughout, a
    float32 input in float32 around that bf16 multiplier. With
    `update_running` False (`frozen_running_stats`) train mode normalises
    with the batch's statistics and leaves the running ones as they are,
    as a flax BatchNorm in train mode whose new statistics are dropped."""

    momentum = 0.9
    update_running = True

    def __init__(self, num_features: int, eps: float = 1e-5, dim: int = 1):
        super().__init__()
        self.eps = eps
        self.dim = dim
        self.param_dtype = torch.float32
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = [1] * x.dim()
        shape[self.dim] = -1
        if self.training:
            return self._batch_forward(x, shape)
        if self.param_dtype == torch.bfloat16:
            dt = torch.bfloat16
            # rsqrt in float32, rounded once, as XLA computes a bf16 rsqrt
            # (PyTorch's bf16 rsqrt on the CPU is off by an ulp now and then)
            var = self.running_var.to(dt) + self.eps
            mul = torch.rsqrt(var.float()).to(dt) * self.weight.to(dt)
            return (x - self.running_mean.to(dt).view(shape)) * mul.view(shape) \
                + self.bias.to(dt).view(shape)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        shift = self.bias - self.running_mean * mul
        return (x.float() * mul.view(shape) + shift.view(shape)).to(x.dtype)

    def _batch_forward(self, x: torch.Tensor, shape) -> torch.Tensor:
        axes = [d for d in range(x.dim()) if d != self.dim % x.dim()]
        xf = x.float()
        mean = xf.mean(axes)
        var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
        if self.update_running:
            with torch.no_grad():
                self.running_mean.copy_(self.momentum * self.running_mean
                                        + (1.0 - self.momentum) * mean)
                self.running_var.copy_(self.momentum * self.running_var
                                       + (1.0 - self.momentum) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)).to(x.dtype)


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """Within it, every BatchNorm of `module` leaves its running statistics
    as they are (in train mode it still normalises with the batch's)."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    before = [m.update_running for m in bns]
    for m in bns:
        m.update_running = False
    try:
        yield module
    finally:
        for m, b in zip(bns, before):
            m.update_running = b


@contextlib.contextmanager
def eval_mode(module: nn.Module):
    """`module` in eval mode inside, its own mode restored after."""
    modes = [(m, m.training) for m in module.modules()]
    module.eval()
    try:
        yield module
    finally:
        for m, training in modes:
            m.training = training


class ConvBlock(nn.Module):
    """conv -> [BatchNorm] -> [ReLU]. Submodules carry flax's automatic names
    (`Conv_0`, `BatchNorm_0`) so the weight converter maps them one to one."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 padding: Optional[int] = None, batch_norm: bool = True, relu: bool = True,
                 stride: int = 1):
        super().__init__()
        pad = kernel_size // 2 if padding is None else padding
        self.relu = relu
        self.Conv_0 = nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                                padding=pad)
        self.BatchNorm_0 = BatchNorm(out_channels) if batch_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(x)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x)
        return F.relu(x) if self.relu else x


class LinearBlock(nn.Module):
    """flatten -> linear -> BatchNorm -> ReLU on (N, C, h, w) inputs. The
    flatten is in (c, h, w) order; the JAX block flattens NHWC in (h, w, c)
    order, and the converter permutes the Dense kernel's rows to match."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, out_features)
        self.BatchNorm_0 = BatchNorm(out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.BatchNorm_0(self.Dense_0(x.flatten(1))))
