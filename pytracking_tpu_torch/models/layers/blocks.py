"""Basic building blocks (counterpart of pytracking_tpu/models/layers/blocks.py:
`instance_l2_norm`; plus the inference-time BatchNorm the JAX package gets
from flax)."""

from __future__ import annotations

import torch
from torch import nn


def instance_l2_norm(x: torch.Tensor, scale: float = 1.0, eps: float = 1e-5) -> torch.Tensor:
    """Instance L2 normalisation over the last three dims, (C, H, W) for NCHW,
    size-averaged: the result's mean square is scale**2."""
    n = x.shape[-1] * x.shape[-2] * x.shape[-3]
    ss = torch.sum(x * x, dim=(-1, -2, -3), keepdim=True)
    return x * (scale * torch.sqrt(n / (ss + eps)))


class BatchNorm(nn.Module):
    """BatchNorm with running statistics (tracking is inference only).

    Normalises along `dim` (1 for NCHW maps, -1 for token vectors). The
    arithmetic is float32 and the result takes the input's dtype, as flax's
    BatchNorm with a compute dtype gives."""

    def __init__(self, num_features: int, eps: float = 1e-5, dim: int = 1):
        super().__init__()
        self.eps = eps
        self.dim = dim
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        shift = self.bias - self.running_mean * mul
        shape = [1] * x.dim()
        shape[self.dim] = -1
        return (x.float() * mul.view(shape) + shift.view(shape)).to(x.dtype)
