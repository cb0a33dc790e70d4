"""Classification feature block (counterpart of
pytracking_tpu/models/classifier/features.py `ResidualBottleneck` with
num_blocks=0, final_conv=True: a 3x3 conv and InstanceL2Norm)."""

from __future__ import annotations

import torch
from torch import nn

from pytracking_tpu_torch.models.backbones.resnet import Conv2d
from pytracking_tpu_torch.models.layers.blocks import instance_l2_norm


class ResidualBottleneck(nn.Module):
    def __init__(self, in_dim: int = 1024, out_dim: int = 256, norm_scale: float = 1.0):
        super().__init__()
        self.final_conv = Conv2d(in_dim, out_dim, 3, padding=1, bias=False)
        self.norm_scale = norm_scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_l2_norm(self.final_conv(x), self.norm_scale)
