"""Classification feature blocks: backbone feature -> classifier feature
(counterpart of pytracking_tpu/models/classifier/features.py
`ResidualBottleneck`, `ResidualBasicBlock`): residual blocks named
`block{i}`, an optional final 3x3 conv and InstanceL2Norm."""

from __future__ import annotations

import torch
from torch import nn

from pytracking_tpu_torch.models.backbones.resnet import BasicBlock, Bottleneck, Conv2d
from pytracking_tpu_torch.models.layers.blocks import instance_l2_norm


class _ResidualFeatures(nn.Module):
    def _final(self, in_dim: int, out_dim: int, final_conv: bool, norm_scale: float,
               final_stride: int = 1) -> None:
        self.final_conv = Conv2d(in_dim, out_dim, 3, stride=final_stride, padding=1,
                                 bias=False) if final_conv else None
        self.norm_scale = norm_scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        if self.final_conv is not None:
            x = self.final_conv(x)
        return instance_l2_norm(x, self.norm_scale)


class ResidualBottleneck(_ResidualFeatures):
    """`num_blocks` Bottlenecks (width `feature_dim`; the last one
    `out_dim // 4` when there is no final conv), then the final conv to
    `out_dim` with stride `final_stride`. DiMP-50's is no block and the final
    conv 1024 -> 512; RTS's classifier takes the same conv at stride 2."""

    def __init__(self, in_dim: int = 1024, out_dim: int = 256, norm_scale: float = 1.0,
                 feature_dim: int = 256, num_blocks: int = 0, final_conv: bool = True,
                 final_stride: int = 1):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            planes = feature_dim if i < num_blocks - 1 + int(final_conv) else out_dim // 4
            self.add_module(f"block{i}", Bottleneck(in_dim, planes,
                                                    downsample=in_dim != planes * 4))
            in_dim = planes * 4
        self._final(in_dim, out_dim, final_conv, norm_scale, final_stride)


class ResidualBasicBlock(_ResidualFeatures):
    """`num_blocks` BasicBlocks (width `feature_dim`; the last one `out_dim`
    when there is no final conv), then the final conv to `out_dim`. DiMP-18's
    is one BasicBlock 256 -> 256 and the final conv 256 -> 256."""

    def __init__(self, in_dim: int = 256, out_dim: int = 256, norm_scale: float = 1.0,
                 feature_dim: int = 256, num_blocks: int = 1, final_conv: bool = True):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            odim = feature_dim if i < num_blocks - 1 + int(final_conv) else out_dim
            self.add_module(f"block{i}", BasicBlock(in_dim, odim, downsample=in_dim != odim))
            in_dim = odim
        self._final(in_dim, out_dim, final_conv, norm_scale)
