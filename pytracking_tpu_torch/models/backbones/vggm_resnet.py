"""ResNet18-VGG-m1, ECO's deep feature net, NCHW (counterpart of
pytracking_tpu/models/backbones/vggm_resnet.py: `spatial_cross_map_lrn`,
`ResNet18VGGm1`, `resnet18_vggmconv1`).

A ResNet-18 trunk and, beside it, VGG-M's first convolution ('vggconv1':
7x7 stride 2 with bias, ReLU, cross-channel LRN). As in the JAX module, only
the layers up to the last requested output exist (flax creates a submodule
when it is first called), so the state_dict matches the flax tree. `dtype`
is the compute dtype of the convolutions; outputs come back in that dtype
(ECO's wrapper casts them to float32).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pytracking_tpu_torch.models.backbones.resnet import BasicBlock, Conv2d
from pytracking_tpu_torch.models.layers.blocks import BatchNorm


def spatial_cross_map_lrn(x: torch.Tensor, local_size: int = 5, alpha: float = 0.0005,
                          beta: float = 0.75, k: float = 2.0) -> torch.Tensor:
    """Across-channel local response normalisation of (N, C, H, W):
    x / (k + alpha * mean_window(x^2))^beta, the channel window zero-padded
    and always divided by `local_size`, in x's dtype."""
    sq = x * x
    pad = (local_size - 1) // 2
    sq = F.pad(sq, (0, 0, 0, 0, pad, pad))
    C = x.shape[1]
    div = sq[:, 0:C]
    for i in range(1, local_size):
        div = div + sq[:, i:i + C]
    return x / (k + alpha * (div / local_size)) ** beta


_STAGES = ("layer1", "layer2", "layer3", "layer4")


class ResNet18VGGm1(nn.Module):
    """Outputs: any of 'vggconv1', 'conv1', 'layer1'..'layer4'."""

    def __init__(self, output_layers: Sequence[str] = ("vggconv1", "layer3"),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.output_layers = tuple(output_layers)
        self.dtype = dtype
        if "vggconv1" in self.output_layers:
            self.vggmconv1 = Conv2d(3, 96, 7, stride=2, padding=3, bias=True, dtype=dtype)
        trunk = [n for n in self.output_layers if n != "vggconv1"]
        order = ("conv1",) + _STAGES
        self.last = max((order.index(n) for n in trunk), default=-1)
        if self.last >= 0:
            self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False, dtype=dtype)
            self.bn1 = BatchNorm(64)
        in_ch = 64
        for stage in range(self.last):
            planes = 64 * 2 ** stage
            for b in range(2):
                s = (1 if stage == 0 else 2) if b == 0 else 1
                self.add_module(f"layer{stage + 1}_{b}",
                                BasicBlock(in_ch, planes, stride=s,
                                           downsample=b == 0 and (s != 1 or in_ch != planes),
                                           dtype=dtype))
                in_ch = planes

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        outputs = {}
        if "vggconv1" in self.output_layers:
            outputs["vggconv1"] = spatial_cross_map_lrn(F.relu(self.vggmconv1(x)))
        if self.last < 0:
            return outputs
        h = F.relu(self.bn1(self.conv1(x)))
        if "conv1" in self.output_layers:
            outputs["conv1"] = h
        if self.last == 0:
            return outputs
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        for stage in range(self.last):
            for b in range(2):
                h = getattr(self, f"layer{stage + 1}_{b}")(h)
            if _STAGES[stage] in self.output_layers:
                outputs[_STAGES[stage]] = h
        return outputs


def resnet18_vggmconv1(output_layers=("vggconv1", "layer3"), dtype=None) -> ResNet18VGGm1:
    return ResNet18VGGm1(output_layers=output_layers, dtype=dtype)
