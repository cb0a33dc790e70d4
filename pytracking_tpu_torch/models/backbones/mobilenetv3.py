"""MobileNetV3-Large, the backbone of ECO's `mobile3`, NCHW (counterpart of
pytracking_tpu/models/backbones/mobilenetv3.py: `h_sigmoid`, `h_swish`,
`SqueezeBlock`, `MobileBlock`, `MobileNetV3Large`, `mobilenet3`).

As in the JAX module, only the stages up to the last requested output
exist (and `out_conv1` only for 'layer_out'), so the state_dict matches the
flax tree.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pytracking_tpu_torch.models.layers.blocks import BatchNorm


def h_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def h_swish(x: torch.Tensor) -> torch.Tensor:
    return x * h_sigmoid(x)


class SqueezeBlock(nn.Module):
    """Squeeze-excite with a hard sigmoid."""

    def __init__(self, exp_size: int, divide: int = 4):
        super().__init__()
        self.fc0 = nn.Linear(exp_size, exp_size // divide)
        self.fc1 = nn.Linear(exp_size // divide, exp_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = h_sigmoid(self.fc1(F.relu(self.fc0(x.mean(dim=(2, 3))))))
        return x * s[:, :, None, None]


class MobileBlock(nn.Module):
    """1x1 expand (no bias) + BN + act; depthwise kxk (bias) + BN; optional
    squeeze-excite; 1x1 project (bias) + BN + act; residual when the stride
    is 1 and the channels match."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int,
                 non_linear: str, se: bool, exp_size: int):
        super().__init__()
        self.act = F.relu if non_linear == "RE" else h_swish
        self.use_connect = stride == 1 and in_channels == out_channels
        pad = (kernel_size - 1) // 2
        self.expand_conv = nn.Conv2d(in_channels, exp_size, 1, bias=False)
        self.expand_bn = BatchNorm(exp_size)
        self.depth_conv = nn.Conv2d(exp_size, exp_size, kernel_size, stride=stride,
                                    padding=pad, groups=exp_size, bias=True)
        self.depth_bn = BatchNorm(exp_size)
        self.se = SqueezeBlock(exp_size) if se else None
        self.point_conv = nn.Conv2d(exp_size, out_channels, 1, bias=True)
        self.point_bn = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.act(self.expand_bn(self.expand_conv(x)))
        out = self.depth_bn(self.depth_conv(out))
        if self.se is not None:
            out = self.se(out)
        out = self.act(self.point_bn(self.point_conv(out)))
        return x + out if self.use_connect else out


# (in, out, k, stride, act, SE, expand) per block, in stages layer1..layer6
_LARGE_STAGES = (
    ((16, 16, 3, 1, "RE", False, 16),),
    ((16, 24, 3, 2, "RE", False, 64), (24, 24, 3, 1, "RE", False, 72)),
    ((24, 40, 5, 2, "RE", True, 72), (40, 40, 5, 1, "RE", True, 120),
     (40, 40, 5, 1, "RE", True, 120)),
    ((40, 80, 3, 2, "HS", False, 240), (80, 80, 3, 1, "HS", False, 200),
     (80, 80, 3, 1, "HS", False, 184), (80, 80, 3, 1, "HS", False, 184)),
    ((80, 112, 3, 1, "HS", True, 480), (112, 112, 3, 1, "HS", True, 672)),
    ((112, 160, 5, 1, "HS", True, 672), (160, 160, 5, 2, "HS", True, 672),
     (160, 160, 5, 1, "HS", True, 960)),
)


class MobileNetV3Large(nn.Module):
    """Outputs: any of 'init_conv', 'layer1'..'layer6', 'layer_out'."""

    def __init__(self, output_layers: Sequence[str] = ("init_conv", "layer5")):
        super().__init__()
        self.output_layers = tuple(output_layers)
        self.init_conv = nn.Conv2d(3, 16, 3, stride=2, padding=1, bias=True)
        self.init_bn = BatchNorm(16)
        stages = [f"layer{i + 1}" for i in range(len(_LARGE_STAGES))]
        self.n_stages = len(stages) if "layer_out" in self.output_layers else \
            max((stages.index(n) + 1 for n in self.output_layers if n in stages), default=0)
        for stage in range(self.n_stages):
            for b, cfg in enumerate(_LARGE_STAGES[stage]):
                self.add_module(f"layer{stage + 1}_{b}", MobileBlock(*cfg))
        if "layer_out" in self.output_layers:
            self.out_conv1 = nn.Conv2d(160, 960, 1, bias=True)
            self.out_bn1 = BatchNorm(960)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        outputs = {}
        h = h_swish(self.init_bn(self.init_conv(x)))
        if "init_conv" in self.output_layers:
            outputs["init_conv"] = h
        for stage in range(self.n_stages):
            for b in range(len(_LARGE_STAGES[stage])):
                h = getattr(self, f"layer{stage + 1}_{b}")(h)
            if f"layer{stage + 1}" in self.output_layers:
                outputs[f"layer{stage + 1}"] = h
        if "layer_out" in self.output_layers:
            outputs["layer_out"] = h_swish(self.out_bn1(self.out_conv1(h)))
        return outputs


def mobilenet3(output_layers=("init_conv", "layer5")) -> MobileNetV3Large:
    return MobileNetV3Large(output_layers=output_layers)
