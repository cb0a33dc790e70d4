"""ResNet backbone with selectable intermediate outputs, NCHW (counterpart of
pytracking_tpu/models/backbones/resnet.py: `BasicBlock`, `Bottleneck`,
`ResNet`, `resnet18`, `resnet50`, `resnet101`, `resnet50_mrcnn`,
`normalize_image`, `normalize_image_bgr255`).

Module names follow the JAX package (`layer3_2.conv2`, `downsample_bn`, ...),
so `utils/convert_weights.py` maps one tree onto the other. `dtype` is the
compute dtype of the convolutions (parameters stay float32, outputs are
returned in float32), as in the JAX package's bf16 mode.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pytracking_tpu_torch.models.layers.blocks import BatchNorm


class Conv2d(nn.Conv2d):
    """nn.Conv2d that runs in a compute dtype: input and weight are cast to
    `dtype` (when set) at the call."""

    def __init__(self, *args, dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or x.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride, self.padding,
                        self.dilation, self.groups)


class BasicBlock(nn.Module):
    """Two 3x3 convolutions (ResNet-18/34)."""
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride=stride, padding=dilation,
                            dilation=dilation, bias=False, dtype=dtype)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=dilation, dilation=dilation,
                            bias=False, dtype=dtype)
        self.bn2 = BatchNorm(planes)
        if downsample:
            self.downsample_conv = Conv2d(inplanes, planes, 1, stride=stride, bias=False,
                                          dtype=dtype)
            self.downsample_bn = BatchNorm(planes)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1, 3x3, 1x1 convolutions. With `stride_in_1x1` (the Caffe2 /
    Detectron convention of the maskrcnn ResNet) the stride is on the first
    1x1 convolution, else on the 3x3 one."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False, dtype: Optional[torch.dtype] = None,
                 stride_in_1x1: bool = False):
        super().__init__()
        out = planes * self.expansion
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = Conv2d(inplanes, planes, 1, stride=s1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=s3, padding=dilation,
                            dilation=dilation, bias=False, dtype=dtype)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv2d(planes, out, 1, bias=False, dtype=dtype)
        self.bn3 = BatchNorm(out)
        if downsample:
            self.downsample_conv = Conv2d(inplanes, out, 1, stride=stride, bias=False,
                                          dtype=dtype)
            self.downsample_bn = BatchNorm(out)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + identity)


class ResNet(nn.Module):
    """ResNet of `block` 'basic' or 'bottleneck' returning a dict of the
    requested stage outputs ('layer1'..'layer4'). Stages after the last
    requested output are built (their weights are part of the model) but not
    run."""

    def __init__(self, layers: Tuple[int, ...] = (3, 4, 6, 3),
                 output_layers: Sequence[str] = ("layer2", "layer3"),
                 base_width: int = 64, dtype: Optional[torch.dtype] = None,
                 block: str = "bottleneck", stride_in_1x1: bool = False):
        super().__init__()
        if block not in ("basic", "bottleneck"):
            raise ValueError(f"unknown ResNet block {block!r}")
        Block = BasicBlock if block == "basic" else \
            functools.partial(Bottleneck, stride_in_1x1=stride_in_1x1)
        expansion = 1 if block == "basic" else Bottleneck.expansion
        self.output_layers = tuple(output_layers)
        self.dtype = dtype
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False, dtype=dtype)
        self.bn1 = BatchNorm(64)
        self.stage_blocks = []
        in_ch = 64
        for stage in range(4):
            planes = base_width * 2 ** stage
            names = []
            for b in range(layers[stage]):
                stride = (1 if stage == 0 else 2) if b == 0 else 1
                need_ds = b == 0 and (stride != 1 or in_ch != planes * expansion)
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, Block(in_ch, planes, stride=stride, downsample=need_ds,
                                            dtype=dtype))
                names.append(name)
                in_ch = planes * expansion
            self.stage_blocks.append(names)
        stages = [f"layer{i}" for i in range(1, 5)]
        self.last_stage = max(stages.index(n) + 1 for n in self.output_layers)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        outputs = {}
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage in range(self.last_stage):
            for name in self.stage_blocks[stage]:
                x = getattr(self, name)(x)
            if f"layer{stage + 1}" in self.output_layers:
                outputs[f"layer{stage + 1}"] = x
        return {k: v.float() for k, v in outputs.items()}


def resnet18(output_layers=("layer2", "layer3"), dtype=None) -> ResNet:
    return ResNet(layers=(2, 2, 2, 2), output_layers=output_layers, dtype=dtype, block="basic")


def resnet50(output_layers=("layer2", "layer3"), dtype=None) -> ResNet:
    return ResNet(layers=(3, 4, 6, 3), output_layers=output_layers, dtype=dtype)


def resnet101(output_layers=("layer2", "layer3"), dtype=None) -> ResNet:
    return ResNet(layers=(3, 4, 23, 3), output_layers=output_layers, dtype=dtype)


def resnet50_mrcnn(output_layers=("layer1", "layer2", "layer3", "layer4"),
                   dtype=None) -> ResNet:
    """The maskrcnn-benchmark ResNet-50 of LWL and RTS: the stride in each
    stage's first 1x1 convolution. Its input is `normalize_image_bgr255`."""
    return ResNet(layers=(3, 4, 6, 3), output_layers=output_layers, dtype=dtype,
                  stride_in_1x1=True)


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@functools.cache
def _mean_std(device: torch.device):
    """(3, 1, 1) mean and std on `device`, uploaded once per device."""
    return (torch.tensor(IMAGENET_MEAN, device=device)[:, None, None],
            torch.tensor(IMAGENET_STD, device=device)[:, None, None])


def normalize_image(im: torch.Tensor) -> torch.Tensor:
    """ImageNet mean/std normalisation of a 0-255 (N, 3, H, W) image."""
    mean, std = _mean_std(im.device)
    return (im / 255.0 - mean) / std


CAFFE_BGR_MEAN = (102.9801, 115.9465, 122.7717)


@functools.cache
def _caffe_mean(device: torch.device) -> torch.Tensor:
    return torch.tensor(CAFFE_BGR_MEAN, device=device)[:, None, None]


def normalize_image_bgr255(im: torch.Tensor) -> torch.Tensor:
    """Caffe2 'bgr255' input of the maskrcnn backbones: a 0-255 RGB
    (N, 3, H, W) image flipped to BGR, minus the Caffe mean, std 1."""
    return im.flip(-3) - _caffe_mean(im.device)
