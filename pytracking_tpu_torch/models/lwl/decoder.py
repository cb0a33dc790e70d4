"""LWL segmentation decoder (counterpart of
pytracking_tpu/models/lwl/decoder.py: `_interp`, `_bicubic_resize`, `TSE`,
`CAB`, `RRB`, `Upsampler`, `LWTLDecoder`).

The mask encoding of the target model is fused with the backbone features
level by level, deepest first (layer4 -> layer1): score/feature fusion
(TSE), residual refinement (RRB) and channel-attention gating (CAB), then a
bicubic upsampler to the crop's resolution. Maps are (B, C, H, W).
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pytracking_tpu_torch.models.layers.blocks import BatchNorm


def _interp(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (B, C, H, W) to `size`, half-pixel centres. As
    `jax.image.resize` does, a downsample is antialiased (the kernel widened
    by the scale); an upsample is plain bilinear."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False,
                         antialias=True)


def _cubic_kernel(t: torch.Tensor, a: float = -0.75) -> torch.Tensor:
    at = torch.abs(t)
    return torch.where(at <= 1.0, ((a + 2.0) * at - (a + 3.0)) * at * at + 1.0,
                       torch.where(at < 2.0, (((at - 5.0) * at + 8.0) * at - 4.0) * a, 0.0))


@functools.cache
def _bicubic_axis_weights(out_size: int, in_size: int, device: torch.device) -> torch.Tensor:
    """(out, in) weights of a bicubic resize along one axis (a = -0.75,
    half-pixel centres, taps outside the input clamped onto its border),
    built once per shape and device."""
    dst = torch.arange(out_size, dtype=torch.float32, device=device)
    src = (dst + 0.5) * (in_size / out_size) - 0.5
    i0 = torch.floor(src).long()
    w = torch.zeros((out_size, in_size), dtype=torch.float32, device=device)
    rows = torch.arange(out_size, device=device)
    for k in range(-1, 3):
        idx = i0 + k
        w.index_put_((rows, torch.clamp(idx, 0, in_size - 1)), _cubic_kernel(src - idx.float()),
                     accumulate=True)
    return w


def _bicubic_resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(..., H, W) -> (..., size[0], size[1]) bicubic, as two matrix
    products with the separable weights of `_bicubic_axis_weights`."""
    wy = _bicubic_axis_weights(int(size[0]), x.shape[-2], x.device)
    wx = _bicubic_axis_weights(int(size[1]), x.shape[-1], x.device)
    return torch.matmul(torch.matmul(wy, x), wx.T)


def _conv(ic: int, oc: int, k: int, bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(ic, oc, k, padding=k // 2, bias=bias)


class TSE(nn.Module):
    """Fuses the resized mask encoding (`score_ch` channels) with the
    reduced backbone feature. Returns the fused map and the pooled context
    for the level's CAB (the global mean at the deepest level, else the
    projected output of the level above)."""

    def __init__(self, ft_ch: int, oc: int, score_ch: int):
        super().__init__()
        self.reduce0 = _conv(ft_ch, oc, 1)
        self.reduce1 = _conv(oc, oc, 1)
        self.transform0 = _conv(oc + score_ch, oc + score_ch, 3)
        self.transform1 = _conv(oc + score_ch, oc + score_ch, 3)
        self.transform2 = _conv(oc + score_ch, oc, 3)

    def forward(self, ft, score, x=None):
        h = self.reduce1(F.relu(self.reduce0(ft)))
        hpool = h.mean(dim=(-2, -1), keepdim=True) if x is None else x
        h = torch.cat([h, _interp(score, h.shape[-2:])], dim=1)
        h = F.relu(self.transform1(F.relu(self.transform0(h))))
        return F.relu(self.transform2(h)), hpool


class CAB(nn.Module):
    """Channel attention from the pooled deeper and shallower maps gates the
    shallower map; the deeper map is added, resized to it."""

    def __init__(self, oc: int, deepest: bool = False):
        super().__init__()
        self.deepest = deepest
        self.att0 = _conv(2 * oc, oc, 1)
        self.att1 = _conv(oc, oc, 1)

    def forward(self, deeper, shallower):
        shallow_pool = shallower.mean(dim=(-2, -1), keepdim=True)
        deeper_pool = deeper if self.deepest else deeper.mean(dim=(-2, -1), keepdim=True)
        a = self.att1(F.relu(self.att0(torch.cat([shallow_pool, deeper_pool], dim=1))))
        gated = shallower * torch.sigmoid(a)
        return gated + _interp(deeper, gated.shape[-2:])


class RRB(nn.Module):
    """Residual refinement: 1x1 conv, then 3x3 conv, BatchNorm, ReLU and a
    bias-free 3x3 conv on the residual branch."""

    def __init__(self, oc: int, use_bn: bool = False):
        super().__init__()
        self.conv1x1 = _conv(oc, oc, 1)
        self.bb0 = _conv(oc, oc, 3)
        self.bn = BatchNorm(oc) if use_bn else None
        self.bb1 = _conv(oc, oc, 3, bias=False)

    def forward(self, x):
        h = self.conv1x1(x)
        b = self.bb0(h)
        if self.bn is not None:
            b = self.bn(b)
        return F.relu(h + self.bb1(F.relu(b)))


class Upsampler(nn.Module):
    """2x bicubic, 3x3 conv and ReLU, bicubic to the crop size, 3x3 conv to
    one logit channel."""

    def __init__(self, in_channels: int = 64):
        super().__init__()
        self.conv1 = _conv(in_channels, in_channels // 2, 3)
        self.conv2 = _conv(in_channels // 2, 1, 3)

    def forward(self, x, image_size: Tuple[int, int]):
        x = _bicubic_resize(x, (2 * x.shape[-2], 2 * x.shape[-1]))
        x = _bicubic_resize(F.relu(self.conv1(x)), image_size)
        return self.conv2(x)


class LWTLDecoder(nn.Module):
    """`ft_channels` maps each layer of `ft_layers` (deepest first) to its
    backbone width; level L works at `_OC[L] * out_channels` channels."""

    _OC = {"layer1": 1, "layer2": 2, "layer3": 2, "layer4": 4}

    def __init__(self, in_channels: int = 1, out_channels: int = 32,
                 ft_channels: Dict[str, int] = None,
                 ft_layers: Sequence[str] = ("layer4", "layer3", "layer2", "layer1"),
                 use_bn: bool = True):
        super().__init__()
        self.ft_layers = tuple(ft_layers)
        last_layer = "layer4" if "layer4" in self.ft_layers else "layer3"
        prev_oc = None
        for L in self.ft_layers:
            oc = self._OC[L] * out_channels
            if prev_oc is not None:
                self.add_module(f"proj_{L}", _conv(prev_oc, oc, 1))
            self.add_module(f"TSE_{L}", TSE(ft_channels[L], oc, in_channels))
            self.add_module(f"RRB1_{L}", RRB(oc, use_bn))
            self.add_module(f"CAB_{L}", CAB(oc, L == last_layer))
            self.add_module(f"RRB2_{L}", RRB(oc, use_bn))
            prev_oc = oc
        self.project = Upsampler(out_channels)

    def forward(self, scores: torch.Tensor, features: Dict[str, torch.Tensor],
                image_size: Tuple[int, int]):
        """scores (B, K, h, w) mask encoding; features: layer -> (B, C_l,
        H_l, W_l). Returns (mask logits (B, 1, H, W), the levels' outputs)."""
        x = None
        outputs = {}
        for L in self.ft_layers:
            ft = features[L]
            s = _interp(scores, ft.shape[-2:])
            if x is not None:
                x = F.relu(getattr(self, f"proj_{L}")(x))
            h, hpool = getattr(self, f"TSE_{L}")(ft, s, x)
            h = getattr(self, f"RRB1_{L}")(h)
            h = getattr(self, f"CAB_{L}")(hpool, h)
            x = getattr(self, f"RRB2_{L}")(h)
            outputs[f"{L}_dec"] = x
        return self.project(x, image_size), outputs
