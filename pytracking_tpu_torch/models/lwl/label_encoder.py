"""Few-shot label encoders of LWL (counterpart of
pytracking_tpu/models/lwl/label_encoder.py: `SegBasicBlock`,
`ResidualDS16SW`, `bbox_to_gauss`, `ResidualDS16FeatSWBox`).

A mask (or a box rendered as a Gaussian prior) at image resolution goes to
the /16 target-model grid through a strided conv block, a max pool and two
strided residual blocks; two heads give the label encoding and the sample
weights. Outputs are (Nf, Ns, K, H/16, W/16).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pytracking_tpu_torch.models.layers.blocks import BatchNorm, ConvBlock


class SegBasicBlock(nn.Module):
    """Bias-free 3x3 convolutions with optional BatchNorm, and a strided 3x3
    `downsample` convolution with bias and no norm on the identity path."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, use_bn: bool = True):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm(planes) if use_bn else None
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(planes) if use_bn else None
        self.downsample = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv1(x)
        if self.bn1 is not None:
            out = self.bn1(out)
        out = self.conv2(F.relu(out))
        if self.bn2 is not None:
            out = self.bn2(out)
        return F.relu(out + self.downsample(x))


def _heads(in_dim: int, out_dim: int, final_bn: bool) -> Tuple[nn.Module, nn.Module]:
    """The label head (a conv block) and the sample-weight head (a 3x3
    convolution, zero weights and bias one before any weights are loaded)."""
    samp_w_pred = nn.Conv2d(in_dim, out_dim, 3, padding=1)
    with torch.no_grad():
        samp_w_pred.weight.zero_()
        samp_w_pred.bias.fill_(1.0)
    return ConvBlock(in_dim, out_dim, 3, batch_norm=final_bn), samp_w_pred


class ResidualDS16SW(nn.Module):
    """Mask -> (label encoding, sample weights) at /16; layer_dims are the
    conv block's, the two residual blocks' and the output widths."""

    def __init__(self, layer_dims: Sequence[int] = (16, 32, 64, 16), use_bn: bool = True):
        super().__init__()
        d = tuple(layer_dims)
        self.conv_block = ConvBlock(1, d[0], 3, stride=2, batch_norm=use_bn)
        self.res1 = SegBasicBlock(d[0], d[1], stride=2, use_bn=use_bn)
        self.res2 = SegBasicBlock(d[1], d[2], stride=2, use_bn=use_bn)
        self.label_pred, self.samp_w_pred = _heads(d[2], d[3], use_bn)

    def forward(self, mask: torch.Tensor, feature: Optional[torch.Tensor] = None):
        """mask (Nf, Ns, H, W) in [0, 1]; `feature` is not used."""
        Nf, Ns = mask.shape[:2]
        x = mask.reshape((-1, 1) + mask.shape[2:])
        x = F.max_pool2d(self.conv_block(x), 3, stride=2, padding=1)
        x = self.res2(self.res1(x))
        label, sw = self.label_pred(x), self.samp_w_pred(x)
        return (label.reshape((Nf, Ns) + label.shape[1:]),
                sw.reshape((Nf, Ns) + sw.shape[1:]))


def bbox_to_gauss(bb: torch.Tensor, sz: Tuple[int, int]) -> torch.Tensor:
    """Soft Gaussian box prior: bb (B, 4) as (x, y, w, h) in image
    coordinates -> (B, 1, H, W), sigma a quarter of the box side (at least
    1 pixel)."""
    H, W = sz
    cx = bb[:, 0] + bb[:, 2] / 2
    cy = bb[:, 1] + bb[:, 3] / 2
    xs = torch.arange(W, dtype=torch.float32, device=bb.device)[None, None, :]
    ys = torch.arange(H, dtype=torch.float32, device=bb.device)[None, :, None]
    dx2 = (xs - cx[:, None, None]) ** 2 / torch.clamp(0.25 * bb[:, 2], min=1.0)[:, None, None] ** 2
    dy2 = (ys - cy[:, None, None]) ** 2 / torch.clamp(0.25 * bb[:, 3], min=1.0)[:, None, None] ** 2
    return torch.exp(-0.5 * (dx2 + dy2))[:, None]


class ResidualDS16FeatSWBox(nn.Module):
    """Box -> (label encoding, sample weights): the box's Gaussian prior
    (`bbox_to_gauss`; the JAX module renders a Gaussian whatever its
    `use_gauss` says, and so does this one) down to /16, concatenated with
    the target-model features (`feat_dim` channels), a third residual block
    and the two heads. `use_bn` sets the norms of the conv block and the
    residual blocks, `final_bn` the label head's."""

    def __init__(self, layer_dims: Sequence[int] = (16, 32, 64, 64, 16), feat_dim: int = 512,
                 use_bn: bool = False, final_bn: bool = True):
        super().__init__()
        d = tuple(layer_dims)
        self.conv_block = ConvBlock(1, d[0], 3, stride=2, batch_norm=use_bn)
        self.res1 = SegBasicBlock(d[0], d[1], stride=2, use_bn=use_bn)
        self.res2 = SegBasicBlock(d[1], d[2], stride=2, use_bn=use_bn)
        self.res3 = SegBasicBlock(d[2] + feat_dim, d[3], stride=1, use_bn=use_bn)
        self.label_pred, self.samp_w_pred = _heads(d[3], d[4], final_bn)

    def forward(self, bb: torch.Tensor, feat: torch.Tensor, im_sz: Tuple[int, int]):
        """bb (Nf, Ns, 4); feat (Nf, Ns, C, H/16, W/16); im_sz (H, W)."""
        Nf, Ns = bb.shape[:2]
        x = self.conv_block(bbox_to_gauss(bb.reshape(-1, 4), im_sz))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        x = self.res2(self.res1(x))
        x = self.res3(torch.cat([x, feat.flatten(0, 1)], dim=1))
        label, sw = self.label_pred(x), self.samp_w_pred(x)
        return (label.reshape((Nf, Ns) + label.shape[1:]),
                sw.reshape((Nf, Ns) + sw.shape[1:]))
