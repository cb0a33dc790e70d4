"""Filter initialiser of the discriminative classifier (counterpart of
pytracking_tpu/models/classifier/initializer.py: `filter_pool`,
`FilterInitializerLinear`).

Shapes: feat (N, S, C, H, W), N images of S sequences; bb (N, S, 4) as
(x, y, w, h) in image-patch coordinates; the filter is (S, 1, C, fs, fs).
"""

from __future__ import annotations

import torch
from torch import nn

from pytracking_tpu_torch.ops.prroi_pool import prroi_pool2d


def filter_pool(feat: torch.Tensor, bb: torch.Tensor, filter_size: int,
                feature_stride: int) -> torch.Tensor:
    """Pool each sample's target box into a filter_size^2 map: feat
    (B, C, H, W), bb (B, 4) xywh in image coordinates -> (B, C, fs, fs)."""
    bb = bb.reshape(-1, 4).to(torch.float32)
    rois = torch.cat([bb[:, :2], bb[:, :2] + bb[:, 2:4]], dim=1)
    bidx = torch.arange(bb.shape[0], device=bb.device)
    return prroi_pool2d(feat, rois, bidx, (filter_size, filter_size),
                        spatial_scale=1.0 / feature_stride)


class FilterInitializerLinear(nn.Module):
    """conv -> PrRoIPool over the target box -> mean over the images (DiMP's
    initialiser, without the JAX module's optional size normalisation)."""

    def __init__(self, filter_size: int = 4, feature_dim: int = 256,
                 feature_stride: int = 16):
        super().__init__()
        self.filter_size = filter_size
        self.feature_stride = feature_stride
        self.filter_conv = nn.Conv2d(feature_dim, feature_dim, 3, padding=1)

    def forward(self, feat: torch.Tensor, bb: torch.Tensor) -> torch.Tensor:
        N, S = feat.shape[:2]
        x = self.filter_conv(feat.flatten(0, 1))
        w = filter_pool(x, bb.reshape(-1, 4), self.filter_size, self.feature_stride)
        return w.reshape((N, S) + w.shape[1:]).mean(dim=0)[:, None]     # (S, 1, C, fs, fs)
