"""TaMOs heads (counterpart of pytracking_tpu/models/transformer/heads.py:
`LinearFilterClassifier`, `DenseBoxRegressor`).

feat (Nf, Ns, C, H, W); filters (Ns, K, C), one per object. The K objects are
folded into the batch of one convolution stack instead of a loop over K.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pytracking_tpu_torch.ops.filter import apply_filter

GN_EPS = 1e-6          # flax GroupNorm's default


def _apply_filters(feat: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    """(Nf, Ns, C, H, W) x (Ns, K, C) 1x1 filters -> (Nf*Ns, K, H, W)."""
    Nf, Ns, C, H, W = feat.shape
    w = filters.repeat(Nf, 1, 1)[..., None, None]
    return apply_filter(feat.reshape(Nf * Ns, C, H, W), w)


class LinearFilterClassifier(nn.Module):
    """Project each object's filter with a linear layer, then correlate."""

    def __init__(self, num_channels: int):
        super().__init__()
        self.linear = nn.Linear(num_channels, num_channels)

    def forward(self, feat: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
        """-> scores (Nf, Ns, K, H, W)."""
        Nf, Ns, C, H, W = feat.shape
        return _apply_filters(feat, self.linear(filters)).reshape(Nf, Ns, -1, H, W)


class DenseBoxRegressor(nn.Module):
    """Filter attention over the features, a 4-layer conv/GroupNorm tower and
    exp(LTRB) dense boxes."""

    def __init__(self, num_channels: int):
        super().__init__()
        c = num_channels
        self.linear = nn.Linear(c, c)
        for i in range(4):
            self.add_module(f"tower{i}_conv", nn.Conv2d(c, c, 3, padding=1))
            self.add_module(f"tower{i}_gn", nn.GroupNorm(1, c, eps=GN_EPS))
        self.bbreg_layer = nn.Conv2d(c, 4, 3, padding=1)

    def forward(self, feat: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
        """-> ltrb (Nf, Ns, K, 4, H, W)."""
        Nf, Ns, C, H, W = feat.shape
        K = filters.shape[1]
        attention = _apply_filters(feat, self.linear(filters))       # (N, K, H, W)
        x = (attention[:, :, None] * feat.reshape(Nf * Ns, 1, C, H, W))
        x = x.reshape(Nf * Ns * K, C, H, W)
        for i in range(4):
            x = getattr(self, f"tower{i}_conv")(x)
            x = F.relu(getattr(self, f"tower{i}_gn")(x))
        return torch.exp(self.bbreg_layer(x)).reshape(Nf, Ns, K, 4, H, W)
