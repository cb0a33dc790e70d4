"""Box encoder of the transformer filter predictors (counterpart of
pytracking_tpu/models/transformer/filter_predictor.py `BoxEncoder`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pytracking_tpu_torch.models.layers.blocks import BatchNorm


class BoxEncoder(nn.Module):
    """Tokenwise MLP 4 -> d/4 -> d -> d with BatchNorm + ReLU between layers,
    on (..., 4)."""

    def __init__(self, d_model: int):
        super().__init__()
        dims = [4, d_model // 4, d_model, d_model]
        self.lin0 = nn.Linear(dims[0], dims[1])
        self.bn0 = BatchNorm(dims[1], dim=-1)
        self.lin1 = nn.Linear(dims[1], dims[2])
        self.bn1 = BatchNorm(dims[2], dim=-1)
        self.lin2 = nn.Linear(dims[2], dims[3])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn0(self.lin0(x)))
        x = F.relu(self.bn1(self.lin1(x)))
        return self.lin2(x)
