"""Convolutional GRU cell (counterpart of pytracking_tpu/models/kys/conv_gru.py
`ConvGRUCell`)."""

from __future__ import annotations

import torch
from torch import nn


class ConvGRUCell(nn.Module):
    """x (B, Cin, H, W) and state (B, hidden, H, W) -> the new state."""

    def __init__(self, input_dim: int, hidden_dim: int, kernel_size: int = 3):
        super().__init__()
        pad = kernel_size // 2
        self.conv_reset = nn.Conv2d(input_dim + hidden_dim, hidden_dim, kernel_size, padding=pad)
        self.conv_update = nn.Conv2d(input_dim + hidden_dim, hidden_dim, kernel_size,
                                     padding=pad)
        self.conv_state_new = nn.Conv2d(input_dim + hidden_dim, hidden_dim, kernel_size,
                                        padding=pad)

    def forward(self, x: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
        xs = torch.cat([x, state], dim=1)
        reset = torch.sigmoid(self.conv_reset(xs))
        update = torch.sigmoid(self.conv_update(xs))
        state_new = torch.tanh(self.conv_state_new(torch.cat([x, reset * state], dim=1)))
        return (1.0 - update) * state + update * state_new
