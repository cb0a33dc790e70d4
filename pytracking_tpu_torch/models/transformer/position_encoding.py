"""Sine positional encodings with anti-aliasing (counterpart of
pytracking_tpu/models/transformer/position_encoding.py)."""

from __future__ import annotations

import functools
import math
from typing import Tuple

import torch


@functools.cache
def position_embedding_sine(shape: Tuple[int, int], d_model: int,
                            max_spatial_resolution: int,
                            device=None) -> torch.Tensor:
    """(H, W) grid -> (H, W, d_model): per basis b = 1..depth, sin then cos of
    b * (max_res / depth) * pi * (x, y), with x and y of each basis adjacent.
    Cached per arguments: callers must not modify the result."""
    H, W = shape
    depth = (d_model // 2) // 2
    factor = max_spatial_resolution / depth
    y = (torch.arange(H, dtype=torch.float32, device=device) + 0.5) / H
    x = (torch.arange(W, dtype=torch.float32, device=device) + 0.5) / W
    pos = torch.stack([x[None, :].expand(H, W), y[:, None].expand(H, W)], dim=-1)
    bases = torch.arange(1, depth + 1, dtype=torch.float32, device=device)
    ang = bases[None, None, :, None] * factor * math.pi * pos[..., None, :]
    sin = torch.sin(ang).reshape(H, W, -1)
    cos = torch.cos(ang).reshape(H, W, -1)
    return torch.cat([sin, cos], dim=-1)
