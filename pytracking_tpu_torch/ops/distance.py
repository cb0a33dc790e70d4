"""Distance-to-centre maps binned with linear interpolation (counterpart of
pytracking_tpu/ops/distance.py), the input of DiMP's learned label, mask
and weight predictors."""

from __future__ import annotations

from typing import Tuple

import torch


def distance_map(center: torch.Tensor, output_sz: Tuple[int, int], num_bins: int,
                 bin_displacement: float = 1.0) -> torch.Tensor:
    """Distance of every cell of an (H, W) grid to `center` (B, 2) as (y, x),
    spread over `num_bins` bins by linear interpolation; the last bin
    saturates, so distances past the grid stay fully in it.

    Returns (B, H, W, num_bins) float32: the bins are the last axis, the
    axis the predictors contract with their per-bin weight vectors."""
    H, W = output_sz
    center = center.to(torch.float32).reshape(-1, 2)
    dev = center.device
    d0 = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None] - center[:, 0, None, None]
    d1 = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :] - center[:, 1, None, None]
    dist = torch.sqrt(d0 * d0 + d1 * d1)
    bin_diff = dist[..., None] / bin_displacement - torch.arange(
        num_bins, dtype=torch.float32, device=dev)
    inner = torch.clamp(1.0 - torch.abs(bin_diff[..., :-1]), min=0.0)
    last = torch.clamp(1.0 + bin_diff[..., -1:], 0.0, 1.0)
    return torch.cat([inner, last], dim=-1)
