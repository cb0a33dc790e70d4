"""Precise RoI pooling, exact and differentiable in the boxes and the
features (counterpart of pytracking_tpu/ops/prroi_pool.py).

A bin's pooled value is the integral of the bilinearly interpolated feature
surface over the bin, divided by its area. The surface is a sum of
separable triangle kernels, so the integral separates into one weight
vector per axis, w(i) = TriCdf(b - i) - TriCdf(a - i), and pooling all N
RoIs is two batched matrix products, P_n = W_y[n] · F[b_n] · W_x[n]^T.
The weights are piecewise quadratic in the box coordinates, so autograd
gives the box gradient IoU-Net refinement ascends.

Boxes are (x1, y1, x2, y2) in image coordinates, scaled by `spatial_scale`
to feature coordinates; feature (i, j) sits at (i, j); the surface is zero
outside the map.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _tri_cdf(x: torch.Tensor) -> torch.Tensor:
    """Antiderivative of tri(t) = max(0, 1 - |t|): 0 below -1, 1 above 1,
    piecewise quadratic between."""
    x = torch.clamp(x, -1.0, 1.0)
    return torch.where(x < 0.0, 0.5 * (x + 1.0) ** 2, 0.5 + x * (1.0 - 0.5 * x))


def _axis_weights(lo: torch.Tensor, hi: torch.Tensor, n_bins: int, size: int) -> torch.Tensor:
    """(N, n_bins, size) weights along one axis for N extents lo..hi:
    w[n, k, i] is the integral of tri(t - i) over bin k of extent n."""
    steps = torch.arange(n_bins + 1, dtype=torch.float32, device=lo.device)
    edges = lo[:, None] + (hi - lo)[:, None] * steps / n_bins
    grid = torch.arange(size, dtype=torch.float32, device=lo.device)
    cdf = _tri_cdf(edges[:, :, None] - grid)
    return cdf[:, 1:] - cdf[:, :-1]


def prroi_pool2d(feat: torch.Tensor, rois: torch.Tensor, batch_idx: torch.Tensor,
                 output_size: Tuple[int, int], spatial_scale: float = 1.0) -> torch.Tensor:
    """Precise RoI pooling of feat (B, C, H, W) over rois (N, 4) (x1, y1, x2,
    y2), RoI n pooling from image batch_idx[n]. Returns (N, C, ph, pw)."""
    ph, pw = output_size
    H, W = feat.shape[-2], feat.shape[-1]
    x1, y1, x2, y2 = (rois.to(torch.float32) * spatial_scale).unbind(-1)
    wy = _axis_weights(y1, y2, ph, H)                                  # (N, ph, H)
    wx = _axis_weights(x1, x2, pw, W)                                  # (N, pw, W)
    f = feat.index_select(0, batch_idx.long())                         # (N, C, H, W)
    pooled = torch.matmul(torch.matmul(wy[:, None], f), wx[:, None].transpose(-1, -2))
    bin_area = torch.clamp((y2 - y1) / ph, min=1e-6) * torch.clamp((x2 - x1) / pw, min=1e-6)
    return pooled / bin_area[:, None, None, None]

