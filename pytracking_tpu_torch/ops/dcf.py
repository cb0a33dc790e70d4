"""Hann windows, Gaussian labels and 2-D argmax (counterpart of
pytracking_tpu/ops/dcf.py: `hann1d`, `hann2d`, `hann2d_clipped`, `gauss_1d`,
`gauss_2d`, `max2d`)."""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def hann1d(sz: int, device=None) -> torch.Tensor:
    """1-D Hann window of sz points, zero just outside both ends."""
    n = torch.arange(sz, dtype=torch.float32, device=device)
    return 0.5 * (1.0 - torch.cos(2.0 * math.pi * (n + 1) / (sz + 1)))


def hann2d(sz: Tuple[int, int], device=None) -> torch.Tensor:
    """Outer-product 2-D Hann window, (H, W)."""
    return hann1d(sz[0], device=device)[:, None] * hann1d(sz[1], device=device)[None, :]


def hann2d_clipped(sz: Tuple[int, int], effective_sz: Tuple[int, int],
                   device=None) -> torch.Tensor:
    """2-D Hann window of `effective_sz`, centre-cropped to `sz` where it is
    larger and edge-padded to `sz` where it is smaller, (H, W)."""
    eh, ew = effective_sz
    win = hann2d((eh, ew), device=device)
    if eh > sz[0]:
        t = (eh - sz[0]) // 2
        win = win[t:t + sz[0], :]
        eh = sz[0]
    if ew > sz[1]:
        left = (ew - sz[1]) // 2
        win = win[:, left:left + sz[1]]
        ew = sz[1]
    pad_t = (sz[0] - eh) // 2
    pad_l = (sz[1] - ew) // 2
    pad = (pad_l, sz[1] - ew - pad_l, pad_t, sz[0] - eh - pad_t)
    return F.pad(win[None, None], pad, mode="replicate")[0, 0]


def gauss_1d(sz: int, sigma: torch.Tensor, center: torch.Tensor,
             end_pad: int = 0) -> torch.Tensor:
    """Sampled 1-D Gaussians on the grid -(sz-1)/2, ..., (sz-1)/2 + end_pad,
    centred at `center`. sigma and center broadcast: returns
    (..., sz + end_pad)."""
    k = torch.arange(sz + end_pad, dtype=torch.float32, device=center.device) - (sz - 1) / 2
    return torch.exp(-1.0 / (2.0 * sigma[..., None] ** 2) * (k - center[..., None]) ** 2)


def gauss_2d(sz: Tuple[int, int], sigma, center: torch.Tensor,
             end_pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Separable 2-D Gaussian labels. center (N, 2) as (y, x); sigma a scalar,
    a (2,) pair or (N, 2) per centre. Returns (N, H + end_pad[0],
    W + end_pad[1])."""
    center = torch.as_tensor(center, dtype=torch.float32)
    if center.dim() == 1:
        center = center[None]
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=center.device)
    sigma = torch.broadcast_to(sigma, center.shape)
    gy = gauss_1d(sz[0], sigma[:, 0], center[:, 0], end_pad[0])
    gx = gauss_1d(sz[1], sigma[:, 1], center[:, 1], end_pad[1])
    return gy[:, :, None] * gx[:, None, :]


def max2d(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Max value and integer (row, col) argmax over the trailing two dims,
    batched over leading dims. Ties go to the first index in row-major order."""
    h, w = a.shape[-2], a.shape[-1]
    flat = a.reshape(a.shape[:-2] + (h * w,))
    max_val, idx = torch.max(flat, dim=-1)
    return max_val, torch.stack([idx // w, idx % w], dim=-1)
