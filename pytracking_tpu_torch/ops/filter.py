"""Per-sample filter application (counterpart of pytracking_tpu/ops/filter.py
`apply_filter`, mode 'dimp')."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def apply_filter(feat: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """Cross-correlate each sample with its own filter: feat (B, C, H, W),
    filt (B, K, C, fh, fw) -> (B, K, Ho, Wo). Pads fh//2, fw//2 on both sides,
    so an even filter gives H+1 rows (the DiMP convention). One grouped
    convolution over the B samples."""
    B, C, H, W = feat.shape
    _, K, _, fh, fw = filt.shape
    out = F.conv2d(feat.reshape(1, B * C, H, W), filt.reshape(B * K, C, fh, fw),
                   padding=(fh // 2, fw // 2), groups=B)
    return out.reshape(B, K, out.shape[-2], out.shape[-1])
