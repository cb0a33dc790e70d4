"""Dense cost volume for KYS's scene propagation (counterpart of
pytracking_tpu/models/kys/cost_volume.py `cost_volume_abs`).

One batched product of the two frames' features over every position pair,
(HW, C) x (C, HW) per sequence, then the correlation window as shifted
adds of that product and the displacement mask: a raw sum of products over
channels and the window, zero outside |p - i|, |q - j| <= md.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cost_volume_abs(feat_ref: torch.Tensor, feat_prev: torch.Tensor, max_displacement: int,
                    kernel_size: int = 1) -> torch.Tensor:
    """feat_ref, feat_prev (B, C, H, W) -> (B, H*W, H, W): entry
    [b, p*W + q, i, j] = sum over the kernel window (u, v) of
    <feat_ref[b, :, i+u, j+v], feat_prev[b, :, p+u, q+v]> (zero outside the
    map) where |p - i|, |q - j| <= max_displacement, else 0."""
    B, C, H, W = feat_ref.shape
    cv = torch.bmm(feat_prev.flatten(2).transpose(1, 2), feat_ref.flatten(2))
    cv = cv.view(B, H, W, H, W)                                      # [b, p, q, i, j]
    if kernel_size > 1:
        r = kernel_size // 2
        cvp = F.pad(cv, (r, r, r, r, r, r, r, r))
        cv = sum(cvp[:, r + u:r + u + H, r + v:r + v + W, r + u:r + u + H, r + v:r + v + W]
                 for u in range(-r, r + 1) for v in range(-r, r + 1))
    ii = torch.arange(H, device=cv.device)
    jj = torch.arange(W, device=cv.device)
    mask_p = (ii[:, None] - ii[None, :]).abs() <= max_displacement          # (p, i)
    mask_q = (jj[:, None] - jj[None, :]).abs() <= max_displacement          # (q, j)
    mask = mask_p[:, None, :, None] & mask_q[None, :, None, :]
    return torch.where(mask, cv, 0.0).reshape(B, H * W, H, W)
