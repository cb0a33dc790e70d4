"""Bounding-box parametrisations and the box of a mask (counterpart of
pytracking_tpu/ops/bbox.py: `rect_to_rel`, `rel_to_rect`,
`masks_to_bboxes`). Boxes are (..., 4) as (x, y, w, h)."""

from __future__ import annotations

from typing import Optional

import torch


def rect_to_rel(bb: torch.Tensor, sz_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(x, y, w, h) -> (cx/σ, cy/σ, log w, log h), σ = `sz_norm` (default the
    box's own size): the space PrDiMP's box refinement ascends in."""
    c = bb[..., :2] + 0.5 * bb[..., 2:]
    c_rel = c / (bb[..., 2:] if sz_norm is None else sz_norm)
    return torch.cat([c_rel, torch.log(bb[..., 2:])], dim=-1)


def rel_to_rect(bb: torch.Tensor, sz_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The inverse of `rect_to_rel`."""
    sz = torch.exp(bb[..., 2:])
    c = bb[..., :2] * (sz if sz_norm is None else sz_norm)
    return torch.cat([c - 0.5 * sz, sz], dim=-1)


def masks_to_bboxes(mask: torch.Tensor, fmt: str = "c") -> torch.Tensor:
    """The tight box of each mask's pixels above 0, float32: mask (..., H, W)
    -> (..., 4) as 'c' (cx, cy, w, h) with the centre at x1 + (w - 1) / 2,
    't' (x, y, w, h) or 'v' (x1, y1, x2, y2). An empty mask's box is zeros
    ('c': its centre at -0.5, as the JAX function's)."""
    H, W = mask.shape[-2], mask.shape[-1]
    m = mask > 0
    rows, cols = m.any(-1), m.any(-2)
    any_ = rows.any(-1)
    yy = torch.arange(H, dtype=torch.float32, device=mask.device)
    xx = torch.arange(W, dtype=torch.float32, device=mask.device)
    big = torch.tensor(1e9, dtype=torch.float32, device=mask.device)
    y1 = torch.where(rows, yy, big).amin(-1)
    y2 = torch.where(rows, yy, -big).amax(-1)
    x1 = torch.where(cols, xx, big).amin(-1)
    x2 = torch.where(cols, xx, -big).amax(-1)
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    x1, y1, x2, y2 = [torch.where(any_, v, zero) for v in (x1, y1, x2, y2)]
    w = torch.where(any_, x2 - x1 + 1, zero)
    h = torch.where(any_, y2 - y1 + 1, zero)
    if fmt == "v":
        return torch.stack([x1, y1, x2, y2], dim=-1)
    if fmt == "c":
        return torch.stack([x1 + 0.5 * (w - 1), y1 + 0.5 * (h - 1), w, h], dim=-1)
    return torch.stack([x1, y1, w, h], dim=-1)
