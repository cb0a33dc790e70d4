"""Bounding-box parametrisations (counterpart of pytracking_tpu/ops/bbox.py:
`rect_to_rel`, `rel_to_rect`). Boxes are (..., 4) as (x, y, w, h)."""

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
