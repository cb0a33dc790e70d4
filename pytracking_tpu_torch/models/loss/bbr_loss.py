"""Box regression losses of ToMP and TaMOs (counterpart of
pytracking_tpu/models/loss/bbr_loss.py: `giou`, `giou_loss`)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def giou(pred_ltrb: torch.Tensor, target_ltrb: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalised IoU of boxes given as (l, t, r, b) distances from common
    anchor points, (..., 4) each. The intersection's width and height are
    clipped at 0, the union and the enclosing box's area at 1e-7 from
    below. Returns (giou, iou), the leading shape."""
    pl, pt, pr, pb = pred_ltrb.unbind(-1)
    tl, tt, tr, tb = target_ltrb.unbind(-1)
    pred_area = (pl + pr) * (pt + pb)
    target_area = (tl + tr) * (tt + tb)
    w_inter = torch.clamp(torch.minimum(pl, tl) + torch.minimum(pr, tr), min=0.0)
    h_inter = torch.clamp(torch.minimum(pt, tt) + torch.minimum(pb, tb), min=0.0)
    inter = w_inter * h_inter
    union = pred_area + target_area - inter
    iou = inter / torch.clamp(union, min=1e-7)
    wc = torch.maximum(pl, tl) + torch.maximum(pr, tr)
    hc = torch.maximum(pt, tt) + torch.maximum(pb, tb)
    area_c = torch.clamp(wc * hc, min=1e-7)
    return iou - (area_c - union) / area_c, iou


def giou_loss(pred_ltrb: torch.Tensor, target_ltrb: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The mean of 1 - GIoU over the positions, or with `mask` (the leading
    shape, 0/1 or bool) its masked sum over the mask's sum, at least 1."""
    loss = 1.0 - giou(pred_ltrb, target_ltrb)[0]
    if mask is None:
        return loss.mean()
    mask = mask.to(loss.dtype)
    return torch.sum(loss * mask) / torch.clamp(mask.sum(), min=1.0)
