"""Target classification losses (counterpart of
pytracking_tpu/models/loss/target_classification.py): `lbhinge`,
`is_target_cell_loss`, `tracking_classification_accuracy`, `focal_loss`."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def lbhinge(prediction: torch.Tensor, label: torch.Tensor, threshold: float = 0.05,
            clip: Optional[float] = None) -> torch.Tensor:
    """Squared error where the label is at least `threshold` (the target),
    max(0, prediction)² elsewhere; the mean over every element."""
    negative_mask = (label < threshold).to(prediction.dtype)
    positive_mask = 1.0 - negative_mask
    pred = negative_mask * F.relu(prediction) + positive_mask * prediction
    loss = torch.mean((pred - positive_mask * label) ** 2)
    if clip is not None:
        loss = torch.clamp(loss, max=clip)
    return loss


def is_target_cell_loss(prediction: torch.Tensor, label: torch.Tensor,
                        use_logits: bool = True) -> torch.Tensor:
    """Binary cross-entropy of whether a cell holds the target."""
    if use_logits:
        return torch.mean(torch.clamp(prediction, min=0) - prediction * label
                          + torch.log1p(torch.exp(-prediction.abs())))
    p = torch.clamp(prediction, 1e-7, 1 - 1e-7)
    return -torch.mean(label * torch.log(p) + (1 - label) * torch.log(1 - p))


def tracking_classification_accuracy(prediction: torch.Tensor, label: torch.Tensor,
                                     threshold: float = 0.25) -> torch.Tensor:
    """Share of maps (..., H, W) whose score peak lies where the label
    exceeds `threshold`; a map whose label never does counts as right when
    its peak stays below `threshold`."""
    pred_flat = prediction.flatten(-2)
    label_flat = label.flatten(-2)
    label_at_peak = torch.gather(label_flat, -1, pred_flat.argmax(-1, keepdim=True))[..., 0]
    correct = torch.where(label_flat.amax(-1) > threshold, label_at_peak > threshold,
                          pred_flat.amax(-1) < threshold)
    return correct.to(prediction.dtype).mean()


def focal_loss(prediction: torch.Tensor, label: torch.Tensor, alpha: float = 0.25,
               gamma: float = 2.0) -> torch.Tensor:
    """Focal loss on sigmoid scores; the positives are the cells whose label
    is 1 or more. Summed, over the number of positives (at least 1)."""
    prob = torch.sigmoid(prediction)
    pos = (label >= 1.0).to(prediction.dtype)
    pt = torch.where(pos > 0, prob, 1 - prob)
    alpha_t = torch.where(pos > 0, torch.full_like(prob, alpha), torch.full_like(prob, 1 - alpha))
    w = alpha_t * (1 - pt) ** gamma
    bce = -torch.log(torch.clamp(pt, 1e-7, 1.0))
    return torch.sum(w * bce) / torch.clamp(pos.sum(), min=1.0)
