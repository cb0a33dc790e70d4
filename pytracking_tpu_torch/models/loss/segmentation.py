"""Segmentation losses of LWL and RTS (counterpart of
pytracking_tpu/models/loss/segmentation.py: `lovasz_hinge`,
`lovasz_seg_loss`, `balanced_bce`).

The Lovász hinge is a convex surrogate of a binary mask's IoU: the hinge
errors sorted in decreasing order, weighted by the Lovász extension's
gradient at the sorted ground truth. Every image of a batch is sorted in
one `torch.sort` over an (N, pixels) tensor. The loss does not depend on
how tied errors are ordered; its gradient does: the sort is stable, so tied
errors keep their pixel order, as `lax.top_k` keeps it in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """The Lovász extension's gradient at each row of sorted ground truth
    (N, P): the increments of the Jaccard loss 1 - |gt ∩ top-k| / |gt ∪
    top-k| as k grows."""
    gts = gt_sorted.sum(-1, keepdim=True)
    intersection = gts - torch.cumsum(gt_sorted, -1)
    union = gts + torch.cumsum(1.0 - gt_sorted, -1)
    jaccard = 1.0 - intersection / union
    return torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]], -1)


def lovasz_hinge(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The binary Lovász hinge of each row of flat logits and {0, 1} labels
    (..., P) -> (...,)."""
    signs = 2.0 * labels - 1.0
    errors = 1.0 - logits * signs
    errors_sorted, perm = torch.sort(errors, dim=-1, descending=True, stable=True)
    grad = _lovasz_grad(torch.gather(labels, -1, perm))
    return torch.sum(F.relu(errors_sorted) * grad, -1)


def lovasz_seg_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean over images of the Lovász hinge; logits and labels (..., H, W)."""
    P = logits.shape[-2] * logits.shape[-1]
    return lovasz_hinge(logits.reshape(-1, P), labels.to(logits.dtype).reshape(-1, P)).mean()


def balanced_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Class-balanced binary cross entropy of mask logits: the mean over the
    positive pixels and the mean over the negative ones (each count at
    least 1), averaged."""
    bce = torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    n_pos = torch.clamp(labels.sum(), min=1.0)
    n_neg = torch.clamp((1.0 - labels).sum(), min=1.0)
    return 0.5 * (torch.sum(bce * labels) / n_pos + torch.sum(bce * (1.0 - labels)) / n_neg)
