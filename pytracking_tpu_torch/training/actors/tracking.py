"""Actors: the training loss on top of a net's forward (counterpart of
pytracking_tpu/training/actors/tracking.py `make_dimp_actor`).

An actor is called on a batch on the device and returns (loss, stats),
both device tensors; the train step differentiates the loss with autograd
and reads the stats back once. Batch layout, frame-major: train_images
(Ntrain, S, 3, H, W) and test_images (Ntest, S, 3, H, W) in 0-255,
train_anno (Ntrain, S, 4), test_proposals (Ntest, S, P, 4), proposal_iou
(Ntest, S, P), test_label (Ntest, S, h, w).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from pytracking_tpu_torch.models.loss.target_classification import (
    lbhinge, tracking_classification_accuracy)


class DiMPActor:
    """DiMP's objective: the IoU predictions' squared error, plus the
    LBHinge classification loss of the filter iterates on the test frames
    (weights: iou 1, the final iterate 100, the first 100, the mean of the
    ones between 400, that last only with more than 2 iterates). The
    stats: Loss/total, Loss/iou, Loss/target_clf (weighted), and
    ClfTrain/test_acc of the final iterate's score peaks."""

    def __init__(self, net, loss_weight: Optional[Dict[str, float]] = None,
                 hinge_threshold: float = 0.05):
        self.net = net
        self.loss_weight = loss_weight or {"iou": 1.0, "test_clf": 100.0,
                                           "test_init_clf": 100.0, "test_iter_clf": 400.0}
        self.hinge_threshold = hinge_threshold

    def __call__(self, batch: Dict[str, torch.Tensor]):
        target_scores, iou_pred = self.net(batch["train_images"], batch["test_images"],
                                           batch["train_anno"], batch["test_proposals"])
        w = self.loss_weight
        loss_iou = torch.mean((iou_pred - batch["proposal_iou"]) ** 2)

        label = batch["test_label"][:, :, None]                # (Ntest, S, 1, h, w)
        clf_losses = [lbhinge(s, label, self.hinge_threshold) for s in target_scores]
        loss_target_clf = w.get("test_clf", 0) * clf_losses[-1]
        loss_init_clf = w.get("test_init_clf", 0) * clf_losses[0]
        loss_iter_clf = w.get("test_iter_clf", 0) * torch.stack(clf_losses[1:-1]).mean() \
            if len(clf_losses) > 2 else 0.0

        loss = w.get("iou", 0) * loss_iou + loss_target_clf + loss_init_clf + loss_iter_clf
        acc = tracking_classification_accuracy(target_scores[-1][:, :, 0], batch["test_label"])
        stats = {"Loss/total": loss, "Loss/iou": loss_iou, "Loss/target_clf": loss_target_clf,
                 "ClfTrain/test_acc": acc}
        return loss, stats
